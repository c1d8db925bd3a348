"""The PyTorch encoder and heads against the JAX package's.

Weights are drawn by the JAX package, mapped by
lstc_vad_tpu_torch/ckpt/interop.py and loaded with ``strict=True``; the same
numpy input goes through ``Encoder.apply`` / ``head.apply`` and through the
port, dropout off.  Tolerance rtol 2e-4 / atol 2e-5, as
tests/test_encoder_parity.py holds the JAX encoder to its torch oracle.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lstc_vad_tpu.config import EncoderConfig as JaxEncoderConfig
from lstc_vad_tpu.models import Encoder as JaxEncoder
from lstc_vad_tpu.models import make_head as jax_make_head
from lstc_vad_tpu.models import rpe as jax_rpe
from lstc_vad_tpu_torch.ckpt.interop import (encoder_state_dict_from_jax,
                                             head_state_dict_from_jax)
from lstc_vad_tpu_torch.config import EncoderConfig
from lstc_vad_tpu_torch.models import Encoder, make_head, rpe

SMALL = dict(d_model=64, d_inner=96, n_head=4, d_k=16, d_v=16, n_layers=2)
LTN = dict(mha_layernorm=True, ffn_layernorm=True, relative_pe=True,
           window_size=4)

# (config kwargs, input tokens): every encoder shape the presets use, cut
# to small widths
CONFIGS = {
    "stn_weight_init_L17": (dict(ffn_layernorm=True, weight_init=True), 16),
    "ltn_full_window_L49": (dict(window_depth=3, **LTN), 48),
    "ltn_short_tail_L33": (dict(window_depth=3, **LTN), 32),
    "ubnormal_like_L81": (dict(window_depth=5, **LTN), 80),
    "rpe_2d": (dict(ffn_layernorm=True, relative_pe_2d=True,
                    window_size=4), 16),
    "cls_learned_pe_input_ln": (dict(cls_learned=True, position_encoding=True,
                                     max_position_tokens=17,
                                     input_layernorm=True,
                                     ffn_layernorm=True), 16),
    "ffn_need_false": (dict(ffn_need=False), 16),
}


def port_config(jcfg: JaxEncoderConfig, **kw) -> EncoderConfig:
    """The port's twin of a JAX EncoderConfig (attn_impl takes the port's
    own values)."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JaxEncoderConfig)}
    fields["attn_impl"] = "auto"
    fields.update(kw)
    return EncoderConfig(**fields)


def jax_and_port_encoder(jcfg: JaxEncoderConfig, x: np.ndarray, seed=0):
    model = JaxEncoder(jcfg)
    params = jax.tree.map(np.asarray,
                          model.init(jax.random.PRNGKey(seed), x))["params"]
    port = Encoder(port_config(jcfg), device="cpu")
    port.load_state_dict(encoder_state_dict_from_jax(params, jcfg),
                         strict=True)
    return model, params, port.eval()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_matches_jax(name):
    kw, n_tok = CONFIGS[name]
    jcfg = JaxEncoderConfig(attn_impl="xla", **SMALL, **kw)
    x = np.random.default_rng(7).standard_normal((3, n_tok, 64),
                                                 dtype=np.float32)
    model, params, port = jax_and_port_encoder(jcfg, x)
    ref = np.asarray(model.apply({"params": params}, x, deterministic=True))
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    assert ours.shape == (3, n_tok + 1, 64)
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-5)


def test_attention_gets_views_of_the_projections(monkeypatch):
    """MultiHeadAttention hands attention [B, H, L, D] views of its q, k, v
    projections, with no copy, in a layout the kernel's checks take."""
    from lstc_vad_tpu_torch.models import encoder as encoder_module
    from lstc_vad_tpu_torch.ops import cuda_attention

    seen = []
    real_sdpa = encoder_module.sdpa

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        return real_sdpa(q, k, v, **kw)

    monkeypatch.setattr(encoder_module, "sdpa", spy)
    widths = dict(SMALL, d_k=32, d_v=32)  # the kernel takes D = 32k
    enc = Encoder(EncoderConfig(window_depth=3, **widths, **LTN), device="cpu")
    enc.reset_parameters(torch.Generator().manual_seed(0)).eval()
    x = np.random.default_rng(10).standard_normal((2, 48, 64),
                                                  dtype=np.float32)
    with torch.no_grad():
        enc(torch.from_numpy(x))
    assert len(seen) == SMALL["n_layers"]
    for q, k, v in seen:
        for t in (q, k, v):
            assert t.shape == (2, 4, 49, 32)
            assert t.stride() == (49 * 128, 32, 128, 1)
            assert t._base is not None and t._base.shape == (2, 49, 128)
        cuda_attention._check(q, k, v, None, 4.0)


def test_attention_maps_and_values_match_jax():
    jcfg = JaxEncoderConfig(attn_impl="xla", window_depth=3, **SMALL, **LTN)
    x = np.random.default_rng(8).standard_normal((2, 48, 64),
                                                 dtype=np.float32)
    model, params, port = jax_and_port_encoder(jcfg, x)
    _, probs, vs = model.apply({"params": params}, x, deterministic=True,
                               return_v=True)
    with torch.no_grad():
        _, ours_probs, ours_vs = port(torch.from_numpy(x), return_v=True)
    for a, b in zip(ours_probs + ours_vs, list(probs) + list(vs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kind", ["regressor", "classifier"])
@pytest.mark.parametrize("weight_init", [False, True])
def test_head_matches_jax(kind, weight_init):
    head = jax_make_head(kind, d_model=64, hidden_dim=32,
                         weight_init=weight_init)
    x = np.random.default_rng(9).standard_normal((10, 64), dtype=np.float32)
    params = jax.tree.map(np.asarray,
                          head.init(jax.random.PRNGKey(1), x))["params"]
    port = make_head(kind, 64, 32, weight_init=weight_init, device="cpu")
    port.load_state_dict(head_state_dict_from_jax(params, kind), strict=True)
    ref = np.asarray(head.apply({"params": params}, x, deterministic=True))
    with torch.no_grad():
        ours = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-5)


def test_head_rejects_wrong_input_width():
    head = make_head("regressor", 32, device="cpu")
    with pytest.raises(ValueError, match="d_model=32 got input width 16"):
        head(torch.zeros(2, 16))


@pytest.mark.parametrize("depth,size", [(3, 4), (5, 4), (2, 3), (1, 2)])
def test_rpe_index_tables_bit_equal(depth, size):
    np.testing.assert_array_equal(
        rpe.relative_position_index_3d(depth, size),
        jax_rpe.relative_position_index_3d(depth, size))
    np.testing.assert_array_equal(rpe.relative_position_index_2d(size),
                                  jax_rpe.relative_position_index_2d(size))
    assert rpe.table_size_3d(depth, size) == jax_rpe.table_size_3d(depth,
                                                                   size)


def test_rpe_window_overflow_raises():
    enc = Encoder(EncoderConfig(window_depth=3, **SMALL, **LTN), device="cpu")
    with pytest.raises(ValueError, match="exceeds the relative-PE window"):
        enc(torch.zeros(1, 49, 64))


@pytest.mark.parametrize("knob", [dict(compute_dtype="bfloat16"),
                                  dict(compute_dtype="bfloat16",
                                       cast_sr=True), dict(remat=True)])
def test_train_knob_matches_jax(knob):
    """Each train-time knob against the JAX encoder with the same knob, a
    train pass with every dropout at 0 and its gradient (norm-wise, per
    parameter): bf16 compute within 2e-2 (tests/test_torch_bf16.py); cast_sr
    within JAX's own SR-vs-f32 bound (0.08, tests/test_sr.py:156: the two
    draw different noise), twice that for the gradient, which goes back
    through twice the stochastic casts; remat at this file's f32 bar for
    the output and the train step's 1e-3 for the gradient."""
    jcfg = JaxEncoderConfig(attn_impl="xla", window_depth=3, attn_dropout=0.0,
                            fc_dropout=0.0, ffn_dropout=0.0, **SMALL, **LTN,
                            **knob)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 48, 64), dtype=np.float32)
    # a random weighting of the output: its LayerNormed square is constant
    w = rng.standard_normal((2, 49, 64), dtype=np.float32)
    model, params, port = jax_and_port_encoder(jcfg, x)

    def loss(p):
        h = model.apply({"params": p}, x, deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1)})
        return (h.astype(np.float32) * w).sum(), h

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    port.train()
    torch.manual_seed(1)
    out = port(torch.from_numpy(x))
    (out.float() * torch.from_numpy(w)).sum().backward()
    # (output rtol, output atol, gradient norm-wise relative error)
    rtol, atol, grad_rel = {"remat": (2e-4, 2e-5, 1e-3),
                            "cast_sr": (0.08, 0.08, 0.16)}.get(
        "cast_sr" if knob.get("cast_sr") else next(iter(knob)),
        (2e-2, 2e-2, 2e-2))
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)
    g_want = encoder_state_dict_from_jax(jax.tree.map(np.asarray, grads))
    for name, g in g_want.items():
        got = dict(port.named_parameters())[name].grad
        rel = float((got - g).norm() / g.norm().clamp_min(1e-12))
        assert rel <= grad_rel, (name, rel)


def test_init_draws_from_the_generator():
    """Same seed, same weights; the distributions follow the JAX package's
    initializers (a distribution match only: the two draw different
    numbers)."""
    cfg = EncoderConfig(window_depth=3, **SMALL, **LTN)

    def draw(seed):
        return Encoder(cfg, device="cpu").reset_parameters(
            torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = draw(0), draw(0), draw(1)
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    w = a["layer_stack.0.slf_attn.w_qs.weight"]
    assert not torch.equal(w, c["layer_stack.0.slf_attn.w_qs.weight"])
    assert w.abs().max() <= 1 / np.sqrt(64)
    table = a["layer_stack.0.slf_attn.relative_position_bias_table"]
    assert 0.01 < table.std() < 0.03
