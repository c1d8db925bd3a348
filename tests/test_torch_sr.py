"""The stochastic-rounding cast (lstc_vad_tpu_torch/ops/sr.py) and the
encoder's ``cast_sr`` arm against the JAX package's (lstc_vad_tpu/ops/sr.py,
tests/test_sr.py).

The two packages draw their noise from different generators, so the cast is
held to JAX's bit for bit given the same 16-bit noise
(``jax.random.bits(key) & 0xFFFF``), and to its distribution otherwise.
The encoder's SR train forward tracks the f32 forward within JAX's own bound
(rtol 0.08 / atol 0.08, tests/test_sr.py:156).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstc_vad_tpu.config import EncoderConfig as JaxEncoderConfig
from lstc_vad_tpu.models import Encoder as JaxEncoder
from lstc_vad_tpu.ops.sr import sr_cast as jax_sr_cast
from lstc_vad_tpu_torch.ckpt.interop import encoder_state_dict_from_jax
from lstc_vad_tpu_torch.config import EncoderConfig
from lstc_vad_tpu_torch.models import Encoder
from lstc_vad_tpu_torch.ops.sr import sr_cast, sr_noise


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _jax_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def _mixed(rng, n):
    return (rng.standard_normal(n) * rng.choice([1e-30, 1e-3, 1.0, 1e3,
                                                 1e30], n)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sr_cast_equals_jax_bit_for_bit_from_the_same_noise(seed):
    x = _mixed(np.random.default_rng(seed), 4096)
    key = jax.random.PRNGKey(seed)
    noise = np.asarray(jax.random.bits(key, x.shape, jnp.uint32)
                       & jnp.uint32(0xFFFF)).astype(np.int32)
    want = jax_sr_cast(jnp.asarray(x), key)
    got = sr_cast(torch.from_numpy(x), torch.from_numpy(noise))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _jax_bits(want))


def test_sr_cast_is_unbiased():
    """E[sr_cast(x)] == x: the mean over 4096 draws of the default
    generator is within 5 sigma of a Bernoulli mean of x, far inside the
    one-ulp gap a round-to-nearest cast can sit at."""
    torch.manual_seed(0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        64).astype(np.float32))
    n = 4096
    mean = torch.stack([sr_cast(x).float() for _ in range(n)]).double()
    mean = mean.mean(0)
    low = (x.view(torch.int32) & -65536).view(torch.float32).double()
    gap = (low.abs() * 2 ** -7).clamp_min(1e-30)  # a bf16 ulp at x
    err = (mean - x.double()).abs()
    assert (err <= 5 * gap * 0.5 / np.sqrt(n)).all(), err.max()


def test_exact_values_come_back_under_every_noise():
    exact = torch.tensor([0.0, 1.0, -2.5, 0.15625, 2.0 ** 15, -2.0 ** -20])
    assert torch.equal(exact.to(torch.bfloat16).float(), exact)
    for fill in (0, 1, 0x8000, 0xFFFF):
        noise = torch.full(exact.shape, fill, dtype=torch.int32)
        assert torch.equal(sr_cast(exact, noise).float(), exact)
    for _ in range(4):
        assert torch.equal(sr_cast(exact).float(), exact)


def test_non_finite_values_pass_through():
    """NaN (a high-payload one too, whose bits 0x7FFFFFFF plus any noise
    wrap through the sign) and ±Inf survive the cast, as in JAX."""
    x = torch.tensor([np.nan, np.inf, -np.inf, 1.5])
    evil = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32)
    x = torch.cat([x, evil])
    for fill in (0, 1, 0xFFFF):
        out = sr_cast(x, torch.full(x.shape, fill, dtype=torch.int32))
        out = out.float()
        assert torch.isnan(out[0]) and torch.isnan(out[4]), out
        assert out[1] == np.inf and out[2] == -np.inf and out[3] == 1.5
    want = np.asarray(jax_sr_cast(jnp.asarray(x.numpy()),
                                  jax.random.PRNGKey(3)), np.float32)
    got = sr_cast(x).float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[1:4], want[1:4])


def test_non_f32_inputs_pass_through_as_the_plain_cast():
    x = torch.full((3,), 1.5, dtype=torch.bfloat16)
    assert torch.equal(sr_cast(x), x)
    y = torch.tensor([1.0, 2.0], dtype=torch.float64)
    assert sr_cast(y).dtype == torch.bfloat16


def test_gradient_is_the_identity_cast():
    x = torch.tensor([0.3, -1.7, 2.0], requires_grad=True)
    (sr_cast(x).float() * 3.0).sum().backward()
    assert x.grad.dtype == torch.float32
    np.testing.assert_allclose(x.grad.numpy(), 3.0, rtol=1e-6)
    g = jax.grad(lambda v: jnp.sum(jax_sr_cast(v, jax.random.PRNGKey(0))
                                   .astype(jnp.float32) * 3.0))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(g))


def test_noise_is_drawn_from_the_default_generator():
    x = torch.zeros(1000)
    torch.manual_seed(5)
    a = sr_noise(x)
    torch.manual_seed(5)
    b = sr_noise(x)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert 0 <= int(a.min()) and int(a.max()) < 2 ** 16


# ------------------------------------------------------- encoder cast_sr arm

ENC = dict(d_model=16, d_inner=32, n_head=2, d_k=8, d_v=8, n_layers=2,
           mha_layernorm=True, ffn_layernorm=True, relative_pe=True,
           window_size=4, window_depth=3)
NO_DROP = dict(attn_dropout=0.0, fc_dropout=0.0, ffn_dropout=0.0)


def _jax_params(x, **kw):
    model = JaxEncoder(JaxEncoderConfig(attn_impl="xla", **ENC, **kw))
    params = jax.tree.map(np.asarray,
                          model.init(jax.random.PRNGKey(0), x))["params"]
    return model, params


def _port(params, **kw):
    cfg = EncoderConfig(**ENC, **kw)
    enc = Encoder(cfg, device="cpu")
    enc.load_state_dict(encoder_state_dict_from_jax(params, cfg),
                        strict=True)
    return enc


def test_cast_sr_requires_bf16_compute():
    """As the JAX encoder's train pass: cast_sr with f32 compute raises."""
    x = np.zeros((1, 12, 16), np.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        JaxEncoder(JaxEncoderConfig(attn_impl="xla", cast_sr=True, **ENC)
                   ).init(jax.random.PRNGKey(0), x, deterministic=False)
    enc = Encoder(EncoderConfig(cast_sr=True, **ENC), device="cpu").train()
    with pytest.raises(ValueError, match="bfloat16"):
        enc(torch.from_numpy(x))


def test_cast_sr_loads_the_same_checkpoints_and_evaluates_as_plain_bf16():
    """The state_dict keys are unchanged, so JAX params load strict=True
    into a cast_sr encoder, and its deterministic pass is the plain bf16
    pass bit for bit (and JAX's cast_sr deterministic pass)."""
    x = np.random.default_rng(2).standard_normal((2, 12, 16)).astype(
        np.float32)
    _, params = _jax_params(x)
    plain = _port(params, compute_dtype="bfloat16").eval()
    sr = _port(params, compute_dtype="bfloat16", cast_sr=True).eval()
    assert list(plain.state_dict()) == list(sr.state_dict())
    with torch.no_grad():
        a = plain(torch.from_numpy(x))
        b = sr(torch.from_numpy(x))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    jax_sr = JaxEncoder(JaxEncoderConfig(attn_impl="xla",
                                         compute_dtype="bfloat16",
                                         cast_sr=True, **ENC))
    want = np.asarray(jax_sr.apply({"params": params}, x,
                                   deterministic=True), np.float32)
    np.testing.assert_allclose(b.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_cast_sr_train_forward_tracks_f32():
    """With dropouts at 0 the SR train forward stays within bf16 matmul
    noise of the f32 forward of the same weights (JAX's bound), and two
    seeds give different outputs: the rounding really is stochastic."""
    x = np.random.default_rng(3).standard_normal((2, 12, 16)).astype(
        np.float32)
    f32_model, params = _jax_params(x, **NO_DROP)
    ref = np.asarray(f32_model.apply({"params": params}, x,
                                     deterministic=True))
    sr = _port(params, compute_dtype="bfloat16", cast_sr=True,
               **NO_DROP).train()
    outs = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        with torch.no_grad():
            out = sr(torch.from_numpy(x))
        assert out.dtype == torch.float32  # the LayerNorms give f32
        outs.append(out.numpy())
        np.testing.assert_allclose(outs[-1], ref, rtol=0.08, atol=0.08)
    assert not np.array_equal(outs[0], outs[1])


def test_cast_sr_composes_with_remat():
    """remat recomputes each layer in the backward from the restored default
    generators, so the SR noise (and the dropout masks) are drawn again the
    same: output and every gradient equal the plain SR pass bit for bit."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 12, 16)).astype(np.float32))
    _, params = _jax_params(x.numpy())
    runs = []
    for remat in (False, True):
        enc = _port(params, compute_dtype="bfloat16", cast_sr=True,
                    remat=remat).train()
        torch.manual_seed(9)
        out = enc(x)
        (out.float() ** 2).mean().backward()
        runs.append((out.detach(), {n: p.grad for n, p in
                                    enc.named_parameters()
                                    if p.grad is not None}))
    (a, ga), (b, gb) = runs
    assert torch.equal(a, b)
    assert ga.keys() == gb.keys() and ga
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name
        assert torch.isfinite(ga[name]).all(), name
