"""bf16 compute and remat in the PyTorch package against the JAX package.

- ``plain_sdpa`` on bf16 q, k, v against lstc_vad_tpu/ops/attention.py::
  _xla_sdpa on the same bf16 values, within one bf16 ulp (rtol 8e-3,
  atol 1e-3), also at a d_k whose square root bf16 does not hold; the f32
  path computes what it computed before, bit for bit.
- The bf16 ``Encoder`` (deterministic, 2 layers, every preset shape) against
  JAX's bf16 Encoder on the same weights within rtol 2e-2 / atol 2e-2,
  tighter than JAX's own bf16-vs-f32 bound (rtol 0.05 / atol 0.08,
  tests/test_encoder_parity.py:143).  Both round at the same places (bf16
  products, the bias added after the dot, f32 LayerNorm statistics), and on
  the CPU the two agree bit for bit at every config here.
- One dropout-free LTN step with bf16 compute against JAX's, at the same
  2e-2: the metrics relative, each parameter's gradient magnitudes (the
  square roots of the first Adagrad sums) norm-wise; the first Adagrad step
  moves each weight by about lr · sign(g), so the two updates may differ
  only where a gradient is within 2e-2 of zero relative to the largest.
- remat: loss and every gradient of a step bit-identical to the plain
  step's, with dropout off and on (tests/test_encoder_parity.py:162-191);
  the diagnostic outputs bypass it.
- The f32 eval twin, the head's upcast, the operator on bf16 CPU inputs
  (``torch.library.opcheck``) and the bf16 route's checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstc_vad_tpu.config import EncoderConfig as JaxEncoderConfig
from lstc_vad_tpu.models import Encoder as JaxEncoder
from lstc_vad_tpu.ops.attention import _xla_sdpa
from lstc_vad_tpu.train.state import create_train_state as jax_state
from lstc_vad_tpu.train.steps import make_ltn_train_step
from lstc_vad_tpu_torch.config import EncoderConfig
from lstc_vad_tpu_torch.models import Encoder, make_head
from lstc_vad_tpu_torch.models.encoder import eval_twin
from lstc_vad_tpu_torch.ops import cuda_attention
from lstc_vad_tpu_torch.ops.attention import plain_sdpa
from lstc_vad_tpu_torch.train import make_train_step

from test_torch_encoder import CONFIGS, SMALL, jax_and_port_encoder
from test_torch_train_step import (batch, flat_from_jax, jax_accumulators,
                                   jax_config, named_params, port_config,
                                   port_state)

BF16_RTOL, BF16_ATOL = 2e-2, 2e-2


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("length", [10, 17, 49])
def test_plain_sdpa_bf16_matches_jax(length, d):
    """d=32: the temperature √32 is not a bf16 number; both divide by its
    bf16 rounding, as JAX's weakly typed scalar takes q's type."""
    rng = np.random.default_rng(length * 100 + d)
    q, k, v = (rng.standard_normal((2, 2, length, d)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((2, length, length)).astype(np.float32)
    temp = float(np.sqrt(d))
    want = _xla_sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                     jnp.asarray(bias), None, temp, 0.0, None)
    got = plain_sdpa(_bf16(q), _bf16(k), _bf16(v), temp,
                     bias=torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=8e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_sdpa_f32_and_f64_paths_are_unchanged(dtype):
    """The bf16 casts are the identity on f32 and f64 tensors: the same ops
    as before, so the same bits (the f64 path is the exact reference the
    card tests and scripts hold the kernels to)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 17, 32)))
               .to(dtype) for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((3, 17, 17))).to(dtype)
    attn = torch.matmul(q / 4.0, k.transpose(-1, -2)) + bias
    want = torch.matmul(torch.softmax(attn, dim=-1), v)
    got = plain_sdpa(q, k, v, 4.0, bias=bias)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bf16_encoder_matches_jax(name):
    kw, n_tok = CONFIGS[name]
    jcfg = JaxEncoderConfig(attn_impl="xla", compute_dtype="bfloat16",
                            **{**SMALL, **kw})
    x = np.random.default_rng(7).standard_normal((3, n_tok, 64),
                                                 dtype=np.float32)
    model, params, port = jax_and_port_encoder(jcfg, x)
    want = np.asarray(model.apply({"params": params}, x, deterministic=True),
                      np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    # the output is bf16 wherever the last op of a layer is (flax's too)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_bf16_encoder_takes_a_bf16_wire_as_jax_does():
    """A bf16 train batch enters the encoder as bf16: the CLS mean is taken
    and rounded on bf16 tokens before the attention casts."""
    kw, n_tok = CONFIGS["ltn_full_window_L49"]
    jcfg = JaxEncoderConfig(attn_impl="xla", compute_dtype="bfloat16",
                            **SMALL, **kw)
    x = np.random.default_rng(8).standard_normal((2, n_tok, 64),
                                                 dtype=np.float32)
    model, params, port = jax_and_port_encoder(jcfg, x)
    want = np.asarray(model.apply({"params": params},
                                  jnp.asarray(x, jnp.bfloat16),
                                  deterministic=True), np.float32)
    with torch.no_grad():
        got = port(_bf16(x)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_bf16_ltn_step_matches_jax():
    """One dropout-free LTN step with bf16 compute from the same weights
    and batch: the f32 master weights and Adagrad sums move as JAX's."""
    jcfg = jax_config("ltn", **{"encoder.compute_dtype": "bfloat16"})
    jstate, enc, head, tx = jax_state(jcfg)
    params0 = jax.tree.map(np.asarray, jstate.params)
    data = batch(np.random.default_rng(11))
    new_jstate, jmetrics = make_ltn_train_step(enc, head, jcfg, tx)(jstate,
                                                                    *data)
    pcfg = port_config(jcfg)
    state = port_state(pcfg, params0)
    state, metrics = make_train_step(pcfg)(state, *data)
    for k, v in metrics.items():
        assert float(v) == pytest.approx(float(jmetrics[k]), rel=BF16_RTOL,
                                         abs=1e-6), k
    params = named_params(state)
    assert all(p.dtype == torch.float32 for p in params.values())
    kind = pcfg.head.kind
    start = flat_from_jax(params0, kind)
    ref_params = flat_from_jax(jax.tree.map(np.asarray, new_jstate.params),
                               kind)
    ref_sums = flat_from_jax(jax.tree.map(
        np.asarray, jax_accumulators(new_jstate.opt_state)), kind)
    for name, ref in ref_params.items():
        g_ref = np.sqrt(ref_sums[name])
        g = np.sqrt(state.optimizer.state[params[name]]["sum"].numpy())
        assert np.linalg.norm(g - g_ref) <= BF16_RTOL * np.linalg.norm(
            g_ref), name
        moved = params[name].detach().numpy() - start[name]
        flips = np.sign(moved) != np.sign(ref - start[name])
        assert (g_ref[flips] <= BF16_RTOL * g_ref.max()).all(), name


def _dropout_config(remat, **kw):
    return port_config(jax_config(
        "ltn", **{"encoder.attn_dropout": 0.2, "encoder.fc_dropout": 0.2,
                  "encoder.ffn_dropout": 0.1, "head.dropout": 0.6,
                  "encoder.n_layers": 2, "encoder.remat": remat, **kw}))


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_is_bit_identical(dropout, dtype):
    """The loss and every gradient of a step under remat equal the plain
    step's bit for bit: each layer's recompute draws its dropout masks from
    the default generators the checkpoint restored."""
    data = batch(np.random.default_rng(12))
    runs = []
    for remat in (False, True):
        cfg = _dropout_config(remat, **{"encoder.compute_dtype": dtype})
        if not dropout:
            cfg = port_config(jax_config(
                "ltn", **{"encoder.n_layers": 2, "encoder.remat": remat,
                          "encoder.compute_dtype": dtype}))
        state = create_state(cfg)
        metrics = make_train_step(cfg).grads(state, *data)
        runs.append((metrics, {n: p.grad for n, p in
                               named_params(state).items()
                               if p.grad is not None}))
    (m0, g0), (m1, g1) = runs
    assert torch.equal(m0["loss"], m1["loss"])
    assert g0.keys() == g1.keys() and g0
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def create_state(cfg):
    from lstc_vad_tpu_torch.train import create_train_state

    return create_train_state(cfg, device="cpu", seed=3)


def test_remat_diagnostic_outputs_bypass_it():
    cfg = EncoderConfig(remat=True, **SMALL, **CONFIGS[
        "ltn_full_window_L49"][0])
    enc = Encoder(cfg, device="cpu").reset_parameters(
        torch.Generator().manual_seed(0)).train()
    x = torch.randn(2, 48, 64, requires_grad=True)
    out, probs = enc(x, return_probs=True)
    assert len(probs) == 2 and probs[0].shape == (2, 4, 49, 49)
    out2, probs2, vs = enc(x, return_v=True)
    assert len(vs) == 2 and vs[0].shape == (2, 4, 49, 16)
    out.float().sum().backward()
    assert x.grad is not None


def test_eval_twin_shares_the_weights_and_runs_f32():
    kw, n_tok = CONFIGS["ltn_full_window_L49"]
    cfg = EncoderConfig(compute_dtype="bfloat16", remat=True, cast_sr=True,
                        **SMALL, **kw)
    enc = Encoder(cfg, device="cpu").reset_parameters(
        torch.Generator().manual_seed(0))
    twin = eval_twin(enc)
    assert twin.cfg.compute_dtype == "float32"
    assert not twin.cfg.remat and not twin.cfg.cast_sr
    assert all(a is b for a, b in zip(enc.parameters(), twin.parameters()))
    f32 = Encoder(twin.cfg, device="cpu")
    f32.load_state_dict(enc.state_dict(), strict=True)
    x = torch.randn(2, n_tok, 64)
    with torch.no_grad():
        want = f32.eval()(x)
        assert torch.equal(twin.eval()(x), want)
        assert enc.training  # the twin's mode is its own
        enc.layer_stack[0].pos_ffn.w_1.weight.mul_(2.0)  # a step, in place
        assert not torch.equal(twin(x), want)
    assert eval_twin(f32) is f32


def test_head_runs_in_f32_on_a_bf16_cls():
    head = make_head("classifier", 16, 8, device="cpu").reset_parameters(
        torch.Generator().manual_seed(0)).eval()
    x = torch.randn(5, 16).to(torch.bfloat16)
    out = head(x)
    assert out.dtype == torch.float32
    assert torch.equal(out, head(x.float()))


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_op_passes_opcheck_on_bf16_cpu_inputs(with_bias, grad):
    rng = np.random.default_rng(int(with_bias) * 2 + int(grad))
    bufs = [_bf16(rng.standard_normal((3, 17, 2, 32), dtype=np.float32))
            .requires_grad_(grad) for _ in range(3)]
    q, k, v = (x.transpose(1, 2) for x in bufs)  # as the encoder passes
    bias = (torch.from_numpy(rng.standard_normal((2, 17, 17),
                                                 dtype=np.float32))
            .requires_grad_(grad) if with_bias else None)
    result = torch.library.opcheck(torch.ops.lstc_vad.attention.default,
                                   (q, k, v, bias, 4.0))
    assert set(result.values()) == {"SUCCESS"}, result
    out = cuda_attention.attention(q, k, v, bias, 4.0)
    assert out.dtype == torch.bfloat16 and out.transpose(1, 2).is_contiguous()
    assert torch.equal(out, plain_sdpa(q, k, v, 4.0, bias=bias))
    assert cuda_attention.launches == cuda_attention.launches_bf16 == 0


def test_bf16_route_checks():
    """bf16 q, k, v with an f32 bias pass: with 16-byte strides (8
    elements) to the tiled bf16 kernel, with 4-element strides to the
    streaming one; a bf16 bias, mixed types and float16 are refused."""
    q = torch.zeros(2, 9, 2, 32, dtype=torch.bfloat16).transpose(1, 2)
    bias = torch.zeros(2, 9, 9)
    odd = torch.zeros(2, 2, 9, 36, dtype=torch.bfloat16)[..., :32]
    for t, want in ((q, "bf16"), (odd, "bf16_stream")):
        cuda_attention._check(t, t, t, bias, 4.0)
        assert cuda_attention.route(t.dtype, 9, 32, 32,
                                    cuda_attention._aligned(t)) == want
    bad = [(q, q, q, bias.to(torch.bfloat16)),
           (q, q.float(), q, bias), (q.half(), q.half(), q.half(), bias)]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            cuda_attention._check(*args, 4.0)


# The tiled bf16 kernel's launch geometry (csrc/attention_bf16.cu::plan,
# read on the card by cuda_attention.bf16_plan and held to the same rule in
# tests/test_torch_cuda_kernel.py::test_bf16_plan_fits_the_block), written
# out: 64-row tiles of 64/R heads of R rows (the least of 16, 32, 64 that
# holds L), one a consumer warpgroup, or 128 rows of one head over both of
# a block's consumer warpgroups; a stage holds Q, K and V of a tile, 3 x
# ceil(D/64) boxes of 128 bytes a row, and 32 bytes of barriers; each
# consumer warpgroup two 8 KB O boxes; as many stages as fit, up to 4, an
# even number at 64-row tiles (two tiles in flight, each on every other).
SMEM_LIMIT, MAX_STAGES = 232448, 4


def bf16_plan(length, d):
    rows = next(r for r in (16, 32, 64, 128) if length <= r)
    nc = 2 if rows == 128 else 1
    stage = 3 * -(-d // 64) * 64 * nc * 128 + 32
    fixed = 2 * 2 * 8192
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
    if nc == 1:  # two 64-row tiles in flight, each on every other stage
        stages -= stages % 2
    return {"smem_bytes": stages * stage + fixed, "threads": 384,
            "rows": 64 * nc, "heads": max(1, 64 // rows), "head_rows": rows,
            "stages": stages}


# (L, D) -> (shared bytes, threads, tile rows, heads a tile, rows a head,
# stages) at the shapes the models run and both sides of each tile edge
PLANS_BF16 = {
    (1, 32): (131200, 384, 64, 4, 16, 4),
    (10, 256): (229440, 384, 64, 4, 16, 2),
    (16, 96): (229504, 384, 64, 4, 16, 4),
    (17, 256): (229440, 384, 64, 2, 32, 2),
    (32, 64): (131200, 384, 64, 2, 32, 4),
    (33, 256): (229440, 384, 64, 1, 64, 2),
    (49, 256): (229440, 384, 64, 1, 64, 2),
    (64, 160): (180288, 384, 64, 1, 64, 2),
    (65, 256): (229408, 384, 128, 1, 128, 1),
    (81, 256): (229408, 384, 128, 1, 128, 1),
    (96, 128): (229440, 384, 128, 1, 128, 2),
    (128, 32): (229504, 384, 128, 1, 128, 4),
}


@pytest.mark.parametrize("length,d", sorted(PLANS_BF16))
def test_bf16_plan_table(length, d):
    """The written-out geometry at the model shapes and tile edges."""
    assert tuple(bf16_plan(length, d).values()) == PLANS_BF16[length, d]


@pytest.mark.parametrize("d", list(range(32, 257, 32)))
@pytest.mark.parametrize("length", [1, 16, 17, 32, 33, 64, 65, 128])
def test_bf16_plan_fits_a_block(length, d):
    """At every tile edge and D the tiled bf16 route takes: the tile holds
    L rows of each of its heads, the block's shared memory fits 227 KB,
    and one more stage (two at 64-row tiles) would not, or the ring is at
    its 4."""
    assert cuda_attention.route(torch.bfloat16, length, d, d, True) == "bf16"
    p = bf16_plan(length, d)
    assert p["head_rows"] >= length and p["heads"] * p["head_rows"] in (
        64, 128)
    assert p["rows"] == max(64, p["head_rows"])
    assert 1 <= p["stages"] <= MAX_STAGES
    assert p["smem_bytes"] <= SMEM_LIMIT
    stage = (p["smem_bytes"] - 2 * 2 * 8192) // p["stages"]
    step = 2 if p["rows"] == 64 else 1
    assert p["stages"] % step == 0
    assert p["stages"] == MAX_STAGES or \
        p["smem_bytes"] + step * stage > SMEM_LIMIT


def test_compute_dtype_is_float32_or_bfloat16():
    """The two types the attention kernels take; anything else is refused
    when the encoder is built."""
    with pytest.raises(ValueError, match="compute_dtype"):
        Encoder(EncoderConfig(compute_dtype="float16", **SMALL),
                device="cpu")
