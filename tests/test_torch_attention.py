"""The PyTorch package's attention against the JAX package's.

``plain_sdpa`` (lstc_vad_tpu_torch/ops/attention.py) is held against
``_xla_sdpa`` and against the Pallas kernel run in interpret mode, at every
sequence length the models use, with the JAX test's tolerance
(tests/test_pallas_attention.py:26-27).  On the CPU the kernel's wrapper
runs the plain version; the kernel itself is checked on the card by
tests/test_torch_cuda_kernel.py and chip_smoke.py.  The wrapper's autograd
Function (forward: the kernel; backward: autograd through plain_sdpa) is
held against plain autograd and against jax.grad of the Pallas kernel's
custom VJP at rtol 1e-4 / atol 1e-5 (tests/test_pallas_attention.py:56-57).

The operator takes every shape the JAX package's ``sdpa`` computes: parts
past 128 tokens (L = 129 and 257, against ``_xla_sdpa`` and the Pallas
kernel) and d_v != d_k (against ``_xla_sdpa``, the JAX package's ``auto``
path; the Pallas kernel takes its output width from q).  ``route`` names
the kernel each shape goes to on the card, from the shape alone.
"""

import jax
import numpy as np
import pytest
import torch

from lstc_vad_tpu.ops.attention import _xla_sdpa
from lstc_vad_tpu.ops.pallas_attention import pallas_sdpa
from lstc_vad_tpu_torch.ops import cuda_attention
from lstc_vad_tpu_torch.ops.attention import plain_sdpa, sdpa

from f32_tiled_plan import MAX_STAGES, SMEM_LIMIT, f32_plan

RTOL, ATOL = 2e-5, 2e-6
LENGTHS = (10, 17, 19, 28, 49, 81)  # STN 9/16 patches, UCF eval/train, SHT, UBnormal


def _inputs(seed, b, h, length, d, with_bias):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, length, d)).astype(np.float32)
               for _ in range(3))
    bias = (rng.standard_normal((h, length, length)).astype(np.float32)
            if with_bias else None)
    return q, k, v, bias


def _port(q, k, v, bias, temp, fn=plain_sdpa):
    t = torch.from_numpy
    return fn(t(q), t(k), t(v), temp,
              bias=None if bias is None else t(bias)).numpy()


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("length", LENGTHS)
def test_plain_matches_jax_and_pallas(length, with_bias):
    q, k, v, bias = _inputs(length, 3, 2, length, 32, with_bias)
    temp = float(np.sqrt(32))
    ours = _port(q, k, v, bias, temp)
    ref = np.asarray(_xla_sdpa(q, k, v, bias, None, temp, 0.0, None))
    pallas = np.asarray(pallas_sdpa(q, k, v, temp, bias=bias, interpret=True))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, rtol=RTOL, atol=ATOL)


def test_plain_matches_jax_at_model_head_width():
    """D = d_k = 256, the presets' head width, at the SHT LTN length."""
    q, k, v, bias = _inputs(1, 2, 2, 49, 256, True)
    temp = 16.0
    ref = np.asarray(_xla_sdpa(q, k, v, bias, None, temp, 0.0, None))
    np.testing.assert_allclose(_port(q, k, v, bias, temp), ref,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("length", [129, 257])
def test_long_parts_match_jax_and_pallas(length, with_bias):
    """C5: parts past 128 tokens (part_len 8 and 16 at 16 patches, with the
    CLS token) through ``sdpa`` and through the operator, against
    ``_xla_sdpa`` and the Pallas kernel, which packs one pair a block
    there."""
    q, k, v, bias = _inputs(length, 2, 2, length, 32, with_bias)
    temp = float(np.sqrt(32))
    ref = np.asarray(_xla_sdpa(q, k, v, bias, None, temp, 0.0, None))
    pallas = np.asarray(pallas_sdpa(q, k, v, temp, bias=bias, interpret=True))
    t = torch.from_numpy
    tb = None if bias is None else t(bias)
    for ours in (_port(q, k, v, bias, temp, fn=sdpa),
                 cuda_attention.attention(t(q), t(k), t(v), tb, temp)
                 .numpy()):
        np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ours, pallas, rtol=RTOL, atol=ATOL)
    assert cuda_attention.launches == 0


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("d_k,d_v", [(16, 24), (48, 80), (24, 8)])
def test_free_head_widths_match_jax(d_k, d_v, with_bias):
    """C6: d_v != d_k (and widths that are not 32k) through ``sdpa`` and
    through the operator, against ``_xla_sdpa``: the output is
    [B, H, L, d_v], a view of a [B, L, H, d_v] buffer from the operator."""
    rng = np.random.default_rng(d_k * 100 + d_v)
    b, h, length = 3, 2, 49
    q, k = (rng.standard_normal((b, h, length, d_k)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, h, length, d_v)).astype(np.float32)
    bias = (rng.standard_normal((h, length, length)).astype(np.float32)
            if with_bias else None)
    temp = float(np.sqrt(d_k))
    ref = np.asarray(_xla_sdpa(q, k, v, bias, None, temp, 0.0, None))
    assert ref.shape == (b, h, length, d_v)
    t = torch.from_numpy
    out = cuda_attention.attention(t(q), t(k), t(v),
                                   None if bias is None else t(bias), temp)
    assert out.shape == (b, h, length, d_v)
    assert out.transpose(1, 2).is_contiguous()
    for ours in (_port(q, k, v, bias, temp, fn=sdpa), out.numpy()):
        np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_mask_and_probs_match_jax():
    q, k, v, _ = _inputs(2, 2, 2, 9, 16, False)
    mask = np.ones((2, 1, 9, 9), np.float32)
    mask[:, :, :, -2:] = 0
    out, probs = sdpa(*(torch.from_numpy(a) for a in (q, k, v)), 4.0,
                      mask=torch.from_numpy(mask), return_probs=True)
    ref_out, ref_probs = _xla_sdpa(q, k, v, None, mask, 4.0, 0.0, None,
                                   return_probs=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["auto", "plain", "pallas", "xla"])
def test_every_impl_on_cpu_is_the_plain_version(impl):
    q, k, v, bias = _inputs(3, 2, 2, 17, 32, True)
    t = torch.from_numpy
    before = cuda_attention.launches
    out = sdpa(t(q), t(k), t(v), 4.0, bias=t(bias), impl=impl)
    np.testing.assert_array_equal(out.numpy(), _port(q, k, v, bias, 4.0))
    assert cuda_attention.launches == before == 0


@pytest.mark.parametrize("impl", ["cuda", "Auto", "XLA"])
def test_unknown_impl_raises(impl):
    """Near-misses of the accepted values raise, and the message names
    every accepted one (the JAX package's "pallas" and "xla" among them)."""
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="unknown attention impl") as err:
        sdpa(q, q, q, temperature=2.0, impl=impl)
    for name in ("auto", "plain", "pallas", "xla"):
        assert repr(name) in str(err.value)


def test_dropout_changes_output_only_when_active():
    q, k, v, _ = _inputs(4, 2, 2, 9, 16, False)
    t = torch.from_numpy
    det = sdpa(t(q), t(k), t(v), 4.0)
    torch.manual_seed(0)
    dropped = sdpa(t(q), t(k), t(v), 4.0, dropout_p=0.5)
    assert not torch.allclose(det, dropped)


def test_kernel_length_limit():
    """The tiled kernel covers L <= 128 (one tile of 128 rows); past that
    the wrapper's checks still take the shape, at every D, and route it to
    the streaming kernel, whose tiles have no length limit.  The tiled
    kernel's plan refuses L = 129 before it builds anything."""
    for d in (32, 256):
        for length, want in ((128, "f32"), (129, "f32_stream")):
            q = torch.zeros(1, 1, length, d)
            cuda_attention._check(q, q, q, None, 16.0)
            assert cuda_attention.route(q.dtype, length, d, d, True) == want
    with pytest.raises(ValueError, match="L=129"):
        cuda_attention.f32_plan(129, 32)


def _views(kind):
    """(q, k, v) of one routing case: [B, H, L, d] tensors, or the views
    that make it."""
    if kind == "row_stride":  # rows 34 floats apart: not 16-byte aligned
        q = torch.zeros(2, 2, 9, 34)[..., :32]
        return q, q, q
    if kind == "base":
        q = torch.zeros(2 * 2 * 9 * 32 + 1)[1:].view(2, 2, 9, 32)
        return q, q, q
    if kind == "encoder_views":  # [B, L, H, D] buffers seen transposed
        q = torch.zeros(2, 49, 8, 256).transpose(1, 2)
        return q, q, q
    if kind == "bf16_row_stride":  # rows 72 bytes apart
        q = torch.zeros(2, 2, 9, 36, dtype=torch.bfloat16)[..., :32]
        return q, q, q
    length, d_k, d_v, dtype = {
        "d": (9, 24, 24, torch.float32),
        "long": (129, 32, 32, torch.float32),
        "f32_main_shape": (49, 256, 256, torch.float32),
        "f32_shortest": (1, 32, 32, torch.float32),
        "f32_longest": (128, 256, 256, torch.float32),
        "bf16_main_shape": (49, 256, 256, torch.bfloat16),
        "bf16_narrow": (17, 96, 96, torch.bfloat16),
        "bf16_longest": (128, 32, 32, torch.bfloat16),
        "bf16_long": (257, 256, 256, torch.bfloat16),
        "dv_ne_dk": (49, 256, 128, torch.float32),
        "bf16_dv_ne_dk": (49, 16, 24, torch.bfloat16),
        "d_past_256": (49, 288, 288, torch.float32),
        "d_odd": (10, 13, 7, torch.bfloat16),
    }[kind]
    q = torch.zeros(2, 2, length, d_k, dtype=dtype)
    return q, q, torch.zeros(2, 2, length, d_v, dtype=dtype)


ROUTE_CASES = {
    # the shapes the tiled kernels take stay with them
    "f32_main_shape": "f32", "f32_shortest": "f32", "f32_longest": "f32",
    "encoder_views": "f32", "bf16_main_shape": "bf16", "bf16_narrow": "bf16",
    "bf16_longest": "bf16",
    # every other shape streams
    "d": "f32_stream", "row_stride": "f32_stream", "base": "f32_stream",
    "long": "f32_stream", "bf16_long": "bf16_stream",
    "bf16_row_stride": "bf16_stream", "dv_ne_dk": "f32_stream",
    "bf16_dv_ne_dk": "bf16_stream", "d_past_256": "f32_stream",
    "d_odd": "bf16_stream",
}


@pytest.mark.parametrize("kind", sorted(ROUTE_CASES))
def test_route_takes_the_shape(kind):
    """The kernel each shape goes to, from the shape alone; the wrapper's
    checks take every one of them."""
    q, k, v = _views(kind)
    bias = torch.zeros(q.shape[1], q.shape[2], q.shape[2])
    cuda_attention._check(q, k, v, bias, 4.0)
    aligned = all(cuda_attention._aligned(t) for t in (q, k, v))
    got = cuda_attention.route(q.dtype, q.shape[2], q.shape[3], v.shape[3],
                               aligned)
    assert got == ROUTE_CASES[kind]
    assert got in cuda_attention.ROUTES


def test_route_refuses_other_types():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_attention.route(torch.float16, 49, 256, 256, True)


# (L, D) -> (shared bytes, threads, tile rows, heads a tile, rows a head,
# keys, rings, stages a ring) of the tiled f32 kernel
# (tests/f32_tiled_plan.py), at every L the old tile table held, the model
# shapes and both sides of each tile edge
PLANS_F32 = {
    (1, 32): (221328, 512, 64, 4, 16, 64, 3, 3),
    (10, 256): (221328, 512, 64, 4, 16, 64, 3, 3),
    (16, 96): (221328, 512, 64, 4, 16, 64, 3, 3),
    (17, 256): (221328, 512, 64, 2, 32, 64, 3, 3),
    (19, 96): (221328, 512, 64, 2, 32, 64, 3, 3),
    (28, 32): (221328, 512, 64, 2, 32, 64, 3, 3),
    (32, 256): (221328, 512, 64, 2, 32, 64, 3, 3),
    (33, 96): (221328, 512, 64, 1, 64, 40, 3, 3),
    (49, 256): (221328, 512, 64, 1, 64, 56, 3, 3),
    (57, 96): (221328, 512, 64, 1, 64, 64, 3, 3),
    (64, 32): (221328, 512, 64, 1, 64, 64, 3, 3),
    (65, 256): (229440, 384, 128, 1, 128, 72, 1, 4),
    (81, 96): (229440, 384, 128, 1, 128, 88, 1, 4),
    (128, 32): (229440, 384, 128, 1, 128, 128, 1, 4),
    (128, 256): (229440, 384, 128, 1, 128, 128, 1, 4),
}


@pytest.mark.parametrize("length,d", sorted(PLANS_F32))
def test_f32_plan_table(length, d):
    """The written-out geometry at the model shapes and tile edges."""
    assert tuple(f32_plan(length, d).values()) == PLANS_F32[length, d]


@pytest.mark.parametrize("d", [32, 96, 256])
@pytest.mark.parametrize("length", [1, 16, 17, 32, 33, 64, 65, 128])
def test_f32_plan_fits_a_block(length, d):
    """At every tile edge and a D of one, three and eight chunks: the tile
    holds L rows of each of its heads and the products L keys of one head,
    128 rows are in flight a block, its shared memory fits 227 KB, and one
    more stage a ring would not, or the rings are at their 4."""
    assert cuda_attention.route(torch.float32, length, d, d, True) == "f32"
    p = f32_plan(length, d)
    assert p["head_rows"] >= length and p["heads"] * p["head_rows"] in (
        64, 128)
    assert p["rows"] == max(64, p["head_rows"])
    assert length <= p["keys"] <= p["rows"] and p["keys"] % 8 == 0
    assert p["keys"] < length + 8 or p["heads"] > 1
    assert p["rings"] * p["rows"] == (192 if p["rows"] == 64 else 128)
    assert 2 <= p["stages"] <= MAX_STAGES
    assert p["smem_bytes"] <= SMEM_LIMIT
    stage = 2 * p["rows"] * 128 + 16
    assert p["stages"] == MAX_STAGES or \
        p["smem_bytes"] + p["rings"] * stage > SMEM_LIMIT


def test_f32_plan_refuses_other_shapes():
    for length, d in ((0, 64), (129, 64), (49, 16), (49, 288), (49, 48)):
        with pytest.raises(ValueError):
            f32_plan(length, d)


def test_kernel_checks_take_the_encoders_strided_views():
    """The encoder passes [B, H, L, D] views of [B, L, H, D] projections;
    the kernel's checks take them as they are, and the CPU path gives the
    same values as on contiguous copies."""
    rng = np.random.default_rng(5)
    bufs = [torch.from_numpy(rng.standard_normal((3, 17, 2, 32),
                                                 dtype=np.float32))
            for _ in range(3)]
    q, k, v = (x.transpose(1, 2) for x in bufs)
    assert not q.is_contiguous() and q.stride() == (17 * 64, 32, 64, 1)
    bias = torch.from_numpy(rng.standard_normal((2, 17, 17),
                                                dtype=np.float32))
    cuda_attention._check(q, k, v, bias, 4.0)
    out = cuda_attention.attention(q, k, v, bias, 4.0)
    ref = plain_sdpa(*(x.contiguous() for x in (q, k, v)), 4.0, bias=bias)
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", ["dtype", "bias", "contiguous",
                                 "temperature", "k_shape", "v_shape",
                                 "bias_dtype"])
def test_kernel_checks_reject_what_the_kernel_does_not_take(bad):
    q = torch.zeros(2, 2, 9, 32)
    k, v = q, q
    bias = torch.zeros(2, 9, 9)
    temperature = 4.0
    if bad == "dtype":
        q = k = v = q.double()
    elif bad == "bias":
        bias = torch.zeros(1, 9, 9)
    elif bad == "contiguous":  # a non-unit innermost stride
        q = torch.zeros(2, 2, 32, 9).transpose(-1, -2)
    elif bad == "temperature":
        temperature = 0.0
    elif bad == "k_shape":  # k must be q's shape
        k = torch.zeros(2, 2, 9, 24)
    elif bad == "v_shape":  # v needs q's B, H and L
        v = torch.zeros(2, 2, 8, 32)
    else:
        bias = bias.double()
    with pytest.raises((TypeError, ValueError)):
        cuda_attention._check(q, k, v, bias, temperature)


GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("length", [10, 17, 49])
def test_kernel_function_gradients_match_plain_and_jax(length, with_bias):
    """The kernel's autograd Function (its CPU path) against autograd
    through plain_sdpa and against jax.grad of the Pallas kernel in
    interpret mode (its custom VJP), with q, k, v as the encoder's strided
    views and a bias that requires grad."""
    rng = np.random.default_rng(length)
    b, h, d = 3, 2, 32
    bufs = [rng.standard_normal((b, length, h, d)).astype(np.float32)
            for _ in range(3)]
    bias = (rng.standard_normal((h, length, length)).astype(np.float32)
            if with_bias else None)
    w = rng.standard_normal((b, h, length, d)).astype(np.float32)
    temp = float(np.sqrt(d))

    def grads(fn):
        leaves = [torch.from_numpy(x).requires_grad_() for x in bufs]
        q, k, v = (x.transpose(1, 2) for x in leaves)
        tb = torch.from_numpy(bias).requires_grad_() if with_bias else None
        out = fn(q, k, v, tb, temp)
        assert out.grad_fn is not None
        wrt = leaves + ([tb] if with_bias else [])
        return torch.autograd.grad((out * torch.from_numpy(w)).sum(), wrt)

    ours = grads(cuda_attention.attention)
    plain = grads(lambda q, k, v, tb, t: plain_sdpa(q, k, v, t, bias=tb))

    def jax_objective(q, k, v, *bias_arg):
        out = pallas_sdpa(q, k, v, temp, bias=bias_arg[0] if bias_arg
                          else None, interpret=True)
        return (out * w).sum()

    heads = [x.transpose(0, 2, 1, 3) for x in bufs]
    args = heads + ([bias] if with_bias else [])
    ref = jax.grad(jax_objective, argnums=tuple(range(len(args))))(*args)
    ref = [np.asarray(g).transpose(0, 2, 1, 3) for g in ref[:3]] + [
        np.asarray(g) for g in ref[3:]]
    assert len(ours) == len(plain) == len(ref)
    for a, p, r in zip(ours, plain, ref):
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        np.testing.assert_allclose(a.numpy(), r, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("length,d_k,d_v", [(129, 32, 32), (17, 16, 24)])
def test_kernel_function_gradients_at_long_parts_and_free_heads(length, d_k,
                                                                d_v):
    """The operator's autograd at L = 129 and at d_v != d_k against plain
    autograd and jax.grad of ``_xla_sdpa`` (the JAX package's ``auto``
    path, which takes both)."""
    rng = np.random.default_rng(length + d_v)
    b, h = 2, 2
    bufs = [rng.standard_normal((b, length, h, d)).astype(np.float32)
            for d in (d_k, d_k, d_v)]
    bias = rng.standard_normal((h, length, length)).astype(np.float32)
    w = rng.standard_normal((b, h, length, d_v)).astype(np.float32)
    temp = float(np.sqrt(d_k))

    def grads(fn):
        leaves = [torch.from_numpy(x).requires_grad_() for x in bufs]
        tb = torch.from_numpy(bias).requires_grad_()
        out = fn(*(x.transpose(1, 2) for x in leaves), tb, temp)
        return torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                   leaves + [tb])

    ours = grads(cuda_attention.attention)
    plain = grads(lambda q, k, v, tb, t: plain_sdpa(q, k, v, t, bias=tb))

    def jax_objective(q, k, v, bias_arg):
        return (_xla_sdpa(q, k, v, bias_arg, None, temp, 0.0, None)
                * w).sum()

    heads = [x.transpose(0, 2, 1, 3) for x in bufs]
    ref = jax.grad(jax_objective, argnums=(0, 1, 2, 3))(*heads, bias)
    ref = [np.asarray(g).transpose(0, 2, 1, 3) for g in ref[:3]] + [
        np.asarray(ref[3])]
    for a, p, r in zip(ours, plain, ref):
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        np.testing.assert_allclose(a.numpy(), r, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_kernel_function_is_forward_only_under_inference_mode():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(6, 2, 2, 17, 32,
                                                          True))
    q.requires_grad_()
    with torch.inference_mode():
        out = sdpa(q, k, v, 4.0, bias=bias)
    assert out.grad_fn is None and not out.requires_grad
    out = sdpa(q, k, v, 4.0, bias=bias)
    assert out.grad_fn is not None
    assert cuda_attention.launches == 0
