"""The streaming kernels' order of operations, rehearsed on the CPU.

csrc/attention_stream.cu (f32) computes attention in one pass over key
tiles of 32 with an online softmax: each row keeps a running max m and sum
l, O and l are scaled by exp(m_old - m_new) when a tile raises the max, and
O is divided by l once at the end (``one_pass``).  Its products are 3xTF32
on the tensor cores: each operand split x = big + small, big rounded to
TF32 to nearest (ties away), small = x - big read by the tensor core as
TF32, small·big + big·small + big·big summed in f32 (``tf32_pass``, with
small read rounded and truncated, the two readings the hardware may
take).  csrc/attention_stream
_bf16.cu (bf16, key tiles of 64) takes the same statistics in a first
phase, Q·K^T alone, and in a second forms P = exp(s - m) / l as plain_sdpa
does, rounds it to bf16 and sums P·V (``two_phase``); with one key tile the
two phases are one; its softmax arithmetic takes e^(s - m) as
2^(fma(s, log2 e, -m·log2 e)) on the special-function unit and multiplies
by one reciprocal of l a row (``two_phase_exp2``, the error of ex2.approx
drawn into each 2^x).  The one-pass order on bf16 (exp(s - m) rounded
unnormalised, O / l at the end) is rehearsed too: it is closer to float64
than plain_sdpa on average, but it rounds other values than plain_sdpa and
on the card came out past the x1.05 bar at one shape, which is why the
kernel takes two phases.  Each order is held to the bars the card tests
hold the kernels to (tests/test_torch_cuda_kernel.py):

- f32: rtol 1e-4 / atol 1e-5 against plain_sdpa;
- bf16: rtol 1e-2 + atol 2^-7·max|v| against plain_sdpa on the same bf16
  inputs, and no farther from attention in float64 than plain_sdpa x1.05.

No card and no JAX: this is the one place the CPU can check the kernels'
order of operations.
"""

import numpy as np
import pytest
import torch

from lstc_vad_tpu_torch.ops.attention import plain_sdpa, scalar_in

F32_KEYS, BF16_KEYS = 32, 64  # each kernel's key tile
RTOL, ATOL = 1e-4, 1e-5
BF16_RTOL, BF16_V_ULP, BF16_F64_SLACK = 1e-2, 2 ** -7, 1.05


def _bf16(x):
    return x.to(torch.bfloat16).float()


def one_pass(q, k, v, bias, temperature, keys):
    """Attention in the kernels' order: q·(1/temperature) (rounded to bf16
    on bf16 inputs), key tiles of ``keys``, a running max and sum, O
    rescaled, exp(s - m) rounded to bf16 before P·V on bf16 inputs, O / l
    at the end (rounded to bf16 on bf16 inputs).  Returns f32."""
    low = q.dtype == torch.bfloat16
    inv = torch.tensor(1.0, dtype=torch.float32) / scalar_in(temperature,
                                                             q.dtype)
    qs = q.float() * inv
    if low:
        qs = _bf16(qs)
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias
    length = s.shape[-1]
    m = torch.full((*s.shape[:-1], 1), -np.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(*s.shape[:-1], v.shape[-1])
    for key0 in range(0, length, keys):
        tile = s[..., key0:key0 + keys]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        base = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(tile - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = _bf16(p) if low else p
        o = o * alpha + torch.matmul(pv, v[..., key0:key0 + keys, :].float())
        m = m_new
    out = o / l
    return _bf16(out) if low else out


def tf32(x, mode="rna"):
    """f32 ``x`` rounded to TF32 (10 mantissa bits) by bit manipulation: to
    nearest with ties away from zero (``rna``, cvt.rna.tf32.f32) or
    truncated (``trunc``), the low 13 bits of the word cleared."""
    bits = x.contiguous().numpy().view(np.uint32)
    if mode == "rna":
        bits = bits + np.uint32(0x1000)
    return torch.from_numpy((bits & np.uint32(0xffffe000)).view(np.float32))


def mm3(a, b, small_read):
    """a·b in 3xTF32: big = a rounded to TF32, small = a - big (exact in
    f32) read as TF32 by ``small_read``; small·big + big·small + big·big,
    each product exact and summed in f32."""
    a_big, b_big = tf32(a), tf32(b)
    a_small = tf32(a - a_big, small_read)
    b_small = tf32(b - b_big, small_read)
    return (torch.matmul(a_small, b_big) + torch.matmul(a_big, b_small)
            + torch.matmul(a_big, b_big))


def tf32_pass(q, k, v, bias, temperature, small_read, keys=F32_KEYS):
    """The f32 kernel's order: q·(1/temperature) in f32, S = Q·K^T in
    3xTF32, + bias, key tiles of ``keys`` with a running max and sum, P =
    exp(s - m) split as the operands are and O += P·V in 3xTF32, O
    rescaled when the max grows, O / l at the end."""
    inv = torch.tensor(1.0, dtype=torch.float32) / scalar_in(temperature,
                                                             q.dtype)
    s = mm3(q * inv, k.transpose(-1, -2), small_read)
    if bias is not None:
        s = s + bias
    length = s.shape[-1]
    m = torch.full((*s.shape[:-1], 1), -np.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(*s.shape[:-1], v.shape[-1])
    for key0 in range(0, length, keys):
        tile = s[..., key0:key0 + keys]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        base = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(tile - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm3(p, v[..., key0:key0 + keys, :], small_read)
        m = m_new
    return o / l


def two_phase(q, k, v, bias, temperature, keys=BF16_KEYS):
    """The bf16 kernel's order: q·(1/temperature) rounded to bf16, each
    row's running max and sum over key tiles of ``keys`` (phase 0), then P
    = exp(s - m) / l rounded to bf16 and P·V summed over the tiles (phase
    1), the output rounded to bf16.  Returns f32."""
    inv = torch.tensor(1.0, dtype=torch.float32) / scalar_in(temperature,
                                                             q.dtype)
    s = torch.matmul(_bf16(q.float() * inv), k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias
    length = s.shape[-1]
    m = torch.full((*s.shape[:-1], 1), -np.inf)
    l = torch.zeros_like(m)
    for key0 in range(0, length, keys):
        tile = s[..., key0:key0 + keys]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        base = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        l = l * torch.exp(m - base) + torch.exp(tile - base).sum(
            -1, keepdim=True)
        m = m_new
    base = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    o = torch.zeros(*s.shape[:-1], v.shape[-1])
    for key0 in range(0, length, keys):
        p = torch.exp(s[..., key0:key0 + keys] - base) / l
        o = o + torch.matmul(_bf16(p), v[..., key0:key0 + keys, :].float())
    return _bf16(o)


LOG2E = 1.4426950408889634
# ex2.approx.ftz.f32's relative error is near 2^-22 (PTX ISA); the rehearsal
# multiplies each 2^x by (1 + u·2^-21), u uniform in [-1, 1], twice that
EX2_REL = 2.0 ** -21


def _fma(a, b, c):
    """a·b + c rounded to f32 once (the product of two f32 values is exact
    in float64)."""
    return (a.double() * b + c.double()).float()


def _ex2(x, gen):
    """2^x in f32 as ex2.approx.ftz gives it: within EX2_REL of the exact
    value (a seeded draw of the error), results below 2^-126 flushed to
    zero."""
    u = torch.rand(x.shape, generator=gen, dtype=torch.float64) * 2 - 1
    y = (torch.exp2(x.double()) * (1 + EX2_REL * u)).float()
    return torch.where(y < 2.0 ** -126, torch.zeros_like(y), y)


def two_phase_exp2(q, k, v, bias, temperature, keys=BF16_KEYS, seed=0):
    """The bf16 kernel's two-phase order with its softmax arithmetic:
    e^(s - m) as 2^(fma(s, log2 e, -bl)), bl = m·log2 e rounded to f32, on
    the special-function unit (_ex2); P = that times one reciprocal of l a
    row, 1/l rounded to f32, where two_phase takes expf and a division.
    Returns f32."""
    gen = torch.Generator().manual_seed(seed)
    l2e = torch.tensor(LOG2E, dtype=torch.float32)
    inv = torch.tensor(1.0, dtype=torch.float32) / scalar_in(temperature,
                                                             q.dtype)
    s = torch.matmul(_bf16(q.float() * inv), k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias
    length = s.shape[-1]
    m = torch.full((*s.shape[:-1], 1), -np.inf)
    l = torch.zeros_like(m)
    for key0 in range(0, length, keys):
        tile = s[..., key0:key0 + keys]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        base = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        bl = base * l2e
        l = l * _ex2(_fma(m, LOG2E, -bl), gen) + _ex2(
            _fma(tile, LOG2E, -bl), gen).sum(-1, keepdim=True)
        m = m_new
    base = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    bl = base * l2e
    rl = torch.tensor(1.0, dtype=torch.float32) / l
    o = torch.zeros(*s.shape[:-1], v.shape[-1])
    for key0 in range(0, length, keys):
        p = _ex2(_fma(s[..., key0:key0 + keys], LOG2E, -bl), gen) * rl
        o = o + torch.matmul(_bf16(p), v[..., key0:key0 + keys, :].float())
    return _bf16(o)


def _exact(q, k, v, bias, temperature):
    s = torch.matmul((q / scalar_in(temperature, q.dtype)).double(),
                     k.double().transpose(-1, -2))
    if bias is not None:
        s = s + bias.double()
    return torch.matmul(torch.softmax(s, dim=-1), v.double())


def _inputs(seed, b, h, length, d_k, d_v, dtype, growing=0):
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.standard_normal(
        (b, h, length, d_k)).astype(np.float32)).to(dtype) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal(
        (b, h, length, d_v)).astype(np.float32)).to(dtype)
    bias = torch.from_numpy(rng.standard_normal(
        (h, length, length)).astype(np.float32))
    if growing:
        # scores of spread ~0.35 and a step of 3 at each tile of
        # ``growing`` keys: every tile's least score tops the tile before
        q, k = (0.5 * q.float()).to(dtype), (0.5 * k.float()).to(dtype)
        bias = 0.25 * bias + 3.0 * (torch.arange(length) // growing)
    return q, k, v, bias


def _check_f32(q, k, v, bias, temperature):
    got = one_pass(q, k, v, bias, temperature, F32_KEYS)
    ref = plain_sdpa(q, k, v, temperature, bias=bias)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)


def _check_bf16(q, k, v, bias, temperature, order=two_phase):
    got = order(q, k, v, bias, temperature, BF16_KEYS)
    ref = plain_sdpa(q, k, v, temperature, bias=bias).float()
    atol = BF16_V_ULP * v.float().abs().max().item()
    err = (got - ref).abs()
    assert (err <= BF16_RTOL * ref.abs() + atol).all(), err.max().item()
    exact = _exact(q, k, v, bias, temperature)
    one_err = (got.double() - exact).abs().max().item()
    plain_err = (ref.double() - exact).abs().max().item()
    assert one_err <= BF16_F64_SLACK * plain_err + 1e-6, (one_err, plain_err)
    return one_err / plain_err if plain_err > 0 else 0.0


LENGTHS = (1, 2, 31, 33, 63, 64, 65, 129, 257, 1024)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("length", LENGTHS)
def test_f32_one_pass_meets_the_f32_bar(length, seed):
    b, h = (1, 2) if length >= 257 else (2, 3)
    q, k, v, bias = _inputs(seed, b, h, length, 32, 48, torch.float32)
    _check_f32(q, k, v, bias, float(np.sqrt(32)))


@pytest.mark.parametrize("small_read", ["rna", "trunc"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("length", LENGTHS)
def test_f32_tf32_order_meets_the_f32_bar(length, seed, small_read):
    """The f32 kernel's 3xTF32 products (S and P·V, P split as the operands
    are) in its one-pass order, whether the tensor core rounds or truncates
    the small half it reads as TF32."""
    b, h = (1, 2) if length >= 257 else (2, 3)
    q, k, v, bias = _inputs(seed, b, h, length, 32, 48, torch.float32)
    temp = float(np.sqrt(32))
    got = tf32_pass(q, k, v, bias, temp, small_read)
    ref = plain_sdpa(q, k, v, temp, bias=bias)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("small_read", ["rna", "trunc"])
@pytest.mark.parametrize("seed", [0, 1])
def test_f32_tf32_order_at_config_b_widths(seed, small_read):
    """The same at d_k 512, d_v 384 (config B), L = 129: five key tiles,
    the widest sums the kernel's route takes at the presets."""
    q, k, v, bias = _inputs(10 + seed, 1, 2, 129, 512, 384, torch.float32)
    temp = float(np.sqrt(512))
    got = tf32_pass(q, k, v, bias, temp, small_read)
    ref = plain_sdpa(q, k, v, temp, bias=bias)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_tf32_split_is_exact_and_rounds_to_nearest():
    """big is x rounded to 10 mantissa bits, ties away from zero (1 + 2^-11
    rounds up to 1 + 2^-10), and big + small gives x back exactly; the
    truncated reading only clears bits."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0e-5, 0.0], dtype=torch.float32)
    big = tf32(x)
    assert big.tolist()[:3] == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    assert torch.equal(big + (x - big), x)
    assert (tf32(x, "trunc").abs() <= x.abs()).all()
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    small = y - tf32(y)
    assert torch.equal(tf32(y) + small, y)
    assert (small.abs() <= 2.0 ** -11 * y.abs()).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("length", LENGTHS)
def test_bf16_kernel_order_meets_the_bf16_bars(length, seed):
    """The two-phase order rounds the probabilities plain_sdpa rounds: within
    plain_sdpa's own distance from float64 (x1.05) at every tile count."""
    b, h = (1, 2) if length >= 257 else (2, 3)
    q, k, v, bias = _inputs(seed, b, h, length, 48, 24, torch.bfloat16)
    _check_bf16(q, k, v, bias, float(np.sqrt(48)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("length", LENGTHS)
def test_bf16_exp2_order_meets_the_bf16_bars(length, seed):
    """The kernel's softmax arithmetic (2^x on the special-function unit
    with log2 e folded into an fma, one reciprocal of l a row) in the
    two-phase order: within the same bars as two_phase at every tile
    count.  Splitting O's columns over two warpgroups (config B's widths)
    changes no sum: each output column is the same P times the same V
    column."""
    b, h = (1, 2) if length >= 257 else (2, 3)
    q, k, v, bias = _inputs(seed, b, h, length, 48, 24, torch.bfloat16)
    _check_bf16(q, k, v, bias, float(np.sqrt(48)), order=two_phase_exp2)


@pytest.mark.parametrize("length", [49, 129])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_exp2_order_at_config_b_widths(seed, length):
    """The same at d_k 512, d_v 384 (config B): one key tile at L = 49,
    three at 129."""
    q, k, v, bias = _inputs(10 + seed, 1, 2, length, 512, 384,
                            torch.bfloat16)
    _check_bf16(q, k, v, bias, float(np.sqrt(512)), order=two_phase_exp2)


@pytest.mark.parametrize("length", [65, 257, 1024])
def test_bf16_exp2_order_late_growing_max(length):
    """A bias rising by 3 at each key tile: the running max grows at every
    tile of the statistics phase, and the bars still hold."""
    q, k, v, bias = _inputs(20 + length, 1, 2, length, 32, 40,
                            torch.bfloat16, growing=BF16_KEYS)
    _check_bf16(q, k, v, bias, float(np.sqrt(32)), order=two_phase_exp2)


def test_bf16_exp2_order_against_plain_over_seeds():
    """Over the seeds of test_bf16_orders_against_plain_on_average: the
    kernel's arithmetic stays within 1% of plain_sdpa's distance from
    float64 at every seed (two_phase: 0.1%), well inside the 1.05 bar."""
    ratios = []
    for seed in range(8):
        q, k, v, bias = _inputs(100 + seed, 2, 2, 129, 64, 64,
                                torch.bfloat16)
        ratios.append(_check_bf16(q, k, v, bias, 8.0,
                                  order=lambda *a: two_phase_exp2(
                                      *a, seed=seed)))
    assert max(abs(r - 1.0) for r in ratios) < 1e-2, ratios


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_config_b_widths(dtype, seed):
    """d_k 512, d_v 384 (config B) at L = 129: three bf16 key tiles, five
    f32 ones."""
    dt = getattr(torch, dtype)
    q, k, v, bias = _inputs(10 + seed, 1, 2, 129, 512, 384, dt)
    temp = float(np.sqrt(512))
    if dt == torch.float32:
        _check_f32(q, k, v, bias, temp)
    else:
        _check_bf16(q, k, v, bias, temp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [65, 257, 1024])
def test_late_growing_max_rescales_every_tile(length, dtype):
    """A bias that rises by 3 at each key tile puts each row's largest
    scores in its last tile: the running max grows at every key tile
    (checked), so O is rescaled each time, and the bars still hold."""
    dt = getattr(torch, dtype)
    keys = F32_KEYS if dt == torch.float32 else BF16_KEYS
    q, k, v, bias = _inputs(20 + length, 1, 2, length, 32, 40, dt,
                            growing=keys)
    temp = float(np.sqrt(32))
    s = torch.matmul(q.float() / temp, k.float().transpose(-1, -2)) + bias
    maxima = torch.stack([s[..., j:j + keys].amax(-1)
                          for j in range(0, length, keys)], dim=-1)
    assert (maxima[..., 1:] > maxima[..., :-1].cummax(-1).values).all()
    if dt == torch.float32:
        _check_f32(q, k, v, bias, temp)
    else:
        _check_bf16(q, k, v, bias, temp)


@pytest.mark.parametrize("order", ["one_pass", "two_phase"])
def test_bf16_orders_against_plain_on_average(order):
    """Over seeds: the one-pass order (exp(s - m) rounded unnormalised) is
    closer to float64 than plain_sdpa on average (its mean ratio below 1)
    but rounds other values, so its ratio moves from seed to seed; the
    two-phase order, the kernel's, rounds plain_sdpa's own probabilities
    and stays within 1e-3 of plain_sdpa's distance at every seed."""
    ratios = []
    for seed in range(8):
        q, k, v, bias = _inputs(100 + seed, 2, 2, 129, 64, 64,
                                torch.bfloat16)
        ratios.append(_check_bf16(q, k, v, bias, 8.0,
                                  order=globals()[order]))
    if order == "one_pass":
        assert np.mean(ratios) < 1.0, ratios
    else:
        assert max(abs(r - 1.0) for r in ratios) < 1e-3, ratios
