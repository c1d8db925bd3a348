"""The f32 GEMM kernel (csrc/gemm.cu) behind ``lstc_vad::linear``, on the
card.

These tests need an NVIDIA card with nvcc; without one they skip.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_linear.py

The kernel computes each product in 3xTF32 on the tensor cores and sums
32-deep stages in IEEE f32; cuBLAS's FP32 kernels (TF32 off) sum one
product at a time.  Both are held to the same product in float64: the
kernel's largest error may be at most ERR_RATIO times cuBLAS's own at the
cells' depths (K >= 1024, where it reads 0.14-0.31 of it, PERF.md §6), and
SHALLOW_ERR_RATIO below that (2.1 times at K = 64: with few stages the
tensor core's truncation within a stage is most of its error).  The bar
holds at the encoder's output widths (N of 1024 and more): at N = 64
cuBLAS runs another kernel whose error is 5-10 times smaller, and the
kernel's, the same as at N = 2048, reads 1.0-2.3 times it at K = 3026-3072.
The weight gradient sums over M, the rows, and is held to the same bar at
depths of 1,001 rows and more; at M = 1 each element is one product, whose
3xTF32 error no sum outweighs, so it is held to the split's own product
error (WGRAD_PRODUCT_ERR).
"""

import pytest
import torch
import torch.nn.functional as F

from lstc_vad_tpu_torch.ops import cuda_linear

pytestmark = pytest.mark.cuda

ERR_RATIO, SHALLOW_ERR_RATIO, SHALLOW_K = 1.0, 3.0, 256

# (M, N, K, bias): the cells' Linears at their eval chunks (sht_ltn: 2,048
# and 1,055 parts of 49 tokens; ubnormal_ltn: 1,258 parts of 81), ragged M,
# 64-column tiles (small M), ragged N and K; the STN presets' d_inner 3027
# into w_1 and out of w_2 (rows not whole 16 bytes: K padded into the row
# stride, C stored from registers), and widths of 1-3 past a multiple of 4
FORWARD = [
    (2048 * 49, 2048, 2048, False), (2048 * 49, 4096, 2048, True),
    (2048 * 49, 2048, 4096, True), (1055 * 49, 2048, 2048, True),
    (1055 * 49, 4096, 2048, False), (1258 * 81, 2048, 1024, False),
    (1258 * 81, 1024, 2048, True), (1258 * 81, 4096, 1024, True),
    (1258 * 81, 1024, 4096, False), (1000, 200, 100, True),
    (17, 2048, 2048, True), (130, 132, 68, False), (1, 4, 4, True),
    (64 * 112, 3027, 2048, True), (64 * 112, 2048, 3027, True),
    (1000, 131, 67, True), (130, 1, 255, False), (257, 2, 131, True)]
# (M, N, K): the input gradient dY [M, N] · W [N, K] at a train step's
# 1,280 parts of 49 tokens, at the eval shapes' widths, and ragged
DGRAD = [(1280 * 49, 2048, 2048), (1280 * 49, 4096, 2048),
         (1280 * 49, 2048, 4096), (1258 * 81, 1024, 4096),
         (777, 132, 68), (64 * 112, 3027, 2048), (64 * 112, 2048, 3027),
         (300, 131, 67)]
# (M, N, K): the weight gradient dYᵀ [N, M] · X [M, K] at a train step's
# 1,280 parts of 49 tokens, at the STN's widths (d_inner 3027 out of w_1,
# dY's rows padded, and into w_2, X's rows padded), at UBnormal's 2048 x
# 1024 (M = 1,258 parts of 81 tokens, ragged: 128 tiles of 128 x 128, fewer
# than the SMs, so 128 x 64 ones), and a ragged M of 1,001 rows
WGRAD = [(1280 * 49, 2048, 2048), (1280 * 49, 4096, 2048),
         (1280 * 49, 2048, 4096), (640 * 112, 3027, 2048),
         (640 * 112, 2048, 3027), (1258 * 81, 2048, 1024),
         (1001, 2048, 2048)]
# a product's own error in the weight gradient's 3xTF32 (each operand's
# big half rounded to TF32, its small half the exact rest, which the tensor
# core truncates): under 2^-19 of |dY|·|x|, doubled here for the tensor
# core's own sum of the three products; at a depth of one row that error is
# the whole error, against cuBLAS's one rounding (2^-24), so M = 1 is held
# to it
WGRAD_PRODUCT_ERR = 2.0 ** -18


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(card, m, n, k, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=card)
    w = torch.randn(n, k, generator=g, device=card) / k ** 0.5
    b = torch.randn(n, generator=g, device=card)
    return x, w, b


def _hold_to_float64(got, library, want, depth):
    """The kernel's and cuBLAS's largest errors against float64."""
    err = float((got.double() - want).abs().max())
    lib_err = float((library.double() - want).abs().max())
    ratio = ERR_RATIO if depth >= SHALLOW_K else SHALLOW_ERR_RATIO
    assert err <= ratio * lib_err, (err, lib_err)


@pytest.mark.parametrize("m,n,k,with_bias", FORWARD)
def test_forward_against_float64(card, m, n, k, with_bias):
    x, w, b = _operands(card, m, n, k, m + n + k)
    b = b if with_bias else None
    before = cuda_linear.launches
    with torch.no_grad():
        got = cuda_linear.linear(x, w, b)
        again = cuda_linear.linear(x, w, b)
        assert cuda_linear.launches == before + 2
        want = x.double() @ w.double().t()
        if b is not None:
            want += b.double()
        _hold_to_float64(got, F.linear(x, w, b), want, k)
    assert torch.equal(got, again)  # a fixed order of sums


@pytest.mark.parametrize("m,n,k", DGRAD)
def test_input_gradient_against_float64(card, m, n, k):
    """dY·W through the weight's transposed halves, directly and as the
    operator's autograd computes the input gradient."""
    _, w, _ = _operands(card, 1, n, k, 3 * m + n)
    g = torch.randn(m, n, device=card)
    with pytest.raises(ValueError):
        cuda_linear.gemm(g[:, :-4], w, None, transpose=True)
    with torch.no_grad():
        got = cuda_linear.gemm(g, w, None, transpose=True)
        again = cuda_linear.gemm(g, w, None, transpose=True)
        want = g.double() @ w.double()
        _hold_to_float64(got, g @ w, want, n)
    assert torch.equal(got, again)
    x = torch.zeros(m, k, device=card, requires_grad=True)
    before = cuda_linear.launches_dgrad
    cuda_linear.linear(x, w).backward(g)
    assert cuda_linear.launches_dgrad == before + 1
    assert torch.equal(x.grad, got)


def _weight_gradient(card, m, n, k):
    """dYᵀ·X through the operator, twice (bit-equal: a fixed order of sums,
    one launch a call), and as the operator's autograd computes the
    weight's gradient (the same bits); returns dY, x and the product."""
    g = torch.randn(m, n, device=card)
    x = torch.randn(m, k, device=card)
    with pytest.raises(ValueError):
        cuda_linear.gemm_wgrad(g[:-1] if m > 1 else g[:0], x)
    before = cuda_linear.launches_wgrad
    with torch.no_grad():
        got = torch.ops.lstc_vad.linear_weight_grad(g, x)
        again = torch.ops.lstc_vad.linear_weight_grad(g, x)
    assert cuda_linear.launches_wgrad == before + 2
    assert got.shape == (n, k) and got.is_contiguous()
    assert torch.equal(got, again)
    w = torch.zeros(n, k, device=card, requires_grad=True)
    before = cuda_linear.launches_wgrad
    cuda_linear.linear(x, w).backward(g)
    assert cuda_linear.launches_wgrad == before + 1
    assert torch.equal(w.grad, got)
    return g, x, got


@pytest.mark.parametrize("m,n,k", WGRAD)
def test_weight_gradient_against_float64(card, m, n, k):
    """dYᵀ·X through the kernel's weight-gradient entry near float64: at
    most cuBLAS's own error at these depths (M of 1,001 and more)."""
    g, x, got = _weight_gradient(card, m, n, k)
    with torch.no_grad():
        want = g.double().t() @ x.double()
        _hold_to_float64(got, torch.matmul(g.t(), x), want, m)


def test_weight_gradient_of_one_row(card):
    """M = 1: dW is the outer product dYᵀ·x, each element one product, so
    its error is the split's alone (WGRAD_PRODUCT_ERR of |dY|·|x|)."""
    g, x, got = _weight_gradient(card, 1, 2048, 2048)
    want = g.double().t() @ x.double()
    err = (got.double() - want).abs()
    assert bool((err <= WGRAD_PRODUCT_ERR * want.abs()).all()), \
        float((err / want.abs().clamp_min(1e-300)).max())


def test_operator_gradients_against_float64(card):
    """x, weight and bias gradients of a 3-D input through the operator:
    the input and the weight gradients from the kernel, the bias's a sum;
    each near the float64 gradient."""
    x, w, b = _operands(card, 2 * 1500, 256, 512, 11)
    x = x.view(2, 1500, 512).requires_grad_()
    w.requires_grad_()
    b.requires_grad_()
    gy = torch.randn(2, 1500, 256, device=card)
    cuda_linear.linear(x, w, b).backward(gy)
    x64, w64, b64 = (t.detach().double().requires_grad_() for t in (x, w, b))
    F.linear(x64, w64, b64).backward(gy.double())
    for got, want in ((x.grad, x64.grad), (w.grad, w64.grad),
                      (b.grad, b64.grad)):
        scale = float(want.abs().max())
        assert float((got.double() - want).abs().max()) <= 1e-5 * scale


def test_ragged_widths_and_refusals(card):
    """Widths off the 16-byte grid take the kernel too: N = 3027 (stored
    from registers), then K = 3026 from an offset view whose rows are 3027
    apart (copied into a padded row stride); other types raise; the kernel
    takes a strided input and writes a fresh contiguous output."""
    x, w, b = _operands(card, 4096, 3027, 2048, 5)
    before = cuda_linear.launches
    with torch.no_grad():
        y = cuda_linear.linear(x, w, b)
        assert cuda_linear.launches == before + 1
        assert y.shape == (4096, 3027) and y.is_contiguous()
        want = x.double() @ w.double().t() + b.double()
        _hold_to_float64(y, F.linear(x, w, b), want, 2048)
        v = y[:, 1:]
        w2 = torch.randn(2048, 3026, device=card) / 3026 ** 0.5
        got = cuda_linear.linear(v, w2)
        assert got.shape == (4096, 2048)
        _hold_to_float64(got, F.linear(v, w2), v.double() @ w2.double().t(),
                         3026)
        with pytest.raises(TypeError):
            cuda_linear.linear(x.bfloat16(), w.bfloat16())
        buf = torch.randn(3, 49, 2048 + 8, device=card)
        xs = buf[..., 4:4 + 2048]
        ws = w[:2048]
        got = cuda_linear.linear(xs, ws)
        assert got.shape == (3, 49, 2048) and got.is_contiguous()
        want = xs.double() @ ws.double().t()
        _hold_to_float64(got, F.linear(xs, ws), want, 2048)


@pytest.mark.parametrize("case", ["linear", "linear_bias", "input_grad",
                                  "weight_grad"])
def test_ops_pass_opcheck_on_the_card(card, case):
    """The three operators on CUDA tensors: schema, fake implementation,
    autograd registration (the backward traced through
    lstc_vad::linear_input_grad and lstc_vad::linear_weight_grad), tracing
    with dynamic shapes."""
    x, w, b = _operands(card, 3 * 49, 256, 128, 21)
    x = x.view(3, 49, 128).requires_grad_()
    w.requires_grad_()
    if case == "input_grad":
        op, args = torch.ops.lstc_vad.linear_input_grad.default, (
            torch.randn(3, 49, 256, device=card), w.detach())
    elif case == "weight_grad":
        op, args = torch.ops.lstc_vad.linear_weight_grad.default, (
            torch.randn(3, 49, 256, device=card), x.detach())
    else:
        op = torch.ops.lstc_vad.linear.default
        args = (x, w, b if case == "linear_bias" else None)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("name", ["sht_ltn", "ubnormal_ltn", "sht_stn"])
def test_every_encoder_linear_of_the_cells_takes_the_kernel(card, name):
    """One eval forward of each cell's configuration, and of the STN's (its
    d_inner 3027), at full width: every Linear of every layer on the kernel
    (6 a layer); then
    one train step's backward: every input gradient through the kernel
    (the first layer's q, k, v take none: the features need no gradient)
    and every weight gradient, those of the first layer's q, k, v too."""
    from lstc_vad_tpu_torch.config import preset
    from lstc_vad_tpu_torch.models import build

    cfg = preset(name)
    encoder, head = build(cfg, device=card, seed=0)
    tokens = cfg.data.part_len * cfg.data.n_patch
    x = torch.randn(4, tokens, cfg.encoder.d_model, device=card)
    n = cfg.encoder.n_layers
    cuda_linear.reset_launches()
    with torch.inference_mode():
        head(encoder(x)[:, 0])
    assert cuda_linear.launches == 6 * n
    cuda_linear.reset_launches()
    encoder.train()
    head(encoder(x)[:, 0]).sum().backward()
    assert cuda_linear.launches == 6 * n
    assert cuda_linear.launches_dgrad == 6 * n - 3
    assert cuda_linear.launches_wgrad == 6 * n


def test_a_model_axis_of_one_rank_is_the_unsharded_step(card):
    """A small LTN's forward and backward on the card with every module on a
    model axis of one rank (``sharded_dense``: the encoder's products on the
    kernel, the heads' on F.linear, as off the mesh) give the unsharded
    modules' output and gradients bit for bit."""
    from lstc_vad_tpu_torch.config import preset
    from lstc_vad_tpu_torch.models import build
    from lstc_vad_tpu_torch.parallel import mesh, tp

    cfg = preset("sht_ltn", **{
        "encoder.d_model": 64, "encoder.d_inner": 96, "encoder.n_head": 2,
        "encoder.d_k": 32, "encoder.d_v": 32, "encoder.n_layers": 2,
        "encoder.attn_dropout": 0.0, "encoder.fc_dropout": 0.0,
        "encoder.ffn_dropout": 0.0, "head.d_model": 64, "data.n_patch": 4,
        "data.d_model": 64, "data.part_len": 3})
    x = torch.randn(8, 12, 64, generator=torch.Generator(
        device=card).manual_seed(3), device=card)
    runs = []
    for one_rank in (False, True):
        encoder, head = build(cfg, device=card, seed=0)
        if one_rank:
            for module in (encoder, head):
                for m in mesh._tp_modules(module):
                    m.tp = tp.Axis(None, 0, 1)
        encoder.train()
        cuda_linear.reset_launches()
        out = head(encoder(x)[:, 0])
        out.sum().backward()
        assert cuda_linear.launches == 6 * cfg.encoder.n_layers
        grads = {k: p.grad for k, p in [*encoder.named_parameters(),
                                         *head.named_parameters()]
                 if p.grad is not None}
        runs.append((out.detach(), grads))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][k]), k
