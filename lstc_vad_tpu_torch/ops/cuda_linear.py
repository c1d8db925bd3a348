"""Wrapper of the Hopper GEMM (csrc/gemm.cu): the encoder's f32 Linears.

``linear(x, weight, bias)`` computes ``x·weightᵀ + bias`` for f32 ``x``
[..., K], ``weight`` [N, K] and ``bias`` [N] or None, the function of
``F.linear``, f32-accurate: 3xTF32 on the tensor cores (each operand as two
TF32 halves, three products summed in f32), as csrc/attention.cu computes
attention.  It replaces no TPU kernel: the JAX package left its Dense
layers to XLA, and the port ran them on cuBLAS's FP32 kernels.

- On CPU tensors it is ``F.linear`` itself, forward and gradients, bit for
  bit.
- On CUDA tensors every f32 call launches the kernel (csrc/gemm.cu), at
  any width: a K that is not a multiple of 4 (the STN and UCF presets'
  d_inner 3027 into ``w_2``) is padded into the row stride of a copy of x
  and of the weight's halves, since TMA reads rows of whole 16 bytes; an N
  that is not one (3027 out of ``w_1``) the kernel stores from registers.
  Any other type raises (``check_kernel``): the encoder's bf16 and SR Linears
  never call it.  A launch the runtime refuses raises; nothing falls back.

The one route to the kernel is the registered operator
``lstc_vad::linear(x, weight, bias?) -> y`` (``torch.library.custom_op``):
its fake implementation states the output's shape, so ``torch.export`` keeps
the product as one node of a graph, and its registered autograd gives

- the input gradient dY·W through the same kernel, its B the weight's
  transposed TF32 halves (both operands K-major: TF32 wgmma takes no
  transposed operand), by the operator ``lstc_vad::linear_input_grad`` so
  that the backward traces too;
- the weight gradient dYᵀ·X through the kernel's weight-gradient entry
  (``lstc_gemm_wgrad``: the sums over the rows, dY and x turned K-major in
  shared memory), by the operator ``lstc_vad::linear_weight_grad``; dY is
  padded once for both products where its width is ragged (d_inner 3027
  out of ``w_1``);
- the bias gradient by a sum, as autograd of ``F.linear`` computes it;
- on CPU tensors, autograd of ``F.linear`` itself, rerun on the saved
  inputs.

The weight is split into its TF32 halves by a small kernel on every call,
into scratch from ``torch.empty``: no split is kept, so none is stale after
an optimizer step.  Importing this module registers the operator; an
exported program that holds it needs the import before
``torch.export.load``.

``launches`` counts the forward launches of the kernel,
``launches_dgrad`` the input-gradient launches and ``launches_wgrad`` the
weight-gradient launches (one for each Linear whose weight takes a
gradient: 6 a layer in a training step, the first layer's q, k and v
included).  A run resets them to 0 and reads them afterwards to show that
its Linears went through the kernel.  ``pad_copies`` counts the copies of
an operand into a padded row stride (``_tma_view``: a forward's x into
``w_2``, a backward's dY out of ``w_1`` and its x into ``w_2`` at d_inner
3027) and ``pad_bytes`` what they move, the rows read and written once
(2 · M · width · 4 bytes a copy); each copy is the span ``linear.pad``.
``reset_launches`` resets all five.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.profiling import annotate
from . import _build

OP_NAME = "lstc_vad::linear"
INPUT_GRAD_OP_NAME = "lstc_vad::linear_input_grad"
WEIGHT_GRAD_OP_NAME = "lstc_vad::linear_weight_grad"
ALIGN = 4  # f32 elements in 16 bytes: the row strides TMA takes

launches = 0        # forward launches of the kernel
launches_dgrad = 0  # input-gradient launches of the kernel
launches_wgrad = 0  # weight-gradient launches of the kernel
pad_copies = 0      # operands copied into a padded row stride
pad_bytes = 0       # bytes those copies read and wrote


def check_kernel(dtype: torch.dtype, n: int, k: int):
    """Refuse what the kernel (csrc/gemm.cu) does not take for a CUDA Linear
    of ``dtype`` from K = ``k`` inputs to N = ``n`` outputs: any type but
    float32 (TypeError) and an empty width (ValueError); every other width
    it takes.  The input gradient, a product over N into K columns, is
    checked the same way."""
    if dtype != torch.float32:
        raise TypeError(f"linear: the kernel takes float32, got {dtype}")
    if n < 1 or k < 1:
        raise ValueError(f"linear: the kernel takes no empty width, got "
                         f"N={n} K={k}")


def reset_launches():
    global launches, launches_dgrad, launches_wgrad, pad_copies, pad_bytes
    launches = launches_dgrad = launches_wgrad = pad_copies = pad_bytes = 0


@functools.cache
def _lib():
    lib = _build.load("gemm")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for fn, args in ((lib.lstc_gemm, [ptr, i, ptr, ptr, i, ptr, ptr, i, i, i,
                                      ptr]),
                     (lib.lstc_gemm_wgrad, [ptr, i, ptr, i, ptr, i, i, i,
                                            ptr]),
                     (lib.lstc_gemm_split, [ptr, ptr, ptr, i, i, i, i, ptr])):
        fn.argtypes = args
        fn.restype = i
    lib.lstc_gemm_error_string.argtypes = [i]
    lib.lstc_gemm_error_string.restype = ctypes.c_char_p
    return lib


def _raise_failed(rc: int, what: str):
    raise RuntimeError(f"linear kernel launch failed: "
                       f"{_lib().lstc_gemm_error_string(rc).decode()} "
                       f"(cudaError {rc}, {what})")


def _padded(width: int) -> int:
    """The row stride TMA takes for rows of ``width`` f32 elements."""
    return -(-width // ALIGN) * ALIGN


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous matrix of its rows on a 16-byte-aligned base
    (a copy only where it is not one already)."""
    t = t.reshape(-1, t.shape[-1])
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _tma_view(t: torch.Tensor) -> torch.Tensor:
    """``t``, or, where its width is not a multiple of 4, a copy whose rows
    are padded to one, as the view of its first ``width`` columns (the
    padding unwritten: TMA reads the columns past the width as zeros).
    Decided by the shape alone, so that the backward traces through it."""
    global pad_copies, pad_bytes
    width = t.shape[-1]
    ld = _padded(width)
    if ld == width:
        return t
    with annotate("linear.pad"):
        out = t.new_empty(*t.shape[:-1], ld)
        out[..., :width] = t
    pad_copies += 1
    pad_bytes += 2 * t.numel() * t.element_size()
    return out[..., :width]


def _row_stride(rows: torch.Tensor) -> Optional[int]:
    """The row stride by which TMA reads the matrix ``rows`` in place
    (elements 16-byte aligned, rows a multiple of 4 elements apart), or
    None where it cannot."""
    m, width = rows.shape
    ld = rows.stride(0) if m > 1 else _padded(width)
    if (width > 1 and rows.stride(1) != 1) or ld < width or ld % ALIGN \
            or rows.data_ptr() % 16:
        return None
    return ld


def _tma_rows(t: torch.Tensor):
    """``t``'s rows and their stride as TMA reads them: ``_rows(t)`` where
    the width is a multiple of 4; else the rows in place where they already
    lie a multiple of 4 elements apart on a 16-byte grid (a padded view
    from ``_tma_view``), or ``_tma_view``'s padded copy."""
    rows = t.reshape(-1, t.shape[-1])
    if rows.shape[1] % ALIGN == 0:
        return _rows(rows), rows.shape[1]
    ld = _row_stride(rows)
    if ld is None:
        rows = _tma_view(rows)
        ld = _row_stride(rows)
    return rows, ld


def _halves(weight: torch.Tensor, transpose: bool):
    """The weight's TF32 halves, [N, K] as it is or transposed to [K, N],
    and their row stride (the width padded to a multiple of 4)."""
    n, k = weight.shape
    w = _rows(weight)
    rows, width = (k, n) if transpose else (n, k)
    ld = _padded(width)
    big, small = w.new_empty(rows, ld), w.new_empty(rows, ld)
    rc = _lib().lstc_gemm_split(w.data_ptr(), big.data_ptr(),
                                small.data_ptr(), n, k, ld, int(transpose),
                                _stream(w))
    if rc != 0:
        _raise_failed(rc, f"split of a [{n}, {k}] weight")
    return big, small, ld


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def gemm(a: torch.Tensor, weight: torch.Tensor,
         bias: Optional[torch.Tensor], transpose: bool) -> torch.Tensor:
    """a [..., K'] times the weight, as a matrix of a's rows:
    ``a·weightᵀ (+ bias)`` (K' = K) or, with ``transpose``, ``a·weight``
    (K' = N), through csrc/gemm.cu on f32 CUDA tensors of any width."""
    depth = a.shape[-1]
    n, k = weight.shape
    if depth != (n if transpose else k):
        raise ValueError(f"linear: a [..., {depth}] does not meet a weight "
                         f"[{n}, {k}]{' transposed' if transpose else ''}")
    cols = k if transpose else n
    m = a.numel() // depth if depth else 0
    out = a.new_empty(m, cols)
    if m == 0:
        return out
    bias = None if bias is None else _rows(bias)
    with torch.cuda.device(a.device):
        a, lda = _tma_rows(a)
        big, small, ldb = _halves(weight, transpose)
        rc = _lib().lstc_gemm(a.data_ptr(), lda, big.data_ptr(),
                              small.data_ptr(), ldb,
                              None if bias is None else bias.data_ptr(),
                              out.data_ptr(), m, cols, depth, _stream(a))
    if rc != 0:
        _raise_failed(rc, f"M={m} N={cols} K={depth}")
    return out


def gemm_wgrad(grad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dYᵀ·X for dY [..., N] and x [..., K] as matrices of their M rows:
    [N, K], the sums over M, through csrc/gemm.cu on f32 CUDA tensors of any
    width (a ragged one through ``_tma_rows``)."""
    n, k = grad.shape[-1], x.shape[-1]
    m = grad.numel() // n if n else 0
    if (x.numel() // k if k else 0) != m:
        raise ValueError(f"linear: dY {tuple(grad.shape)} and x "
                         f"{tuple(x.shape)} differ in their rows")
    out = grad.new_empty(n, k)
    if m == 0:
        return out.zero_()
    with torch.cuda.device(grad.device):
        g, ldg = _tma_rows(grad)
        xs, ldx = _tma_rows(x)
        rc = _lib().lstc_gemm_wgrad(g.data_ptr(), ldg, xs.data_ptr(), ldx,
                                    out.data_ptr(), m, n, k, _stream(g))
    if rc != 0:
        _raise_failed(rc, f"weight gradient M={m} N={n} K={k}")
    return out


def _check(x, weight, bias):
    tensors = {"x": x, "weight": weight}
    if bias is not None:
        tensors["bias"] = bias
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"linear: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"linear: {name} is {t.dtype}, x {x.dtype}")
    _check_shapes(x, weight, bias)


def _check_shapes(x, weight, bias):
    """x [..., K], weight [N, K], bias [N] or None."""
    if x.dim() < 1 or weight.dim() != 2 or x.shape[-1] != weight.shape[1] \
            or (bias is not None and tuple(bias.shape) != weight.shape[:1]):
        raise ValueError(f"linear: x must be [..., K], weight [N, K] and bias "
                         f"[N], got {tuple(x.shape)}, {tuple(weight.shape)}, "
                         f"{None if bias is None else tuple(bias.shape)}")


def _forward(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    global launches
    if all(t.device.type == "cpu"
           for t in (x, weight) + (() if bias is None else (bias,))):
        return F.linear(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"linear: tensors on {x.device}; the kernel runs on "
                         "CUDA tensors")
    _check(x, weight, bias)
    n, k = weight.shape
    check_kernel(x.dtype, n, k)
    y = gemm(x, weight, bias, transpose=False)
    launches += 1
    return y.view(*x.shape[:-1], n)


@torch.library.custom_op(OP_NAME, mutates_args=())
def _linear_op(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    return _forward(x, weight, bias)


@_linear_op.register_fake
def _linear_fake(x, weight, bias):
    _check_shapes(x, weight, bias)
    return x.new_empty(*x.shape[:-1], weight.shape[0])


@torch.library.custom_op(INPUT_GRAD_OP_NAME, mutates_args=())
def _input_grad_op(grad: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """dY·W for dY [..., N] and the weight [N, K]: on CUDA tensors the
    kernel (a product over N into K columns), on the CPU ``torch.matmul``.
    An operator of its own, so that the backward traces (AOT autograd) as
    the forward does."""
    global launches_dgrad
    n, k = weight.shape
    if grad.device.type != "cuda":
        return torch.matmul(grad.reshape(-1, n), weight).view(
            *grad.shape[:-1], k)
    check_kernel(grad.dtype, k, n)
    dx = gemm(grad, weight, None, transpose=True)
    launches_dgrad += 1
    return dx.view(*grad.shape[:-1], k)


@_input_grad_op.register_fake
def _input_grad_fake(grad, weight):
    return grad.new_empty(*grad.shape[:-1], weight.shape[1])


@torch.library.custom_op(WEIGHT_GRAD_OP_NAME, mutates_args=())
def _weight_grad_op(grad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dYᵀ·X for dY [..., N] and x [..., K]: the weight's gradient [N, K].
    On CUDA tensors the kernel (``lstc_gemm_wgrad``, the sums over the
    rows), on the CPU ``torch.matmul``.  An operator of its own, as the
    input gradient's is, so that the backward traces."""
    global launches_wgrad
    n, k = grad.shape[-1], x.shape[-1]
    if grad.device.type != "cuda":
        return torch.matmul(grad.reshape(-1, n).t(), x.reshape(-1, k))
    check_kernel(grad.dtype, n, k)
    check_kernel(x.dtype, n, k)
    dw = gemm_wgrad(grad, x)
    launches_wgrad += 1
    return dw


@_weight_grad_op.register_fake
def _weight_grad_fake(grad, x):
    return grad.new_empty(grad.shape[-1], x.shape[-1])


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, grad):
    x, weight, bias = ctx.saved_tensors
    wanted = ctx.needs_input_grad
    if x.device.type == "cpu":
        # autograd of F.linear itself, so every gradient is its bit for bit
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip((x, weight, bias), wanted)]
        with torch.enable_grad():
            out = F.linear(*inputs)
        wrt = [t for t, need in zip(inputs, wanted) if need]
        grads = iter(torch.autograd.grad(out, wrt, grad))
        return tuple(next(grads) if need else None for need in wanted)
    dx = dw = db = None
    if wanted[0] or wanted[1]:
        g = _tma_view(grad)  # a ragged dY padded once for both products
        if wanted[0]:
            dx = _input_grad_op(g, weight)
        if wanted[1]:
            dw = _weight_grad_op(g, x)
    if wanted[2]:
        db = grad.reshape(-1, weight.shape[0]).sum(0)
    return dx, dw, db


_linear_op.register_autograd(_backward, setup_context=_setup_context)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x·weightᵀ + bias`` through ``lstc_vad::linear``."""
    return _linear_op(x, weight, bias)
