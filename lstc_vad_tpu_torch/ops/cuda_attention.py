"""Wrapper of the Hopper attention kernel (csrc/attention.cu).

``attention(q, k, v, bias, temperature)`` computes
softmax(q·kᵀ/temperature + bias[h])·v for q, k, v [B, H, L, D] and bias
[H, L, L] or None.  It replaces the TPU kernel
lstc_vad_tpu/ops/pallas_attention.py::_kernel.

- q, k and v may be strided views, as the encoder passes them: a unit
  innermost stride, a 16-byte-aligned base, and batch, head and row strides
  that are multiples of 4 elements.  The output is a [B, H, L, D] view of a
  [B, L, H, D] buffer, the layout the encoder's output projection reads.
- On CPU tensors it runs the plain version (ops/attention.py::plain_sdpa),
  because there is no kernel there, and returns it in the same layout.
- On CUDA tensors it launches the kernel or raises.  It never falls back to
  the plain version: a shape, dtype or layout the kernel does not take is an
  error, and so is a launch the runtime refuses.

The one route to the kernel is the registered operator
``lstc_vad::attention(q, k, v, bias?, temperature) -> out``
(``torch.library.custom_op``): its implementation is ``_launch``, its fake
implementation states the output's shape and strides, so ``torch.export``
keeps the kernel as one opaque node of a graph, and its registered autograd
reruns ``plain_sdpa`` under autograd on the saved q, k, v and bias — the one
source of the attention math, as lstc_vad_tpu/ops/pallas_attention.py:98-169
wraps its kernel in a ``jax.custom_vjp`` that recomputes through
``_xla_reference``.  Under ``torch.inference_mode`` (the scorers) nothing is
saved.  Importing this module registers the operator; an exported program
that holds it needs the import before ``torch.export.load``.

``launches`` counts the kernel launches of this process (forward launches;
the backward launches none); a run resets it to 0 and reads it afterwards to
show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from .attention import plain_sdpa

OP_NAME = "lstc_vad::attention"
MAX_L = 128       # 16 key tiles of 8
MAX_D = 256
CHUNK = 32        # D-columns per pipeline stage
ROW_FLOATS = CHUNK + 4  # a shared-memory row, padded against bank conflicts
STAGES = 2        # shared-memory buffers of the copy pipeline
BLOCK_WARPS = 4   # short sequences share a block up to this many warps

launches = 0


class Tile(NamedTuple):
    m_tiles: int     # 16-row query tiles of a pair: its warps
    n_tiles: int     # 8-key tiles: the kernel's compile-time instantiation
    pairs: int       # (b, h) pairs per block
    threads: int     # of a block
    smem_bytes: int  # dynamic shared memory of a block (all stages)


def tile(length: int) -> Tile:
    """The launch geometry at sequence length ``length`` (kept in step with
    csrc/attention.cu::launch): query rows padded to 16 per warp, keys to 8;
    a pair gets ceil(L/16) warps, and at L <= 32 a block takes as many pairs
    as make 4 warps."""
    if not 1 <= length <= MAX_L:
        raise ValueError(f"attention: the kernel takes 1 <= L <= {MAX_L}, "
                         f"got L={length}")
    m_tiles, n_tiles = -(-length // 16), -(-length // 8)
    pairs = max(1, BLOCK_WARPS // m_tiles)
    rows = 16 * m_tiles + 8 * n_tiles
    return Tile(m_tiles, n_tiles, pairs, 32 * m_tiles * pairs,
                STAGES * 4 * pairs * rows * ROW_FLOATS)


def reset_launches():
    global launches
    launches = 0


@functools.cache
def _kernel():
    lib = _build.load("attention")
    fn = lib.lstc_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.lstc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lstc_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.lstc_cuda_error_string


def _strides(t: torch.Tensor):
    """Batch, head and row strides in elements; 0 for a dimension of size 1,
    whose stride PyTorch leaves arbitrary and the kernel never multiplies."""
    return [s if n > 1 else 0 for s, n in zip(t.stride()[:3], t.shape[:3])]


def _check(q, k, v, bias, temperature):
    tensors = {"q": q, "k": k, "v": v}
    if bias is not None:
        tensors["bias"] = bias
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"attention: {name} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"attention: the kernel takes float32, {name} "
                            f"is {t.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention: q, k, v must share one [B, H, L, D] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name in ("q", "k", "v"):
        t = tensors[name]
        if t.stride(-1) != 1:
            raise ValueError(f"attention: {name} must have a unit innermost "
                             f"stride, got strides {t.stride()}")
        if t.data_ptr() % 16 or any(s % 4 for s in _strides(t)):
            raise ValueError(
                f"attention: {name} needs a 16-byte-aligned base and batch, "
                f"head and row strides that are multiples of 4 elements, got "
                f"strides {t.stride()}")
    if bias is not None and not bias.is_contiguous():
        raise ValueError("attention: bias must be contiguous")
    _, h, length, d = q.shape
    if d % CHUNK or not 0 < d <= MAX_D:
        raise ValueError(f"attention: the kernel takes D a multiple of "
                         f"{CHUNK} up to {MAX_D}, got D={d}")
    if length > MAX_L:
        raise ValueError(f"attention: the kernel takes L up to {MAX_L}, got "
                         f"L={length}")
    if bias is not None and tuple(bias.shape) != (h, length, length):
        raise ValueError(f"attention: bias must be [H, L, L] = "
                         f"{(h, length, length)}, got {tuple(bias.shape)}")
    if not temperature > 0:
        raise ValueError(f"attention: temperature must be > 0, got "
                         f"{temperature}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], temperature: float) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors; either
    way the result is a [B, H, L, D] view of a fresh [B, L, H, D] buffer, the
    strides the op's fake implementation states."""
    global launches
    tensors = [q, k, v] + ([bias] if bias is not None else [])
    b, h, length, d = q.shape
    if all(t.device.type == "cpu" for t in tensors):
        out = q.new_empty(b, length, h, d).transpose(1, 2)
        return out.copy_(plain_sdpa(q, k, v, temperature, bias=bias))
    if q.device.type != "cuda":
        raise ValueError(f"attention: tensors on {q.device}; the kernel "
                         "runs on CUDA tensors")
    _check(q, k, v, bias, temperature)
    out = torch.empty(b, length, h, d, device=q.device,
                      dtype=q.dtype).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *_strides(q), *_strides(k), *_strides(v), *_strides(out))
    fn, error_string = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                out.data_ptr(), strides, b, h, length, d, tile(length).pairs,
                float(temperature), stream)
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed: "
                           f"{error_string(rc).decode()} (cudaError {rc}, "
                           f"B={b} H={h} L={length} D={d})")
    launches += 1
    return out


@torch.library.custom_op(OP_NAME, mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], temperature: float
                  ) -> torch.Tensor:
    return _launch(q, k, v, bias, temperature)


@_attention_op.register_fake
def _attention_fake(q, k, v, bias, temperature):
    """Shape, type and strides only: [B, H, L, D] over a [B, L, H, D]
    buffer.  q, k and v may be strided views; nothing here assumes they are
    contiguous."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention: q, k, v must share one [B, H, L, D] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, length, d = q.shape
    return q.new_empty(b, length, h, d).transpose(1, 2)


def _setup_context(ctx, inputs, output):
    q, k, v, bias, temperature = inputs
    ctx.temperature = temperature
    ctx.save_for_backward(q, k, v, bias)


def _backward(ctx, grad_out):
    """Autograd through ``plain_sdpa`` on detached copies of the saved
    inputs (q, k, v are the encoder's strided views of its projections;
    saving them copies nothing)."""
    q, k, v, bias = ctx.saved_tensors
    wanted = ctx.needs_input_grad[:4]
    inputs = [t.detach().requires_grad_(need) if t is not None else None
              for t, need in zip((q, k, v, bias), wanted)]
    with torch.enable_grad():
        out = plain_sdpa(*inputs[:3], ctx.temperature, bias=inputs[3])
    # autograd calls backward only when some input needs a gradient
    wrt = [t for t, need in zip(inputs, wanted) if need]
    grads = iter(torch.autograd.grad(out, wrt, grad_out))
    return tuple(next(grads) if need else None for need in wanted) + (None,)


_attention_op.register_autograd(_backward, setup_context=_setup_context)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor], temperature: float
              ) -> torch.Tensor:
    """softmax(q·kᵀ/temperature + bias[h])·v through ``lstc_vad::attention``."""
    return _attention_op(q, k, v, bias, float(temperature))
