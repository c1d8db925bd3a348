"""Wrapper of the Hopper attention kernels (csrc/attention.cu,
csrc/attention_bf16.cu).

``attention(q, k, v, bias, temperature)`` computes
softmax(q·kᵀ/temperature + bias[h])·v for q, k, v [B, H, L, D] and bias
[H, L, L] or None.  It replaces the TPU kernel
lstc_vad_tpu/ops/pallas_attention.py::_kernel, in both of its routes, chosen
by q's type:

- float32 q, k, v: csrc/attention.cu, f32-accurate (3xTF32);
- bfloat16 q, k, v (``encoder.compute_dtype="bfloat16"``):
  csrc/attention_bf16.cu, bf16 products summed in f32, an f32 softmax, the
  probabilities and the output rounded to bf16, as the TPU kernel does on
  bf16 inputs.  The bias is float32 in both.

Any other type raises.

- q, k and v may be strided views, as the encoder passes them: a unit
  innermost stride, a 16-byte-aligned base, and batch, head and row strides
  that are multiples of 16 bytes (4 f32 or 8 bf16 elements).  The output is
  a [B, H, L, D] view of a [B, L, H, D] buffer of q's type, the layout the
  encoder's output projection reads.
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

``launches`` counts the kernel launches of this process, both routes
(forward launches; the backward launches none), and ``launches_bf16`` those
of the bf16 route alone; a run resets both to 0 and reads them afterwards to
show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from .attention import plain_sdpa, scalar_in

OP_NAME = "lstc_vad::attention"
MAX_L = 128       # 16 key tiles of 8 (f32), 8 key tiles of 16 (bf16)
MAX_D = 256
CHUNK = 32        # D-columns per pipeline stage
# shared-memory rows, in elements, padded against bank conflicts
ROW_FLOATS = CHUNK + 4  # f32 route
ROW_BF16 = CHUNK + 8    # bf16 route
STAGES = 2        # shared-memory buffers of the copy pipeline
BLOCK_WARPS = 4   # short sequences share a block up to this many warps
DTYPES = (torch.float32, torch.bfloat16)

launches = 0       # both routes
launches_bf16 = 0  # the bf16 route


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


def tile_bf16(length: int) -> Tile:
    """The bf16 route's launch geometry at sequence length ``length`` (kept
    in step with csrc/attention_bf16.cu::launch): query rows and keys padded
    to 16, a warp per 16 query rows, and at L <= 32 as many pairs a block as
    make 4 warps."""
    if not 1 <= length <= MAX_L:
        raise ValueError(f"attention: the kernel takes 1 <= L <= {MAX_L}, "
                         f"got L={length}")
    tiles = -(-length // 16)
    pairs = max(1, BLOCK_WARPS // tiles)
    return Tile(tiles, tiles, pairs, 32 * tiles * pairs,
                STAGES * 2 * pairs * 32 * tiles * ROW_BF16)


def reset_launches():
    global launches, launches_bf16
    launches = launches_bf16 = 0


# the library, its entry point and its error-string function of each route
_ROUTES = {torch.float32: ("attention", "lstc_attention_fwd",
                           "lstc_cuda_error_string"),
           torch.bfloat16: ("attention_bf16", "lstc_attention_bf16_fwd",
                            "lstc_cuda_bf16_error_string")}


@functools.cache
def _kernel(dtype: torch.dtype = torch.float32):
    name, entry, errors = _ROUTES[dtype]
    lib = _build.load(name)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    error_string = getattr(lib, errors)
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return fn, error_string


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
    if q.dtype not in DTYPES:
        raise TypeError(f"attention: the kernels take float32 or bfloat16, "
                        f"q is {q.dtype}")
    for name, t in tensors.items():
        want = torch.float32 if name == "bias" else q.dtype
        if t.dtype != want:
            raise TypeError(f"attention: with {q.dtype} q the kernel takes "
                            f"{want} {name}, got {t.dtype}")
    align = 16 // q.element_size()  # elements in 16 bytes
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention: q, k, v must share one [B, H, L, D] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name in ("q", "k", "v"):
        t = tensors[name]
        if t.stride(-1) != 1:
            raise ValueError(f"attention: {name} must have a unit innermost "
                             f"stride, got strides {t.stride()}")
        if t.data_ptr() % 16 or any(s % align for s in _strides(t)):
            raise ValueError(
                f"attention: {name} needs a 16-byte-aligned base and batch, "
                f"head and row strides that are multiples of {align} "
                f"elements, got strides {t.stride()}")
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
    """The kernel of q's type on CUDA tensors, the plain version on CPU
    tensors; either way the result is a [B, H, L, D] view of a fresh
    [B, L, H, D] buffer, the strides the op's fake implementation states."""
    global launches, launches_bf16
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
    bf16 = q.dtype == torch.bfloat16
    fn, error_string = _kernel(q.dtype)
    pairs = (tile_bf16 if bf16 else tile)(length).pairs
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # the bf16 route scales by the temperature rounded as plain_sdpa
        # rounds it (16 at every preset: exact)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                out.data_ptr(), strides, b, h, length, d, pairs,
                scalar_in(float(temperature), q.dtype), stream)
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed: "
                           f"{error_string(rc).decode()} (cudaError {rc}, "
                           f"B={b} H={h} L={length} D={d} {q.dtype})")
    launches += 1
    launches_bf16 += bf16
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
