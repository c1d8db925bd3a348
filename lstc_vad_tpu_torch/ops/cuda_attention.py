"""Wrapper of the Hopper attention kernels (csrc/attention.cu,
csrc/attention_bf16.cu, csrc/attention_stream.cu,
csrc/attention_stream_bf16.cu).

``attention(q, k, v, bias, temperature)`` computes
softmax(q·kᵀ/temperature + bias[h])·v for q, k [B, H, L, d_k], v
[B, H, L, d_v] and bias [H, L, L] or None.  It replaces the TPU kernel
lstc_vad_tpu/ops/pallas_attention.py::_kernel, in both of its routes, chosen
by q's type:

- float32 q, k, v: f32-accurate (3xTF32);
- bfloat16 q, k, v (``encoder.compute_dtype="bfloat16"``): bf16 products
  summed in f32, an f32 softmax, the probabilities and the output rounded to
  bf16, as the TPU kernel does on bf16 inputs.  The bias is float32 in both.

Any other type raises.  Each route has two kernels, and ``route`` picks one
from the shape alone:

- L <= 128, d_k = d_v a multiple of 32 up to 256, and q, k, v with a
  16-byte-aligned base and batch, head and row strides that are multiples of
  16 bytes (4 f32 or 8 bf16 elements): csrc/attention.cu (f32) or
  csrc/attention_bf16.cu (bf16), which keep a row's scores for every key in
  registers: both persistent, one block an SM, with Q, K, V in by TMA,
  wgmma for both products (3xTF32 on TF32 wgmma for f32) and O out by TMA;
  ``f32_plan`` and ``bf16_plan`` read their launch geometry;
- every other shape (any L >= 1, any d_k and d_v >= 1, any strides): the
  streaming kernels, which walk the keys in tiles with the scores of one
  tile at a time on chip, both with Q, K and V brought in by TMA behind
  mbarriers by a producer warpgroup and wgmma for both products:
  csrc/attention_stream.cu (f32: 3xTF32 on TF32 wgmma, one pass with an
  online softmax, the producers splitting K and V into TF32 halves and V
  into the K-major V^T that TF32 wgmma reads) and
  csrc/attention_stream_bf16.cu (bf16: persistent blocks, two query tiles
  in ping-pong, a statistics phase past one key tile so that P is rounded
  as plain_sdpa rounds it; q, k and v through TMA alone, so a view off the
  16-byte grid is first copied into a padded buffer, ``_padded``).

q, k and v may be strided views, as the encoder passes them, with a unit
innermost stride.  The output is a [B, H, L, d_v] view of a
[B, L, H, d_v] buffer of q's type, the layout the encoder's output
projection reads.

- On CPU tensors it runs the plain version (ops/attention.py::plain_sdpa),
  because there is no kernel there, and returns it in the same layout.
- On CUDA tensors it launches a kernel or raises.  It never falls back to
  the plain version: a type or layout no kernel takes is an error, and so is
  a launch the runtime refuses.

The one route to the kernels is the registered operator
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
``stream_attention`` launches the streaming kernel at any shape, for the
tests and chip_smoke.py to hold it where the other two also run.

``launches`` counts the kernel launches of this process, every kernel
(forward launches; the backward launches none), ``launches_bf16`` those of
the bf16 route (both of its kernels) and ``launches_stream`` those of the
streaming kernel (both routes); ``by_route`` counts each of the four
kernels, keyed as ``route`` names them.  A run resets them to 0 and reads
them afterwards to show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .attention import plain_sdpa, scalar_in

OP_NAME = "lstc_vad::attention"
# the tiled kernels (csrc/attention.cu, csrc/attention_bf16.cu) take
# L <= MAX_L and d_k = d_v a multiple of CHUNK up to MAX_D
MAX_L = 128       # one tile of 128 rows
MAX_D = 256
CHUNK = 32        # D-columns of a 128-byte f32 box: a ring stage (f32)
DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("f32", "bf16", "f32_stream", "bf16_stream")

launches = 0         # every kernel
launches_bf16 = 0    # the bf16 route, both kernels
launches_stream = 0  # the streaming kernel, both routes
by_route = dict.fromkeys(ROUTES, 0)


def route(dtype: torch.dtype, length: int, d_k: int, d_v: int,
          aligned: bool) -> str:
    """The kernel that computes attention on CUDA tensors of ``dtype`` at
    sequence length ``length`` and head widths ``d_k``, ``d_v``: "f32" or
    "bf16" (csrc/attention.cu, csrc/attention_bf16.cu) where L <= 128, d_k =
    d_v is a multiple of 32 up to 256 and q, k, v are ``aligned`` (a
    16-byte-aligned base, batch, head and row strides of whole 16 bytes);
    "f32_stream" or "bf16_stream" (csrc/attention_stream.cu,
    csrc/attention_stream_bf16.cu) at every other shape."""
    if dtype not in DTYPES:
        raise TypeError(f"attention: the kernels take float32 or bfloat16, "
                        f"got {dtype}")
    name = "f32" if dtype == torch.float32 else "bf16"
    tiled = (1 <= length <= MAX_L and d_k == d_v and d_k % CHUNK == 0
             and 0 < d_k <= MAX_D and aligned)
    return name if tiled else f"{name}_stream"


def reset_launches():
    global launches, launches_bf16, launches_stream
    launches = launches_bf16 = launches_stream = 0
    by_route.update(dict.fromkeys(ROUTES, 0))


# the library, its entry point and its error-string function of each tiled
# route
_ROUTES = {torch.float32: ("attention", "lstc_attention_fwd",
                           "lstc_cuda_error_string"),
           torch.bfloat16: ("attention_bf16", "lstc_attention_bf16_fwd",
                            "lstc_cuda_bf16_error_string")}


def _error_string(lib, name: str):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn


@functools.cache
def _kernel(dtype: torch.dtype = torch.float32):
    name, entry, errors = _ROUTES[dtype]
    lib = _build.load(name)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, _error_string(lib, errors)


BF16_PLAN_KEYS = ("smem_bytes", "threads", "rows", "heads", "head_rows",
                  "stages")
F32_PLAN_KEYS = ("smem_bytes", "threads", "rows", "heads", "head_rows",
                 "keys", "rings", "stages")


def _tiled_plan(name: str, entry: str, keys, length: int, d: int) -> dict:
    fn = getattr(_build.load(name), entry)
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(keys))()
    if fn(length, d, out) != 0:
        raise ValueError(f"attention: the tiled kernel of {name}.cu does "
                         f"not take L={length} d={d}")
    return dict(zip(keys, out))


def bf16_plan(length: int, d: int) -> dict:
    """The tiled bf16 kernel's launch geometry at L = ``length`` and
    d_k = d_v = ``d``, as its launcher computes it: dynamic shared memory
    bytes and threads a block (one block an SM), query rows a tile, heads
    a tile, rows a head takes in it, and ring stages.  Builds the kernel's
    library (the geometry lives in its C source)."""
    return _tiled_plan("attention_bf16", "lstc_attention_bf16_plan",
                       BF16_PLAN_KEYS, length, d)


def f32_plan(length: int, d: int) -> dict:
    """The tiled f32 kernel's launch geometry at L = ``length`` and
    d_k = d_v = ``d``, as its launcher computes it: dynamic shared memory
    bytes and threads a block (one block an SM), query rows a tile, heads
    a tile, rows a head takes in it, keys the products take (8·ceil(L/8)
    with one head a tile), rings (tiles in flight a block) and stages a
    ring.  Raises for a shape the kernel does not take, the length
    checked before the kernel's library is built (the geometry lives in its
    C source)."""
    if not 1 <= length <= MAX_L:
        raise ValueError(f"attention: the tiled f32 kernel takes 1 <= L <= "
                         f"{MAX_L}, got L={length}")
    return _tiled_plan("attention", "lstc_attention_f32_plan",
                       F32_PLAN_KEYS, length, d)


# the same for each streaming route
_STREAM_ROUTES = {torch.float32: ("attention_stream",
                                  "lstc_attention_stream_fwd",
                                  "lstc_cuda_stream_error_string"),
                  torch.bfloat16: ("attention_stream_bf16",
                                   "lstc_attention_stream_bf16_fwd",
                                   "lstc_cuda_stream_bf16_error_string")}


@functools.cache
def _stream_kernel(dtype: torch.dtype):
    name, entry, errors = _STREAM_ROUTES[dtype]
    lib = _build.load(name)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 + [
        ctypes.c_uint, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, _error_string(lib, errors)


# the launch geometry each streaming route's plan function writes
STREAM_PLAN_KEYS = {
    torch.float32: ("smem_bytes", "threads", "rows", "stages", "q_resident",
                    "keys", "landing_stages"),
    torch.bfloat16: ("smem_bytes", "threads", "rows", "stages",
                     "q_resident", "keys", "row_tiles", "v_stages",
                     "bias_stages", "persistent", "pingpong")}


def stream_plan(dtype: torch.dtype, length: int, d_k: int, d_v: int,
                with_bias: bool) -> dict:
    """The streaming kernel's launch geometry at a shape, as its launcher
    computes it: dynamic shared memory bytes, threads and query rows a
    block, ring stages, and whether Q stays resident; for the f32 kernel
    also its keys a tile and its landing zones (``stages`` are then its
    ready slots, the ring of split operands the consumers read); for the
    bf16 kernel (``rows`` a work item, ``stages`` its K ring's) also its
    keys a tile, the query tiles a block holds at once, its V and bias
    rings' stages, whether blocks are persistent and whether its consumer
    warpgroups take turns (ping-pong), mirrored in
    tests/bf16_stream_plan.py.  Builds the kernel's library (the geometry
    lives in its C source)."""
    name, entry, _ = _STREAM_ROUTES[dtype]
    fn = getattr(_build.load(name), entry.replace("_fwd", "_plan"))
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    keys = STREAM_PLAN_KEYS[dtype]
    out = (ctypes.c_int * len(keys))()
    rc = fn(length, d_k, d_v, int(with_bias), out)
    if rc != 0:
        raise RuntimeError(f"attention: no launch geometry fits L={length} "
                           f"d_k={d_k} d_v={d_v} (cudaError {rc})")
    return dict(zip(keys, out))


def _strides(t: torch.Tensor):
    """Batch, head and row strides in elements; 0 for a dimension of size 1,
    whose stride PyTorch leaves arbitrary and the kernel never multiplies."""
    return [s if n > 1 else 0 for s, n in zip(t.stride()[:3], t.shape[:3])]


def _aligned(t: torch.Tensor) -> bool:
    """Whether 16-byte copies fit ``t``: its base, batch, head and row
    strides and its width are whole multiples of 16 bytes."""
    align = 16 // t.element_size()  # elements in 16 bytes
    return (t.data_ptr() % 16 == 0 and t.shape[-1] % align == 0
            and all(s % align == 0 for s in _strides(t)))


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether a TMA map can describe ``t``: a 16-byte-aligned base and
    batch, head and row strides of whole 16 bytes (any width)."""
    align = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % align == 0 for s in _strides(t))


def _padded(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a fresh buffer with rows padded to whole 16 bytes:
    a view of the same shape and values that a TMA map can describe.  The
    bf16 streaming kernel reads q, k and v through TMA alone; this copy
    takes the place of its element-by-element fallback."""
    d = t.shape[-1]
    align = 16 // t.element_size()
    buf = t.new_empty(*t.shape[:-1], -(-d // align) * align)
    buf[..., :d].copy_(t)
    return buf[..., :d]


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
    _check_shapes(q, k, v)
    for name in ("q", "k", "v"):
        t = tensors[name]
        if t.stride(-1) != 1:
            raise ValueError(f"attention: {name} must have a unit innermost "
                             f"stride, got strides {t.stride()}")
    if bias is not None and not bias.is_contiguous():
        raise ValueError("attention: bias must be contiguous")
    _, h, length, d = q.shape
    if d < 1:
        raise ValueError("attention: q and k need d_k >= 1")
    if bias is not None and tuple(bias.shape) != (h, length, length):
        raise ValueError(f"attention: bias must be [H, L, L] = "
                         f"{(h, length, length)}, got {tuple(bias.shape)}")
    if not temperature > 0:
        raise ValueError(f"attention: temperature must be > 0, got "
                         f"{temperature}")


def _check_shapes(q, k, v):
    """q and k [B, H, L, d_k], v [B, H, L, d_v]."""
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError("attention: q, k must share one [B, H, L, d_k] "
                         "shape and v be [B, H, L, d_v], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _output(q, v) -> torch.Tensor:
    """A [B, H, L, d_v] view of a fresh [B, L, H, d_v] buffer of q's type."""
    b, h, length, _ = q.shape
    return q.new_empty(b, length, h, v.shape[-1]).transpose(1, 2)


def _count(name: str):
    global launches, launches_bf16, launches_stream
    launches += 1
    launches_bf16 += name.startswith("bf16")
    launches_stream += name.endswith("_stream")
    by_route[name] += 1


def _raise_failed(rc, error_string, q, v, name):
    b, h, length, d = q.shape
    raise RuntimeError(f"attention kernel launch failed: "
                       f"{error_string(rc).decode()} (cudaError {rc}, "
                       f"{name}, B={b} H={h} L={length} d_k={d} "
                       f"d_v={v.shape[-1]} {q.dtype})")


def _launch_tiled(q, k, v, bias, temperature, out, strides, name):
    b, h, length, d = q.shape
    fn, error_string = _kernel(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # the bf16 route scales by the temperature rounded as plain_sdpa
        # rounds it (16 at every preset: exact)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                out.data_ptr(), strides, b, h, length, d,
                scalar_in(float(temperature), q.dtype), stream)
    if rc != 0:
        _raise_failed(rc, error_string, q, v, name)


def _launch_stream(q, k, v, bias, temperature, out, strides, name):
    b, h, length, d = q.shape
    ready = _tma_ready if name == "bf16_stream" else _aligned
    vec = sum(bit for bit, t in ((1, q), (2, k), (4, v)) if ready(t))
    fn, error_string = _stream_kernel(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                out.data_ptr(), strides, b, h, length, d, v.shape[-1], vec,
                scalar_in(float(temperature), q.dtype), stream)
    if rc != 0:
        _raise_failed(rc, error_string, q, v, name)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], temperature: float,
            stream_only: bool = False) -> torch.Tensor:
    """The kernel ``route`` names for the shape on CUDA tensors (the
    streaming one at any shape when ``stream_only``), the plain version on
    CPU tensors; either way the result is a [B, H, L, d_v] view of a fresh
    [B, L, H, d_v] buffer, the strides the op's fake implementation
    states."""
    tensors = [q, k, v] + ([bias] if bias is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        _check_shapes(q, k, v)
        return _output(q, v).copy_(plain_sdpa(q, k, v, temperature,
                                              bias=bias))
    if q.device.type != "cuda":
        raise ValueError(f"attention: tensors on {q.device}; the kernel "
                         "runs on CUDA tensors")
    _check(q, k, v, bias, temperature)
    out = _output(q, v)
    if out.numel() == 0:
        return out
    name = route(q.dtype, q.shape[2], q.shape[3], v.shape[3],
                 all(_aligned(t) for t in (q, k, v)))
    if stream_only and not name.endswith("_stream"):
        name += "_stream"
    if name == "bf16_stream":
        q, k, v = (t if _tma_ready(t) else _padded(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 12)(
        *_strides(q), *_strides(k), *_strides(v), *_strides(out))
    launch = _launch_stream if name.endswith("_stream") else _launch_tiled
    launch(q, k, v, bias, temperature, out, strides, name)
    _count(name)
    return out


@torch.library.custom_op(OP_NAME, mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], temperature: float
                  ) -> torch.Tensor:
    return _launch(q, k, v, bias, temperature)


@_attention_op.register_fake
def _attention_fake(q, k, v, bias, temperature):
    """Shape, type and strides only: [B, H, L, d_v] over a [B, L, H, d_v]
    buffer.  q, k and v may be strided views; nothing here assumes they are
    contiguous."""
    _check_shapes(q, k, v)
    return _output(q, v)


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


def stream_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor], temperature: float
                     ) -> torch.Tensor:
    """The streaming kernel of q's type at any shape, also where ``route``
    names a tiled kernel: forward only, outside the operator.  The tests
    and chip_smoke.py hold it against the plain version there."""
    return _launch(q, k, v, bias, float(temperature), stream_only=True)
