"""Wrapper of the Hopper attention kernel (csrc/attention.cu).

``attention(q, k, v, bias, temperature)`` computes
softmax(q·kᵀ/temperature + bias[h])·v for q, k, v [B, H, L, D] and bias
[H, L, L] or None.  It replaces the TPU kernel
lstc_vad_tpu/ops/pallas_attention.py::_kernel.

- On CPU tensors it runs the plain version (ops/attention.py::plain_sdpa),
  because there is no kernel there.
- On CUDA tensors it launches the kernel or raises.  It never falls back to
  the plain version: a shape, dtype or layout the kernel does not take is an
  error, and so is a launch the runtime refuses.

``launches`` counts the kernel launches of this process; a run resets it to
0 and reads it afterwards to show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .attention import plain_sdpa

WARP = 32
MAX_WARPS = 16
MAX_D = 256
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90

launches = 0


def num_warps(length: int) -> int:
    return max(1, min(MAX_WARPS, length))


def smem_bytes(length: int, d: int) -> int:
    """Dynamic shared memory of one block: K and V of a (b, h) pair plus one
    row of scores per warp (kept in step with csrc/attention.cu)."""
    return 4 * (2 * length * d + num_warps(length) * length)


def reset_launches():
    global launches
    launches = 0


@functools.cache
def _kernel():
    lib = _build.load("attention")
    fn = lib.lstc_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.lstc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lstc_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.lstc_cuda_error_string


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
        if not t.is_contiguous():
            raise ValueError(f"attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"attention: {name} must be 16-byte aligned")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention: q, k, v must share one [B, H, L, D] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _, h, length, d = q.shape
    if d % WARP or not 0 < d <= MAX_D:
        raise ValueError(f"attention: the kernel takes D a multiple of {WARP} "
                         f"up to {MAX_D}, got D={d}")
    if bias is not None and tuple(bias.shape) != (h, length, length):
        raise ValueError(f"attention: bias must be [H, L, L] = "
                         f"{(h, length, length)}, got {tuple(bias.shape)}")
    need = smem_bytes(length, d)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"attention: L={length}, D={d} needs {need} bytes of shared "
            f"memory per block, over the {SMEM_LIMIT} an sm_90 block may use")
    if not temperature > 0:
        raise ValueError(f"attention: temperature must be > 0, got "
                         f"{temperature}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor], temperature: float
              ) -> torch.Tensor:
    global launches
    tensors = [q, k, v] + ([bias] if bias is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return plain_sdpa(q, k, v, temperature, bias=bias)
    if q.device.type != "cuda":
        raise ValueError(f"attention: tensors on {q.device}; the kernel "
                         "runs on CUDA tensors")
    _check(q, k, v, bias, temperature)
    b, h, length, d = q.shape
    out = torch.empty_like(q)
    if b * h == 0:
        return out
    fn, error_string = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                out.data_ptr(), b, h, length, d, float(temperature), stream)
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed: "
                           f"{error_string(rc).decode()} (cudaError {rc}, "
                           f"B={b} H={h} L={length} D={d})")
    launches += 1
    return out
