"""Scaled dot-product attention with additive bias — the hot op.

Semantics (reference models/MultiHeadAttention.py:103-120, and
lstc_vad_tpu/ops/attention.py:34-86):
    attn = (q / temperature) @ k^T        # temperature = d_k ** 0.5
    attn = where(mask == 0, -1e9, attn)   # optional
    attn += bias                          # optional additive [H, L, L] bias
    attn = dropout(softmax(attn))
    out  = attn @ v

Two implementations:
- ``plain_sdpa``: plain PyTorch ops.  It runs on a CPU tensor, it is what the
  tests compare with the JAX package, and it is what the CUDA kernel is held
  against on the card.
- the hand-written Hopper kernels (ops/cuda_attention.py; csrc/attention.cu
  on f32 tensors, csrc/attention_bf16.cu on bf16 ones), which keep the
  [L, L] scores on chip.

Shapes: q, k, v: [B, H, L, D]; bias: [H, L, L] broadcast over batch;
mask: broadcastable to [B, H, L, L], nonzero = keep.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

MASK_FILL = -1e9
IMPLS = ("auto", "plain")


def scalar_in(x: float, dtype: torch.dtype) -> float:
    """The Python float ``x`` rounded to ``dtype`` where that is narrower
    than f32 (the value a weakly typed JAX scalar takes); ``x`` itself
    otherwise.  At every preset the temperature is 16, which bf16 holds
    exactly."""
    if dtype in (torch.float32, torch.float64):
        return x
    return torch.tensor(x, dtype=dtype).item()


def _at_least_f32(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.element_size() < 4 else t


def plain_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               temperature: float,
               bias: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None,
               dropout_p: float = 0.0,
               return_probs: bool = False):
    """The plain version: f32 scores, -1e9 mask fill, bias add, f32
    softmax, optional dropout (active when ``dropout_p > 0``), optional
    probabilities.

    On bf16 q, k, v (``encoder.compute_dtype="bfloat16"``) it computes what
    lstc_vad_tpu/ops/attention.py::_xla_sdpa does with
    ``preferred_element_type=float32``: q divided by the temperature rounded
    to bf16 (JAX's weakly typed scalar takes q's type), the quotient rounded
    to bf16, both products on f32 copies of the bf16 operands (exact
    products, f32 sums), the probabilities rounded to v's type before P·V,
    the output rounded to it.  On f32 (and f64) inputs every cast is the
    identity."""
    qs = _at_least_f32(q / scalar_in(temperature, q.dtype))
    attn = torch.matmul(qs, _at_least_f32(k).transpose(-1, -2))
    if mask is not None:
        attn = attn.masked_fill(mask == 0, MASK_FILL)
    if bias is not None:
        attn = attn + bias.to(attn.dtype)
    probs = torch.softmax(attn, dim=-1)
    if dropout_p > 0.0:
        probs = F.dropout(probs, dropout_p, training=True)
    out = torch.matmul(_at_least_f32(probs.to(v.dtype)),
                       _at_least_f32(v)).to(v.dtype)
    if return_probs:
        return out, probs
    return out


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         temperature: float,
         bias: Optional[torch.Tensor] = None,
         mask: Optional[torch.Tensor] = None,
         dropout_p: float = 0.0,
         impl: str = "auto",
         return_probs: bool = False):
    """Dispatching SDPA.  ``impl``:

    - "auto": the CUDA kernel on a CUDA tensor, the plain version on a CPU
      tensor (the kernel's wrapper makes that choice by device);
    - "plain": the plain version on any device (tests and chip_smoke.py hold
      the kernel against it).

    A mask, active dropout or ``return_probs`` takes the plain path: the
    kernel computes none of them.  That choice is made from the arguments,
    never by catching a kernel failure."""
    if impl not in IMPLS:
        # a typo'd config knob must not silently run the plain path while
        # the user believes they are exercising the kernel
        raise ValueError(f"unknown attention impl {impl!r}; "
                         f"expected one of {IMPLS}")
    if impl == "plain" or mask is not None or dropout_p > 0.0 \
            or return_probs:
        return plain_sdpa(q, k, v, temperature, bias=bias, mask=mask,
                          dropout_p=dropout_p, return_probs=return_probs)
    from .cuda_attention import attention

    return attention(q, k, v, bias, temperature)
