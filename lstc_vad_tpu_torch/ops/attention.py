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
- the hand-written Hopper kernel (ops/cuda_attention.py,
  csrc/attention.cu), which keeps the [L, L] scores on chip.

Shapes: q, k, v: [B, H, L, D]; bias: [H, L, L] broadcast over batch;
mask: broadcastable to [B, H, L, L], nonzero = keep.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

MASK_FILL = -1e9
IMPLS = ("auto", "plain")


def plain_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               temperature: float,
               bias: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None,
               dropout_p: float = 0.0,
               return_probs: bool = False):
    """The plain version: f32 scores, -1e9 mask fill, bias add, f32
    softmax, optional dropout (active when ``dropout_p > 0``), optional
    probabilities."""
    attn = torch.matmul(q / temperature, k.transpose(-1, -2)).float()
    if mask is not None:
        attn = attn.masked_fill(mask == 0, MASK_FILL)
    if bias is not None:
        attn = attn + bias.to(attn.dtype)
    probs = torch.softmax(attn, dim=-1)
    if dropout_p > 0.0:
        probs = F.dropout(probs, dropout_p, training=True)
    out = torch.matmul(probs.to(v.dtype), v)
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
