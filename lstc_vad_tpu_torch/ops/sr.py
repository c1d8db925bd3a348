"""Stochastic-rounding float32 -> bfloat16 cast — PyTorch counterpart of
lstc_vad_tpu/ops/sr.py.

Round-to-nearest is biased conditional on the value: the same weights round
the same way on every step, so the error never averages out.  Stochastic
rounding (Gupta et al. 2015) rounds up with probability proportional to the
truncated remainder, so E[sr_cast(x)] == x and the rounding error becomes
zero-mean noise the optimizer averages over steps.  It is the cast in front
of every matmul of the encoder's ``cast_sr`` train passes
(models/encoder.py).

bfloat16 is the top 16 bits of float32, so the cast is integer arithmetic on
the bits: add a uniform 16-bit value to the low half and truncate.  A
mantissa overflow carries into the exponent, which lands exactly on the next
representable bf16.  NaN and ±Inf pass through as the plain cast gives them
(the add could wrap a high-payload NaN through the sign bit into ±0.0).

The noise comes from PyTorch's default generator of the input's device
(``torch.randint``), the generator ``torch.utils.checkpoint`` restores for a
recompute, so a rematerialized layer draws the same noise again.  It is not
the JAX package's noise; given the same 16-bit noise (``noise=``) the two
casts agree bit for bit.  No kernel is needed: JAX's is plain jnp too.
"""

from __future__ import annotations

from typing import Optional

import torch

_HIGH = -65536  # 0xFFFF0000 as an int32: the bits a bf16 keeps


def sr_noise(x: torch.Tensor) -> torch.Tensor:
    """Uniform 16-bit noise in an int32 tensor of x's shape, from the
    default generator of x's device."""
    return torch.randint(0, 1 << 16, x.shape, dtype=torch.int32,
                         device=x.device)


class _SRCast(torch.autograd.Function):
    """The cast with a straight-through gradient: the gradient of the
    identity cast, as the JAX custom_jvp gives."""

    @staticmethod
    def forward(ctx, x, noise):
        rounded = (x.view(torch.int32) + noise) & _HIGH
        sr = rounded.view(torch.float32).to(torch.bfloat16)
        return torch.where(torch.isfinite(x), sr, x.to(torch.bfloat16))

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.float32), None


def sr_cast(x: torch.Tensor, noise: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """float32 -> bfloat16 with stochastic rounding, unbiased over the
    noise.  ``noise``: int32 values in [0, 2^16) of x's shape; drawn with
    ``sr_noise`` when None.  Values exactly representable in bf16 come back
    exactly under any noise.  Non-f32 inputs pass through ``.to(bfloat16)``:
    there is no cast to randomize."""
    if x.dtype != torch.float32:
        return x.to(torch.bfloat16)
    if noise is None:
        noise = sr_noise(x)
    return _SRCast.apply(x, noise)


def sr_linear(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear`` on stochastically rounded bf16 casts of x, the weight
    and the bias; the output stays bf16, as lstc_vad_tpu/models/encoder.py::
    _SRLinear's does.  The three noise draws come in the order x, weight,
    bias."""
    xs = sr_cast(x)
    ws = sr_cast(weight)
    y = torch.nn.functional.linear(xs, ws)
    if bias is not None:
        y = y + sr_cast(bias)
    return y
