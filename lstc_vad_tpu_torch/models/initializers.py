"""Parameter initializers, drawn from an explicit ``torch.Generator``.

PyTorch counterparts of lstc_vad_tpu/models/initializers.py.  The two
packages draw different numbers from the same seed, so these match the JAX
initializers in distribution only; parity tests move weights across with
ckpt/interop.py instead.

- ``torch_linear_``: nn.Linear's default, kaiming_uniform(a=sqrt(5)), which
  is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the weight and for the bias.
- ``xavier_uniform_``: torch's xavier with torch's fans, used when a reference
  script passes *_weight_init (models/Encoder.py:38-41) — on every parameter
  with dim > 1, the relative-position table and the CLS/PE tables included.
- ``trunc_normal_02_``: trunc_normal(std=.02) for the relative-position bias
  table when xavier init is off (models/MultiHeadAttention.py:74,90).  torch
  truncates at the ABSOLUTE bounds -2 and 2, i.e. +/-100 sigma.
- ``randn_``: the standard normal of the learned CLS and PE tables.

The generator must live on the tensors' device.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    return t.uniform_(-bound, bound, generator=generator)


def torch_linear_(linear: nn.Linear, generator: torch.Generator,
                  weight_init: bool = False):
    """Weight: xavier if ``weight_init`` else U(+/-1/sqrt(fan_in)); bias (if
    any): U(+/-1/sqrt(fan_in)) either way, as the JAX package draws it."""
    bound = 1.0 / math.sqrt(linear.in_features)
    if weight_init:
        xavier_uniform_(linear.weight, generator)
    else:
        uniform_(linear.weight, bound, generator)
    if linear.bias is not None:
        uniform_(linear.bias, bound, generator)


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, generator: torch.Generator):
    return nn.init.xavier_uniform_(t, generator=generator)


@torch.no_grad()
def trunc_normal_02_(t: torch.Tensor, generator: torch.Generator):
    return nn.init.trunc_normal_(t, std=0.02, a=-2.0, b=2.0,
                                 generator=generator)


@torch.no_grad()
def randn_(t: torch.Tensor, generator: torch.Generator):
    return t.normal_(0.0, 1.0, generator=generator)


@torch.no_grad()
def layer_norm_(ln: nn.LayerNorm):
    nn.init.ones_(ln.weight)
    nn.init.zeros_(ln.bias)
