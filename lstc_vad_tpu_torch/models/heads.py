"""Scoring heads — PyTorch counterpart of lstc_vad_tpu/models/heads.py.

- ``Regressor`` (STN): d -> hidden -> 32 -> 1 with Sigmoid
  (reference models/Regressor.py:4-21).  Dropout after BOTH the first
  (post-ReLU) and second linear — the second has no activation before its
  dropout, exactly as the reference Sequential is wired.
- ``Classifier`` (LTN): d -> 512 -> 32 -> 2 with Softmax INSIDE the module
  (models/Classifier.py:5-23).

Each is one ``nn.Sequential`` attribute named after the module, with its
Linears at indices 0/3/5 — the reference's state_dict keys
(``classifier.0.weight`` ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..parallel import tp as tpc
from . import initializers as init
from .encoder import sharded_dense


def _check_width(x: torch.Tensor, d_model: int):
    """The reference heads' first Linear has in_features=d_model and errors
    on a width mismatch; say so with the JAX package's message."""
    if x.shape[-1] != d_model:
        raise ValueError(f"head configured for d_model={d_model} got input "
                         f"width {x.shape[-1]}")


def _mlp(d_model, hidden_dim, n_out, dropout, last, device):
    return nn.Sequential(
        nn.Linear(d_model, hidden_dim, device=device), nn.ReLU(),
        nn.Dropout(dropout),
        nn.Linear(hidden_dim, 32, device=device), nn.Dropout(dropout),
        nn.Linear(32, n_out, device=device), last)


class _Head(nn.Module):
    kind = ""

    def __init__(self, d_model: int = 2048, hidden_dim: int = 512,
                 dropout: float = 0.6, weight_init: bool = False,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.weight_init = weight_init
        n_out, last = ((1, nn.Sigmoid()) if self.kind == "regressor"
                       else (2, nn.Softmax(dim=-1)))
        setattr(self, self.kind,
                _mlp(d_model, hidden_dim, n_out, dropout, last, device))
        self.tp = None  # the model axis, when laid out on a mesh

    def reset_parameters(self, generator: torch.Generator):
        for i in (0, 3, 5):
            init.torch_linear_(getattr(self, self.kind)[i], generator,
                               self.weight_init)
        return self

    def forward(self, x):
        """x: [..., d_model] in any float type; the head runs in f32 on
        it, as flax promotes a bf16 encoder output with the head's f32
        parameters (lstc_vad_tpu/models/heads.py, Dense with dtype=None)."""
        _check_width(x, self.d_model)
        mlp = getattr(self, self.kind)
        tp = self.tp
        if tp is None:
            return mlp(x.float())
        # on a mesh: the first Linear column-parallel, the second
        # row-parallel, the last replicated; every product on F.linear, as
        # nn.Linear computes it off the mesh
        f32 = torch.float32
        x = torch.relu(sharded_dense(mlp[0], tpc.copy_to_model(x.float(), tp),
                                     f32, False, tp, row=False,
                                     f32_linear=F.linear))
        x = sharded_dense(mlp[3], tpc.dropout(mlp[2], x, cols=tp), f32,
                          False, tp, row=True, f32_linear=F.linear)
        return mlp[6](mlp[5](tpc.dropout(mlp[4], x)))


class Regressor(_Head):
    kind = "regressor"


class Classifier(_Head):
    kind = "classifier"


def make_head(kind: str, d_model: int, hidden_dim: int = 512,
              dropout: float = 0.6, weight_init: bool = False, device="cuda"):
    if kind == "regressor":
        return Regressor(d_model, hidden_dim, dropout, weight_init, device)
    if kind == "classifier":
        return Classifier(d_model, hidden_dim, dropout, weight_init, device)
    raise ValueError(f"unknown head kind {kind!r}")
