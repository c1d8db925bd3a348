"""Training state — PyTorch counterpart of lstc_vad_tpu/train/state.py:21-58.

The JAX state is one pytree (params, optimizer state, step, PRNG key).  Here
it holds the two modules, their optimizer, an int step and the run's seed;
the step's dropout masks are drawn from a generator seeded from (seed, step)
(train/steps.py), so the seed and the step stand in for the threaded PRNG
key.  A train step updates the modules and the optimizer in place.  On a
mesh (``mesh``), the modules hold this process's shards of the parameters
and the optimizer their accumulators (parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import TrainConfig
from ..device import resolve_device
from ..models import build
from .optim import make_optimizer


@dataclasses.dataclass
class TrainState:
    encoder: torch.nn.Module
    head: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    seed: int
    mesh: Optional[object] = None  # a (data, model) DeviceMesh

    @property
    def device(self) -> torch.device:
        return next(self.encoder.parameters()).device


def create_train_state(cfg: TrainConfig, device="cuda",
                       seed: Optional[int] = None, mesh=None) -> TrainState:
    """Encoder and head of ``cfg`` on ``device`` (the card unless told the
    CPU), weights drawn from a generator seeded ``seed`` (``cfg.seed`` by
    default), both in train mode, and their two-group Adagrad.  ``mesh``:
    the weights are drawn whole, as without one, and each process keeps
    its shards (parallel/mesh.py::shard_params)."""
    seed = cfg.seed if seed is None else seed
    encoder, head = build(cfg, device=resolve_device(device), seed=seed)
    if mesh is not None:
        from ..parallel.mesh import shard_params

        shard_params(encoder, mesh)
        shard_params(head, mesh)
    encoder.train()
    head.train()
    return TrainState(encoder, head, make_optimizer(cfg.optim, encoder, head),
                      step=0, seed=seed, mesh=mesh)
