"""Optimizer: Adagrad with two learning-rate groups — PyTorch counterpart of
lstc_vad_tpu/train/optim.py:14-82.

The reference trains with torch.optim.Adagrad over two parameter groups,
encoder at ``lr_encoder`` (1e-4) and head at ``lr_head`` (1e-2), with a shared
``weight_decay`` (Train/spatio_transformer_shanghaitech.py:76-78) and optional
per-model gradient-norm clipping at 10 (:105-107).  Here that is
``torch.optim.Adagrad`` itself (``eps`` and ``initial_accumulator_value``
from the config), and ``clip_gradients`` clips each group's RAW gradients
before ``step`` adds the weight decay, the order of the reference and of the
JAX chain (clip -> add_decayed_weights -> rss -> -lr).

A parameter whose gradient is ``None`` (a module the config leaves unused,
such as the input LayerNorm with ``input_layernorm`` off) is skipped by both,
as in the reference; the JAX package has no such parameter at all.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..config import OptimConfig

GROUPS = ("encoder", "head")


def make_optimizer(cfg: OptimConfig, encoder: torch.nn.Module,
                   head: torch.nn.Module) -> torch.optim.Adagrad:
    """Adagrad over two groups, named by their ``"name"`` key."""
    return torch.optim.Adagrad(
        [{"params": list(encoder.parameters()), "lr": cfg.lr_encoder,
          "name": "encoder"},
         {"params": list(head.parameters()), "lr": cfg.lr_head,
          "name": "head"}],
        weight_decay=cfg.weight_decay, eps=cfg.adagrad_eps,
        initial_accumulator_value=cfg.initial_accumulator)


def clip_gradients(cfg: OptimConfig, optimizer: torch.optim.Optimizer,
                   mesh=None) -> List[Optional[torch.Tensor]]:
    """With ``clip_grad`` on, scale each group's gradients to a total norm
    of at most ``clip_norm`` (the reference clips encoder and head
    separately).  Returns each group's norm before clipping (None: no
    gradient, or clipping off).

    ``mesh``: the gradients of parameters split over "model" are this
    process's shards, so their squares are summed over the model axis; a
    replicated parameter is counted once."""
    from ..parallel.tp import mesh_axis

    norms: List[Optional[torch.Tensor]] = []
    if not cfg.clip_grad:
        return norms
    if mesh is not None and mesh_axis(mesh, "model").size == 1:
        mesh = None  # every gradient is whole
    for group in optimizer.param_groups:
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            norms.append(None)
        elif mesh is None:
            norms.append(torch.nn.utils.clip_grad_norm_(params,
                                                        cfg.clip_norm))
        else:
            norms.append(_clip_sharded(params, cfg.clip_norm, mesh))
    return norms


def _clip_sharded(params, max_norm: float, mesh) -> torch.Tensor:
    """``clip_grad_norm_`` over parameters some of which are model
    shards."""
    import torch.distributed as dist

    from ..parallel.tp import mesh_axis

    def sq(ps):
        return sum((p.grad.float().pow(2).sum() for p in ps),
                   torch.zeros((), device=params[0].grad.device))

    split = [p for p in params if getattr(p, "tp_dim", None) is not None]
    whole = [p for p in params if getattr(p, "tp_dim", None) is None]
    split_sq = sq(split)
    dist.all_reduce(split_sq, group=mesh_axis(mesh, "model").group)
    total = (sq(whole) + split_sq).sqrt()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in params:
        p.grad.mul_(coef.to(p.grad.dtype))
    return total
