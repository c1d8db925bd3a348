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


def clip_gradients(cfg: OptimConfig, optimizer: torch.optim.Optimizer):
    """With ``clip_grad`` on, scale each group's gradients to a total norm
    of at most ``clip_norm`` (the reference clips encoder and head
    separately)."""
    if not cfg.clip_grad:
        return
    for group in optimizer.param_groups:
        params = [p for p in group["params"] if p.grad is not None]
        if params:
            torch.nn.utils.clip_grad_norm_(params, cfg.clip_norm)
