"""Device mesh and the tensor-parallel layout — counterpart of
lstc_vad_tpu/parallel/mesh.py.

A mesh is a ``torch.distributed`` DeviceMesh of shape (data, model),
``mesh_dim_names=("data", "model")``, over the process group every process
of the run joined (parallel/distributed.py), one process per device.  Ranks
are laid out row-major, so the processes of one "model" group are
consecutive ranks.  Batches are split over "data"; attention heads, FFN
hidden units and the head MLP's hidden units over "model" (``_TP_RULES``);
everything else is replicated.  The collectives at the layers' edges are
parallel/tp.py's.

The reference's only parallelism is single-process nn.DataParallel
(Train/spatio_transformer_shanghaitech.py:69-71); the scalable axes are the
batch (dp) and the d_model=2048 / d_inner=4096 contractions (tp).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .tp import Axis, all_gather_rows, mesh_axis


def factor_devices(n: int, n_head: int = 8,
                   max_model: int = 4) -> Tuple[int, int]:
    """Split n devices into (data, model).  The model axis divides the head
    count (heads shard evenly) and is the largest power of 2 <= max_model
    that still leaves data >= 2 whenever n >= 4; the rest goes to data:
    4 -> (2, 2), 8 -> (2, 4), 16 -> (4, 4), 32 -> (8, 4)."""
    model = 1
    m = 2
    while m <= max_model and n % m == 0 and n_head % m == 0:
        if n // m >= 2 or n <= 2:
            model = m
        m *= 2
    return n // model, model


_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(data: int, model: int = 1, device_type: str = "cpu"):
    """The (data, model) DeviceMesh over the initialized process group, on
    ``device_type`` ("cuda" over NCCL, "cpu" over gloo).  The mesh covers
    every process of the group."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized process group: launch the processes "
            "with torchrun, or join them with --multihost "
            "(parallel/distributed.py)")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} "
                         f"processes; the process group has {world}")
    backend = dist.get_backend()
    if _BACKEND.get(device_type) != backend:
        raise ValueError(f"a {device_type} mesh needs the "
                         f"{_BACKEND.get(device_type)} backend; the process "
                         f"group runs {backend}")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def batch_sharding(mesh, n: int) -> slice:
    """This process's rows of a leading batch axis of ``n`` split over
    "data"."""
    ax = mesh_axis(mesh, "data")
    if n % ax.size:
        raise ValueError(f"a batch of {n} does not split over a data axis "
                         f"of {ax.size}")
    m = n // ax.size
    return slice(ax.rank * m, (ax.rank + 1) * m)


# (regex on the reference-layout parameter name) -> the dim split over
# "model".  torch Linear weights are [out, in]: a JAX kernel split
# P(None, "model") is split here on dim 0, P("model", None) on dim 1.
_TP_RULES = (
    # attention input projections: heads
    (r"slf_attn\.w_[qkv]s\.weight$", 0),
    # attention output projection: its inputs (heads)
    (r"slf_attn\.fc\.weight$", 1),
    # relative position bias table [table, n_head]: heads
    (r"relative_position_bias_table$", 1),
    # FFN: hidden units
    (r"pos_ffn\.w_1\.(weight|bias)$", 0),
    (r"pos_ffn\.w_2\.weight$", 1),
    # head MLP: its first Linear's outputs, its second's inputs
    (r"(classifier|regressor)\.0\.(weight|bias)$", 0),
    (r"(classifier|regressor)\.3\.weight$", 1),
)


def param_sharding_rules(name: str) -> Optional[int]:
    """The dim of parameter ``name`` split over "model"; None: replicated
    (LayerNorms, the row-parallel biases, CLS/PE tables, the head's last
    Linear)."""
    for pattern, dim in _TP_RULES:
        if re.search(pattern, name):
            return dim
    return None


def local_shard(full: torch.Tensor, dim: Optional[int], axis: Axis
                ) -> torch.Tensor:
    """This process's slice of ``full`` along ``dim``, split over ``axis``
    (``full`` itself when ``dim`` is None)."""
    if dim is None:
        return full
    if full.shape[dim] % axis.size:
        raise ValueError(f"a dim of {full.shape[dim]} does not split over a "
                         f"model axis of {axis.size}")
    n = full.shape[dim] // axis.size
    return full.narrow(dim, axis.rank * n, n).clone()


def full_tensor(local: torch.Tensor, dim: Optional[int], axis: Axis
                ) -> torch.Tensor:
    """The whole tensor from every rank's ``local`` slice along ``dim``: a
    collective, which every rank of ``axis`` calls in the same order."""
    if dim is None:
        return local
    return torch.cat(all_gather_rows(local, axis), dim=dim)


def local_state_dict(state_dict, mesh) -> Dict[str, torch.Tensor]:
    """A full reference-layout state_dict -> this process's shards."""
    ax = mesh_axis(mesh, "model")
    return {k: local_shard(v, param_sharding_rules(k), ax)
            for k, v in state_dict.items()}


def full_state_dict(state_dict, mesh) -> Dict[str, torch.Tensor]:
    """This process's shards -> the full state_dict, gathered over "model"
    (a collective)."""
    ax = mesh_axis(mesh, "model")
    return {k: full_tensor(v, param_sharding_rules(k), ax)
            for k, v in state_dict.items()}


def _tp_modules(module: nn.Module):
    from ..models.encoder import FeedForward, MultiHeadAttention
    from ..models.heads import _Head

    return [m for m in module.modules()
            if isinstance(m, (MultiHeadAttention, FeedForward, _Head))]


def shard_params(module: nn.Module, mesh) -> nn.Module:
    """Lay ``module`` (an Encoder or a head, built at full size) out on
    ``mesh`` in place: each parameter a rule splits becomes this process's
    shard (``tp_dim`` names the split dim), the attention, FFN and head
    modules learn their model axis (``tp``), and ``module.mesh`` is set,
    which the scorers read.  Parameter names and the replicated parameters
    stay as they were."""
    ax = mesh_axis(mesh, "model")
    for name, p in list(module.named_parameters()):
        dim = param_sharding_rules(name)
        if dim is None:
            continue
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        shard = nn.Parameter(local_shard(p.detach(), dim, ax),
                             requires_grad=p.requires_grad)
        shard.tp_dim = dim
        setattr(owner, attr, shard)
    for m in _tp_modules(module):
        m.tp = ax
    module.mesh = mesh
    return module


def state_shardings(optimizer: torch.optim.Optimizer):
    """The split dim of every parameter of ``optimizer``, in the order of
    its state_dict's indices: Adagrad's accumulators mirror the
    parameters."""
    return [getattr(p, "tp_dim", None)
            for g in optimizer.param_groups for p in g["params"]]
