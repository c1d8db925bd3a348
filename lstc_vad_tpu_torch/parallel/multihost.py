"""Host values onto the mesh and sharded results back — counterpart of
lstc_vad_tpu/parallel/multihost.py.

Contract: every process runs the same host-side pipeline, so identical
seeds give identical numpy batches, and ``to_global`` hands each process
its rows; no process copies another's features to its device.  Replicated
outputs (losses, metrics) are read directly; data-sharded ones (per-part
eval scores) come back through ``fetch``, an all-gather over "data" run in
program order on every process.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import batch_sharding
from .tp import all_gather_rows, mesh_axis


def to_global(batch, mesh):
    """A train batch ``(norm_feats, norm_labs, abnorm_feats, abnorm_labs)``
    as one process takes it: its rows of the two feature arrays over
    "data", the labels whole (the loss is a function of the whole batch,
    train/steps.py)."""
    norm, norm_labs, abnorm, abnorm_labs = batch
    rows = batch_sharding(mesh, len(norm))
    return norm[rows], norm_labs, abnorm[rows], abnorm_labs


def fetch(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's ``x`` concatenated on the leading axis, on every
    process (a collective; ``x`` itself on a data axis of one)."""
    axis = mesh_axis(mesh, "data")
    return x if axis.size == 1 else torch.cat(all_gather_rows(x, axis))


def barrier():
    """Wait for every process of the run (nothing when there is no
    process group)."""
    if dist.is_initialized():
        dist.barrier()


def is_writer(mesh=None) -> bool:
    """The process that writes a run's files: rank 0, or the only one."""
    return mesh is None or not dist.is_initialized() or dist.get_rank() == 0

