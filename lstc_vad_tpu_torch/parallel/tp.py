"""The collectives of a sharded run, written out: what GSPMD inserts for the
JAX package (lstc_vad_tpu/parallel/mesh.py) is code here.

- ``Axis``: one process's place on a mesh axis (its group, rank, size).
- ``copy_to_model`` / ``reduce_from_model``: the two edges of a
  tensor-parallel block.  A column-parallel Linear reads its replicated
  input through ``copy_to_model`` (identity forward, gradient summed over
  "model" backward); a row-parallel Linear's partial products go through
  ``reduce_from_model`` (summed over "model" forward, identity backward),
  and only then is its bias added, once.
- ``gather_batch``: the per-video outputs of every data rank, in the global
  batch's row order, with a backward that hands each rank the gradient of
  its own rows.  Every rank then computes the same loss of the whole batch
  (the MIL hinge pairs every normal video with every abnormal one), so the
  parameters' gradients are partial sums over each rank's rows and are
  summed over "data" (``all_reduce_grads``), never averaged.
- ``BatchLayout`` and ``dropout``: a sharded step draws every dropout mask
  (and every stochastic-rounding noise tensor) at its global shape from the
  step's generators, as the unsharded step draws it, and takes this rank's
  rows and model columns, so masks do not depend on the partition.  Each
  rank draws the whole mask: dp x tp times the generator work of its own
  slice.  ``remat_contexts`` carries the layout into a rematerialized
  layer's recompute, which runs in the backward, outside the step's
  forward.

An axis of one rank moves nothing: every collective here is then skipped
and every mask drawn as the unsharded modules draw it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Axis:
    """One process's place on a mesh axis."""

    group: object  # a torch.distributed ProcessGroup
    rank: int
    size: int


def mesh_axis(mesh, name: str) -> Axis:
    return Axis(mesh.get_group(name), mesh.get_local_rank(name),
                mesh.size(mesh.mesh_dim_names.index(name)))


def _all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=axis.group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceFromModel.apply(x, axis)


def all_gather_rows(x: torch.Tensor, axis: Axis) -> List[torch.Tensor]:
    """Every rank's ``x`` (of one shape), in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return parts


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, blocks):
        ctx.axis, ctx.blocks = axis, blocks
        parts = all_gather_rows(x, axis)
        # [size, blocks, rows of a block, ...] -> [blocks, size, ...]
        stacked = torch.stack(parts).unflatten(1, (blocks, -1))
        return stacked.transpose(0, 1).flatten(0, 2)

    @staticmethod
    def backward(ctx, grad):
        axis, blocks = ctx.axis, ctx.blocks
        g = grad.unflatten(0, (blocks, axis.size, -1))[:, axis.rank]
        return g.flatten(0, 1), None, None


def gather_batch(x: torch.Tensor, axis: Optional[Axis],
                 blocks: int = 1) -> torch.Tensor:
    """The global batch of per-row outputs from this rank's ``x``: its
    leading axis is ``blocks`` equal blocks (the normal and the abnormal
    videos of a step: 2), each this rank's contiguous share of the global
    block.  The gradient of this rank's rows flows back to it.  ``x`` itself
    when ``axis`` is None."""
    if axis is None or axis.size == 1:
        return x
    return _GatherBatch.apply(x, axis, blocks)


def all_reduce_grads(params: Sequence[torch.Tensor], axis: Axis):
    """Sum the gradients of ``params`` over ``axis`` in one collective per
    type (parameters without a gradient are skipped, on every rank
    alike)."""
    if axis.size == 1:
        return
    by_type = {}
    for p in params:
        if p.grad is not None:
            by_type.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_type.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=axis.group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


# -------------------------------------------------------------- the layout

@dataclasses.dataclass(frozen=True)
class BatchLayout:
    """Where this rank's rows sit in the global batch: the leading axis of
    every activation is ``blocks`` blocks, each holding this data rank's
    contiguous share of the global block."""

    rank: int
    size: int
    blocks: int = 2

    def rows(self, n_local: int, device) -> torch.Tensor:
        block = n_local // self.blocks
        start = torch.arange(self.blocks, device=device) * block * self.size
        return (start[:, None] + self.rank * block
                + torch.arange(block, device=device)).reshape(-1)


_LAYOUT: contextvars.ContextVar = contextvars.ContextVar(
    "lstc_vad_batch_layout", default=None)


@contextlib.contextmanager
def batch_layout(layout: Optional[BatchLayout]):
    """Run the body with ``layout`` as the current step's (None: no
    sharded step)."""
    token = _LAYOUT.set(layout)
    try:
        yield
    finally:
        _LAYOUT.reset(token)


def remat_contexts():
    """``context_fn`` for ``torch.utils.checkpoint``: the recompute of a
    layer runs in the backward, outside the step's ``batch_layout`` (and on
    a CUDA tensor in autograd's device thread), so it re-enters the layout
    current at the forward and draws the same global masks and noise."""
    return contextlib.nullcontext(), batch_layout(_LAYOUT.get())


def sharded(cols: Optional[Axis] = None) -> bool:
    """Whether a mask must be drawn at a global shape and sliced: inside a
    step whose data axis has more than one rank, or for a tensor split over
    a model axis ``cols`` of more than one."""
    layout = _LAYOUT.get()
    return ((layout is not None and layout.size > 1)
            or (cols is not None and cols.size > 1))


def draw_global(shape: Sequence[int], draw: Callable[[list], torch.Tensor],
                cols: Optional[Axis] = None, col_dim: int = -1,
                rows: bool = True) -> torch.Tensor:
    """A random tensor of the local ``shape`` cut from one drawn at the
    global shape by ``draw(global_shape)``: the leading axis grown by the
    current layout's data size (``rows``; none outside a sharded step) and
    ``col_dim`` by ``cols.size``."""
    layout = _LAYOUT.get() if rows else None
    shape = list(shape)
    full = list(shape)
    if layout is not None:
        full[0] *= layout.size
    if cols is not None:
        full[col_dim] *= cols.size
    out = draw(full)
    if layout is not None and layout.size > 1:
        out = out.index_select(0, layout.rows(shape[0], out.device))
    if cols is not None and cols.size > 1:
        n = shape[col_dim]
        # a copy: a view would hold the whole draw alive until backward
        out = out.narrow(col_dim, cols.rank * n, n).contiguous()
    return out


def dropout_noise(shape, p: float, dtype, device,
                  cols: Optional[Axis] = None, col_dim: int = -1
                  ) -> torch.Tensor:
    """The scaled keep mask (0 or 1/(1-p)) dropout multiplies by, drawn as
    ``F.dropout`` draws it for a tensor of the global shape."""
    return draw_global(shape, lambda full: F.dropout(
        torch.ones(full, dtype=dtype, device=device), p, training=True),
        cols, col_dim)


def dropout(module: nn.Dropout, x: torch.Tensor,
            cols: Optional[Axis] = None) -> torch.Tensor:
    """``module(x)``; inside a sharded step, or on a tensor whose last axis
    is split over ``cols``, with the mask drawn at the global shape."""
    if not module.training or module.p == 0.0 or not sharded(cols):
        return module(x)
    return x * dropout_noise(x.shape, module.p, x.dtype, x.device, cols)
