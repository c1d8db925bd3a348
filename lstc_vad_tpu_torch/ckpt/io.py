"""Checkpoints of the train state or of the parameters alone, written with
``torch.save`` — the counterpart of lstc_vad_tpu/ckpt/orbax_io.py.

- Full state (a ``TrainState``): the encoder's and head's state_dicts in the
  reference's key layout (so a state's ``"encoder"`` entry loads into the
  reference's module with ``strict=True``), the optimizer's state (Adagrad's
  accumulators and both groups), the step and the run's seed, which together
  give the next step's dropout masks: a resumed run continues exactly.
- Parameters alone: ``{"encoder": state_dict, "head": state_dict}``.

A save never destroys the previous checkpoint before the new one is whole on
disk (orbax_io.py:13-18, 62-80): it writes ``<path>.next``, parks the old
file at ``<path>.old``, promotes the new one with ``os.replace`` and only
then removes ``.old``.  ``load_checkpoint`` falls back to ``.next`` and then
``.old`` when ``path`` is missing or unreadable, and says which it restored.

``save_checkpoint(..., asynchronous=True)`` (the Trainer's periodic autosave)
copies every tensor to fresh host memory before it returns, since a train
step updates the parameters and Adagrad's sums in place, and then runs
``torch.save`` and the promotion in one background thread.  At most one save
is in flight: the next save, or ``wait_for_saves()``, waits for it first and
raises its error if its write failed (orbax_io.py:92-160).

On a mesh (a ``TrainState`` laid out on one, or ``mesh=``), every process
calls ``save_checkpoint``: the shards are gathered over "model" into the
full reference-layout state, rank 0 writes it, and a barrier follows
(orbax_io.py:39-89, 129).  ``load_checkpoint`` into a state on a mesh waits
for rank 0's save in flight and a barrier, then each process reads the whole
file and keeps its shards.  So a checkpoint written under any mesh loads in
one process, and the reverse, bit for bit.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

import torch

from ..train.state import TrainState

log = logging.getLogger("lstc_vad_tpu_torch")

# one worker: saves are written one at a time, in the order they were made
_executor = ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix="checkpoint-save")
_pending: Optional[Future] = None  # the asynchronous save in flight


def _payload(obj, mesh=None) -> Dict[str, Any]:
    """The checkpoint's content; on a mesh, gathered whole (a
    collective)."""
    if isinstance(obj, TrainState):
        out = {"encoder": obj.encoder.state_dict(),
               "head": obj.head.state_dict(),
               "optimizer": obj.optimizer.state_dict(),
               "step": obj.step, "seed": obj.seed}
    else:
        out = {"encoder": obj["encoder"], "head": obj["head"]}
    if mesh is None:
        return out
    from ..parallel.mesh import full_state_dict

    out["encoder"] = full_state_dict(out["encoder"], mesh)
    out["head"] = full_state_dict(out["head"], mesh)
    if "optimizer" in out:
        out["optimizer"] = _optimizer_state(obj.optimizer, out["optimizer"],
                                            mesh, gather=True)
    return out


def _optimizer_state(optimizer, sd, mesh, gather: bool):
    """Adagrad's accumulators gathered whole (``gather``) or cut to this
    process's shards; they mirror the parameters (parallel/mesh.py::
    state_shardings)."""
    from ..parallel.mesh import full_tensor, local_shard, state_shardings
    from ..parallel.tp import mesh_axis

    ax = mesh_axis(mesh, "model")
    dims = state_shardings(optimizer)
    fn = full_tensor if gather else local_shard
    state = {i: {k: (fn(v, dims[i], ax) if k == "sum" else v)
                 for k, v in s.items()} for i, s in sd["state"].items()}
    return {**sd, "state": state}


def _host_copy(obj):
    """``obj`` with every tensor copied to new host memory, synchronously:
    nothing a later in-place update writes can reach the copy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _replace_keeping_old(tmp: str, final: str):
    """Swap ``tmp`` over ``final`` with one whole checkpoint reachable at
    every instant: a crash between the steps leaves ``final``, or ``.old``
    and ``.next``, for ``load_checkpoint`` to find."""
    old = final + ".old"
    if os.path.exists(old):
        os.remove(old)
    if os.path.exists(final):
        os.replace(final, old)
    os.replace(tmp, final)
    if os.path.exists(old):
        os.remove(old)


def _write(payload, path: str):
    tmp = path + ".next"
    torch.save(payload, tmp)
    _replace_keeping_old(tmp, path)


def wait_for_saves():
    """Wait until the asynchronous save in flight, if any, is written and
    promoted; raise its error if it failed (the failed save is dropped, so
    the next save starts clean)."""
    global _pending
    pending, _pending = _pending, None
    if pending is not None:
        pending.result()


def save_checkpoint(path: str, obj, asynchronous: bool = False, mesh=None):
    """Write ``obj`` (a ``TrainState``, or ``{"encoder": state_dict,
    "head": state_dict}``) to ``path`` through ``<path>.next``.

    ``asynchronous``: return once the state is copied to host memory; the
    write and the promotion go on in a background thread.  Either way a
    save in flight is committed first (it may own ``<path>.next``).

    ``mesh`` (a state's own by default): ``obj`` holds this process's
    shards; every process must call, and rank 0 writes the whole."""
    global _pending
    if mesh is None and isinstance(obj, TrainState):
        mesh = obj.mesh
    path = os.path.abspath(path)
    payload = _payload(obj, mesh)
    from ..parallel.multihost import barrier, is_writer

    if is_writer(mesh):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        wait_for_saves()
        if not asynchronous:
            _write(payload, path)
        else:
            _pending = _executor.submit(_write, _host_copy(payload), path)
    if mesh is not None:
        barrier()


def load_checkpoint(path: str, target: TrainState = None):
    """The checkpoint at ``path`` (or its ``.next``, then ``.old``) on the
    CPU.  With a ``target`` state, a full-state checkpoint is loaded into
    it (modules strictly, optimizer, step and seed) and the state returned;
    a parameter checkpoint loads only the modules.  Without one, the dict."""
    path = os.path.abspath(path)
    mesh = getattr(target, "mesh", None)
    if mesh is not None:
        from ..parallel.multihost import barrier

        wait_for_saves()  # rank 0's save in flight, if any
        barrier()
    candidates = [p for p in (path, path + ".next", path + ".old")
                  if os.path.isfile(p)] or [path]
    err = None
    for p in candidates:
        try:
            payload = torch.load(p, map_location="cpu", weights_only=True)
        except Exception as e:  # noqa: BLE001
            # a partial write fails anywhere in the unpickler (EOFError,
            # KeyError, UnpicklingError, RuntimeError...): try the next
            # candidate, and raise the first error if none loads
            err = err or e
            continue
        if p != path:
            log.warning("checkpoint %s missing or unreadable; restored "
                        "fallback %s (its step may differ from the last "
                        "save)", path, p)
        if target is None:
            return payload
        if mesh is not None:
            from ..parallel.mesh import local_state_dict

            payload = {**payload,
                       "encoder": local_state_dict(payload["encoder"], mesh),
                       "head": local_state_dict(payload["head"], mesh)}
            if "optimizer" in payload:
                payload["optimizer"] = _optimizer_state(
                    target.optimizer, payload["optimizer"], mesh,
                    gather=False)
        target.encoder.load_state_dict(payload["encoder"], strict=True)
        target.head.load_state_dict(payload["head"], strict=True)
        if "optimizer" in payload:
            target.optimizer.load_state_dict(payload["optimizer"])
            target.step = int(payload["step"])
            target.seed = int(payload["seed"])
        return target
    raise err
