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


def _payload(obj) -> Dict[str, Any]:
    if isinstance(obj, TrainState):
        return {"encoder": obj.encoder.state_dict(),
                "head": obj.head.state_dict(),
                "optimizer": obj.optimizer.state_dict(),
                "step": obj.step, "seed": obj.seed}
    return {"encoder": obj["encoder"], "head": obj["head"]}


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


def save_checkpoint(path: str, obj, asynchronous: bool = False):
    """Write ``obj`` (a ``TrainState``, or ``{"encoder": state_dict,
    "head": state_dict}``) to ``path`` through ``<path>.next``.

    ``asynchronous``: return once the state is copied to host memory; the
    write and the promotion go on in a background thread.  Either way a
    save in flight is committed first (it may own ``<path>.next``)."""
    global _pending
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    wait_for_saves()
    if not asynchronous:
        _write(_payload(obj), path)
        return
    _pending = _executor.submit(_write, _host_copy(_payload(obj)), path)


def load_checkpoint(path: str, target: TrainState = None):
    """The checkpoint at ``path`` (or its ``.next``, then ``.old``) on the
    CPU.  With a ``target`` state, a full-state checkpoint is loaded into
    it (modules strictly, optimizer, step and seed) and the state returned;
    a parameter checkpoint loads only the modules.  Without one, the dict."""
    path = os.path.abspath(path)
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
        target.encoder.load_state_dict(payload["encoder"], strict=True)
        target.head.load_state_dict(payload["head"], strict=True)
        if "optimizer" in payload:
            target.optimizer.load_state_dict(payload["optimizer"])
            target.step = int(payload["step"])
            target.seed = int(payload["seed"])
        return target
    raise err
