"""Tracing — the counterpart of lstc_vad_tpu/utils/profiling.py:1-60 on
``torch.profiler``.

- ``annotate(name)``: the program's one span call.  While a profiler runs
  it returns ``torch.profiler.record_function(name)``, a span in the same
  Kineto timeline as the device's kernels and copies; otherwise a shared
  ``contextlib.nullcontext``, so a span costs well under a microsecond
  with tracing off.  ``name`` must be one of ``SPANS`` (checked only while
  a profiler runs).
- ``SPANS``: every span name the program records, each with its meaning.
  Spans sit at layer boundaries of the eval pass and the train epoch,
  never one per part, clip or kernel launch; the two operator spans
  (``linear.pad``, ``attention.plain``) come once per encoder layer call.
- ``trace(logdir)``: a context manager that profiles the host, every
  thread of it, and, when a card is visible, the device, and writes a
  Chrome trace (``<logdir>/trace.json``, viewable in Perfetto or
  chrome://tracing).
- ``device_busy_ms(path)``: the device's busy time in a written trace, the
  union of its kernel, copy and memset intervals.

This module imports no torch: a torch-free serving worker imports the
package's logging.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

TRACE_FILE = "trace.json"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

SPANS = {
    # evaluation drivers (evaluation/drivers.py)
    "eval.score": "the scorer's score_videos over the split",
    "eval.frames": "part or clip scores expanded to frames, labels, AUC",
    # scorers (evaluation/scoring.py)
    "scorer.read_wait": "the consumer waiting for the reader's next video",
    "scorer.read": "the reader thread loading one video's features",
    "scorer.pack": "one video: slices, part plan, binning, chunk fill "
                   "(inline, or submitted to the copy threads), flush",
    "scorer.alloc": "a new pinned chunk buffer",
    "scorer.fill": "a copy thread copying one row range into a chunk buffer",
    "scorer.fill_wait": "the unit thread waiting for pooled copies to land: "
                        "a chunk's before its dispatch, the oldest video's "
                        "at the cap, every one when the packer is left",
    "scorer.dispatch": "one device call: cast, copies and forward enqueued",
    "scorer.h2d": "the chunk's host-to-device copy enqueued",
    "scorer.forward": "the encoder and head enqueued",
    "scorer.d2h": "the pinned score buffer, its copy and the ready event",
    "scorer.wait": "the host blocked until a call's scores are on the host",
    # trainer (train/driver.py)
    "train.epoch": "Trainer.train_epoch",
    "train.sync": "the epoch's closing metrics read (waits for the card)",
    # batch pipeline (data/pipeline.py)
    "batch.start": "a BatchWorker's side stream and thread started (once "
                   "per worker: the Trainer's lasts across epochs)",
    "batch.wait": "the consumer waiting for the worker's next batch",
    "batch.build": "the worker building one batch (store reads, sampling), "
                   "this epoch's or, ahead of it, the next one's",
    "batch.stage": "the worker's pinned copy or cast and H2D enqueue",
    "batch.discard": "prepared batches dropped at an epoch's start, since "
                     "the dataset no longer draws what they were drawn "
                     "from: the worker stopped and its queue emptied",
    # train step (train/steps.py)
    "step.forward": "the loss under the step's RNG and layout contexts",
    "step.backward": "the backward and the gradient all-reduce",
    "step.optim": "gradient clipping and the Adagrad update",
    # operators (ops/cuda_linear.py, ops/attention.py), CUDA tensors only
    "linear.pad": "a GEMM operand's rows copied into a padded row stride "
                  "(a width off the 16-byte grid: d_inner 3027), on the "
                  "thread that runs the product, the backward's too",
    "attention.plain": "plain_sdpa's forward, the path a train step takes "
                       "under attention dropout",
}

_NULL = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` while a profiler runs, else ``_NULL``.

    ``torch.autograd.profiler._is_profiler_enabled`` is set by every
    ``torch.profiler.profile`` for as long as it runs, whatever thread
    reads it; ``torch.autograd._profiler_enabled()`` reads False on every
    thread of a profile with ``profile_all_threads``.  Without torch
    imported no profiler can run."""
    profiler = sys.modules.get("torch.autograd.profiler")
    if profiler is None or not profiler._is_profiler_enabled:
        return _NULL
    if name not in SPANS:
        raise ValueError(f"unknown span {name!r}: add it to "
                         "utils/profiling.py::SPANS")
    return profiler.record_function(name)


def _all_threads():
    """``experimental_config`` that records every thread, where the
    installed torch has it."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except TypeError:
        return {}


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block, every thread of the process, and write
    ``<logdir>/trace.json``; yields the ``torch.profiler.profile``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, **_all_threads()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def device_busy_ms(trace_path: str) -> float:
    """The union of the device intervals of a Chrome trace written by
    ``trace``, in ms: time in which the device ran at least one kernel,
    copy or memset."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                              if e.get("cat") in DEVICE_CATEGORIES):
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop
    return busy / 1e3
