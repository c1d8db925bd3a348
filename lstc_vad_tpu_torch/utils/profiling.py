"""Tracing and step timing — the counterpart of
lstc_vad_tpu/utils/profiling.py:1-60 on ``torch.profiler``.

- ``trace(logdir)``: a context manager that profiles the host and, when a
  card is visible, the device, and writes a Chrome trace
  (``<logdir>/trace.json``, viewable in Perfetto or chrome://tracing).
- ``annotate(name)``: a named span in that trace (``record_function``).
- ``device_busy_ms(path)``: the device's busy time in a written trace, the
  union of its kernel, copy and memset intervals.
- ``StepTimer``: wall-clock step timing and an items/s counter.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

TRACE_FILE = "trace.json"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write ``<logdir>/trace.json``; yields the
    ``torch.profiler.profile``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    import torch

    return torch.profiler.record_function(name)


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


class StepTimer:
    """Accumulates (steps, items, seconds); ``rate()`` -> items/s."""

    def __init__(self):
        self.steps = 0
        self.items = 0
        self.seconds = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._t0
        self.steps += 1
        self._t0 = None
        return False

    def add_items(self, n: int):
        self.items += n

    def rate(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0

    def per_step(self) -> float:
        return self.seconds / self.steps if self.steps else 0.0
