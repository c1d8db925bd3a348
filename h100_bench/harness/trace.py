"""Reading a ``torch.profiler`` Chrome trace: the window, the device's busy
time, the device time under one operator, host-to-device copies and the
breakdown of a traced run.

Times in a Chrome trace are microseconds.  Every function here takes the
trace's event list and the window ``(start, end)`` in the trace's clock,
and returns seconds.

The union of kernel, copy and memset intervals is a frozen copy of
lstc_vad_tpu_torch/utils/profiling.py::device_busy_ms, clipped to the
window.
"""

from __future__ import annotations

import bisect
import collections
import json
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"
UNIT_SPAN = "bench.unit"

Interval = Tuple[float, float]


def load(path: str) -> List[dict]:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]


def window(events: List[dict], name: str = WINDOW_SPAN) -> Optional[Interval]:
    """(start, end) of the host span ``name``, or None."""
    for e in events:
        if e.get("name") == name and e.get("cat") == "user_annotation":
            return e["ts"], e["ts"] + e["dur"]
    return None


def _clip(start: float, stop: float, win: Interval) -> Optional[Interval]:
    a, b = max(start, win[0]), min(stop, win[1])
    return (a, b) if b > a else None


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Merged, sorted, non-overlapping intervals."""
    merged: List[List[float]] = []
    for start, stop in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return [(a, b) for a, b in merged]


def device_intervals(events: List[dict], win: Interval) -> List[Interval]:
    """The union of the device's kernel, copy and memset intervals inside
    the window."""
    clipped = (_clip(e["ts"], e["ts"] + e["dur"], win) for e in events
               if e.get("cat") in DEVICE_CATEGORIES)
    return union(c for c in clipped if c is not None)


def busy_s(events: List[dict], win: Interval) -> float:
    return sum(b - a for a, b in device_intervals(events, win)) / 1e6


def h2d_s(events: List[dict], win: Interval) -> float:
    """Device time of host-to-device copies inside the window."""
    total = 0.0
    for e in events:
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            c = _clip(e["ts"], e["ts"] + e["dur"], win)
            if c is not None:
                total += c[1] - c[0]
    return total / 1e6


def op_calls(events: List[dict], op_name: str, win: Interval
             ) -> List[Tuple[dict, float]]:
    """[(host event of the operator, device seconds of what it launched)]
    for each call of ``op_name`` that starts inside the window.

    A kernel belongs to a call when the runtime or driver call that
    launched it (the same ``correlation`` id) ran on the call's thread
    inside the call's host interval, or when the kernel carries the call's
    ``External id``.  Kernel names play no part."""
    calls = [e for e in events if e.get("cat") == "cpu_op"
             and e.get("name") == op_name and win[0] <= e["ts"] < win[1]]
    if not calls:
        return []
    launches = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in LAUNCH_CATEGORIES:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[e.get("tid")].append((e["ts"], corr))
    device_by_corr: Dict[int, float] = collections.defaultdict(float)
    device_by_ext: Dict[int, float] = collections.defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES:
            args = e.get("args", {})
            if args.get("correlation") is not None:
                device_by_corr[args["correlation"]] += e["dur"]
            if args.get("External id") is not None:
                device_by_ext[args["External id"]] += e["dur"]
    out = []
    for call in calls:
        end = call["ts"] + call["dur"]
        corrs = {corr for ts, corr in launches.get(call.get("tid"), ())
                 if call["ts"] <= ts <= end}
        dev = sum(device_by_corr.get(c, 0.0) for c in corrs)
        if not corrs:
            ext = call.get("args", {}).get("External id")
            dev = device_by_ext.get(ext, 0.0) if ext is not None else 0.0
        out.append((call, dev / 1e6))
    return out


def breakdown(events: List[dict], win: Interval, top: int = 10) -> dict:
    """``device_ops``: the device operations that took most time in the
    window, by name; ``idle_gaps``: the device's idle time in the window,
    by the host operator that overlaps each gap most ("host: no operator"
    where none does), the largest first.  Seconds."""
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES:
            c = _clip(e["ts"], e["ts"] + e["dur"], win)
            if c is not None:
                by_name[e.get("name", "?")] += c[1] - c[0]
    busy = device_intervals(events, win)
    gaps, cursor = [], win[0]
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < win[1]:
        gaps.append((cursor, win[1]))
    host = sorted(((e["ts"], e["ts"] + e["dur"], e.get("name", "?"))
                   for e in events if e.get("cat") == "cpu_op"),
                  key=lambda t: t[0])
    starts = [h[0] for h in host]
    by_host: Dict[str, float] = collections.defaultdict(float)
    longest = max((h[1] - h[0] for h in host), default=0.0)
    for a, b in gaps:
        best, best_overlap = "host: no operator", 0.0
        lo = bisect.bisect_left(starts, a - longest)
        hi = bisect.bisect_right(starts, b)
        for s, t, name in host[lo:hi]:
            overlap = min(t, b) - max(s, a)
            if overlap > best_overlap:
                best, best_overlap = name, overlap
        by_host[best] += b - a

    def ranked(d):
        return [[k, v / 1e6] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_name), "idle_gaps": ranked(by_host)}
