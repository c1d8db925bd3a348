"""The program's own spans in a traced run: the host time of a span, the
device's idle time under it, and the device time of what it launched.

The program marks its layers with ``torch.profiler`` spans
(``lstc_vad_tpu_torch/utils/profiling.py::SPANS``); the Chrome trace writes
each as a ``user_annotation`` event on the host thread that opened it, in
the clock of the device's kernels and copies.  The rules:

- **unit thread**: the thread of the ``bench.unit`` spans;
- **host time of span X**: the summed duration of the outermost X spans
  that start in the window on the unit thread;
- **idle under X**: the device-idle time in the window (the window less
  ``trace.device_intervals``) during which the unit thread is inside an X
  span, at any depth;
- **device time under X**: the device time of the kernels, copies and
  memsets whose launch (the runtime or driver call of the same
  ``correlation``, as ``trace.op_calls`` matches them) ran on X's thread
  inside an X span.

Each returns seconds, or None when no X span starts in the window (never 0
for a span that did not run).  Names are passed as they are: a program
without a span reads None.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

from h100_bench.harness import trace as tr

HOST_SPAN = "user_annotation"
BENCH_SPANS = (tr.WINDOW_SPAN, tr.UNIT_SPAN)


def unit_thread(events: List[dict], win) -> Optional[int]:
    """The ``tid`` of the window's ``bench.unit`` spans, or None."""
    for e in events:
        if (e.get("cat") == HOST_SPAN and e.get("name") == tr.UNIT_SPAN
                and win[0] <= e["ts"] < win[1]):
            return e.get("tid")
    return None


def _spans(events: List[dict], name: str, win, tid=None) -> List[dict]:
    return [e for e in events if e.get("cat") == HOST_SPAN
            and e.get("name") == name and win[0] <= e["ts"] < win[1]
            and (tid is None or e.get("tid") == tid)]


def _unit_intervals(events: List[dict], name: str, win) -> List[tr.Interval]:
    """The union of the unit thread's ``name`` spans that start in the
    window, clipped to it."""
    if win is None:
        return []
    tid = unit_thread(events, win)
    if tid is None:
        return []
    return tr.union((e["ts"], min(e["ts"] + e["dur"], win[1]))
                    for e in _spans(events, name, win, tid))


def idle_intervals(events: List[dict], win) -> List[tr.Interval]:
    """The window less the device's busy intervals, sorted."""
    idle, cursor = [], win[0]
    for a, b in tr.device_intervals(events, win):
        if a > cursor:
            idle.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < win[1]:
        idle.append((cursor, win[1]))
    return idle


def overlap(xs: List[tr.Interval], ys: List[tr.Interval]) -> float:
    """The length of the intersection of two sorted, disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_s(events: List[dict], win, name: str) -> Optional[float]:
    """Host time of span ``name`` on the unit thread."""
    spans = _unit_intervals(events, name, win)
    if not spans:
        return None
    return sum(b - a for a, b in spans) / 1e6


def idle_under_s(events: List[dict], win, name: str) -> Optional[float]:
    """Device-idle time while the unit thread is inside span ``name``."""
    spans = _unit_intervals(events, name, win)
    if not spans:
        return None
    return overlap(spans, idle_intervals(events, win)) / 1e6


def device_under_s(events: List[dict], win, name: str) -> Optional[float]:
    """Device time of what span ``name`` launched, on whatever thread the
    span ran."""
    if win is None:
        return None
    spans = _spans(events, name, win)
    if not spans:
        return None
    launches = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in tr.LAUNCH_CATEGORIES:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[e.get("tid")].append((e["ts"], corr))
    corrs = set()
    for s in spans:
        end = s["ts"] + s["dur"]
        corrs.update(c for ts, c in launches.get(s.get("tid"), ())
                     if s["ts"] <= ts <= end)
    return sum(e["dur"] for e in events
               if e.get("cat") in tr.DEVICE_CATEGORIES
               and e.get("args", {}).get("correlation") in corrs) / 1e6


def idle_by_innermost(events: List[dict], win, idle=None, names=None
                      ) -> Dict[str, float]:
    """The window's device-idle time (or that of the sorted, disjoint
    intervals ``idle``) by the innermost span open on the unit thread at
    each instant ("no span" where none is), seconds.  ``names``: the spans
    to consider (the benchmark's own are always), else every span."""
    tid = unit_thread(events, win) if win is not None else None
    if tid is None:
        return {}
    # spans of one thread nest: at each boundary the open span that started
    # last is the innermost
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == HOST_SPAN and e.get("tid") == tid
                    and e["ts"] < win[1] and e["ts"] + e["dur"] > win[0]
                    and (names is None or e["name"] in names
                         or e["name"] in BENCH_SPANS)),
                   key=lambda s: (s[0], -s[1]))
    segments, stack, cursor = [], [], win[0]

    def close_until(t):
        nonlocal cursor
        while stack and stack[-1][1] <= t:
            end, name = stack[-1][1], stack[-1][2]
            if end > cursor:
                segments.append((cursor, end, name))
                cursor = end
            stack.pop()
        if t > cursor:
            segments.append((cursor, t, stack[-1][2] if stack else "no span"))
            cursor = t

    for s in spans:
        close_until(s[0])
        stack.append(s)
    close_until(win[1])
    out: Dict[str, float] = collections.defaultdict(float)
    if idle is None:
        idle = idle_intervals(events, win)
    j = 0
    for a, b, name in segments:
        a, b = max(a, win[0]), min(b, win[1])
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            lo, hi = max(a, idle[k][0]), min(b, idle[k][1])
            if hi > lo:
                out[name] += (hi - lo) / 1e6
            k += 1
    return dict(out)


def per_unit_ms(seconds: Optional[float], n) -> Optional[float]:
    """``seconds`` in ms per one of ``n`` units, None when either is
    missing."""
    if seconds is None or not n:
        return None
    return 1e3 * seconds / n
