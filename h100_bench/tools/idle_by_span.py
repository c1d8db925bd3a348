"""One traced run of a cell, as ``run.py --trace 1`` makes it, and where its
device-idle time went by the program's spans.

    python3 h100_bench/tools/idle_by_span.py --workload sht_ltn.eval \
        --seed 7 --seconds 20 [--out idle.jsonl]

Prints run.py's result line, then one JSON line read from the same trace
(ms are per unit: a pass, or an epoch of one step in the train cell):

- ``units``, ``unit_s``: the window's units, each timed by its
  ``bench.unit`` span, and their median;
- ``idle_ms``: the device's idle time; ``by_innermost``: that time by the
  innermost of the program's spans (``SPANS``; none at a commit without
  them) and the benchmark's open on the unit thread; ``program_share``:
  the share of it whose innermost span is the program's, other than the
  outer ``eval.score`` and ``train.epoch``;
- ``host_ms``, ``idle_under_ms``, ``count``: each span's host time, the
  idle time under it (``harness/spans.py``'s rules) and how many ran on
  the unit thread;
- ``gaps_by_op``: the idle time ``trace.breakdown`` gives each host
  operator (the one overlapping a gap most takes all of it), split by the
  innermost span.

The benchmark's own runs never run this.
"""

import argparse
import bisect
import collections
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

OUTER = ("eval.score", "train.epoch")


def _gaps_by_op(events, idle):
    """{host operator: its gaps}, by ``trace.breakdown``'s rule."""
    host = sorted(((e["ts"], e["ts"] + e["dur"], e.get("name", "?"))
                   for e in events if e.get("cat") == "cpu_op"),
                  key=lambda t: t[0])
    starts = [h[0] for h in host]
    longest = max((h[1] - h[0] for h in host), default=0.0)
    by_op = collections.defaultdict(list)
    for a, b in idle:
        best, best_overlap = "host: no operator", 0.0
        lo = bisect.bisect_left(starts, a - longest)
        for s, t, name in host[lo:bisect.bisect_right(starts, b)]:
            if min(t, b) - max(s, a) > best_overlap:
                best, best_overlap = name, min(t, b) - max(s, a)
        by_op[best].append((a, b))
    return by_op


def split(events) -> dict:
    """The idle time of one traced window by span (see the module's
    docstring)."""
    from h100_bench.harness import spans as sp
    from h100_bench.harness import trace as tr

    win = tr.window(events)
    tid = sp.unit_thread(events, win)
    units = [e["dur"] / 1e6 for e in events
             if e.get("cat") == sp.HOST_SPAN and e.get("name") == tr.UNIT_SPAN
             and e.get("tid") == tid]
    n = len(units)

    def ms(seconds):
        return sp.per_unit_ms(seconds, n)

    try:
        from lstc_vad_tpu_torch.utils.profiling import SPANS
    except ImportError:  # a program without spans
        SPANS = {}
    idle = sp.idle_intervals(events, win)
    idle_s = sum(b - a for a, b in idle) / 1e6
    by_innermost = sp.idle_by_innermost(events, win, names=SPANS)
    names = sorted({e["name"] for e in events if e.get("cat") == sp.HOST_SPAN
                    and e["name"] in SPANS})
    program = sum(v for k, v in by_innermost.items()
                  if k in SPANS and k not in OUTER)
    gaps = sorted(_gaps_by_op(events, idle).items(),
                  key=lambda kv: -sum(b - a for a, b in kv[1]))[:4]
    return {
        "units": n, "unit_s": units,
        "unit_median_s": statistics.median(units) if units else None,
        "window_s": (win[1] - win[0]) / 1e6, "idle_ms": ms(idle_s),
        "program_share": program / idle_s if idle_s else None,
        "by_innermost": {k: ms(v) for k, v in sorted(
            by_innermost.items(), key=lambda kv: -kv[1])},
        "host_ms": {k: ms(sp.host_s(events, win, k)) for k in names},
        "idle_under_ms": {k: ms(sp.idle_under_s(events, win, k))
                          for k in names},
        "count": {k: sum(1 for e in events if e.get("cat") == sp.HOST_SPAN
                         and e["name"] == k and e.get("tid") == tid) / n
                  for k in names} if n else {},
        "other_threads": sorted({e["name"] for e in events
                                 if e.get("cat") == sp.HOST_SPAN
                                 and e.get("tid") != tid}),
        "gaps_by_op": {op: {k: ms(v) for k, v in sorted(
            sp.idle_by_innermost(events, win, g, SPANS).items(),
            key=lambda kv: -kv[1])} for op, g in gaps},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from h100_bench import run
    from h100_bench.harness import trace as tr

    found = {}
    load = tr.load

    def split_on_load(path):
        events = load(path)
        found["split"] = split(events)
        return events

    tr.load = split_on_load  # the window reads its trace through tr.load
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if "split" not in found:
        return rc or 1
    text = json.dumps({"workload": args.workload, "seed": args.seed,
                       **found["split"]})
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
