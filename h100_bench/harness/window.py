"""One run of one cell: inputs, set-up, the measured window, the trace, the
output check, and the result line.

``run`` takes the device it is given and looks for no card; run.py does
that, and the tests call ``run`` on the CPU at a tiny size.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import torch

from h100_bench.harness import spec as specs
from h100_bench.harness import trace as tr
from h100_bench.harness.peaks import PEAK_FLOP_PER_S
from h100_bench.reference.model import matmul

# modules the process may not hold once the window has closed: JAX, its
# libraries and the JAX package (top-level names, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lstc_vad_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card(device: torch.device) -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` names it."""
    if device.type != "cuda":
        return "cpu (no card)"
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


class Run:
    """What a per-layer metric reader is given: the traced run's events and
    window, the window's unit counts, the configuration's numbers and the
    peaks."""

    def __init__(self, events, win, counts: Dict[str, float], units: int,
                 p: dict, dtype: str):
        self.events = events
        self.win = win
        self.counts = counts
        self.units = units
        self.p = p
        self.dtype = dtype
        self.peak_flop_per_s = PEAK_FLOP_PER_S[dtype]

    @property
    def window_s(self) -> float:
        return (self.win[1] - self.win[0]) / 1e6


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(workload: str, seed: int, seconds: float, traced: bool, device,
        t_start: float, cell_spec: Optional[dict] = None,
        log=sys.stderr) -> dict:
    """The result line of one run (see ``h100_bench/README.md``)."""
    device = torch.device(device)
    c = cell_spec or specs.cell(workload)
    entry = specs.entry(c["traffic"]["entry"])
    cell = entry.Cell(c, seed, device)
    t_inputs = time.perf_counter()
    cell.inputs()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_build = time.perf_counter()
    cell.build()
    _sync(device)
    phases = (f"set-up: start to inputs {t_inputs - t_start:.3f} s, inputs "
              f"{t_build - t_inputs:.3f} s, build {cell.warm_from - t_build:.3f}"
              f" s, warm-up {time.perf_counter() - cell.warm_from:.3f} s")

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities, record_shapes=True)
        prof.start()
    counts: Dict[str, float] = {}
    unit_s = []
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    deadline = t0 + seconds
    with torch.profiler.record_function(tr.WINDOW_SPAN):
        while True:
            t_unit = time.perf_counter()
            with torch.profiler.record_function(tr.UNIT_SPAN):
                got = cell.unit()
            unit_s.append(time.perf_counter() - t_unit)
            for k, v in got.items():
                counts[k] = counts.get(k, 0.0) + v
            if (time.perf_counter() >= deadline
                    and len(unit_s) >= cell.min_units):
                break
        _sync(device)
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)

    units = len(unit_s)
    line = {"correct": False, "attempted": units, "failed": 0,
            "metrics": {}, "device": {}}
    metrics = line["metrics"]
    for m in c["end_to_end"]:
        if m["name"] == "setup_s":
            metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
    for name, counter in c["traffic"]["end_to_end"].items():
        unit = next(m["unit"] for m in c["end_to_end"] if m["name"] == name)
        metrics[name] = {"value": counts[counter] / window_s, "unit": unit}
    card_name = card(device)
    line["device"] = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1, "memory_peak_bytes": memory_peak}

    if traced:
        line["metrics"] = {}
        with tempfile.TemporaryDirectory(prefix="h100_bench_trace_") as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            events = tr.load(path)
        win = tr.window(events)
        r = Run(events, win, counts, units, c["config"]["program"],
                c["config"]["dtype"])
        for m in c["per_layer"]:
            value = specs.metric_reader(m["name"])(r)
            if value is not None:
                line["metrics"][m["name"]] = {"value": value,
                                              "unit": m["unit"]}
        line["device"]["busy_s"] = tr.busy_s(events, win)
        line["device"]["window_s"] = r.window_s
        line["breakdown"] = tr.breakdown(events, win)
        del events, r

    # the output check, once the program's state is freed
    got = cell.outputs()
    line["failed"] = cell.failed(got)
    cell.release()
    numbers = cell.compare(got, cell.reference(matmul))
    limits = c["limits"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    line["correct"] = (line["failed"] == 0 and all(
        math.isfinite(v) and v <= limits[k] for k, v in numbers.items()))
    line["checks"] = checks
    print(f"card: {card_name}; window {window_s:.3f} s, {units} units "
          f"({', '.join(f'{u:.3f}' for u in unit_s)} s); setup {setup_s:.3f} "
          f"s ({phases})", file=log)
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=log)
    log.flush()
    return line

