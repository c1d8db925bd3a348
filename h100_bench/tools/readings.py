"""The readings a cell's output-check limits are set from, in one process:
the program's numbers over many seeds, the control's (the reference with
its products in TF32, in the program's place), and the planted faults'.

    python3 h100_bench/tools/readings.py --workload sht_ltn.eval \
        --seeds 11,12,13 --control-seeds 21,22,23 --faults half_batch \
        --fault-seeds 31,32,33 [--units 1] [--out readings.jsonl]

Prints one JSON line per (kind, seed): {"kind", "seed", "numbers"}.  The
benchmark's own runs never run this.
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def _seeds(s: str):
    return [int(x) for x in s.split(",") if x]


def readings(workload, seeds, control_seeds, faults, fault_seeds, units,
             device, cell_spec=None, log=sys.stdout, out=None):
    import torch

    from h100_bench.harness import spec
    from h100_bench.reference.model import matmul, tf32_matmul
    from h100_bench.tools import faults as fault_mod

    c = cell_spec or spec.cell(workload)
    entry_name = c["traffic"]["entry"]
    entry = spec.entry(entry_name)
    rows = []

    def emit(kind, seed, numbers, t0, cell=None):
        row = {"workload": workload, "kind": kind, "seed": seed,
               "numbers": numbers, "seconds": time.perf_counter() - t0}
        # where a leaf-wise number was worst, for the record
        for attr in ("grad_leaf", "worst_change", "later_loss_gaps"):
            if hasattr(cell, attr):
                row[attr] = getattr(cell, attr)
        rows.append(row)
        text = json.dumps(row)
        print(text, file=log, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(text + "\n")

    def program(seed, kind, fault=None):
        t0 = time.perf_counter()
        cell = entry.Cell(c, seed, device)
        cell.inputs()
        with fault(entry_name) if fault else contextlib.nullcontext():
            cell.build()
            for _ in range(max(units, cell.min_units)):
                cell.unit()
        got = cell.outputs()
        cell.release()
        emit(kind, seed, cell.compare(got, cell.reference(matmul)), t0, cell)
        del cell, got
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    for seed in seeds:
        program(seed, "program")
    for seed in control_seeds:
        t0 = time.perf_counter()
        cell = entry.Cell(c, seed, device)
        cell.inputs()
        want = cell.reference(matmul)
        emit("control", seed, cell.compare(cell.reference(tf32_matmul),
                                           want), t0, cell)
        del cell, want
        gc.collect()
    for name in faults:
        fault = getattr(fault_mod, name)
        for seed in fault_seeds:
            program(seed, f"fault:{name}", fault)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    device = torch.device("cuda:0")
    readings(args.workload, _seeds(args.seeds), _seeds(args.control_seeds),
             [f for f in args.faults.split(",") if f],
             _seeds(args.fault_seeds), args.units, device, out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
