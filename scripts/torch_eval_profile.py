"""Where the time of one LTN eval pass goes on the card (PyTorch package).

    python3 scripts/torch_eval_profile.py [--out profile_out] [--seed 0]

Takes chip_smoke.py's set-up and eval pass as they are (``set_up``:
``sht_ltn`` at full width, random weights from a torch.Generator seeded
``--seed``, the synthetic ShanghaiTech-scale test split, TF32 off;
``run_eval``), runs one warm-up eval, then one eval under torch.profiler.  From the Chrome trace it writes to ``--out``
it prints one JSON line: the wall time of the profiled pass, the device's
busy time (the union of kernel, copy and memset intervals) and idle share,
device time by category (GEMM, the attention kernel, copies, other) and the
ten kernels with the most device time.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CATEGORIES = (("attention_kernel", re.compile(r"attention_fwd_kernel")),
              ("gemm", re.compile(r"gemm|sm90_xmma|cutlass|cublas", re.I)))


def _union_us(intervals):
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop
    return busy


def summarize(trace_path: str, wall_s: float) -> dict:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_cat, by_name = {}, {}
    for e in device:
        name = e["name"]
        cat = "copy" if e["cat"] != "kernel" else next(
            (c for c, pat in CATEGORIES if pat.search(name)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e["dur"] / 1e3
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
    busy_ms = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in device]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
            "device_ms_by_category": by_cat,
            "top_kernels_ms": [{"name": n[:120], "ms": t} for n, t in top]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(REPO, "profile_out"))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    card = chip_smoke.card_line()
    cfg, items, encoder, head = chip_smoke.set_up(args.seed)
    chip_smoke.run_eval(encoder, head, cfg, items)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        auc, _, wall, _ = chip_smoke.run_eval(encoder, head, cfg, items)
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, "eval_trace.json")
    prof.export_chrome_trace(trace)
    print(json.dumps({"preset": "sht_ltn", "auc": auc, "card": card,
                      **summarize(trace, wall)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
