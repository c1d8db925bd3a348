"""Where the time of one UCF LTN final-eval pass goes on the card (PyTorch
package).

    python3 scripts/torch_ucf_profile.py [--out profile_out] [--seed 0]

``ucf_ltn`` at its final-eval shapes (part_len 2, window_depth 2) and full
width, random weights from a torch.Generator seeded ``--seed``, TF32 off,
over the synthetic UCF-scale test split (data/synthetic.py: 290 videos whose
features are made from the seed as each is read).  Runs one warm-up pass of
evaluate_ucf_ltn through the final-eval UCFBinnedScorer, then one under
torch.profiler, and prints one JSON line: wall time, device busy time and
idle share, device time by category (GEMM, the attention kernel, copies,
other) and the ten kernels with the most device time, plus the host seconds
spent making the features, timed alone.  Writes the Chrome trace to ``--out``.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CATEGORIES = (("attention_kernel", re.compile(r"attention_fwd_kernel")),
              ("gemm", re.compile(r"gemm|sm90_xmma|cutlass|cublas", re.I)))


def summarize(trace_path: str, wall_s: float) -> dict:
    """The device's busy time, idle share, time by category and top kernels
    in the Chrome trace at ``trace_path`` of a pass of ``wall_s`` seconds."""
    from lstc_vad_tpu_torch.utils.profiling import (DEVICE_CATEGORIES,
                                                    device_busy_ms)

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    by_cat, by_name = {}, {}
    for e in device:
        name = e["name"]
        cat = "copy" if e["cat"] != "kernel" else next(
            (c for c, pat in CATEGORIES if pat.search(name)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e["dur"] / 1e3
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
    busy_ms = device_busy_ms(trace_path)
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
    from lstc_vad_tpu_torch.config import preset
    from lstc_vad_tpu_torch.data.synthetic import ucf_test_split
    from lstc_vad_tpu_torch.evaluation.drivers import evaluate_ucf_ltn
    from lstc_vad_tpu_torch.evaluation.scoring import (ucf_final_eval_scorer,
                                                       ucf_final_eval_shapes)
    from lstc_vad_tpu_torch.models import build

    if not torch.cuda.is_available():
        print("torch sees no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    cfg = ucf_final_eval_shapes(preset("ucf_ltn"))
    d = cfg.data
    encoder, head = build(cfg, device="cuda", seed=args.seed)
    store, videos, _ = ucf_test_split(args.seed)
    items = [(v.loader, v.anno, v.n_frames // d.segment_len) for v in videos]

    def run():
        scorer = ucf_final_eval_scorer(cfg, encoder, head)
        t0 = time.perf_counter()
        auc = evaluate_ucf_ltn(scorer, items, d.segment_len)
        return auc, time.perf_counter() - t0

    run()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        auc, wall = run()
    t0 = time.perf_counter()
    for v in videos:
        store.get(v.key)
    make_s = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, "ucf_eval_trace.json")
    prof.export_chrome_trace(trace)
    print(json.dumps({"preset": "ucf_ltn", "part_len": d.part_len,
                      "videos": len(videos), "auc": auc,
                      "features_made_s": make_s, "card": card,
                      **summarize(trace, wall)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
