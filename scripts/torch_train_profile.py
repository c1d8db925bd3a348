"""Where the time of one LTN train step goes on the card (PyTorch package).

    python3 scripts/torch_train_profile.py [--out profile_out] [--seed 0]

Takes chip_smoke.py's train set-up as it is (``set_up_train``: ``sht_ltn``
at full width, random weights from a torch.Generator seeded ``--seed``, the
synthetic ShanghaiTech-scale train split, TF32 off) in two configurations:
the preset's dropouts, where a step's attention takes the plain path, and
every dropout at 0, where its forward is the Hopper kernel and its backward
autograd through ``plain_sdpa``.  For each it runs one warm-up epoch (one
step of batch 40: batch build, H2D copy, forward, backward, Adagrad), then
one epoch under torch.profiler, and prints one JSON line: the epoch's wall
time, the device's busy time and idle share and its time by kernel category
(GEMM, the attention kernel, copies, other; scripts/torch_eval_profile.py's
``summarize`` over the Chrome trace written to ``--out``), the self device
time by operator group (the encoder's and head's Linear GEMMs ``aten::mm`` /
``aten::addmm``, the plain attention's ``aten::bmm``, softmax, dropout,
LayerNorm, the rest), the peak device memory and the card.  Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

OP_GROUPS = {
    "linear_gemm": ("aten::mm", "aten::addmm"),
    "attention_bmm": ("aten::bmm",),
    "softmax": ("aten::_softmax", "aten::_softmax_backward_data"),
    "dropout": ("aten::native_dropout", "aten::native_dropout_backward",
                "aten::bernoulli_"),
    "layer_norm": ("aten::native_layer_norm",
                   "aten::native_layer_norm_backward"),
}


def op_groups(prof) -> dict:
    """Self device time (ms) of the CPU-side operators, by group."""
    from torch.autograd import DeviceType

    out = {k: 0.0 for k in (*OP_GROUPS, "other_ops")}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU:
            continue  # kernel rows repeat their operators' time
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        group = next((g for g, names in OP_GROUPS.items()
                      if e.key in names), "other_ops")
        out[group] += ms
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(REPO, "profile_out"))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from lstc_vad_tpu_torch.ops import cuda_attention
    from lstc_vad_tpu_torch.train.driver import Trainer
    from torch_eval_profile import summarize

    card = chip_smoke.card_line()
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as root:
        cfg, store = chip_smoke.set_up_train(root, args.seed)
        for name, c in (("preset_dropout", cfg),
                        ("no_dropout", chip_smoke.no_dropout(cfg))):
            trainer = Trainer(c, store=store, test_videos=[])
            trainer.train_epoch()  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_attention.reset_launches()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                m = trainer.train_epoch()  # ends by reading the loss
                wall = time.perf_counter() - t0
            trace = os.path.join(args.out, f"train_{name}_trace.json")
            prof.export_chrome_trace(trace)
            print(json.dumps({
                "preset": "sht_ltn", "config": name,
                "batch_size": c.data.batch_size, "loss": m["loss"],
                "kernel_launches": cuda_attention.launches,
                "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                "op_self_device_ms": op_groups(prof), "card": card,
                **summarize(trace, wall)}))
            del trainer
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
