#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: build, check, drive.

    python3 chip_smoke.py

1. Set-up: prints the card's name and power limit (nvidia-smi) and the torch
   and CUDA versions, turns TF32 off, and builds every CUDA kernel of the
   package from the sources in this checkout (one nvcc per source, started
   together).
2. Kernel phase: the attention kernel against its plain PyTorch version at
   H=8, D=256 and every sequence length the models use plus the tile edges
   L=64, 65 and 128 (B=256), at B=2048 and at the main path's own shape,
   with and without bias, and at the main path's shape fed as the encoder
   feeds it (strided views of [B, L, H, D] buffers); the error must stay
   within rtol 1e-4 / atol 1e-5.  Times the kernel, the plain version and,
   as a yardstick the package never calls, F.scaled_dot_product_attention.
   Prints ptxas's registers and spills of each kernel instantiation.
3. Slice phase (the main path): LTN scoring to frame AUC at full sht_ltn
   width (3 layers, d_model 2048, d_inner 4096, 8 heads, d_k 256) with
   random weights from a torch.Generator seeded 0, over synthetic features
   at ShanghaiTech test-split scale (107 videos, ~2,550 clips of 16 patches
   x 2048, per-frame masks on the abnormal ones) made from a numpy seed.
   The launch counter is set to 0 just before and read just after; it must
   equal n_layers x encoder calls.  The same eval with attn_impl="plain"
   must give the same frame scores (atol 5e-5) and AUC (within 1e-4).
4. Prints one JSON line of kernels, then, as the last line,
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed phase raises and the script exits non-zero without that line.
Without a CUDA card it runs nothing and exits 2.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

RTOL, ATOL = 1e-4, 1e-5          # kernel vs plain on the card
SCORE_ATOL, AUC_TOL = 5e-5, 1e-4  # main path, kernel vs plain
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
# the kernel's f32-accurate rate: 3xTF32 is three TF32 tensor-core products
# (495 TFLOP/s dense) for each f32 one
F32_FLOP_PER_S = 495e12 / 3
H, D = 8, 256
LENGTHS = (10, 17, 19, 28, 49, 64, 65, 81, 128)  # model L and tile edges
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean time of one call, by CUDA events around ``iters`` calls after
    warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(b: int, length: int, with_bias: bool):
    """Least time for one attention call: q, k, v read once, out written
    once (and the bias read once) over the memory rate, against the two
    products' FLOPs over the kernel's f32-accurate tensor-core rate."""
    n_bytes = 4 * (4 * b * H * length * D
                   + (H * length * length if with_bias else 0))
    flops = 4 * b * H * length * length * D
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_lines(log: str):
    """One line per kernel instantiation from nvcc's -Xptxas=-v output: its
    key-tile count (the template argument), registers, stack and spills."""
    name, spill = "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"ILi(\d+)E", m.group(1))
            name = f"NT={t.group(1)}" if t else m.group(1)
        elif "bytes stack frame" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            used = line.split(":", 1)[-1].strip()
            yield f"{name}: {used}; {spill}"


def check_kernel(b: int, length: int, with_bias: bool, dev,
                 strided: bool = False) -> dict:
    """q, k, v [B, H, L, D], contiguous or (``strided``) views of
    [B, L, H, D] buffers as the encoder passes them."""
    import torch
    import torch.nn.functional as F

    from lstc_vad_tpu_torch.ops.attention import plain_sdpa
    from lstc_vad_tpu_torch.ops.cuda_attention import attention

    g = torch.Generator(device=dev).manual_seed(b * 1000 + length)
    shape = (b, length, H, D) if strided else (b, H, length, D)
    q, k, v = (torch.randn(*shape, device=dev, generator=g)
               for _ in range(3))
    if strided:
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    bias = (torch.randn(H, length, length, device=dev, generator=g)
            if with_bias else None)
    temp = float(np.sqrt(D))
    out = attention(q, k, v, bias, temp)
    ref = plain_sdpa(q, k, v, temp, bias=bias)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"kernel gave non-finite values at B={b} "
                             f"L={length} bias={with_bias}")
    err = (out - ref).abs()
    excess = (err - (ATOL + RTOL * ref.abs())).max().item()
    max_err = err.max().item()
    if excess > 0:
        raise AssertionError(
            f"kernel disagrees with plain_sdpa at B={b} L={length} "
            f"bias={with_bias} strided={strided}: max abs err {max_err} "
            f"beyond rtol {RTOL} / atol {ATOL}")
    mask = bias[None] if bias is not None else None
    bound_ms, bound_by = bound(b, length, with_bias)
    return {
        "B": b, "H": H, "L": length, "D": D, "bias": with_bias,
        "strided": strided, "max_abs_err": max_err,
        "ms": cuda_ms(lambda: attention(q, k, v, bias, temp)),
        "plain_ms": cuda_ms(lambda: plain_sdpa(q, k, v, temp, bias=bias)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=1.0 / temp)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def set_up(seed: int = SEED):
    """TF32 off, then the main path's config, synthetic data and model on the
    card (scripts/torch_eval_profile.py drives the same set-up)."""
    import torch

    from lstc_vad_tpu_torch.config import preset
    from lstc_vad_tpu_torch.data.synthetic import sht_test_split
    from lstc_vad_tpu_torch.models import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = preset("sht_ltn")
    items = sht_test_split(seed)
    encoder, head = build(cfg, device="cuda", seed=seed)
    return cfg, items, encoder, head


def run_eval(encoder, head, cfg, items):
    from lstc_vad_tpu_torch.evaluation.drivers import evaluate_ltn
    from lstc_vad_tpu_torch.evaluation.scoring import PartScorer

    scorer = PartScorer(encoder, head, cfg.data.part_len, cfg.data.n_patch,
                        tail_rewindow=cfg.eval_tail_rewindow)
    t0 = time.perf_counter()
    auc, scores = evaluate_ltn(scorer, items, cfg.data.segment_len,
                               return_scores=True)
    wall = time.perf_counter() - t0  # resolve() synchronised every chunk
    return auc, scores, wall, scorer.scorer.n_calls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; nothing was run",
              file=sys.stderr)
        return 2

    from lstc_vad_tpu_torch.config import replace
    from lstc_vad_tpu_torch.evaluation.frame_auc import part_slices
    from lstc_vad_tpu_torch.evaluation.scoring import CHUNK
    from lstc_vad_tpu_torch.models import Encoder
    from lstc_vad_tpu_torch.ops import _build, cuda_attention

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    built = ", ".join(sorted(logs)) or "nothing (up to date)"
    print(f"build: {time.perf_counter() - t0:.1f} s for {built}")
    for name, log in logs.items():
        for line in ptxas_lines(log):
            print(f"  {name}: {line}")

    # -- the main path's data, model and attention shape -------------------
    t0 = time.perf_counter()
    cfg, items, encoder, head = set_up()
    n_clips = sum(len(f) for f, _ in items)
    n_parts = sum(len(part_slices(len(f), cfg.data.part_len,
                                  cfg.eval_tail_rewindow)[0])
                  for f, _ in items)
    main_b = min(n_parts, CHUNK)
    main_len = cfg.data.part_len * cfg.data.n_patch + 1
    print(f"data: {len(items)} videos, {n_clips} clips, {n_parts} parts of "
          f"{main_len} tokens; data and model made in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- kernel phase -----------------------------------------------------
    shapes = [(256, n) for n in LENGTHS] + [(2048, 49), (main_b, main_len)]
    cases = [(b, n, with_bias, False) for b, n in shapes
             for with_bias in (False, True)]
    cases.append((main_b, main_len, True, True))  # as the encoder feeds it
    rows = []
    for b, length, with_bias, strided in cases:
        row = check_kernel(b, length, with_bias, dev, strided)
        rows.append(row)
        print("kernel " + json.dumps(row))
    main_row = rows[-1]

    # -- slice phase: the main path ---------------------------------------
    cuda_attention.reset_launches()
    auc, scores, wall, n_calls = run_eval(encoder, head, cfg, items)
    launches = cuda_attention.launches
    expect = cfg.encoder.n_layers * n_calls
    if launches != expect or launches == 0:
        raise AssertionError(f"attention kernel launched {launches} times on "
                             f"the main path; expected {expect} "
                             f"({cfg.encoder.n_layers} layers x {n_calls} "
                             "encoder calls)")
    for s, (_, labels) in zip(scores, items):
        if s.shape != labels.shape or not np.isfinite(s).all() \
                or s.min() < 0 or s.max() > 1:
            raise AssertionError("main path gave scores of the wrong shape "
                                 "or outside [0, 1]")
    if not np.isfinite(auc):
        raise AssertionError(f"main path AUC is {auc}")

    plain_cfg = replace(cfg, **{"encoder.attn_impl": "plain"})
    plain_encoder = Encoder(plain_cfg.encoder, device=dev)
    plain_encoder.load_state_dict(encoder.state_dict(), strict=True)
    plain_auc, plain_scores, plain_wall, _ = run_eval(plain_encoder, head,
                                                      plain_cfg, items)
    if cuda_attention.launches != launches:
        raise AssertionError("the plain eval launched the kernel")
    score_err = max(float(np.abs(a - b).max())
                    for a, b in zip(scores, plain_scores))
    if score_err > SCORE_ATOL or abs(auc - plain_auc) > AUC_TOL:
        raise AssertionError(
            f"kernel eval disagrees with the plain eval: frame scores max "
            f"abs err {score_err} (limit {SCORE_ATOL}), AUC {auc} vs "
            f"{plain_auc} (limit {AUC_TOL})")
    _, _, warm_wall, _ = run_eval(encoder, head, cfg, items)
    print("slice " + json.dumps({
        "preset": "sht_ltn", "videos": len(items), "clips": n_clips,
        "parts": n_parts, "auc": auc, "plain_auc": plain_auc,
        "max_abs_score_err": score_err, "launches": launches,
        "encoder_calls": n_calls, "wall_s": wall, "parts_per_s": n_parts / wall,
        "warm_wall_s": warm_wall, "warm_parts_per_s": n_parts / warm_wall,
        "plain_wall_s": plain_wall, "plain_parts_per_s": n_parts / plain_wall,
        "card": card}))

    max_err = max(r["max_abs_err"] for r in rows)  # over every shape checked
    print(json.dumps({"kernels": [{
        "name": "attention", "route": "cuda",
        "source": "lstc_vad_tpu_torch/csrc/attention.cu",
        "replaces": "lstc_vad_tpu/ops/pallas_attention.py:50",
        "launches": launches,
        "max_abs_err": max_err, "max_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": {k: main_row[k]
                  for k in ("B", "H", "L", "D", "bias", "strided")},
        "card": card}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
