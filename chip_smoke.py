#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: build, check, drive.

    python3 chip_smoke.py

1. Set-up: prints the card's name and power limit (nvidia-smi) and the torch
   and CUDA versions, turns TF32 off, and builds every CUDA kernel of the
   package from the sources in this checkout (one nvcc per source, started
   together).
2. Kernel phase: the attention kernel against its plain PyTorch version at
   H=8, D=256 and every sequence length the models use (the co-teaching
   paths' short tails included: L=17 and 33 at sht_ltn) plus the tile edges
   L=64, 65 and 128 (B=256), at B=2048 and at the main path's own shape,
   with and without bias, and at the main path's shape fed as the encoder
   feeds it (strided views of [B, L, H, D] buffers); the error must stay
   within rtol 1e-4 / atol 1e-5.  Then the bf16 route (csrc/attention_bf16
   .cu) on bf16 q, k, v at every L above and the main path's shape, with
   and without bias, contiguous and strided, against plain_sdpa on the same
   bf16 inputs (rtol 1e-2, atol 2^-7 max|v|: see BF16_RTOL) and, no farther
   than plain_sdpa x1.05, against attention in float64.  Times the kernel,
   the plain version and, as a yardstick the package never calls,
   F.scaled_dot_product_attention (its mask in q's type), with the bound at
   the route's bytes per element and tensor-core rate.  Prints ptxas's
   registers and spills of each kernel instantiation.
3. Slice phase (the main path): LTN scoring to frame AUC at full sht_ltn
   width (3 layers, d_model 2048, d_inner 4096, 8 heads, d_k 256) with
   random weights from a torch.Generator seeded 0, over synthetic features
   at ShanghaiTech test-split scale (107 videos, ~2,550 clips of 16 patches
   x 2048, per-frame masks on the abnormal ones) made from a numpy seed.
   The launch counter is set to 0 just before and read just after; it must
   equal n_layers x encoder calls.  The same eval with attn_impl="plain"
   must give the same frame scores (atol 5e-5) and AUC (within 1e-4).
4. Autograd phase: the kernel's autograd Function (forward: the kernel;
   backward: autograd through plain_sdpa) against autograd through
   plain_sdpa at B=256, L in {17, 49, 81}, and at the main path's shape fed
   as strided views, all with a bias that requires grad: out, dq, dk, dv and
   dbias within rtol 1e-4 / atol 1e-5, and each forward launched the kernel.
5. Train phase, at full sht_ltn width from the same seed-0 weights, over a
   synthetic SHT-scale train split (238 videos, data/synthetic.py) and the
   test split above:
   (a) Trainer.fit(epochs=3) at the preset's dropouts: 3 steps of batch 40,
       evaluations of the test and train splits after epochs 0 and 2.  The
       kernel launches equal n_layers x the evaluations' encoder calls (the
       steps run attention on the plain path, as the JAX package does at
       attention dropout 0.2); losses and AUCs finite, parameters changed.
   (b) One step with every dropout at 0 from the same weights and batch on
       the kernel path and on an attn_impl="plain" copy: the kernel step
       launches it n_layers times, the losses agree within rel 1e-5, each
       parameter's gradient within 1e-3 relative (norm of the difference
       over the norm; two accurate f32 forwards already differ by up to
       ~2.5e-4 here, see GRAD_RTOL), and every parameter the JAX package
       trains has a gradient on the kernel path.
   Prints a ``train`` JSON line: s/step and snippets/s of steps 2-3, peak
   device memory, the evaluations' wall time, launches, gradient errors.
6. Co-teaching phase, at full sht_stn and sht_ltn width from seed-0
   weights, over the same train and test splits:
   CoTeachingDriver.run(rounds=3, stn_epochs=2, ltn_epochs=2) at the
   default thresholds (0.9, 0.65), evaluating after every epoch.  The rounds
   train stn, ltn (on stn_pseudo.npy) and stn_bce (on ltn_pseudo.npy); each
   artifact holds one entry per train video, of its clip count, each value
   0 or above its threshold; the kernel launches equal n_layers x the
   encoder calls of every evaluation and pseudo-label scorer.  Each round's
   pseudo labels are scored again from the same best weights on the kernel
   and on an attn_impl="plain" copy: raw scores within 5e-5, and the saved
   labels of rounds 1 and 2 equal the plain path's thresholded ones apart
   from entries within 5e-5 of the threshold.  The encoder's CLS output on
   a few videos, kernel vs plain, must agree within 1e-4 relative (the STN
   regressor saturates at full width, see CLS_RTOL).  Prints a ``coteach``
   JSON line per round: walls, s/step, pseudo-label clips/s or parts/s, the
   share kept, launches, peak device memory, the largest differences.
7. UCF phase, at full ucf_ltn (final-eval shapes: part_len 2, window_depth
   2) and ucf_stn width from seed-0 weights, over a synthetic UCF-scale
   test split (290 videos, 9 patches x 2048, features made per video from
   the seed when read): evaluate_ucf_ltn through the final-eval
   UCFBinnedScorer (L=19), evaluate_ucf_stn through UCFClipBinScorer
   (L=10), and LTN pseudo labels through the generator's UCF branch at the
   training shape (part_len 3: L=28 and its L=19 tail) over the same videos
   taken as train records.  Each against an attn_impl="plain" copy: frame
   (or raw pseudo) scores within 5e-5, AUCs within 1e-4, launches n_layers
   x encoder calls.  Prints a ``ucf`` JSON line.
8. tenCrop phase, at full sht_ltn width from the seed-0 weights: a tenCrop
   SHT-scale test split (107 videos, [n_clips, 10, 16, 2048] each, 3.4 GB
   held in RAM, data/synthetic.py), evaluate_multicrop_mean (crop-major
   passes) and a crop-0 eval, each against a plain copy (frame scores
   within 5e-5, AUCs within 1e-4); then a Trainer over the same videos as
   tenCrop train records: one PairedTrainDataset(ten_crop=True) pair, one
   fit(1) step with evaluations at crop 0 (finite loss).  Launches equal
   n_layers x encoder calls.  Prints a ``tencrop`` JSON line.
9. Serve phase: the 107 test videos as 107 streams, pushed round-robin one
   clip at a time as base64 f32 JSONL through serve_jsonl in this process
   (flush every 64 pushes, 64 streams a call, then end_all): every stream's
   scores against offline PartScorer(tail_rewindow=False) and a plain-path
   StreamingScorer (5e-5).  Prints clips/s, flush latency p50/p99, device
   calls and padded rows (``serve`` line).
10. serve_mp phase: ``python -m lstc_vad_tpu_torch serve-backend
   --max-batch 128`` as a subprocess on the card (the weights through a
   checkpoint file), then 4 ``serve --backend`` worker subprocesses, each
   reading a quarter of the streams as JSONL from a file: their scores
   against the serve phase's (5e-5); while they run, ``nvidia-smi
   --query-compute-apps=pid`` lists no worker and no worker maps libcuda;
   SIGTERM shuts the backend down and it prints its calls, rows and
   launches (``serve_mp`` line).
11. Export phase: save_scorer_artifact with the tails (L=49/33/17 with
   CLS) from the modules on the card and from a CPU copy; each artifact is
   loaded on the card in a fresh interpreter (``export_child``), which
   scores a saved token batch (against the live kernel path, 5e-5) and
   serves the serve phase's requests through StreamingScorer.from_artifact
   (against the serve phase, 5e-5); the kernel launched n_layers x program
   calls there.  Prints sizes and export, save and load seconds
   (``export`` line).
12. Pack phase, run right after the train phase, in its directory and
   over the same train split: ``write_pack`` writes it as a .lstcpack
   (2.34 GB; timed), a PackedStore opens it in the native reader
   (libpackstore's g++ build is timed again), and for 3 epochs' batches
   (batch 40, 48 clips x 16 x 2048) ``get_batch`` through the native gather and through the numpy reader is
   held bit-equal to the per-item batches from memory, each build timed,
   with the copy of a gathered batch into pinned memory.  Then fit(2) at
   the preset's dropouts from the pack (``data.pack_path``) and from memory,
   same seed: losses within rel 1e-6 (PACK_LOSS_RTOL; the same batches and
   masks), test AUCs within 1e-4, launches n_layers x the evaluations'
   encoder calls; one more epoch of each under torch.profiler gives the
   device's idle share.  Prints a ``pack`` line.
13. cli phase: ``python -m lstc_vad_tpu_torch`` subprocesses on the card
   over the pack: validate-data (exit 0; exit 1 naming the unknown key of a
   broken train list), info (the card's name, every library built),
   profile --mode eval --steps 3 (the attention kernel in the trace,
   n_layers x 3 launches), sweep over optim.lr_encoder (the preset's value
   and half of it, 1 epoch each, full width: two ranked runs),
   export-torch on the pack fit's best weights (the two files load
   strict=True into fresh modules) and evaluate with --ckpt and with
   --torch-ckpt on its files (the same AUC).  Prints a ``cli`` line.
14. bf16 phase, right after the cli phase, at full sht_ltn width from the
   seed-0 weights and one batch (40 pairs) of the train phase's split:
   dropout-free steps with f32 and with bf16 compute (3 each: the first's
   loss, the second's s/step and peak memory, the third's device ms by op
   group under torch.profiler), their losses within 0.05
   (tests/test_train_e2e.py:168);
   the bf16 step on the kernel and on an attn_impl="plain" copy (losses
   within rel 1e-3); the bf16 step under remat (the kernel launched 2 x
   n_layers: the recompute runs it again; 3 steps, profiled as above) and
   with cast_sr (finite loss),
   and the stochastic rounding unbiased over a 2048 x 2048 tensor on the
   card; f32 steps at the preset's dropouts with remat against none (3
   each, profiled as above; the first steps' losses equal and gradients
   within 1e-6 relative: the RPE tables' gradients are summed with
   atomics); one epoch from the pack with
   data.transfer_dtype=bfloat16 against float32 (feature bytes halved,
   losses within 0.05); and a bf16-compute Trainer's evaluation, which
   must launch only the f32 kernel (its f32 twin) and give the f32
   Trainer's AUC.  Prints a ``bf16`` line.
15. Prints each phase's wall time, one JSON line of kernels (for each route,
   launches summed over every path above, and by path), then, as the last
   line, {"ok": true, "device": {"platform": "gpu", "kind": ...,
   "count": ...}}.

Any failed phase raises and the script exits non-zero without that line.
Without a CUDA card it runs nothing and exits 2.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

RTOL, ATOL = 1e-4, 1e-5          # kernel vs plain on the card
SCORE_ATOL, AUC_TOL = 5e-5, 1e-4  # main path, kernel vs plain
# dropout-free train step, kernel path vs plain path.  Per-parameter
# gradients of this step move by up to ~2.5e-4 (relative norm) between any
# two accurate f32 forwards: the plain step against the same step with its
# attention in float64, or against the whole step in float64
# (scripts/torch_train_grad_check.py).  So they are held at 1e-3, above that
# spread; a missing or wrong gradient is off by O(1).
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3
# a round's encoder CLS output, kernel vs plain, as norm(diff) / norm: the
# STN regressor's sigmoid saturates at full width (scores of exactly 0 or
# 1), so its scores alone would compare equal whatever the attention did.
# Two accurate f32 forwards differ by ~1e-6 here; a wrong kernel by O(1).
CLS_RTOL = 1e-4
# fit(2) from a pack against fit(2) from memory: the same batches and the
# same dropout masks, so the same losses up to the order of float sums
PACK_LOSS_RTOL = 1e-6
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
# the f32 kernel's f32-accurate rate: 3xTF32 is three TF32 tensor-core
# products (495 TFLOP/s dense) for each f32 one; the bf16 kernel's, the bf16
# dense rate
F32_FLOP_PER_S = 495e12 / 3
BF16_FLOP_PER_S = 989e12
# the bf16 kernel against plain_sdpa on the same bf16 inputs: both sum exact
# products in f32 but in another order, so a probability near a bf16
# rounding edge may round the other way in one of them, which moves the
# output by up to 2^-7 (a bf16 ulp, relative, of the probabilities summed)
# times max|v|, and the output's own rounding by an ulp (rtol).  The kernel
# must also err no more than plain_sdpa against attention in float64 on the
# same inputs (x BF16_F64_SLACK).
BF16_RTOL, BF16_V_ULP, BF16_F64_SLACK = 1e-2, 2 ** -7, 1.05
# bf16 phase: f32 vs bf16 compute, the dropout-free losses of one step from
# the same weights and batch (tests/test_train_e2e.py:168-169), the bf16
# step on the kernel vs the plain path, and an epoch on the bf16 wire vs f32
BF16_LOSS_ATOL, BF16_KERNEL_LOSS_RTOL = 0.05, 1e-3
H, D = 8, 256
LENGTHS = (10, 17, 19, 28, 33, 49, 64, 65, 81, 128)  # model L, tile edges
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


def bound(b: int, length: int, with_bias: bool, itemsize: int = 4):
    """Least time for one attention call: q, k, v read once and out written
    once at ``itemsize`` bytes an element (and the f32 bias read once) over
    the memory rate, against the two products' FLOPs over the kernel's
    tensor-core rate (3xTF32 for f32, bf16 dense for bf16)."""
    n_bytes = (itemsize * 4 * b * H * length * D
               + (4 * H * length * length if with_bias else 0))
    flops = 4 * b * H * length * length * D
    rate = F32_FLOP_PER_S if itemsize == 4 else BF16_FLOP_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
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
                 strided: bool = False, dtype: str = "float32") -> dict:
    """q, k, v [B, H, L, D] of ``dtype``, contiguous or (``strided``) views
    of [B, L, H, D] buffers as the encoder passes them; the bias f32.  The
    f32 route is held to rtol RTOL / atol ATOL, the bf16 route as BF16_RTOL
    etc. say."""
    import torch
    import torch.nn.functional as F

    from lstc_vad_tpu_torch.ops import cuda_attention
    from lstc_vad_tpu_torch.ops.attention import plain_sdpa, scalar_in

    attention = cuda_attention.attention
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(b * 1000 + length)
    shape = (b, length, H, D) if strided else (b, H, length, D)
    q, k, v = (torch.randn(*shape, device=dev, generator=g).to(dt)
               for _ in range(3))
    if strided:
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    bias = (torch.randn(H, length, length, device=dev, generator=g)
            if with_bias else None)
    temp = float(np.sqrt(D))
    before = cuda_attention.launches_bf16
    out = attention(q, k, v, bias, temp)
    ref = plain_sdpa(q, k, v, temp, bias=bias)
    torch.cuda.synchronize()
    where = f"{dtype} B={b} L={length} bias={with_bias} strided={strided}"
    if out.dtype != dt or not torch.isfinite(out).all():
        raise AssertionError(f"kernel gave {out.dtype} or non-finite values "
                             f"at {where}")
    if cuda_attention.launches_bf16 - before != (dt == torch.bfloat16):
        raise AssertionError(f"the {dtype} call took the wrong route")
    err = (out.float() - ref.float()).abs()
    row = {"B": b, "H": H, "L": length, "D": D, "dtype": dtype,
           "bias": with_bias, "strided": strided,
           "max_abs_err": err.max().item()}
    if dt == torch.float32:
        rtol, atol = RTOL, ATOL
    else:
        rtol, atol = BF16_RTOL, BF16_V_ULP * v.float().abs().max().item()
        # both against attention in float64 on the same bf16 inputs
        s = torch.matmul((q / scalar_in(temp, dt)).double(),
                         k.double().transpose(-1, -2))
        if bias is not None:
            s = s + bias.double()
        exact = torch.matmul(torch.softmax(s, dim=-1), v.double())
        row["f64_err"] = (out.double() - exact).abs().max().item()
        row["plain_f64_err"] = (ref.double() - exact).abs().max().item()
        del s, exact
        if row["f64_err"] > BF16_F64_SLACK * row["plain_f64_err"]:
            raise AssertionError(
                f"kernel farther from float64 than plain_sdpa at {where}: "
                f"{row['f64_err']} vs {row['plain_f64_err']}")
    if (err - (atol + rtol * ref.float().abs())).max().item() > 0:
        raise AssertionError(
            f"kernel disagrees with plain_sdpa at {where}: max abs err "
            f"{row['max_abs_err']} beyond rtol {rtol} / atol {atol}")
    mask = bias[None].to(dt) if bias is not None else None
    bound_ms, bound_by = bound(b, length, with_bias, q.element_size())
    return {
        **row,
        "ms": cuda_ms(lambda: attention(q, k, v, bias, temp)),
        "plain_ms": cuda_ms(lambda: plain_sdpa(q, k, v, temp, bias=bias)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=1.0 / temp)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_autograd(b: int, length: int, dev, strided: bool) -> dict:
    """The kernel's autograd Function against autograd through plain_sdpa:
    out and the gradients of a random weighting of it for q, k, v (leaves
    of [B, L, H, D] buffers when ``strided``) and a bias that requires
    grad."""
    import torch

    from lstc_vad_tpu_torch.ops import cuda_attention
    from lstc_vad_tpu_torch.ops.attention import plain_sdpa

    g = torch.Generator(device=dev).manual_seed(7 * b + length)
    shape = (b, length, H, D) if strided else (b, H, length, D)
    bufs = [torch.randn(*shape, device=dev, generator=g) for _ in range(3)]
    bias0 = torch.randn(H, length, length, device=dev, generator=g)
    w = torch.randn(b, H, length, D, device=dev, generator=g)
    temp = float(np.sqrt(D))

    def run(fn):
        leaves = [x.clone().requires_grad_() for x in bufs]
        bias = bias0.clone().requires_grad_()
        q, k, v = ((x.transpose(1, 2) for x in leaves) if strided
                   else leaves)
        out = fn(q, k, v, bias)
        grads = torch.autograd.grad((out * w).sum(), leaves + [bias])
        return [out.detach(), *grads]

    def kernel(q, k, v, bias):
        return cuda_attention.attention(q, k, v, bias, temp)

    def plain(q, k, v, bias):
        return plain_sdpa(q, k, v, temp, bias=bias)

    before = cuda_attention.launches
    ours = run(kernel)
    torch.cuda.synchronize()
    if cuda_attention.launches != before + 1:
        raise AssertionError("the autograd Function's forward did not "
                             f"launch the kernel at B={b} L={length}")
    ref = run(plain)
    errs = {}
    for name, a, r in zip(("out", "dq", "dk", "dv", "dbias"), ours, ref):
        if not torch.isfinite(a).all():
            raise AssertionError(f"autograd: non-finite {name} at B={b} "
                                 f"L={length}")
        err = (a - r).abs()
        errs[name] = err.max().item()
        if (err - (ATOL + RTOL * r.abs())).max().item() > 0:
            raise AssertionError(
                f"autograd: {name} disagrees with plain at B={b} L={length} "
                f"strided={strided}: max abs err {errs[name]} beyond rtol "
                f"{RTOL} / atol {ATOL}")
    return {"B": b, "H": H, "L": length, "D": D, "strided": strided,
            "max_abs_err": errs,
            "fwd_bwd_ms": cuda_ms(lambda: run(kernel), iters=5),
            "plain_fwd_bwd_ms": cuda_ms(lambda: run(plain), iters=5)}


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


def set_up_train(root: str, seed: int = SEED, **overrides):
    """The train phase's config and data (scripts/torch_train_profile.py
    drives the same set-up): ``sht_ltn`` at full width, the synthetic SHT
    train split made from ``seed`` with its list and masks written under
    ``root``, evaluations every 2 epochs, TF32 off.  Returns (cfg, store)."""
    import torch

    from lstc_vad_tpu_torch.config import preset, replace
    from lstc_vad_tpu_torch.data.synthetic import (sht_train_split,
                                                   write_train_files)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    store, records, masks = sht_train_split(seed)
    train_txt, mask_dir = write_train_files(root, records, masks)
    cfg = replace(preset("sht_ltn"), **{
        "data.train_txt": train_txt, "data.test_mask_dir": mask_dir,
        "inter_epoch": 2, "model_save_dir": os.path.join(root, "ckpt"),
        **overrides})
    return cfg, store


def no_dropout(cfg):
    from lstc_vad_tpu_torch.config import replace

    return replace(cfg, **{"encoder.attn_dropout": 0.0,
                           "encoder.fc_dropout": 0.0,
                           "encoder.ffn_dropout": 0.0,
                           "encoder.position_dropout": 0.0,
                           "head.dropout": 0.0})


def named_params(state) -> dict:
    return {**{f"encoder.{k}": p for k, p in
               state.encoder.named_parameters()},
            **{f"head.{k}": p for k, p in state.head.named_parameters()}}


def run_train(cfg, store, test_videos, card: str) -> dict:
    """Train phase (a) and (b); raises on any failed check."""
    import torch

    from lstc_vad_tpu_torch.config import replace
    from lstc_vad_tpu_torch.data import BatchIterator
    from lstc_vad_tpu_torch.ops import cuda_attention
    from lstc_vad_tpu_torch.train import create_train_state, make_train_step
    from lstc_vad_tpu_torch.train.driver import Trainer

    n_layers = cfg.encoder.n_layers
    # -- (a) fit at the preset's dropouts ---------------------------------
    trainer = Trainer(cfg, store=store, test_videos=test_videos)
    start = {n: p.detach().clone()
             for n, p in named_params(trainer.state).items()}
    torch.cuda.reset_peak_memory_stats()
    cuda_attention.reset_launches()
    result = trainer.fit(epochs=3)
    fit_launches = cuda_attention.launches
    fit_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    eval_calls = trainer.scorer.scorer.n_calls
    if fit_launches != n_layers * eval_calls or fit_launches == 0:
        raise AssertionError(
            f"fit launched the kernel {fit_launches} times; expected "
            f"{n_layers} layers x {eval_calls} eval encoder calls and none "
            "in the steps")
    with open(cfg.metrics_jsonl) as f:
        epochs = [r for r in map(json.loads, f) if r["kind"] == "train"]
    if result.steps != 3 or len(epochs) != 3 or len(result.history) != 2:
        raise AssertionError(f"fit ran {result.steps} steps, {len(epochs)} "
                             f"epochs and {len(result.history)} evaluations")
    losses = [r["loss"] for r in epochs]
    aucs = [(h["auc_test"], h["auc_train"]) for h in result.history]
    if not np.isfinite(losses).all() or not np.isfinite(aucs).all():
        raise AssertionError(f"fit gave losses {losses}, AUCs {aucs}")
    unchanged = [n for n, p in named_params(trainer.state).items()
                 if torch.equal(p, start[n])
                 and not n.startswith("encoder.layer_norm.")]
    if unchanged:
        raise AssertionError(f"fit left parameters unchanged: {unchanged}")
    s_per_step = float(np.mean([r["seconds"] for r in epochs[1:]]))
    snippets = 2 * cfg.data.batch_size * cfg.data.part_num * cfg.data.part_len

    # -- (b) one dropout-free step, kernel path against plain path ----------
    cfg0 = no_dropout(cfg)
    batch = next(iter(BatchIterator(trainer.dataset, cfg.data.batch_size)))
    eval_s = trainer.eval_seconds
    del trainer, start
    torch.cuda.empty_cache()
    states = {impl: create_train_state(
        replace(cfg0, **{"encoder.attn_impl": impl}), seed=SEED)
        for impl in ("auto", "plain")}
    states["plain"].encoder.load_state_dict(
        states["auto"].encoder.state_dict())
    states["plain"].head.load_state_dict(states["auto"].head.state_dict())
    step = make_train_step(cfg0)
    for impl, st in states.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_attention.reset_launches()
        t0 = time.perf_counter()
        _, metrics = step(st, *batch)
        loss = float(metrics["loss"])  # waits for the step
        states[impl] = (st, loss, time.perf_counter() - t0,
                        cuda_attention.launches,
                        torch.cuda.max_memory_allocated() / 2 ** 30)
    (sk, loss_k, sec_k, launch_k, peak_k), (sp, loss_p, sec_p, launch_p, _) \
        = states["auto"], states["plain"]
    if launch_k != n_layers or launch_p != 0:
        raise AssertionError(f"dropout-free step launched the kernel "
                             f"{launch_k} times (expected {n_layers}); the "
                             f"plain step {launch_p} (expected 0)")
    if not abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p):
        raise AssertionError(f"dropout-free step: loss {loss_k} (kernel) vs "
                             f"{loss_p} (plain), limit rel {LOSS_RTOL}")
    # the JAX package has no parameter for the input LayerNorm, which the
    # preset leaves unused: every other parameter must get a gradient
    unused = {"encoder.layer_norm.weight", "encoder.layer_norm.bias"}
    pk, pp = named_params(sk), named_params(sp)
    missing = [n for n, p in pk.items() if p.grad is None and n not in unused]
    if missing or any(pp[n].grad is None for n in pk if n not in unused):
        raise AssertionError(f"no gradient on the kernel path for {missing}")
    grad_err = {}
    for n in pk:
        if n in unused:
            continue
        ref = pp[n].grad
        grad_err[n] = ((pk[n].grad - ref).norm() / ref.norm()).item()
    worst = max(grad_err, key=grad_err.get)
    if not grad_err[worst] <= GRAD_RTOL:
        raise AssertionError(f"dropout-free step: gradient of {worst} off by "
                             f"{grad_err[worst]} relative (limit "
                             f"{GRAD_RTOL})")
    return {
        "preset": "sht_ltn", "batch_size": cfg.data.batch_size,
        "steps": result.steps, "losses": losses, "aucs": aucs,
        "epoch_seconds": [r["seconds"] for r in epochs],
        "s_per_step": s_per_step, "snippets_per_step": snippets,
        "snippets_per_s": snippets / s_per_step,
        "fit_peak_gb": fit_peak_gb, "eval_wall_s": eval_s,
        "fit_launches": fit_launches, "eval_encoder_calls": eval_calls,
        "dropout0": {"loss": loss_k, "plain_loss": loss_p,
                     "launches": launch_k, "s": sec_k, "plain_s": sec_p,
                     "peak_gb": peak_k, "max_grad_rel_err": grad_err[worst],
                     "worst_param": worst, "params_above_1e-4": sum(
                         e > 1e-4 for e in grad_err.values()),
                     "params": len(grad_err)},
        "card": card}


OP_GROUPS = {"gemm": ("aten::mm", "aten::addmm"),
             "attention": ("lstc_vad::attention", "aten::bmm",
                           "aten::_softmax", "aten::_softmax_backward_data"),
             "casts": ("aten::_to_copy", "aten::copy_"),
             "optimizer": ("aten::_foreach_addcmul_", "aten::_foreach_sqrt",
                           "aten::_foreach_add_", "aten::_foreach_addcdiv_")}


def op_group_ms(prof, groups: dict = OP_GROUPS) -> dict:
    """Self device time (ms) of the CPU-side operators of a profile, by
    group of operator names, the rest under "other" (the kernels' own rows
    repeat their operators' time)."""
    from torch.autograd import DeviceType

    out = {k: 0.0 for k in (*groups, "other")}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        out[next((g for g, names in groups.items() if e.key in names),
                 "other")] += ms
    return out


def sr_bias(n: int = 2048, draws: int = 16, device="cuda") -> dict:
    """SR on the card over an n x n tensor whose values lie a fraction f in
    [0, 0.5) of an ulp above a bf16 number: round-to-nearest always rounds
    them down (a mean error of about -0.25 ulp), stochastic rounding is
    unbiased.  The mean error in ulps over every element and draw must be
    within 5 sigma of 0 (sigma <= 0.5 / sqrt(samples))."""
    import torch

    from lstc_vad_tpu_torch.ops.sr import sr_cast

    g = torch.Generator(device=device).manual_seed(SEED)
    base = torch.randn(n, n, device=device, generator=g).to(torch.bfloat16)
    low = base.float()
    ulp = (low.abs() * 2 ** -7).clamp_min(2 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(ulp)))  # a power of two
    frac = torch.rand(n, n, device=device, generator=g) * 0.5
    x = low + frac * ulp
    sr = sum(((sr_cast(x).float() - x) / ulp).double().mean()
             for _ in range(draws)) / draws
    rtn = ((x.to(torch.bfloat16).float() - x) / ulp).double().mean()
    limit = 5 * 0.5 / np.sqrt(n * n * draws)
    out = {"n": n, "draws": draws, "sr_mean_err_ulp": sr.item(),
           "rtn_mean_err_ulp": rtn.item(), "limit_ulp": limit}
    if not abs(out["sr_mean_err_ulp"]) <= limit:
        raise AssertionError(f"stochastic rounding is biased on the card: "
                             f"{out}")
    return out


def run_bf16(cfg, store, test_videos, pack: str, card: str,
             device="cuda", sr_n: int = 2048) -> dict:
    """bf16 phase: the train knobs at full sht_ltn width from the seed-0
    weights and one batch of the train phase's split; raises on any failed
    check.  On the CPU (a rehearsal at a tiny width) nothing launches a
    kernel and no device memory is counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lstc_vad_tpu_torch.config import replace
    from lstc_vad_tpu_torch.data import BatchIterator, Prefetcher
    from lstc_vad_tpu_torch.ops import cuda_attention
    from lstc_vad_tpu_torch.train import create_train_state, make_train_step
    from lstc_vad_tpu_torch.train.driver import Trainer
    from lstc_vad_tpu_torch.utils.misc import resolve_dtype

    dev = torch.device(device)
    card_run = dev.type == "cuda"
    # the launches a step of the kernel path makes on each route
    n_layers = cfg.encoder.n_layers if card_run else 0

    def sync():
        if card_run:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return (torch.cuda.max_memory_allocated() / 2 ** 30 if card_run
                else None)

    cfg0 = no_dropout(cfg)
    trainer = Trainer(cfg, store=store, test_videos=test_videos,
                      device=dev)
    batch = next(iter(BatchIterator(trainer.dataset, cfg.data.batch_size)))
    f32_auc = trainer.evaluate("test")
    del trainer

    def knobs(c, **kw):
        return replace(c, **{f"encoder.{k}": v for k, v in kw.items()})

    def step(c, repeats: int = 1, profiled: bool = False, keep=False):
        """``repeats`` steps of ``c`` from the seed-0 weights: the first's
        loss, launches (both routes) and gradients (``keep``); the wall time
        and peak memory of the last unprofiled one; and, when ``profiled``,
        the last one under torch.profiler for the device ms by op group."""
        st = create_train_state(c, device=dev, seed=SEED)
        fn = make_train_step(c)
        row = {}
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if card_run else [])
        timed = repeats - 1 - (profiled and repeats > 1)
        for i in range(repeats):
            sync()
            cuda_attention.reset_launches()
            ctx = (profile(activities=activities)
                   if profiled and i == repeats - 1 and i else None)
            t0 = time.perf_counter()
            if ctx is not None:
                with ctx as prof:
                    _, m = fn(st, *batch)
                    loss = float(m["loss"])
            else:
                _, m = fn(st, *batch)
                loss = float(m["loss"])  # waits for the step
            sec = time.perf_counter() - t0
            if i == 0:
                row = {"loss": loss, "launches": cuda_attention.launches,
                       "launches_bf16": cuda_attention.launches_bf16}
                if keep:
                    row["grads"] = {n: p.grad.detach().clone() for n, p in
                                    named_params(st).items()
                                    if p.grad is not None}
            if i == timed:
                row["s"] = sec
                row["peak_gb"] = peak_gb()
            if ctx is not None:
                row["device_ms"] = op_group_ms(prof)
                row["device_ms"]["total"] = sum(row["device_ms"].values())
        if not np.isfinite(row["loss"]):
            raise AssertionError(f"non-finite loss {row['loss']}")
        del st
        if card_run:
            torch.cuda.empty_cache()
        return row

    out = {}
    # -- f32 against bf16 compute, dropout-free, same weights and batch -----
    out["f32"] = step(cfg0, repeats=3, profiled=True)
    out["bf16"] = step(knobs(cfg0, compute_dtype="bfloat16"), repeats=3,
                       profiled=True)
    out["loss_diff"] = abs(out["bf16"]["loss"] - out["f32"]["loss"])
    if not out["loss_diff"] <= BF16_LOSS_ATOL:
        raise AssertionError(f"bf16 compute moved the dropout-free loss by "
                             f"{out['loss_diff']} (limit {BF16_LOSS_ATOL})")
    for name, want in (("f32", (n_layers, 0)), ("bf16", (n_layers,
                                                         n_layers))):
        got = (out[name]["launches"], out[name]["launches_bf16"])
        if got != want:
            raise AssertionError(f"the {name} step launched {got} (all, "
                                 f"bf16); expected {want}")
    # -- the bf16 step on the plain path, under remat, with cast_sr ---------
    out["bf16_plain"] = step(knobs(cfg0, compute_dtype="bfloat16",
                                   attn_impl="plain"))
    rel = abs(out["bf16"]["loss"] - out["bf16_plain"]["loss"]) / abs(
        out["bf16_plain"]["loss"])
    out["bf16_kernel_vs_plain_loss_rel"] = rel
    if out["bf16_plain"]["launches"] or not rel <= BF16_KERNEL_LOSS_RTOL:
        raise AssertionError(f"bf16 step: kernel vs plain loss rel {rel} "
                             f"(limit {BF16_KERNEL_LOSS_RTOL}), plain "
                             f"launches {out['bf16_plain']['launches']}")
    out["bf16_remat"] = step(knobs(cfg0, compute_dtype="bfloat16",
                                   remat=True), repeats=3, profiled=True)
    out["cast_sr"] = step(knobs(cfg0, compute_dtype="bfloat16",
                                cast_sr=True))
    for name, mult in (("bf16_remat", 2), ("cast_sr", 1)):
        got = (out[name]["launches"], out[name]["launches_bf16"])
        if got != (mult * n_layers,) * 2:
            raise AssertionError(f"the {name} step launched {got}; expected "
                                 f"{mult} x {n_layers} on the bf16 route")
    out["sr_bias"] = sr_bias(sr_n, device=dev)
    # -- remat against none, f32 at the preset's dropouts -------------------
    plain = step(cfg, repeats=3, profiled=True, keep=True)
    remat = step(knobs(cfg, remat=True), repeats=3, profiled=True, keep=True)
    grad_err = max(((remat["grads"][n] - g).norm() / g.norm()).item()
                   for n, g in plain["grads"].items())
    out["f32_remat"] = {
        "loss": remat["loss"], "plain_loss": plain["loss"],
        "peak_gb": remat["peak_gb"], "plain_peak_gb": plain["peak_gb"],
        "s": remat["s"], "plain_s": plain["s"],
        "device_ms": remat["device_ms"], "plain_device_ms": plain["device_ms"],
        "max_grad_rel_err": grad_err,
        "grads_bit_equal": sum(torch.equal(remat["grads"][n], g)
                               for n, g in plain["grads"].items()),
        "params": len(plain["grads"])}
    del plain, remat
    # the RPE tables' gradients are summed with atomics, in no fixed order
    if out["f32_remat"]["loss"] != out["f32_remat"]["plain_loss"] \
            or not grad_err <= 1e-6:
        raise AssertionError(f"remat changed the step: {out['f32_remat']}")
    # -- one epoch on the bf16 wire from the pack ---------------------------
    wires = {}
    for wire in ("float32", "bfloat16"):
        c = replace(cfg, **{"data.pack_path": pack,
                            "data.transfer_dtype": wire})
        tr = Trainer(c, test_videos=[], device=dev)
        dtype = resolve_dtype(wire)
        one = next(iter(Prefetcher(BatchIterator(tr.dataset,
                                                 c.data.batch_size),
                                   dev, feature_dtype=dtype)))
        m = tr.train_epoch()
        wires[wire] = {"loss": m["loss"], "epoch_s": m["seconds"],
                       "batch_bytes": sum(t.nbytes for t in one),
                       "feature_bytes": one[0].nbytes + one[2].nbytes}
        tr.store.close()
        del tr, one
    out["wire"] = wires
    f, b = wires["float32"], wires["bfloat16"]
    if 2 * b["feature_bytes"] != f["feature_bytes"] \
            or not abs(b["loss"] - f["loss"]) <= BF16_LOSS_ATOL:
        raise AssertionError(f"bf16 wire: {wires}")
    # -- the bf16 Trainer evaluates through the f32 kernel ------------------
    tr = Trainer(knobs(cfg, compute_dtype="bfloat16", remat=True),
                 store=store, test_videos=test_videos, device=dev)
    cuda_attention.reset_launches()
    auc = tr.evaluate("test")
    calls = tr.scorer.scorer.n_calls
    out["eval"] = {"auc": auc, "f32_auc": f32_auc,
                   "launches": cuda_attention.launches,
                   "launches_bf16": cuda_attention.launches_bf16,
                   "encoder_calls": calls}
    del tr
    if auc != f32_auc or cuda_attention.launches_bf16 \
            or cuda_attention.launches != n_layers * calls:
        raise AssertionError(f"the bf16 Trainer's evaluation: {out['eval']}")
    if card_run:
        torch.cuda.empty_cache()
    return {**out, "preset": "sht_ltn", "batch_size": cfg.data.batch_size,
            "card": card}


def set_up_coteach(cfg_t, root: str):
    """sht_stn and sht_ltn at full width over the train phase's split and
    masks, evaluating after every epoch, metrics in one JSON-lines file."""
    from lstc_vad_tpu_torch.config import preset

    common = {"data.train_txt": cfg_t.data.train_txt,
              "data.test_mask_dir": cfg_t.data.test_mask_dir,
              "inter_epoch": 1,
              "model_save_dir": os.path.join(root, "coteach_ckpt"),
              "metrics_jsonl": os.path.join(root, "coteach.jsonl")}
    return preset("sht_stn", **common), preset("sht_ltn", **common)


def plain_copy(cfg, encoder, head):
    """An ``encoder.attn_impl="plain"`` encoder and a head on the encoder's
    device, holding ``encoder``'s and ``head``'s weights."""
    from lstc_vad_tpu_torch.config import replace
    from lstc_vad_tpu_torch.models import build

    device = next(encoder.parameters()).device
    plain_enc, plain_head = build(
        replace(cfg, **{"encoder.attn_impl": "plain"}), device=device,
        seed=SEED)
    plain_enc.load_state_dict(encoder.state_dict(), strict=True)
    plain_head.load_state_dict(head.state_dict(), strict=True)
    return plain_enc, plain_head


def pseudo_raw(trainer, store, plain: bool = False):
    """The round's pseudo-label scores before thresholding (a threshold of
    -1 keeps every one), from its best weights, through the kernel or
    (``plain``) plain attention."""
    from lstc_vad_tpu_torch.pseudo import (generate_ltn_pseudo_labels,
                                           generate_stn_pseudo_labels,
                                           pseudo_scorer)

    cfg, d = trainer.cfg, trainer.cfg.data
    encoder, head = trainer.scoring_modules()
    if plain:
        encoder, head = plain_copy(cfg, encoder, head)
    scorer = pseudo_scorer(cfg, encoder, head)
    if cfg.model.startswith("stn"):
        return generate_stn_pseudo_labels(scorer, store,
                                          trainer.train_records, -1.0)
    return generate_ltn_pseudo_labels(scorer, store, trainer.train_records,
                                      -1.0, dataset=d.dataset,
                                      segment_len=d.segment_len)


def cls_err(trainer, store, n_videos: int = 8):
    """(relative, max abs) difference of the encoder's CLS output between
    the round's best weights through the kernel and through plain
    attention, over the first ``n_videos`` train videos' clips (STN) or
    full parts (LTN)."""
    import torch

    d = trainer.cfg.data
    x = np.concatenate([store.get(r.key)[:, :d.n_patch]
                        for r in trainer.train_records[:n_videos]])
    if not trainer.cfg.model.startswith("stn"):
        n = len(x) // d.part_len * d.part_len
        x = x[:n].reshape(n // d.part_len, d.part_len * d.n_patch, -1)
    encoder, head = trainer.scoring_modules()
    plain_enc, _ = plain_copy(trainer.cfg, encoder, head)
    x = torch.from_numpy(x).to(trainer.device)
    with torch.inference_mode():
        kernel, plain = encoder(x)[:, 0], plain_enc(x)[:, 0]
    diff = kernel - plain
    return ((diff.norm() / plain.norm()).item(), diff.abs().max().item())


def check_labels(labels, plain_raw, tau: float, what: str):
    """Thresholded ``labels`` against the plain path's raw scores: equal
    zero patterns and values within SCORE_ATOL, apart from entries within
    SCORE_ATOL of the threshold ``tau``."""
    if labels.keys() != plain_raw.keys():
        raise AssertionError(f"{what}: the labels' videos differ")
    for key, raw in plain_raw.items():
        got = labels[key]
        want = np.where(raw > tau, raw, 0.0)
        clear = np.abs(raw - tau) > SCORE_ATOL
        if got.shape != raw.shape or (
                (got[clear] == 0) != (want[clear] == 0)).any() or (
                np.abs(got - want)[clear] > SCORE_ATOL).any():
            raise AssertionError(f"{what}: labels of {key} differ from the "
                                 "plain path's beyond the threshold edge")


def max_dict_err(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k] - b[k]).max()) for k in b)


def run_coteach(cfg_stn, cfg_ltn, store, test_videos, root: str,
                card: str) -> dict:
    """Co-teaching phase; raises on any failed check."""
    from lstc_vad_tpu_torch.data import load_pseudo_labels
    from lstc_vad_tpu_torch.evaluation.frame_auc import n_parts
    from lstc_vad_tpu_torch.ops import cuda_attention
    from lstc_vad_tpu_torch.pseudo import CoTeachingDriver

    driver = CoTeachingDriver(cfg_stn, cfg_ltn, os.path.join(root, "work"),
                              store=store, test_videos=test_videos)
    cuda_attention.reset_launches()
    trainers = driver.run(rounds=3, stn_epochs=2, ltn_epochs=2)
    launches = cuda_attention.launches
    n_layers = cfg_stn.encoder.n_layers
    assert cfg_ltn.encoder.n_layers == n_layers
    calls = [t.scorer.scorer.n_calls + r["pseudo_encoder_calls"]
             for t, r in zip(trainers, driver.rounds)]
    if launches != n_layers * sum(calls) or launches == 0:
        raise AssertionError(
            f"co-teaching launched the kernel {launches} times; expected "
            f"{n_layers} layers x {sum(calls)} evaluation and pseudo-label "
            "encoder calls")
    models = [t.cfg.model for t in trainers]
    if models != ["stn", "ltn", "stn_bce"]:
        raise AssertionError(f"co-teaching rounds trained {models}")
    if trainers[1].cfg.data.pseudo_labels_path != driver.stn_pseudo_path \
            or trainers[2].cfg.data.pseudo_labels_path \
            != driver.ltn_pseudo_path:
        raise AssertionError("a round did not read the other network's "
                             "pseudo labels")
    records = trainers[0].train_records
    clips = {r.key: store.n_clips(r.key) for r in records}
    artifacts = {}
    for path, tau in ((driver.stn_pseudo_path, driver.stn_threshold),
                      (driver.ltn_pseudo_path, driver.ltn_threshold)):
        labels = artifacts[path] = load_pseudo_labels(path)
        if {k[:-4] for k in labels} != set(clips) or any(
                len(v) != clips[k[:-4]] or not ((v == 0) | (v > tau)).all()
                for k, v in labels.items()):
            raise AssertionError(f"{path}: not one entry of clip length per "
                                 f"train video, each 0 or above {tau}")
    # every round's pseudo labels again from its best weights, kernel vs
    # plain; rounds 1 and 2 wrote the artifacts left on disk
    with open(cfg_stn.metrics_jsonl) as f:
        epochs = [r for r in map(json.loads, f) if r["kind"] == "train"]
    rows = []
    for i, (trainer, rec) in enumerate(zip(trainers, driver.rounds)):
        kernel = pseudo_raw(trainer, store)
        plain = pseudo_raw(trainer, store, plain=True)
        err = max_dict_err(kernel, plain)
        if err > SCORE_ATOL:
            raise AssertionError(f"round {i}: pseudo-label scores differ "
                                 f"from the plain path by {err}")
        cls_rel, cls_abs = cls_err(trainer, store)
        if not cls_rel <= CLS_RTOL:
            raise AssertionError(f"round {i}: the encoder's CLS output "
                                 f"differs from the plain path by {cls_rel} "
                                 f"relative (limit {CLS_RTOL})")
        tau = (driver.stn_threshold if trainer.cfg.model.startswith("stn")
               else driver.ltn_threshold)
        if i:
            check_labels(artifacts[driver.stn_pseudo_path if i == 2
                                   else driver.ltn_pseudo_path],
                         plain, tau, f"round {i}")
        stn = trainer.cfg.model.startswith("stn")
        units = sum(clips.values()) if stn else sum(
            n_parts(n, trainer.cfg.data.part_len) for n in clips.values())
        seconds = [r["seconds"] for r in epochs[2 * i:2 * i + 2]]
        rows.append({
            "round": i, "model": trainer.cfg.model,
            "wall_s": rec["fit_seconds"] + rec["pseudo_seconds"],
            "fit_s": rec["fit_seconds"], "epoch_seconds": seconds,
            "s_per_step": seconds[-1], "eval_wall_s": trainer.eval_seconds,
            "pseudo_wall_s": rec["pseudo_seconds"],
            "pseudo_unit": "clips" if stn else "parts",
            "pseudo_units": units,
            "pseudo_units_per_s": units / rec["pseudo_seconds"],
            "kept": rec["kept"], "threshold": tau,
            "encoder_calls": calls[i], "launches": n_layers * calls[i],
            "peak_gb": (rec["peak_bytes"] / 2 ** 30
                        if rec["peak_bytes"] is not None else None),
            "max_abs_score_err": err, "cls_rel_err": cls_rel,
            "cls_max_abs_err": cls_abs})
    return {"rounds": rows, "launches": launches, "card": card}


def run_ucf(card: str) -> dict:
    """UCF phase; raises on any failed check."""
    from lstc_vad_tpu_torch.config import preset
    from lstc_vad_tpu_torch.data.synthetic import ucf_test_split
    from lstc_vad_tpu_torch.evaluation.drivers import (evaluate_ucf_ltn,
                                                       evaluate_ucf_stn)
    from lstc_vad_tpu_torch.evaluation.frame_auc import (part_bounds,
                                                         ucf_bin_edges,
                                                         ucf_part_plan)
    from lstc_vad_tpu_torch.evaluation.scoring import (UCFClipBinScorer,
                                                       ucf_final_eval_scorer,
                                                       ucf_final_eval_shapes)
    from lstc_vad_tpu_torch.models import build
    from lstc_vad_tpu_torch.ops import cuda_attention
    from lstc_vad_tpu_torch.pseudo import (generate_ltn_pseudo_labels,
                                           pseudo_scorer)

    t0 = time.perf_counter()
    store, videos, records = ucf_test_split(SEED)
    # final and STN evals bin n_frames // 16 clips (cli.py cmd_evaluate)
    items = [(v.loader, v.anno, v.n_frames // 16) for v in videos]
    out = {"videos": len(videos), "clips": sum(store.clips.values()),
           "split_made_s": time.perf_counter() - t0}

    def ltn_eval(enc, head, cfg):
        scorer = ucf_final_eval_scorer(cfg, enc, head)
        auc, scores = evaluate_ucf_ltn(scorer, items, cfg.data.segment_len,
                                       return_scores=True)
        return scorer, auc, scores, len(videos) * len(
            ucf_part_plan(cfg.max_clips, cfg.data.part_len))

    def stn_eval(enc, head, cfg):
        # the Trainer's UCF STN scorer, as cmd_evaluate uses it
        scorer = UCFClipBinScorer(enc, head, cfg.data.n_patch, cfg.max_clips)
        auc, scores = evaluate_ucf_stn(scorer, items, cfg.data.segment_len,
                                       return_scores=True)
        bins = sum(int(np.count_nonzero(np.diff(
            ucf_bin_edges(n, cfg.max_clips)))) for _, _, n in items)
        return scorer, auc, scores, bins

    def pseudo(enc, head, cfg):
        scorer = pseudo_scorer(cfg, enc, head)
        raw = generate_ltn_pseudo_labels(scorer, store, records, -1.0,
                                         dataset="UCF",
                                         segment_len=cfg.data.segment_len)
        return (scorer, None, raw, len(records) * len(
            part_bounds(cfg.max_clips, cfg.data.part_len)))

    paths = (("ltn_eval", ucf_final_eval_shapes(preset("ucf_ltn")), ltn_eval,
              "parts"),
             ("stn_eval", preset("ucf_stn"), stn_eval, "bins"),
             ("pseudo", preset("ucf_ltn"), pseudo, "parts"))
    total = 0
    for name, cfg, fn, unit in paths:
        enc, head = build(cfg, device="cuda", seed=SEED)
        cuda_attention.reset_launches()
        t0 = time.perf_counter()
        scorer, auc, scores, units = fn(enc, head, cfg)
        wall = time.perf_counter() - t0
        launches = cuda_attention.launches
        calls = scorer.scorer.n_calls
        if launches != cfg.encoder.n_layers * calls or launches == 0:
            raise AssertionError(f"ucf {name}: {launches} kernel launches "
                                 f"for {calls} encoder calls")
        plain_enc, plain_head = plain_copy(cfg, enc, head)
        del enc, head, scorer
        _, plain_auc, plain_scores, _ = fn(plain_enc, plain_head, cfg)
        del plain_enc, plain_head
        if cuda_attention.launches != launches:
            raise AssertionError(f"ucf {name}: the plain path launched the "
                                 "kernel")
        if auc is None:  # raw pseudo-label scores, thresholded at 0.65
            err = max_dict_err(scores, plain_scores)
            check_labels({k: np.where(v > 0.65, v, 0.0)
                          for k, v in scores.items()}, plain_scores, 0.65,
                         "ucf pseudo labels")
            row = {"kept_at_0.65": float(np.mean(np.concatenate(
                list(scores.values())) > 0.65))}
        else:
            err = max((float(np.abs(a - b).max()) for a, b in
                       zip(scores, plain_scores) if len(a)), default=0.0)
            if not np.isfinite(auc) or abs(auc - plain_auc) > AUC_TOL:
                raise AssertionError(f"ucf {name}: AUC {auc} vs plain "
                                     f"{plain_auc} (limit {AUC_TOL})")
            row = {"auc": auc, "plain_auc": plain_auc}
        if err > SCORE_ATOL:
            raise AssertionError(f"ucf {name}: scores differ from the "
                                 f"plain path by {err} (limit {SCORE_ATOL})")
        total += launches
        out[name] = {**row, unit: units, "wall_s": wall,
                     f"{unit}_per_s": units / wall, "encoder_calls": calls,
                     "launches": launches, "max_abs_score_err": err}
    out.update(launches=total, card=card)
    return out


def check_launches(launches: int, n_layers: int, calls: int, device: str,
                   what: str):
    """On the card every encoder call launches the kernel once a layer, and
    a path launches it at least once; on the CPU nothing launches."""
    want = n_layers * calls if device == "cuda" else 0
    if launches != want or (device == "cuda" and launches == 0):
        raise AssertionError(f"{what}: the kernel launched {launches} times "
                             f"for {calls} encoder calls ({n_layers} "
                             "layers)")


def run_tencrop(cfg, encoder, head, root: str, card: str,
                device="cuda") -> dict:
    """tenCrop phase; raises on any failed check."""
    import torch

    from lstc_vad_tpu_torch.config import replace
    from lstc_vad_tpu_torch.data.synthetic import (sht_tencrop_test_split,
                                                   write_train_files)
    from lstc_vad_tpu_torch.evaluation.drivers import (evaluate_ltn,
                                                       evaluate_multicrop_mean)
    from lstc_vad_tpu_torch.evaluation.scoring import PartScorer
    from lstc_vad_tpu_torch.ops import cuda_attention
    from lstc_vad_tpu_torch.train.driver import Trainer

    t0 = time.perf_counter()
    store, videos, records, masks = sht_tencrop_test_split(SEED)
    out = {"videos": len(videos),
           "clips": sum(v.n_clips for v in videos),
           "gb": sum(f.nbytes for f in store.feats.values()) / 1e9,
           "split_made_s": time.perf_counter() - t0}
    d, n_layers = cfg.data, cfg.encoder.n_layers

    def items_for_crop(c):
        return [((lambda v=v, c=c: v.feat[:, c]), v.anno) for v in videos]

    def evals(enc, hd):
        scorer = PartScorer(enc, hd, d.part_len, d.n_patch,
                            tail_rewindow=cfg.eval_tail_rewindow)
        t0 = time.perf_counter()
        mean = evaluate_multicrop_mean(evaluate_ltn, scorer, items_for_crop,
                                       d.segment_len, return_scores=True)
        t1 = time.perf_counter()
        crop0 = evaluate_ltn(scorer, items_for_crop(0), d.segment_len,
                             return_scores=True)
        return mean, crop0, t1 - t0, scorer.scorer.n_calls

    cuda_attention.reset_launches()
    mean, crop0, mean_wall, calls = evals(encoder, head)
    launches = cuda_attention.launches
    check_launches(launches, n_layers, calls, device, "tencrop evals")
    plain_mean, plain_crop0, plain_wall, _ = evals(
        *plain_copy(cfg, encoder, head))
    if cuda_attention.launches != launches:
        raise AssertionError("tencrop: the plain path launched the kernel")
    for name, (auc, scores), (p_auc, p_scores) in (
            ("mean", mean, plain_mean), ("crop0", crop0, plain_crop0)):
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(scores, p_scores))
        if not np.isfinite(auc) or abs(auc - p_auc) > AUC_TOL \
                or err > SCORE_ATOL:
            raise AssertionError(f"tencrop {name}: AUC {auc} vs plain "
                                 f"{p_auc}, frame scores off by {err}")
        out[name] = {"auc": auc, "plain_auc": p_auc,
                     "max_abs_score_err": err}
    out.update(encoder_calls=calls, mean_wall_s=mean_wall,
               plain_mean_wall_s=plain_wall)

    # one full-width fit(1) step on tenCrop training data: the pair-shared
    # crop draw, then evaluations of the test and train splits at crop 0
    train_txt, mask_dir = write_train_files(os.path.join(root, "tencrop"),
                                            records, masks)
    cfg_t = replace(cfg, **{"data.ten_crop": True, "data.eval_crop": 0,
                            "data.train_txt": train_txt,
                            "data.test_mask_dir": mask_dir,
                            "model_save_dir": os.path.join(root, "tc_ckpt")})
    trainer = Trainer(cfg_t, store=store, test_videos=videos, device=device)
    batch = trainer.dataset[0]
    want = (d.part_num * d.part_len, d.n_patch, d.d_model)
    if batch[0].shape != want or batch[2].shape != want:
        raise AssertionError(f"tenCrop pair shapes {batch[0].shape}, "
                             f"{batch[2].shape}; expected {want}")
    cuda_attention.reset_launches()
    t0 = time.perf_counter()
    result = trainer.fit(1)
    fit_wall = time.perf_counter() - t0
    fit_launches = cuda_attention.launches
    fit_calls = trainer.scorer.scorer.n_calls
    entry = result.history[-1]
    if result.steps != 1 or not np.isfinite(entry["loss"]):
        raise AssertionError(f"tenCrop fit(1): {result.steps} steps, loss "
                             f"{entry['loss']}")
    check_launches(fit_launches, n_layers, fit_calls, device,
                   "tenCrop fit(1) evals")
    out["fit"] = {"steps": result.steps, "loss": entry["loss"],
                  "auc_test": entry["auc_test"],
                  "auc_train": entry["auc_train"], "wall_s": fit_wall,
                  "eval_encoder_calls": fit_calls, "launches": fit_launches}
    del trainer, store, videos
    if device == "cuda":
        torch.cuda.empty_cache()
    out.update(launches=launches + fit_launches, card=card)
    return out


def _trainer_run(trainer, jsonl: str, device: str, trace_dir: str):
    """fit(2) with the kernel's launches counted, then one more epoch under
    the profiler for the device's idle share of an epoch (batch building
    included: one step an epoch leaves the prefetcher nothing to overlap)."""
    from lstc_vad_tpu_torch.ops import cuda_attention
    from lstc_vad_tpu_torch.utils.profiling import (TRACE_FILE,
                                                    device_busy_ms, trace)

    cuda_attention.reset_launches()
    result = trainer.fit(2)
    launches = cuda_attention.launches
    if result.steps < 1:
        raise AssertionError("fit(2) took no step")
    with open(jsonl) as f:
        epochs = [r for r in map(json.loads, f) if r["kind"] == "train"]
    with trace(trace_dir):
        t0 = time.perf_counter()
        trainer.train_epoch()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = (device_busy_ms(os.path.join(trace_dir, TRACE_FILE))
            if device == "cuda" else None)
    return {"losses": [r["loss"] for r in epochs],
            "aucs_test": [h["auc_test"] for h in result.history],
            "aucs_train": [h["auc_train"] for h in result.history],
            "s_per_step": sum(r["seconds"] for r in epochs) / result.steps,
            "traced_epoch_ms": wall_ms, "traced_epoch_busy_ms": busy,
            "idle_share": None if busy is None else 1.0 - busy / wall_ms,
            "launches": launches,
            "eval_encoder_calls": trainer.scorer.scorer.n_calls}


def run_pack(cfg, store, test_videos, root: str, card: str,
             device="cuda") -> dict:
    """Pack phase: the train split written as a .lstcpack, its batches held
    bit-equal to the in-memory per-item batches, the batch build timed per
    reader, and fit(2) from the pack against fit(2) from memory; raises on
    any failed check.  Returns (row, path of the pack, params file of the
    pack fit's best weights)."""
    import torch

    from lstc_vad_tpu_torch.ckpt import save_checkpoint
    from lstc_vad_tpu_torch.config import replace
    from lstc_vad_tpu_torch.data import (BatchIterator, PackedStore,
                                         PairedTrainDataset,
                                         load_train_records)
    from lstc_vad_tpu_torch.data.packed import write_pack
    from lstc_vad_tpu_torch.ops import _build
    from lstc_vad_tpu_torch.train.driver import Trainer

    d, n_layers = cfg.data, cfg.encoder.n_layers
    pack = os.path.join(root, "train.lstcpack")
    t0 = time.perf_counter()
    write_pack(pack, store.feats.items())
    out = {"videos": len(store.feats), "pack_gb": os.path.getsize(pack) / 1e9,
           "write_s": time.perf_counter() - t0}
    # the reader's build, timed again apart from main()'s parallel build
    lib = os.path.join(root, "libpackstore.so")
    t0 = time.perf_counter()
    subprocess.run(_build._command("packstore", lib), check=True,
                   capture_output=True, timeout=300)
    out["libpackstore_build_s"] = time.perf_counter() - t0

    records = load_train_records(d.dataset, d.train_txt)
    kw = dict(part_num=d.part_num, part_len=d.part_len, n_patch=d.n_patch,
              sample=d.sample, seed=d.seed)
    native = PackedStore(pack)
    if not native.native:
        raise AssertionError("the pack did not open in the native reader")
    readers = {"native": PairedTrainDataset(records, native, **kw),
               "numpy": PairedTrainDataset(
                   records, PackedStore(pack, use_native=False), **kw),
               "memory": PairedTrainDataset(records, store, **kw)}
    build_ms = {name: [] for name in readers}
    pin_ms = []
    n_batches = 0
    for _ in range(3):  # epochs
        batches = {}
        for name, ds in readers.items():
            t0 = time.perf_counter()
            batches[name] = list(BatchIterator(ds, d.batch_size))
            build_ms[name].append((time.perf_counter() - t0) * 1e3
                                  / max(len(batches[name]), 1))
            ds.shuffle_keys()
        want = batches["memory"]
        for name in ("native", "numpy"):
            if len(batches[name]) != len(want) or not all(
                    np.array_equal(a, b) and a.dtype == b.dtype
                    for got, ref in zip(batches[name], want)
                    for a, b in zip(got, ref)):
                raise AssertionError(f"pack batches ({name} reader) differ "
                                     "from the in-memory per-item batches")
        n_batches += len(want)
        if device == "cuda":
            # the Prefetcher's copy of a gathered batch into pinned memory
            for batch in batches["native"]:
                t0 = time.perf_counter()
                for a in batch:
                    torch.empty(a.shape, dtype=torch.float32,
                                pin_memory=True).copy_(torch.from_numpy(a))
                pin_ms.append((time.perf_counter() - t0) * 1e3)
        del batches, want
    native.close()
    out.update(batches_checked=n_batches, batch_mb=float(
        2 * d.batch_size * d.part_num * d.part_len * d.n_patch * d.d_model
        * 4 / 1e6), batch_build_ms={k: float(np.median(v))
                                    for k, v in build_ms.items()},
        batch_build_ms_all=build_ms,
        pin_copy_ms=float(np.median(pin_ms)) if pin_ms else None)

    runs = {}
    for name in ("pack", "memory"):
        jsonl = os.path.join(root, f"pack_{name}.jsonl")
        over = {"metrics_jsonl": jsonl,
                "model_save_dir": os.path.join(root, f"pack_{name}_ckpt")}
        if name == "pack":
            over["data.pack_path"] = pack
        trainer = Trainer(replace(cfg, **over), device=device,
                          store=None if name == "pack" else store,
                          test_videos=test_videos)
        runs[name] = _trainer_run(trainer, jsonl, device,
                                  os.path.join(root, f"trace_{name}"))
        check_launches(runs[name]["launches"], n_layers,
                       runs[name]["eval_encoder_calls"], device,
                       f"fit(2) from {name}")
        if name == "pack":
            if not trainer.store.native:
                raise AssertionError("the pack Trainer's store is not native")
            best = os.path.join(root, "pack_best.pt")
            save_checkpoint(best, trainer.best_params or trainer.params())
        del trainer
        if device == "cuda":
            torch.cuda.empty_cache()
    got, want = runs["pack"], runs["memory"]
    for a, b in zip(got["losses"], want["losses"]):
        if not np.isfinite(a) or not abs(a - b) <= PACK_LOSS_RTOL * abs(b):
            raise AssertionError(f"fit(2) losses from the pack {got['losses']}"
                                 f" vs from memory {want['losses']} (limit "
                                 f"rel {PACK_LOSS_RTOL})")
    if len(got["losses"]) != 2 or not np.allclose(
            got["aucs_test"], want["aucs_test"], rtol=0, atol=AUC_TOL):
        raise AssertionError(f"fit(2) test AUCs {got['aucs_test']} (pack) vs "
                             f"{want['aucs_test']} (memory)")
    out.update(fit_pack=got, fit_memory=want, loss_rtol=PACK_LOSS_RTOL,
               launches=got["launches"] + want["launches"], card=card)
    return out, pack, best


def _run_all(cmds: dict, cwd: str, timeout: float) -> dict:
    """Run {name: argv} as ``python -m lstc_vad_tpu_torch`` subprocesses,
    all started together; {name: (returncode, stdout, stderr, wall s)}."""
    env = dict(os.environ, PYTHONPATH=cwd)
    procs = {name: (subprocess.Popen(
        [sys.executable, "-m", "lstc_vad_tpu_torch", *argv], cwd=cwd,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        time.perf_counter()) for name, argv in cmds.items()}
    results = {}
    try:
        for name, (proc, t0) in procs.items():
            so, se = proc.communicate(timeout=timeout)
            results[name] = (proc.returncode, so, se, time.perf_counter() - t0)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def run_cli(cfg, pack: str, best: str, store, root: str, card: str,
            device="cuda") -> dict:
    """cli phase: validate-data, info, profile, sweep, export-torch and
    evaluate as subprocesses over the pack and the train phase's text
    files; raises on any failed check."""
    from lstc_vad_tpu_torch.ckpt.interop import load_reference_checkpoint
    from lstc_vad_tpu_torch.config import replace
    from lstc_vad_tpu_torch.models import build

    here = os.path.dirname(os.path.abspath(__file__))
    d = cfg.data
    # the train videos again as an SHT test list (key,label,n_frames; the
    # abnormal ones' masks are in the train phase's mask dir)
    test_txt = os.path.join(root, "cli_test.txt")
    bad_txt = os.path.join(root, "cli_train_bad.txt")
    with open(test_txt, "w") as f:
        for key, feat in store.feats.items():
            abnormal = os.path.exists(os.path.join(d.test_mask_dir,
                                                   key + ".npy"))
            f.write(f"{key},{int(abnormal)},"
                    f"{-1 if abnormal else 16 * len(feat)}\n")
    with open(d.train_txt) as f, open(bad_txt, "w") as g:
        g.write(f.read() + "ghost_video_000,0\n")
    dev = ["--device", device]
    # the model's widths only: the lists go in as flags of their own
    widths = cfg_flags(replace(cfg, **{"data.train_txt": "",
                                       "data.test_mask_dir": ""}))
    data = ["--preset", cfg_name(cfg), *widths, "--set",
            f"data.pack_path={pack}", "--test-txt", test_txt, "--mask-dir",
            d.test_mask_dir]
    lr = cfg.optim.lr_encoder
    prof, enc, head = (os.path.join(root, n) for n in
                       ("cli_prof", "cli_enc.ckpt", "cli_head.ckpt"))
    sweep_out = os.path.join(root, "cli_sweep.jsonl")
    waves = [
        {"validate_ok": ["validate-data", *data, "--train-txt", d.train_txt],
         "validate_bad": ["validate-data", *data, "--train-txt", bad_txt],
         "info": ["info", *dev],
         "export_torch": ["export-torch", *data, "--ckpt", best,
                          "--encoder-out", enc, "--head-out", head, *dev]},
        {"profile": ["profile", "--preset", cfg_name(cfg), *widths,
                     "--mode", "eval", "--steps", "3", "--out", prof, *dev],
         "sweep": ["sweep", *data, "--train-txt", d.train_txt, "--grid",
                   f"optim.lr_encoder={lr},{lr / 2}", "--epochs", "1",
                   "--out", sweep_out, "--save-dir",
                   os.path.join(root, "cli_sweep_ckpt"), *dev],
         "evaluate_ckpt": ["evaluate", *data, "--ckpt", best, *dev],
         "evaluate_torch_ckpt": ["evaluate", *data, "--torch-ckpt",
                                 "--encoder-ckpt", enc, "--head-ckpt", head,
                                 *dev]}]
    results = {}
    for wave in waves:
        results.update(_run_all(wave, here, timeout=600))
    walls = {name: r[3] for name, r in results.items()}
    want_rc = {name: 1 if name == "validate_bad" else 0 for name in results}
    for name, (rc, so, se, _) in results.items():
        if rc != want_rc[name]:
            raise AssertionError(f"cli {name}: exit {rc} (expected "
                                 f"{want_rc[name]}): {se[-3000:]}")
    out = {"walls_s": walls}
    so = results["validate_ok"][1]
    if "ok: all referenced" not in so:
        raise AssertionError(f"cli validate-data: {so[-2000:]}")
    so = results["validate_bad"][1]
    if "'ghost_video_000' not in the feature store" not in so \
            or "1 problem(s) found" not in so:
        raise AssertionError(f"cli validate-data (bad list): {so[-2000:]}")
    out["validate_stats"] = so.splitlines()[0]
    so = results["info"][1]
    lines = ["packstore (packstore.cpp): built"]
    if device == "cuda":  # on the CPU nothing builds the kernel
        import torch

        lines += ["attention (attention.cu): built",
                  "attention_bf16 (attention_bf16.cu): built",
                  torch.cuda.get_device_name(0)]
    if not all(ln in so for ln in lines):
        raise AssertionError(f"cli info: {so}")
    prof_row = json.loads(results["profile"][1].splitlines()[-1])
    with open(os.path.join(prof, "trace.json")) as f:
        kernel_in_trace = "attention_fwd_kernel" in f.read()
    want_launches = cfg.encoder.n_layers * 3 if device == "cuda" else 0
    if prof_row["attention_launches"] != want_launches or (
            device == "cuda" and not kernel_in_trace):
        raise AssertionError(f"cli profile: {prof_row}, attention kernel in "
                             f"the trace: {kernel_in_trace}")
    out["profile"] = {**prof_row, "kernel_in_trace": kernel_in_trace}
    with open(sweep_out) as f:
        sweep = [json.loads(ln) for ln in f]
    table = results["sweep"][1].split("rank ")[-1].splitlines()[1:]
    if len(sweep) != 2 or len(table) != 2 or not all(
            np.isfinite(r["gate_auc"]) for r in sweep):
        raise AssertionError(f"cli sweep: {sweep}, table {table}")
    out["sweep"] = {"records": sweep, "ranking": table}
    # the exported files load strict=True into fresh modules
    enc_sd, head_sd = load_reference_checkpoint(enc, head)
    fresh_enc, fresh_head = build(cfg, device=device, seed=SEED + 1)
    fresh_enc.load_state_dict(enc_sd, strict=True)
    fresh_head.load_state_dict(head_sd, strict=True)
    aucs = [auc_line(results[n][1])
            for n in ("evaluate_ckpt", "evaluate_torch_ckpt")]
    if not np.isfinite(aucs[0]) or abs(aucs[0] - aucs[1]) > 1e-9:
        raise AssertionError(f"cli evaluate: --ckpt AUC {aucs[0]}, "
                             f"--torch-ckpt AUC {aucs[1]}")
    out.update(evaluate_auc_ckpt=aucs[0], evaluate_auc_torch_ckpt=aucs[1],
               export_keys=len(enc_sd) + len(head_sd),
               passed=sorted(results), card=card)
    return out


def auc_line(stdout: str) -> float:
    return float([ln for ln in stdout.splitlines()
                  if ln.startswith("auc = ")][-1].split("=")[1])


def stream_requests(items) -> list:
    """The test split as JSONL push requests, one clip at a time round-robin
    over the videos (stream ``v<index>``), base64 f32 payloads, then
    end_all."""
    import base64

    lines = []
    for t in range(max(len(f) for f, _ in items)):
        for i, (feats, _) in enumerate(items):
            if t < len(feats):
                feat = base64.b64encode(np.ascontiguousarray(
                    feats[t], dtype="<f4").tobytes()).decode()
                lines.append(json.dumps({"op": "push", "stream": f"v{i}",
                                         "feat": feat}))
    lines.append(json.dumps({"op": "end_all"}))
    return lines


def stream_scores(replies) -> dict:
    """{stream: [part scores in order]} from serve_jsonl's replies; raises
    on an error reply."""
    scores = {}
    for r in replies:
        if "error" in r:
            raise AssertionError(f"serve replied {r}")
        if "score" in r:
            scores.setdefault(r["stream"], []).append(r["score"])
        elif r.get("ended"):
            scores.setdefault(r["stream"], []).extend(r["scores"])
    return scores


def serve_lines(scorer, lines, flush_every: int = 64):
    """serve_jsonl over ``lines``; returns (replies, wall seconds, each
    flush() call's seconds)."""
    import io

    from lstc_vad_tpu_torch.serving import serve_jsonl

    inner, flush_s = scorer.flush, []

    def timed_flush():
        t0 = time.perf_counter()
        result = inner()
        flush_s.append(time.perf_counter() - t0)
        return result

    scorer.flush = timed_flush
    out = io.StringIO()
    t0 = time.perf_counter()
    serve_jsonl(scorer, lines, out, flush_every=flush_every)
    wall = time.perf_counter() - t0
    scorer.flush = inner
    return [json.loads(x) for x in out.getvalue().splitlines()], wall, flush_s


def max_stream_err(got: dict, want: dict) -> float:
    if got.keys() != want.keys() or any(len(got[k]) != len(want[k])
                                        for k in want):
        raise AssertionError("streams or their part counts differ")
    return max(float(np.abs(np.subtract(got[k], want[k])).max())
               for k in want)


def run_serve(cfg, encoder, head, items, card: str, device="cuda"):
    """Serve phase; raises on any failed check.  Returns (line, the
    kernel path's stream scores, the request lines)."""
    from lstc_vad_tpu_torch.evaluation.scoring import PartScorer
    from lstc_vad_tpu_torch.ops import cuda_attention
    from lstc_vad_tpu_torch.serving import StreamingScorer

    d, n_layers = cfg.data, cfg.encoder.n_layers
    t0 = time.perf_counter()
    lines = stream_requests(items)
    made = time.perf_counter() - t0
    n_clips = sum(len(f) for f, _ in items)

    def serve(enc, hd):
        scorer = StreamingScorer(enc, hd, d.part_len, d.n_patch, d.d_model,
                                 max_streams=64)
        replies, wall, flush_s = serve_lines(scorer, lines)
        return scorer, stream_scores(replies), wall, flush_s

    cuda_attention.reset_launches()
    scorer, scores, wall, flush_s = serve(encoder, head)
    launches = cuda_attention.launches
    calls = scorer.scorer.n_calls
    check_launches(launches, n_layers, calls, device, "serve")
    if calls != scorer.n_calls:
        raise AssertionError(f"serve: {scorer.n_calls} flush calls made "
                             f"{calls} encoder calls")
    offline = PartScorer(encoder, head, d.part_len, d.n_patch,
                         tail_rewindow=False).score_videos(
                             [f for f, _ in items])
    want = {f"v{i}": s.tolist() for i, (s, _) in enumerate(offline)}
    offline_err = max_stream_err(scores, want)
    before = cuda_attention.launches
    _, plain_scores, plain_wall, _ = serve(*plain_copy(cfg, encoder, head))
    if cuda_attention.launches != before:
        raise AssertionError("serve: the plain path launched the kernel")
    plain_err = max_stream_err(scores, plain_scores)
    if offline_err > SCORE_ATOL or plain_err > SCORE_ATOL:
        raise AssertionError(f"serve: scores off the offline PartScorer by "
                             f"{offline_err}, the plain path by {plain_err} "
                             f"(limit {SCORE_ATOL})")
    line = {"streams": len(items), "clips": n_clips,
            "parts": sum(len(v) for v in scores.values()),
            "requests_made_s": made, "request_mb": sum(map(len, lines)) / 1e6,
            "wall_s": wall, "clips_per_s": n_clips / wall,
            "flushes": len(flush_s),
            "flush_ms_p50": float(np.percentile(flush_s, 50)) * 1e3,
            "flush_ms_p99": float(np.percentile(flush_s, 99)) * 1e3,
            "device_calls": calls, "padded_rows": scorer.n_padded,
            "launches": launches, "max_abs_err_vs_offline": offline_err,
            "max_abs_err_vs_plain": plain_err, "plain_wall_s": plain_wall,
            "card": card}
    return line, scores, lines


def _read_line(proc, timeout: float) -> str:
    """One line of ``proc``'s stdout within ``timeout`` seconds."""
    import select

    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    if not ready:
        raise AssertionError(f"no line from pid {proc.pid} in {timeout} s")
    return proc.stdout.readline()


def _holds_cuda(pid: int) -> bool:
    """Whether process ``pid`` has the CUDA driver library mapped."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "libcuda" in f.read()
    except OSError:
        return False


def run_serve_mp(cfg, encoder, head, lines, want: dict, root: str,
                 card: str, device="cuda") -> dict:
    """serve_mp phase: a serve-backend subprocess and 4 serve --backend
    workers; raises on any failed check."""
    import signal
    import threading

    from lstc_vad_tpu_torch.ckpt import save_checkpoint

    n_layers, n_workers = cfg.encoder.n_layers, 4
    ckpt = os.path.join(root, "serve.pt")
    save_checkpoint(ckpt, {"encoder": encoder.state_dict(),
                           "head": head.state_dict()})
    # a short path: unix socket paths are limited to 108 bytes
    sock_dir = tempfile.mkdtemp(prefix="lv")
    sock = os.path.join(sock_dir, "b.sock")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    cmd = [sys.executable, "-m", "lstc_vad_tpu_torch"]
    t0 = time.perf_counter()
    backend = subprocess.Popen(
        [*cmd, "serve-backend", "--preset", cfg_name(cfg), *cfg_flags(cfg),
         "--socket", sock, "--max-batch", "128", "--ckpt", ckpt,
         "--device", device], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    workers, listed, cuda_workers = [], set(), set()
    try:
        ready = json.loads(_read_line(backend, 300))
        if ready["listening"] != sock or ready["max_batch"] != 128:
            raise AssertionError(f"backend ready line {ready}")
        backend_up = time.perf_counter() - t0
        # each worker takes a quarter of the streams, in the same order
        shards = [[] for _ in range(n_workers)]
        for ln in lines[:-1]:
            sid = json.loads(ln)["stream"]
            shards[int(sid[1:]) % n_workers].append(ln)
        outs, inputs = [None] * n_workers, []
        for i, shard in enumerate(shards):
            inputs.append(os.path.join(root, f"worker{i}.jsonl"))
            with open(inputs[-1], "w") as f:
                f.write("\n".join(shard + [lines[-1]]) + "\n")
        t0 = time.perf_counter()
        for path in inputs:
            with open(path) as stdin:
                workers.append(subprocess.Popen(
                    [*cmd, "serve", "--preset", cfg_name(cfg),
                     *cfg_flags(cfg), "--backend", sock, "--max-streams",
                     "64", "--flush-every", "64"], cwd=here, env=env,
                    stdin=stdin, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True))

        done = [0.0] * n_workers

        def drain(i):
            outs[i] = workers[i].communicate(timeout=600)
            done[i] = time.perf_counter()

        threads = [threading.Thread(target=drain, args=(i,))
                   for i in range(n_workers)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            smi = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60)
            listed |= {int(x) for x in smi.stdout.split() if x.isdigit()}
            cuda_workers |= {w.pid for w in workers if _holds_cuda(w.pid)}
            time.sleep(0.5)
        for t in threads:
            t.join()
        wall = max(done) - t0  # the last worker's exit, not the poll's
        for w, (_, err) in zip(workers, outs):
            if w.returncode != 0:
                raise AssertionError(f"worker {w.pid} exited "
                                     f"{w.returncode}: {err[-2000:]}")
        scores = {}
        for out, _ in outs:
            scores.update(stream_scores(json.loads(x)
                                        for x in out.splitlines()))
        err = max_stream_err(scores, want)
        worker_pids = {w.pid for w in workers}
        if listed & worker_pids or cuda_workers:
            raise AssertionError(f"a worker holds a CUDA context: nvidia-smi "
                                 f"lists {sorted(listed)}, workers "
                                 f"{sorted(worker_pids)}, libcuda mapped in "
                                 f"{sorted(cuda_workers)}")
        backend.send_signal(signal.SIGTERM)
        out, berr = backend.communicate(timeout=120)
        summary = json.loads(out.strip().splitlines()[-1])
        if backend.returncode != 0:
            raise AssertionError(f"backend exited {backend.returncode}: "
                                 f"{berr[-2000:]}")
    finally:
        for proc in workers + [backend]:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        shutil.rmtree(sock_dir, ignore_errors=True)
    calls, launches = summary["device_calls"], summary["kernel_launches"]
    check_launches(launches, n_layers, calls, device, "serve-backend")
    if err > SCORE_ATOL:
        raise AssertionError(f"serve_mp: worker scores off the serve "
                             f"phase's by {err} (limit {SCORE_ATOL})")
    n_clips = len(lines) - 1
    return {"workers": n_workers, "clips": n_clips, "backend_up_s": backend_up,
            "wall_s": wall, "clips_per_s": n_clips / wall,
            "worker_walls_s": [d - t0 for d in done],
            "device_calls": calls, "rows": summary["rows"],
            "rows_per_call": summary["rows"] / max(calls, 1),
            "backend_apply_s": summary["apply_s"],
            "launches": launches, "max_abs_err_vs_serve": err,
            "smi_pids": sorted(listed), "script_pid": os.getpid(),
            "backend_pid": backend.pid, "worker_pids": sorted(worker_pids),
            "card": card}


def cfg_name(cfg) -> str:
    return "sht_ltn" if cfg.model == "ltn" else "sht_stn"


def cfg_flags(cfg) -> list:
    """--set flags giving ``cfg``'s model widths (none at the preset's)."""
    from lstc_vad_tpu_torch.config import preset

    base, flags = preset(cfg_name(cfg)), []
    for group in ("encoder", "head", "data"):
        for k, v in vars(getattr(cfg, group)).items():
            if getattr(getattr(base, group), k) != v and not isinstance(
                    v, (tuple, list)) and v is not None:
                flags += ["--set", f"{group}.{k}={v}"]
    return flags


def export_child(art: str, tokens_npy: str, requests: str, out_json: str,
                 device="cuda") -> int:
    """Run in a fresh interpreter by the export phase: load the artifact on
    ``device``, score the saved token batch, then serve the serve phase's
    requests (one JSON line each in the file ``requests``) through
    StreamingScorer.from_artifact."""
    from lstc_vad_tpu_torch.export import load_scorer
    from lstc_vad_tpu_torch.ops import cuda_attention
    from lstc_vad_tpu_torch.serving import StreamingScorer

    if device == "cuda":
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    loaded = load_scorer(art, device=device)
    load_s = time.perf_counter() - t0
    cuda_attention.reset_launches()
    scores = loaded.score(np.load(tokens_npy))
    calls = loaded.n_calls
    scorer = StreamingScorer.from_artifact(art, max_streams=64,
                                           device=device)
    with open(requests) as f:
        replies, wall, _ = serve_lines(scorer, f)
    with open(out_json, "w") as f:
        json.dump({"load_s": load_s, "scores": scores.tolist(),
                   "streams": stream_scores(replies), "serve_wall_s": wall,
                   "program_calls": calls + scorer.loaded.n_calls,
                   "launches": cuda_attention.launches}, f)
    return 0


def run_export(cfg, encoder, head, lines, want: dict, root: str, card: str,
               device="cuda") -> dict:
    """Export phase: artifacts exported on the card and on the CPU, each
    loaded on the card in a fresh interpreter; raises on any failed
    check."""
    import torch

    from lstc_vad_tpu_torch.evaluation.scoring import _scorer_apply
    from lstc_vad_tpu_torch.export import save_scorer_artifact
    from lstc_vad_tpu_torch.models import build

    d, n_layers = cfg.data, cfg.encoder.n_layers
    token_len = d.part_len * d.n_patch
    tails = tuple(range(d.n_patch, token_len, d.n_patch))
    here = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(SEED)
    tokens = rng.standard_normal((64, token_len, d.d_model),
                                 dtype=np.float32)
    tokens_npy = os.path.join(root, "tokens.npy")
    np.save(tokens_npy, tokens)
    requests = os.path.join(root, "requests.jsonl")
    with open(requests, "w") as f:
        f.write("\n".join(lines) + "\n")
    with torch.inference_mode():
        live = _scorer_apply(encoder, head, "classifier", False,
                             torch.from_numpy(tokens).to(device)
                             ).cpu().numpy()
    rows, total = {}, 0
    for on in ("cuda", "cpu") if device == "cuda" else ("cpu",):
        if on == "cpu":
            enc, hd = build(cfg, device="cpu", seed=SEED)
            enc.load_state_dict({k: v.cpu() for k, v in
                                 encoder.state_dict().items()})
            hd.load_state_dict({k: v.cpu() for k, v in
                                head.state_dict().items()})
        else:
            enc, hd = encoder, head
        art = os.path.join(root, f"artifact_{on}")
        seconds = save_scorer_artifact(
            art, enc, hd, "classifier", token_len, d.d_model,
            extra_token_lens=tails,
            extra_meta={"n_patch": d.n_patch, "part_len": d.part_len})
        del enc, hd
        size = sum(os.path.getsize(os.path.join(art, f))
                   for f in os.listdir(art))
        out_json = os.path.join(root, f"child_{on}.json")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c",
             "import sys, chip_smoke; sys.exit(chip_smoke.export_child("
             f"{art!r}, {tokens_npy!r}, {requests!r}, {out_json!r}, "
             f"{device!r}))"],
            cwd=here, env=dict(os.environ, PYTHONPATH=here),
            capture_output=True, text=True, timeout=600)
        child_wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"export child ({on}) exited "
                                 f"{res.returncode}: {res.stderr[-3000:]}")
        with open(out_json) as f:
            child = json.load(f)
        score_err = float(np.abs(np.subtract(child["scores"], live)).max())
        stream_err = max_stream_err(child["streams"], want)
        launches = child["launches"]
        check_launches(launches, n_layers, child["program_calls"], device,
                       f"export ({on}), loaded programs")
        if score_err > SCORE_ATOL or stream_err > SCORE_ATOL:
            raise AssertionError(f"export ({on}): scores off the live "
                                 f"scorer by {score_err}, streams by "
                                 f"{stream_err} (limit {SCORE_ATOL})")
        total += launches
        rows[f"exported_on_{on}"] = {
            "token_lens": sorted({token_len, *tails}),
            "artifact_mb": size / 1e6, **seconds,
            "load_s": child["load_s"], "child_wall_s": child_wall,
            "serve_wall_s": child["serve_wall_s"],
            "program_calls": child["program_calls"], "launches": launches,
            "max_abs_err_vs_live": score_err,
            "max_abs_err_vs_serve": stream_err}
    return {**rows, "launches": total, "card": card}


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
    walls = {"build": time.perf_counter() - t0}
    print(f"build: {walls['build']:.1f} s for {built}")
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
    t0 = time.perf_counter()
    shapes = [(256, n) for n in LENGTHS] + [(2048, 49), (main_b, main_len)]
    cases = [(b, n, with_bias, False, "float32") for b, n in shapes
             for with_bias in (False, True)]
    # as the encoder feeds it
    cases.append((main_b, main_len, True, True, "float32"))
    # the bf16 route: every L and the main shape, both layouts
    cases += [(b, n, with_bias, strided, "bfloat16")
              for b, n in [(256, n) for n in LENGTHS] + [(main_b, main_len)]
              for with_bias in (False, True) for strided in (False, True)]
    rows = {"float32": [], "bfloat16": []}
    for b, length, with_bias, strided, dtype in cases:
        row = check_kernel(b, length, with_bias, dev, strided, dtype)
        rows[dtype].append(row)
        print("kernel " + json.dumps(row))
    main_rows = {"float32": rows["float32"][-1],
                 "bfloat16": rows["bfloat16"][-1]}  # strided, with bias
    walls["kernel"] = time.perf_counter() - t0

    # -- slice phase: the main path ---------------------------------------
    t0 = time.perf_counter()
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
    walls["slice"] = time.perf_counter() - t0

    # -- autograd phase: the kernel's gradient ------------------------------
    t0 = time.perf_counter()
    grad_rows = [check_autograd(256, n, dev, False) for n in (17, 49, 81)]
    grad_rows.append(check_autograd(main_b, main_len, dev, True))
    for row in grad_rows:
        print("autograd " + json.dumps(row))
    walls["autograd"] = time.perf_counter() - t0

    # -- train and co-teaching phases ---------------------------------------
    from lstc_vad_tpu_torch.data.synthetic import as_test_videos

    test_videos = as_test_videos(items)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        cfg_t, store = set_up_train(
            root, metrics_jsonl=os.path.join(root, "metrics.jsonl"))
        print(f"train data: {len(store.feats)} videos, "
              f"{sum(f.shape[0] for f in store.feats.values())} clips, "
              f"{store.nbytes / 2 ** 30:.2f} GiB of host RAM, made in "
              f"{time.perf_counter() - t0:.1f} s")
        train = run_train(cfg_t, store, test_videos, card)
        print("train " + json.dumps(train))
        walls["train"] = time.perf_counter() - t0
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        pack_row, pack, best = run_pack(cfg_t, store, test_videos, root,
                                        card)
        print("pack " + json.dumps(pack_row))
        walls["pack"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        cli_row = run_cli(cfg_t, pack, best, store, root, card)
        print("cli " + json.dumps(cli_row))
        walls["cli"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        bf16 = run_bf16(cfg_t, store, test_videos, pack, card)
        print("bf16 " + json.dumps(bf16))
        walls["bf16"] = time.perf_counter() - t0
        os.remove(pack)

        t0 = time.perf_counter()
        coteach = run_coteach(*set_up_coteach(cfg_t, root), store,
                              test_videos, root, card)
        print("coteach " + json.dumps(coteach))
        walls["coteach"] = time.perf_counter() - t0
    del store
    torch.cuda.empty_cache()

    # -- UCF phase --------------------------------------------------------
    t0 = time.perf_counter()
    ucf = run_ucf(card)
    print("ucf " + json.dumps(ucf))
    walls["ucf"] = time.perf_counter() - t0

    # -- tenCrop, serving and export phases -------------------------------
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        tencrop = run_tencrop(cfg, encoder, head, root, card)
        print("tencrop " + json.dumps(tencrop))
        walls["tencrop"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        serve, serve_scores, lines = run_serve(cfg, encoder, head, items,
                                               card)
        print("serve " + json.dumps(serve))
        walls["serve"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        serve_mp = run_serve_mp(cfg, encoder, head, lines, serve_scores,
                                root, card)
        print("serve_mp " + json.dumps(serve_mp))
        walls["serve_mp"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        export = run_export(cfg, encoder, head, lines, serve_scores, root,
                            card)
        print("export " + json.dumps(export))
        walls["export"] = time.perf_counter() - t0
    print("walls " + json.dumps(walls))

    # launches by path, read after each path ran; the f32 route's in the
    # bf16 phase are its evaluation's (the f32 twin), the rest bf16's
    by_path = {"float32": {
        "slice": launches, "fit_evals": train["fit_launches"],
        "fit_steps": 0, "dropout0_step": train["dropout0"]["launches"],
        "coteach": coteach["launches"], "ucf": ucf["launches"],
        "tencrop": tencrop["launches"], "serve": serve["launches"],
        "serve_mp": serve_mp["launches"], "export": export["launches"],
        "pack_fit": pack_row["fit_pack"]["launches"],
        "pack_fit_memory": pack_row["fit_memory"]["launches"],
        "cli_profile": cli_row["profile"]["attention_launches"],
        "f32_step": bf16["f32"]["launches"],
        "bf16_trainer_eval": bf16["eval"]["launches"]}, "bfloat16": {
        "bf16_step": bf16["bf16"]["launches_bf16"],
        "bf16_remat_step": bf16["bf16_remat"]["launches_bf16"],
        "cast_sr_step": bf16["cast_sr"]["launches_bf16"]}}
    sources = {"float32": ("attention", "attention.cu"),
               "bfloat16": ("attention_bf16", "attention_bf16.cu")}
    kernels = []
    for dtype, (name, source) in sources.items():
        row = main_rows[dtype]
        max_err = max(r["max_abs_err"] for r in rows[dtype])  # every shape
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"lstc_vad_tpu_torch/csrc/{source}",
            "replaces": "lstc_vad_tpu/ops/pallas_attention.py:50",
            "launches": sum(by_path[dtype].values()),
            "launches_by_path": by_path[dtype],
            "max_abs_err": max_err, "max_err": max_err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": {k: row[k] for k in ("B", "H", "L", "D", "dtype",
                                          "bias", "strided")},
            "card": card})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
