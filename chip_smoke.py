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
6. Prints one JSON line of kernels, then, as the last line,
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed phase raises and the script exits non-zero without that line.
Without a CUDA card it runs nothing and exits 2.
"""

from __future__ import annotations

import json
import os
import re
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

    # -- autograd phase: the kernel's gradient ------------------------------
    grad_rows = [check_autograd(256, n, dev, False) for n in (17, 49, 81)]
    grad_rows.append(check_autograd(main_b, main_len, dev, True))
    for row in grad_rows:
        print("autograd " + json.dumps(row))

    # -- train phase ------------------------------------------------------
    from lstc_vad_tpu_torch.data.synthetic import as_test_videos

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        cfg_t, store = set_up_train(
            root, metrics_jsonl=os.path.join(root, "metrics.jsonl"))
        print(f"train data: {len(store.feats)} videos, "
              f"{sum(f.shape[0] for f in store.feats.values())} clips, "
              f"{store.nbytes / 2 ** 30:.2f} GiB of host RAM, made in "
              f"{time.perf_counter() - t0:.1f} s")
        train = run_train(cfg_t, store, as_test_videos(items), card)
    print("train " + json.dumps(train))

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
        "train_launches": {"fit_evals": train["fit_launches"],
                           "fit_steps": 0,
                           "dropout0_step": train["dropout0"]["launches"]},
        "shape": {k: main_row[k]
                  for k in ("B", "H", "L", "D", "bias", "strided")},
        "card": card}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
