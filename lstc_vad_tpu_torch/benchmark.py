"""Benchmark of the port on the card — PyTorch counterpart of
lstc_vad_tpu/benchmark.py: single-card throughput over the preset matrix,
at the presets' full widths.

    python -m lstc_vad_tpu_torch benchmark

Prints ONE JSON line on stdout whose keys are exactly ``CONTRACT_KEYS``
(the JAX benchmark's, in its order), and returns 0; under a confirmed
outage of the card it prints the same keys as nulls with
``transient_outage: true`` and returns 1, so that no reader of the exit
code takes an outage line for a measurement.  Values are not rounded.

Headline metric: snippets (16-frame clips) scored per second through the
flagship ShanghaiTech LTN eval path — encoder (3 layers, d_model 2048, 8
heads of d_k 256, 3-D relative position bias over 49 tokens) + classifier
— with all parts of all videos staged on the card, batched as the
evaluation drivers batch them.  The attention is the operator
``lstc_vad::attention`` (``attn_impl="auto"``), i.e. the Hopper kernels of
ops/cuda_attention.py on the card; the GEMMs are cuBLAS f32.

Baseline: the reference evaluates ONE part per device call in a Python
loop with a ``.cpu().numpy()`` sync per part
(Test/evaluation_shanghaitech_ubnormal.py:77-91) and publishes no
throughput, so ``vs_baseline`` is measured: the same weights driven
through a reference-style batch-1 per-part loop on the same card;
vs_baseline = batched / reference-style.

Extra keys, each measured on the shape its reference script runs:
- ``stn_eval_snippets_per_sec``: SHT STN eval, 17-token sequences (16
  patches + CLS) through the regressor.  One clip = one snippet.
- ``ucf_eval_snippets_per_sec``: the UCF LTN final eval end to end through
  ``ucf_final_eval_scorer`` (host 32-bin mean-pooling, L2 normalize on the
  card, encoder at part_len 2), as ``evaluate --preset ucf_ltn`` drives
  it.  Snippets = raw input clips.
- ``ubnormal_eval_snippets_per_sec``: UBnormal LTN eval, d_model 1024,
  part_len 5 (81-token parts).
- ``hostfed_eval_snippets_per_sec``: the SHT LTN sweep fed from HOST
  memory through ``PartScorer.score_videos`` (pinned chunk buffers, copies
  to the card overlapped with the previous chunk's compute); includes the
  host-to-device copy the device-resident flagship number excludes.
- ``hostfed_h2d_gbps`` / ``h2d_raw_gbps``: the host-fed sweep's feature
  bytes over its wall, against the raw ceiling of the link.  The raw probe
  times the copy the scorers make: a 256 MB random f32 array in a PINNED
  host tensor, ``.to(device, non_blocking=True)`` then
  ``torch.cuda.synchronize()``, best of 3.  A pageable copy would read
  below the pinned host-fed rate it is meant to bound.
- ``train_snippets_per_sec`` (+ ``train_bf16_*``, ``train_bf16_sr_*``):
  the SHT LTN train step (forward, backward, two-group Adagrad; batch 40
  pairs of [48, 16, 2048] on the card; the preset's dropouts) in f32, in
  bf16 compute and in bf16 with stochastic-rounding casts.  The headline
  train number stays the f32 step (the preset default).  With the
  preset's attention dropout on, the steps' attention takes the plain path
  (ops/attention.py::sdpa), as the JAX step takes XLA's.
- ``serving_parts_per_sec`` / ``serving_flush_p50_ms`` / ``_p99_ms``:
  ``StreamingScorer`` at 16 concurrent flagship-LTN streams, one part per
  stream per flush; p99 is nearest-rank.
- ``serving_mp_parts_per_sec`` / ``serving_mp_roundtrip_p50_ms``: the
  multi-process serving path (serving_mp.py), 16-part requests through a
  unix-socket ``RemoteApply`` into an in-process ``BatchingBackend`` over
  the production apply (``VideoScorer.score_tokens_async``).
- ``eval_tflops`` / ``train_tflops`` / ``stn_eval_tflops`` /
  ``ubnormal_eval_tflops`` (+ the train alternates): FLOP-derived rates
  from the analytic matmul count (``flops_per_tokens``; a train step
  counts 3x its forward).  Every ``*_mfu`` divides by
  ``H100_PEAK_TFLOPS``, the H100 SXM's published dense bf16 tensor-core
  peak at 700 W, on every path: the f32 paths run cuBLAS f32 without
  TF32, whose peak outside the tensor cores is 67 TFLOP/s, so their
  ``eval_mfu`` reads about 0.05.  TF32 stays off: the f32 path must stay
  f32-accurate.

stderr carries a summary line naming the card (``nvidia-smi
--query-gpu=name,power.limit``), the peak divided by and the f32 train
step's peak device memory, and a ``benchmark launches {json}`` line with
ops/cuda_attention.py's launch counters for the whole run, by route.

``_run(device)`` measures the card (``"cuda"``, what the CLI passes);
``_run("cpu")`` exists for the tests, at shrunken sizes: its numbers are
CPU numbers and never a device figure.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import preset
from .device import resolve_device
from .evaluation.scoring import (PartScorer, VideoScorer, _scorer_apply,
                                 ucf_final_eval_scorer,
                                 ucf_final_eval_shapes)
from .models import build
from .ops import cuda_attention

# H100 SXM, dense bf16 tensor-core peak at 700 W (NVIDIA data sheet)
H100_PEAK_TFLOPS = 989.0
# set in the re-executed interpreter after a transient failure; named after
# this package so that a JAX benchmark in the same environment cannot trip it
RETRY_ENV = "LSTC_TORCH_BENCH_RETRY"
# CUDA's cudaErrorDevicesUnavailable and cudaErrorNoDevice: the card is
# held by another process or not there
TRANSIENT_MARKERS = ("busy or unavailable",
                     "no CUDA-capable device is detected")
# errors of the attention kernels and of their build: faults of the
# program, never an outage, whatever CUDA error they carry
KERNEL_ERRORS = ("attention", "native build failed")


def flops_per_tokens(cfg, L: int) -> float:
    """Analytic forward FLOPs for ONE L-token sequence (CLS included)
    through the encoder + head: qkv/out projections, attention score +
    weighted-sum matmuls, FFN, head MLP.  2 FLOPs per MAC;
    layernorm/softmax/bias terms are negligible and excluded."""
    e = cfg.encoder
    d, h, dk, dv, di = e.d_model, e.n_head, e.d_k, e.d_v, e.d_inner
    per_layer = (2 * L * d * h * (2 * dk + dv)   # q, k, v projections
                 + 2 * h * L * L * (dk + dv)     # scores + weighted sum
                 + 2 * L * h * dv * d            # output projection
                 + 2 * L * d * di * 2)           # FFN in + out
    hid = cfg.head.hidden_dim
    head = 2 * (d * hid + hid * 32 + 32 * 2)
    return float(e.n_layers * per_layer + head)


def flops_per_part(cfg) -> float:
    """Forward FLOPs for one training-shaped part
    (part_len*n_patch + CLS tokens)."""
    return flops_per_tokens(cfg, cfg.data.part_len * cfg.data.n_patch + 1)


def _probe_device(timeout_s: float = 90.0):
    """Cheap card-reachability probe in a FRESH subprocess with a hard
    timeout, so that a hung or failed CUDA initialisation is not this
    interpreter's.  Returns (ok, detail).

    A hung child is sent SIGTERM first; if it ignores that, it is left to
    a daemon reaper thread.  The JAX benchmark never SIGKILLs its probe
    because killing a TPU-attaching process could wedge the remote device
    grant; no such hazard exists for a CUDA process, but the
    terminate-first order is kept."""
    import threading

    code = ("import torch; torch.cuda.init(); "
            "assert torch.cuda.device_count() >= 1; print('LSTC_PROBE_OK')")
    p = subprocess.Popen([sys.executable, "-c", code],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        out, err = p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        p.terminate()
        try:
            p.communicate(timeout=15)
        except subprocess.TimeoutExpired:
            threading.Thread(target=p.communicate, daemon=True).start()
        return False, f"card probe hung >{timeout_s:.0f}s"
    if p.returncode == 0 and "LSTC_PROBE_OK" in out:
        return True, ""
    return False, (err.strip() or out.strip())[-500:]


# every key the success-path JSON line carries (kept in sync by an assert
# in _run and by tests/test_torch_benchmark.py): an outage line presents the
# SAME keys as nulls so per-key consumers see None, never KeyError.
CONTRACT_KEYS = (
    "metric", "value", "unit", "vs_baseline",
    "train_snippets_per_sec", "eval_tflops", "train_tflops",
    "eval_mfu", "train_mfu", "train_compute_dtype",
    "train_bf16_snippets_per_sec", "train_bf16_tflops", "train_bf16_mfu",
    "train_bf16_sr_snippets_per_sec", "train_bf16_sr_tflops",
    "train_bf16_sr_mfu",
    "stn_eval_snippets_per_sec", "stn_eval_tflops",
    "ubnormal_eval_snippets_per_sec", "ubnormal_eval_tflops",
    "ucf_eval_snippets_per_sec",
    "hostfed_eval_snippets_per_sec", "hostfed_h2d_gbps", "h2d_raw_gbps",
    "serving_parts_per_sec", "serving_flush_p50_ms", "serving_flush_p99_ms",
    "serving_mp_parts_per_sec", "serving_mp_roundtrip_p50_ms",
)


def _print_outage(detail: str) -> None:
    """The one-JSON-line contract under a confirmed outage: the SAME
    contract keys as the success line, null values, plus an explicit
    transient_outage marker."""
    line = {k: None for k in CONTRACT_KEYS}
    line.update({
        "metric": "sht_ltn_eval_snippets_per_sec",
        "unit": "snippets/s",
        "transient_outage": True,
        "outage_detail": detail[-500:],
    })
    print(json.dumps(line), flush=True)


def _transient(e: Exception) -> bool:
    """An outage of the card, not a fault of the program: CUDA's "busy or
    unavailable" / "no device".  Running out of device memory and any
    error of the attention kernels are faults, whatever they say."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    msg = str(e)
    if msg.startswith(KERNEL_ERRORS):
        return False
    return any(m in msg for m in TRANSIENT_MARKERS)


def main(retry_wait_s: float = 60.0, probe=_probe_device, runner=None
         ) -> int:
    """Outage-proof entry: exactly ONE JSON line on stdout even when the
    card cannot be reached.  Returns 0 after a measurement, 1 after an
    outage line.

    1. Probe reachability in a cheap subprocess before CUDA is initialised
       here; on failure, re-probe once after a short bounded wait, then
       print the outage line.
    2. A transient failure mid-run (``TRANSIENT_MARKERS``) gets one re-exec
       in a fresh interpreter; if it persists there and the card is
       unreachable, the outage line is printed.  If the card is reachable,
       the error is the program's and raises."""
    runner = runner or _run
    ok, detail = probe()
    if not ok:
        time.sleep(min(retry_wait_s, 60.0))
        ok, detail = probe()
        if not ok:
            _print_outage(detail)
            return 1
    try:
        runner()
    except Exception as e:
        if not _transient(e):
            raise
        if os.environ.get(RETRY_ENV):
            ok, _detail = probe()
            if ok:
                raise
            _print_outage(f"transient failure persisted after re-exec: {e}")
            return 1
        print(f"transient device failure ({e}); re-executing in "
              f"{retry_wait_s:.0f}s", file=sys.stderr)
        time.sleep(retry_wait_s)
        os.environ[RETRY_ENV] = "1"
        sys.stdout.flush()
        sys.stderr.flush()
        # sys.argv[0] is __main__.py under 'python -m lstc_vad_tpu_torch',
        # which cannot run as a top-level script: rebuild the interpreter's
        # own command line, and exec the interpreter by absolute path
        tail = (list(sys.orig_argv)[1:] if getattr(sys, "orig_argv", None)
                else sys.argv)
        os.execv(sys.executable, [sys.executable] + tail)
    return 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stage(rows: np.ndarray, batch: int, device: torch.device):
    """Device-resident chunks of ``batch`` rows."""
    return [torch.from_numpy(rows[i:i + batch]).to(device)
            for i in range(0, len(rows), batch)]


def _build_apply(cfg, device="cuda"):
    """(encoder, head, apply(x) -> [B] scores) for a preset config: weights
    from ``models.build`` (seed 0), the apply the scorers run
    (``_scorer_apply``) under ``torch.inference_mode()``; probs[:, 1] of the
    classifier, out[:, 0] of the regressor."""
    encoder, head = build(cfg, device, seed=0)

    def apply(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return _scorer_apply(encoder, head, cfg.head.kind, False, x)

    return encoder, head, apply


def _sweep_rate(apply, staged, n_items: int, device: torch.device,
                sweeps: int = 3) -> float:
    """Items (leading-axis rows) per second over device-resident batches;
    each timed region ends in a synchronize."""
    for chunk in staged:  # warm
        apply(chunk)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(sweeps):
        outs = [apply(chunk) for chunk in staged]
    _sync(device)
    dt = (time.perf_counter() - t0) / sweeps
    return n_items / dt


# synthetic SHT-scale test sweep: 64 videos x 192 clips = 64 parts each
FLAGSHIP_VIDEOS, FLAGSHIP_CLIPS, FLAGSHIP_BATCH = 64, 192, 1024
REF_PARTS = 128  # the reference-style batch-1 loop


def _flagship_eval(rng, device):
    """SHT LTN eval sweep + the reference-style batch-1 loop (vs_baseline).
    Returns (snippets_per_sec, vs_baseline, tflops)."""
    cfg = preset("sht_ltn")
    d = cfg.encoder.d_model
    part_len, n_patch = cfg.data.part_len, cfg.data.n_patch
    tokens = part_len * n_patch
    _, _, apply = _build_apply(cfg, device)

    parts_per_video = FLAGSHIP_CLIPS // part_len
    all_parts = rng.standard_normal(
        (FLAGSHIP_VIDEOS * parts_per_video, tokens, d)).astype(np.float32)
    staged = _stage(all_parts, FLAGSHIP_BATCH, device)
    del all_parts
    total_snippets = FLAGSHIP_VIDEOS * FLAGSHIP_CLIPS

    apply(staged[0])  # first call: the kernels' libraries load
    _sync(device)
    batched = _sweep_rate(apply, staged, total_snippets, device)

    # reference-style: batch-1 per part, host fetch per part
    apply(staged[0][:1]).cpu().numpy()
    t0 = time.perf_counter()
    for i in range(REF_PARTS):
        apply(staged[0][i:i + 1]).cpu().numpy()
    ref_rate = REF_PARTS * part_len / (time.perf_counter() - t0)

    tflops = (batched / part_len) * flops_per_part(cfg) / 1e12
    return batched, batched / ref_rate, tflops


def _device_sweep(cfg, rng, n_rows: int, tokens: int, batch: int, device):
    """Rows-per-second of a device-resident [n_rows, tokens, d] sweep:
    build, stage, warm, time (the shared shape of every device-bound eval
    phase)."""
    rows = rng.standard_normal(
        (n_rows, tokens, cfg.encoder.d_model)).astype(np.float32)
    _, _, apply = _build_apply(cfg, device)
    staged = _stage(rows, batch, device)
    del rows
    apply(staged[0])
    _sync(device)
    return _sweep_rate(apply, staged, n_rows, device)


STN_ROWS, STN_BATCH = 16384, 2048


def _stn_eval(rng, device):
    """SHT STN eval: 17-token clip sequences through the regressor
    (Train/spatio_transformer_shanghaitech.py:133-137)."""
    cfg = preset("sht_stn")
    n_patch = cfg.data.n_patch
    rate = _device_sweep(cfg, rng, STN_ROWS, n_patch, STN_BATCH, device)
    tflops = rate * flops_per_tokens(cfg, n_patch + 1) / 1e12
    return rate, tflops


UBNORMAL_ROWS, UBNORMAL_BATCH = 4096, 1024


def _ubnormal_eval(rng, device):
    """UBnormal LTN eval: d_model 1024, part_len 5 -> 81-token parts
    (README.md:55 shape; Train/temporal_transformer_UBnormal.py)."""
    cfg = preset("ubnormal_ltn")
    part_len, n_patch = cfg.data.part_len, cfg.data.n_patch
    tokens = part_len * n_patch
    parts_rate = _device_sweep(cfg, rng, UBNORMAL_ROWS, tokens,
                               UBNORMAL_BATCH, device)
    tflops = parts_rate * flops_per_tokens(cfg, tokens + 1) / 1e12
    return parts_rate * part_len, tflops


UCF_VIDEOS, UCF_CLIPS, UCF_SWEEPS = 32, 320, 2


def _ucf_eval(rng, device):
    """UCF LTN final-eval path end to end through the final-eval scorer:
    host 32-bin linspace mean-pool, L2 norm on the card, encoder at
    part_len 2 (Test/evaluation_UCF.py:52-77).  Snippets = raw input
    clips."""
    # the final-eval shapes (part_len 2, the window_depth 2 RPE table) and
    # scorer flags evaluate --preset ucf_ltn uses
    cfg = ucf_final_eval_shapes(preset("ucf_ltn"))
    d, n_patch = cfg.encoder.d_model, cfg.data.n_patch
    encoder, head, _ = _build_apply(cfg, device)
    scorer = ucf_final_eval_scorer(cfg, encoder, head)
    items = [(rng.standard_normal(
        (UCF_CLIPS, n_patch, d)).astype(np.float32), UCF_CLIPS)
        for _ in range(UCF_VIDEOS)]
    scorer.score_videos(items)  # warm (host pool + device)
    t0 = time.perf_counter()
    for _ in range(UCF_SWEEPS):
        scorer.score_videos(items)
    dt = (time.perf_counter() - t0) / UCF_SWEEPS
    return UCF_VIDEOS * UCF_CLIPS / dt


# 2 videos x 1536 clips = 1024 full parts (~0.4 GB of features a sweep)
HOSTFED_VIDEOS, HOSTFED_CLIPS, HOSTFED_SWEEPS = 2, 1536, 2


def _hostfed_eval(rng, device):
    """SHT LTN eval fed from HOST memory through the production scorer path
    (PartScorer.score_videos: read-ahead, block packing into pinned chunk
    buffers, copies overlapped with the previous chunk's compute) — the
    copy-inclusive number the device-resident flagship sweep cannot show.

    Returns (snippets_per_sec, achieved_h2d_gbps): compare the second with
    the raw pinned-copy ceiling (_h2d_probe) to tell a saturated link from
    a pipeline stall."""
    cfg = preset("sht_ltn")
    d = cfg.encoder.d_model
    part_len, n_patch = cfg.data.part_len, cfg.data.n_patch
    encoder, head, _ = _build_apply(cfg, device)
    scorer = PartScorer(encoder, head, part_len, n_patch)
    feats = [rng.standard_normal(
        (HOSTFED_CLIPS, n_patch, d)).astype(np.float32)
        for _ in range(HOSTFED_VIDEOS)]
    scorer.score_videos(feats)  # warm
    t0 = time.perf_counter()
    for _ in range(HOSTFED_SWEEPS):
        scorer.score_videos(feats)
    dt = (time.perf_counter() - t0) / HOSTFED_SWEEPS
    wire_bytes = sum(f.nbytes for f in feats)  # every clip ships once
    return HOSTFED_VIDEOS * HOSTFED_CLIPS / dt, wire_bytes / dt / 1e9


H2D_SHAPE = (64, 1024, 1024)  # 256 MB of f32


def _h2d_probe(rng, device):
    """Raw host->device ceiling of this link, measured as the scorers copy:
    one 256 MB random f32 array in a pinned host tensor,
    ``.to(device, non_blocking=True)`` then a synchronize, best of 3.  (On
    the CPU, the tests' device, the copy is a clone.)"""
    x = rng.standard_normal(H2D_SHAPE).astype(np.float32)
    host = torch.from_numpy(x)
    if device.type == "cuda":
        host = host.pin_memory()

    def copy():
        if device.type == "cuda":
            out = host.to(device, non_blocking=True)
        else:
            out = host.clone()
        _sync(device)
        return out

    copy()  # warm the allocator
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        copy()
        best = min(best, time.perf_counter() - t0)
    return x.nbytes / best / 1e9


SERVING_STREAMS, SERVING_FLUSHES = 16, 100


def _serving_probe(rng, device):
    """Online serving (StreamingScorer) at flagship LTN dims:
    ``SERVING_STREAMS`` concurrent streams each push one part per round,
    then one flush scores the round in a single device call.  Returns
    (parts_per_sec, p50_ms, p99_ms) of the flush latency."""
    from .serving import StreamingScorer

    cfg = preset("sht_ltn")
    d = cfg.encoder.d_model
    part_len, n_patch = cfg.data.part_len, cfg.data.n_patch
    encoder, head, _ = _build_apply(cfg, device)
    scorer = StreamingScorer(encoder, head, part_len, n_patch, d,
                             max_streams=SERVING_STREAMS)
    clip = rng.standard_normal((n_patch, d)).astype(np.float32)

    def push_round():
        for s in range(SERVING_STREAMS):
            for _ in range(part_len):
                scorer.push(f"s{s}", clip)

    push_round()
    scorer.flush()  # warm
    lat = []
    t_all = time.perf_counter()
    for _ in range(SERVING_FLUSHES):
        push_round()
        t0 = time.perf_counter()
        got = scorer.flush()
        lat.append(time.perf_counter() - t0)
        if len(got) != SERVING_STREAMS:
            raise RuntimeError(f"a flush scored {len(got)} streams, "
                               f"expected {SERVING_STREAMS}")
    total = time.perf_counter() - t_all
    lat_ms = np.sort(np.array(lat) * 1e3)
    # nearest-rank percentile (int(n*0.99) would select the MAX at n=100)
    p99_idx = max(0, int(np.ceil(len(lat_ms) * 0.99)) - 1)
    return (SERVING_STREAMS * SERVING_FLUSHES / total,
            float(lat_ms[len(lat_ms) // 2]),
            float(lat_ms[p99_idx]))


SERVING_MP_ROWS, SERVING_MP_CALLS, SERVING_MP_MAX_BATCH = 16, 50, 64


def _serving_mp_probe(rng, device):
    """Multi-process serving path at flagship LTN dims: one in-process
    BatchingBackend on a unix socket + one RemoteApply client shipping
    ``SERVING_MP_ROWS``-part requests (the worker wire format,
    serving_mp.py).  Returns (parts_per_sec, roundtrip_p50_ms) — the
    socket, coalesce and copy overhead on top of the device call."""
    import tempfile

    from .serving_mp import BatchingBackend, RemoteApply

    cfg = preset("sht_ltn")
    d = cfg.encoder.d_model
    tokens = cfg.data.part_len * cfg.data.n_patch
    encoder, head, _ = _build_apply(cfg, device)
    apply_fn = VideoScorer(encoder, head, cfg.head.kind).score_tokens_async
    backend = BatchingBackend(apply_fn, d, max_batch=SERVING_MP_MAX_BATCH,
                              window_ms=0.0)
    with tempfile.TemporaryDirectory(prefix="lstc_bench_mp_") as tmp:
        backend.start(os.path.join(tmp, "backend.sock"))
        try:
            client = RemoteApply(os.path.join(tmp, "backend.sock"), d)
            rows = rng.standard_normal(
                (SERVING_MP_ROWS, tokens, d)).astype(np.float32)
            client(rows)  # warm
            lat = []
            t_all = time.perf_counter()
            for _ in range(SERVING_MP_CALLS):
                t0 = time.perf_counter()
                client(rows)
                lat.append(time.perf_counter() - t0)
            total = time.perf_counter() - t_all
            client.close()
        finally:
            backend.shutdown()
    lat_ms = np.sort(np.array(lat) * 1e3)
    return (SERVING_MP_ROWS * SERVING_MP_CALLS / total,
            float(lat_ms[len(lat_ms) // 2]))


TRAIN_WARM, TRAIN_STEPS = 2, 10


def _train_step(rng, device, compute_dtype: str = "float32",
                cast_sr: bool = False):
    """SHT LTN train step: forward, backward, two-group Adagrad at the
    preset's batch and dropouts (the program of
    Train/temporal_transformer_shanghaitech.py:99-142), the batch resident
    on the card.  Returns (snippets_per_sec, tflops).

    ``compute_dtype='bfloat16'`` measures the throughput alternate:
    matmuls and activations in bf16 (params, LN, softmax stay f32).
    ``cast_sr=True`` (bf16 only) adds the unbiased stochastic-rounding
    casts on the matmul inputs (ops/sr.py)."""
    from .train.state import create_train_state
    from .train.steps import make_ltn_train_step

    cfg = preset("sht_ltn", **{"encoder.compute_dtype": compute_dtype,
                               "encoder.cast_sr": cast_sr})
    d = cfg.encoder.d_model
    part_len, n_patch = cfg.data.part_len, cfg.data.n_patch
    state = create_train_state(cfg, device)
    step_fn = make_ltn_train_step(cfg)
    b, pn = cfg.data.batch_size, cfg.data.part_num
    fshape = (b, pn * part_len, n_patch, d)
    norm = torch.from_numpy(
        rng.standard_normal(fshape).astype(np.float32)).to(device)
    abnorm = torch.from_numpy(
        rng.standard_normal(fshape).astype(np.float32)).to(device)
    labs = torch.from_numpy(
        rng.random((b, pn * part_len)).astype(np.float32)).to(device)

    state, m = step_fn(state, norm, labs, abnorm, labs)  # first step
    float(m["loss"])
    for _ in range(TRAIN_WARM):
        state, m = step_fn(state, norm, labs, abnorm, labs)
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step_fn(state, norm, labs, abnorm, labs)
    float(m["loss"])  # the host fetch waits for the last step
    train_dt = (time.perf_counter() - t0) / TRAIN_STEPS
    rate = 2 * b * pn * part_len / train_dt
    tflops = (rate / part_len) * 3 * flops_per_part(cfg) / 1e12
    return rate, tflops


def _card(device: torch.device) -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` names it."""
    if device.type != "cuda":
        return "cpu (no card)"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    res = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _run(device="cuda"):
    device = resolve_device(device)
    card = _card(device)
    rng = np.random.default_rng(0)
    cuda_attention.reset_launches()

    # each phase's staging is freed when its helper returns, and handed
    # back to the card before the next (a no-op on the CPU)
    eval_rate, vs_ref, eval_tflops = _flagship_eval(rng, device)
    torch.cuda.empty_cache()
    stn_rate, stn_tflops = _stn_eval(rng, device)
    torch.cuda.empty_cache()
    ub_rate, ub_tflops = _ubnormal_eval(rng, device)
    torch.cuda.empty_cache()
    ucf_rate = _ucf_eval(rng, device)
    torch.cuda.empty_cache()
    hostfed_rate, hostfed_gbps = _hostfed_eval(rng, device)
    torch.cuda.empty_cache()
    h2d_raw_gbps = _h2d_probe(rng, device)
    torch.cuda.empty_cache()
    serving_rate, serving_p50, serving_p99 = _serving_probe(rng, device)
    torch.cuda.empty_cache()
    mp_rate, mp_p50 = _serving_mp_probe(rng, device)
    torch.cuda.empty_cache()
    # train phases last, as in the JAX benchmark; the headline train number
    # is the f32 step (the preset default), bf16 and bf16 + SR alternates
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    train_rate, train_tflops = _train_step(rng, device, "float32")
    train_peak = (f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB"
                  if device.type == "cuda" else "not measured (cpu)")
    torch.cuda.empty_cache()
    train_bf16_rate, train_bf16_tflops = _train_step(rng, device,
                                                     "bfloat16")
    torch.cuda.empty_cache()
    train_sr_rate, train_sr_tflops = _train_step(rng, device, "bfloat16",
                                                 cast_sr=True)

    print(f"sht_ltn eval: {eval_rate:.0f} snippets/s ({eval_tflops:.1f} "
          f"TFLOP/s) | stn: {stn_rate:.0f} ({stn_tflops:.1f}) | "
          f"ubnormal: {ub_rate:.0f} ({ub_tflops:.1f}) | "
          f"ucf end-to-end: {ucf_rate:.0f} | "
          f"host-fed: {hostfed_rate:.0f} ({hostfed_gbps:.2f} GB/s of "
          f"{h2d_raw_gbps:.2f} raw pinned) | "
          f"serving: {serving_rate:.0f} parts/s "
          f"(p50 {serving_p50:.1f} ms) | "
          f"serving-mp: {mp_rate:.0f} parts/s (p50 {mp_p50:.1f} ms) | "
          f"train f32: {train_rate:.0f} ({train_tflops:.1f}) | "
          f"train bf16 alt: {train_bf16_rate:.0f} ({train_bf16_tflops:.1f})"
          f" | train bf16+SR: {train_sr_rate:.0f} ({train_sr_tflops:.1f})"
          f" | on {card}; mfu over {H100_PEAK_TFLOPS:.0f} TFLOP/s (H100 "
          f"SXM dense bf16 peak) | f32 train peak {train_peak}",
          file=sys.stderr)
    print("benchmark launches " + json.dumps(dict(cuda_attention.by_route)),
          file=sys.stderr, flush=True)
    line = {
        "metric": "sht_ltn_eval_snippets_per_sec",
        "value": eval_rate,
        "unit": "snippets/s",
        "vs_baseline": vs_ref,
        "train_snippets_per_sec": train_rate,
        "eval_tflops": eval_tflops,
        "train_tflops": train_tflops,
        "eval_mfu": eval_tflops / H100_PEAK_TFLOPS,
        "train_mfu": train_tflops / H100_PEAK_TFLOPS,
        "train_compute_dtype": "float32",
        "train_bf16_snippets_per_sec": train_bf16_rate,
        "train_bf16_tflops": train_bf16_tflops,
        "train_bf16_mfu": train_bf16_tflops / H100_PEAK_TFLOPS,
        "train_bf16_sr_snippets_per_sec": train_sr_rate,
        "train_bf16_sr_tflops": train_sr_tflops,
        "train_bf16_sr_mfu": train_sr_tflops / H100_PEAK_TFLOPS,
        "stn_eval_snippets_per_sec": stn_rate,
        "stn_eval_tflops": stn_tflops,
        "ubnormal_eval_snippets_per_sec": ub_rate,
        "ubnormal_eval_tflops": ub_tflops,
        "ucf_eval_snippets_per_sec": ucf_rate,
        "hostfed_eval_snippets_per_sec": hostfed_rate,
        "hostfed_h2d_gbps": hostfed_gbps,
        "h2d_raw_gbps": h2d_raw_gbps,
        "serving_parts_per_sec": serving_rate,
        "serving_flush_p50_ms": serving_p50,
        "serving_flush_p99_ms": serving_p99,
        "serving_mp_parts_per_sec": mp_rate,
        "serving_mp_roundtrip_p50_ms": mp_p50,
    }
    if tuple(line) != CONTRACT_KEYS:
        raise AssertionError("success line keys drifted from CONTRACT_KEYS: "
                             f"{set(line) ^ set(CONTRACT_KEYS)}")
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())
