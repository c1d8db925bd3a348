"""The port's spans (utils/profiling.py): where the eval pass and the train
epoch record them, on which thread, nested how, how many, and that they
change no result.  The file imports neither JAX nor the JAX package, so its
card test also runs on a machine without them."""

import ast
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lstc_vad_tpu_torch.config import preset, replace
from lstc_vad_tpu_torch.data.annotations import TrainRecord
from lstc_vad_tpu_torch.data.synthetic import SyntheticStore, write_train_files
from lstc_vad_tpu_torch.evaluation import scoring
from lstc_vad_tpu_torch.evaluation.drivers import evaluate_ltn
from lstc_vad_tpu_torch.models import build
from lstc_vad_tpu_torch.train.driver import Trainer
from lstc_vad_tpu_torch.utils import profiling
from lstc_vad_tpu_torch.utils.profiling import SPANS, annotate, trace

PORT = Path(__file__).resolve().parents[1] / "lstc_vad_tpu_torch"
TINY = {"encoder.d_model": 16, "encoder.d_inner": 32, "encoder.n_head": 2,
        "encoder.d_k": 8, "encoder.d_v": 8, "encoder.n_layers": 1,
        "head.d_model": 16, "head.hidden_dim": 8, "data.n_patch": 4,
        "data.d_model": 16, "data.batch_size": 2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _spans(logdir):
    """The trace's program spans: [{name, ts, end, tid, parent}], the
    parent the innermost span of the same thread holding it (None)."""
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e["name"] in SPANS]
    spans = [{"name": e["name"], "ts": e["ts"], "end": e["ts"] + e["dur"],
              "tid": e["tid"]} for e in events]
    for s in spans:
        holders = [h for h in spans if h is not s and h["tid"] == s["tid"]
                   and h["ts"] <= s["ts"] and s["end"] <= h["end"]
                   and (h["end"] - h["ts"]) > (s["end"] - s["ts"])]
        s["parent"] = min(holders, key=lambda h: h["end"] - h["ts"],
                          default={"name": None})["name"]
    return spans


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def _parents(spans, name):
    return {s["parent"] for s in _named(spans, name)}


def _split(seed=0, videos=5):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(videos):
        n = int(rng.integers(4, 14))
        items.append((rng.standard_normal((n, 4, 16), dtype=np.float32),
                      (np.arange(n * 16) % 7 < 2 * (i % 2)).astype(float)))
    return items


def _part_scorer(device):
    cfg = preset("sht_ltn", **TINY)
    encoder, head = build(cfg, device, seed=0)
    return scoring.PartScorer(encoder, head, cfg.data.part_len,
                              cfg.data.n_patch)


def test_annotate_without_a_profiler_is_the_shared_null():
    assert annotate("eval.score") is profiling._NULL
    # the name is checked only while a profiler runs
    assert annotate("no.such.span") is profiling._NULL


def test_annotate_refuses_an_unknown_name_while_tracing(tmp_path):
    with trace(str(tmp_path)):
        with pytest.raises(ValueError, match="no.such.span"):
            annotate("no.such.span")
        with annotate("eval.score"):
            pass
    assert _named(_spans(str(tmp_path)), "eval.score")


def test_every_span_the_port_names_is_in_spans():
    names = []
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", None)) \
                    == "annotate":
                assert len(node.args) == 1 and isinstance(
                    node.args[0], ast.Constant), (path, node.lineno)
                names.append(node.args[0].value)
    assert set(names) <= set(SPANS), set(names) - set(SPANS)
    assert set(names) == set(SPANS)  # every span is recorded somewhere


def _eval_pass(scorer, items):
    return evaluate_ltn(scorer, items, 16, return_labels=True)


def test_eval_pass_spans_nest_and_count(tmp_path, monkeypatch):
    # chunks of 8 parts: flushes inside the per-video loop and after it
    monkeypatch.setattr(scoring, "CHUNK", 8)
    scorer = _part_scorer("cpu")
    items = _split()
    calls = scorer.scorer.n_calls
    with trace(str(tmp_path)):
        _eval_pass(scorer, items)
    calls = scorer.scorer.n_calls - calls
    spans = _spans(str(tmp_path))
    (score,) = _named(spans, "eval.score")
    (frames,) = _named(spans, "eval.frames")
    unit = score["tid"]
    assert frames["tid"] == unit and frames["ts"] >= score["end"]
    assert _parents(spans, "eval.score") == _parents(spans, "eval.frames")
    assert len(_named(spans, "scorer.pack")) == len(items)
    assert _parents(spans, "scorer.pack") == {"eval.score"}
    assert len(_named(spans, "scorer.read_wait")) == len(items) + 1
    assert _parents(spans, "scorer.read_wait") == {"eval.score"}
    assert _parents(spans, "scorer.alloc") == {"scorer.pack"}
    assert calls >= 3 and len(_named(spans, "scorer.dispatch")) == calls
    assert _parents(spans, "scorer.dispatch") == {"scorer.pack",
                                                  "eval.score"}
    assert len(_named(spans, "scorer.forward")) == calls
    assert _parents(spans, "scorer.forward") == {"scorer.dispatch"}
    reads = _named(spans, "scorer.read")
    assert len(reads) == len(items)
    assert {s["tid"] for s in reads} and unit not in {s["tid"] for s in reads}
    for name in ("eval.score", "eval.frames", "scorer.pack",
                 "scorer.dispatch", "scorer.alloc", "scorer.read_wait"):
        assert {s["tid"] for s in _named(spans, name)} == {unit}, name


def test_pooled_fill_spans(tmp_path, monkeypatch):
    """Every copy on the copy threads (``FILL_MIN_BYTES`` of one byte), each
    slowed so the unit thread waits for some: ``scorer.fill`` on threads of
    their own, ``scorer.fill_wait`` on the unit thread inside a video's pack
    or the pass, and still one ``scorer.pack`` a video."""
    monkeypatch.setattr(scoring, "CHUNK", 8)
    monkeypatch.setattr(scoring, "FILL_MIN_BYTES", 1)
    monkeypatch.setattr(scoring, "FILL_RANGE_BYTES", 1)
    fill = scoring.fill

    def slow(buf, index, value):
        time.sleep(0.002)
        fill(buf, index, value)

    monkeypatch.setattr(scoring, "fill", slow)
    assert {"scorer.fill", "scorer.fill_wait"} <= set(SPANS)
    scorer = _part_scorer("cpu")
    items = _split(3)
    with trace(str(tmp_path)):
        _eval_pass(scorer, items)
    assert scorer.scorer.fill_inline_bytes == 0
    assert scorer.scorer.fill_pooled_bytes > 0
    spans = _spans(str(tmp_path))
    (score,) = _named(spans, "eval.score")
    unit = score["tid"]
    assert len(_named(spans, "scorer.pack")) == len(items)
    fills = _named(spans, "scorer.fill")
    assert fills and unit not in {s["tid"] for s in fills}
    assert _parents(spans, "scorer.fill") == {None}
    waits = _named(spans, "scorer.fill_wait")
    assert waits and {s["tid"] for s in waits} == {unit}
    assert _parents(spans, "scorer.fill_wait") <= {"scorer.pack",
                                                   "eval.score"}


def test_operator_spans_are_known():
    assert SPANS.keys() >= {"linear.pad", "attention.plain"}


@pytest.mark.parametrize("width,padded", [(31, True), (3027, True),
                                          (32, False), (4096, False)])
def test_padded_copy_counts_and_span(tmp_path, width, padded):
    """``_tma_rows`` copies rows off the 16-byte grid into a padded row
    stride (returning the view of their first ``width`` columns, rows
    ``ld`` apart), counts the copy and the bytes it reads and writes (2 · M
    · width · 4) and records it as ``linear.pad``; aligned rows it leaves
    alone.  (On CPU tensors the operator itself never calls it.)"""
    from lstc_vad_tpu_torch.ops import cuda_linear

    x = torch.randn(3, 5, width)
    cuda_linear.reset_launches()
    with trace(str(tmp_path)):
        rows, ld = cuda_linear._tma_rows(x)
    assert ld == -(-width // 4) * 4 and rows.shape == (15, width)
    assert rows.stride() == (ld, 1)
    assert torch.equal(rows, x.reshape(15, width))
    assert cuda_linear.pad_copies == int(padded)
    assert cuda_linear.pad_bytes == (2 * 15 * width * 4 if padded else 0)
    assert len(_named(_spans(str(tmp_path)), "linear.pad")) == int(padded)
    cuda_linear.reset_launches()
    assert cuda_linear.pad_copies == cuda_linear.pad_bytes == 0


def test_perf_md_names_the_scorers_spans_and_counters():
    perf = (PORT.parent / "PERF.md").read_text()
    (row,) = [line for line in perf.splitlines()
              if line.startswith("| scorers |")]
    for name in ("scorer.fill", "scorer.fill_wait", "fill_pooled_bytes",
                 "fill_inline_bytes"):
        assert name in row, name


def test_eval_results_are_the_same_traced(tmp_path):
    scorer = _part_scorer("cpu")
    items = _split(1)
    off = _eval_pass(scorer, items)
    with trace(str(tmp_path)):
        on = _eval_pass(scorer, items)
    assert on[0] == off[0]
    for a, b in zip(on[1] + on[2], off[1] + off[2]):
        np.testing.assert_array_equal(a, b)


def _trainer(tmp_path, seed=3):
    rng = np.random.default_rng(seed)
    feats, records, masks = {}, [], {}
    for i in range(10):
        key, abnormal, n = f"v{i:02d}", i >= 5, int(rng.integers(8, 20))
        feats[key] = rng.standard_normal((n, 4, 16), dtype=np.float32)
        records.append(TrainRecord(key, abnormal))
        if abnormal:
            masks[key] = (np.arange(n * 16) < n * 8).astype(np.float64)
    train_txt, mask_dir = write_train_files(str(tmp_path), records, masks)
    cfg = preset("sht_ltn", **TINY, **{
        "data.train_txt": train_txt, "data.test_mask_dir": mask_dir,
        "model_save_dir": str(tmp_path / "ckpt")})
    return Trainer(replace(cfg, seed=seed), store=SyntheticStore(feats),
                   test_videos=[], device="cpu")


def settle(trainer, timeout=60.0):
    """Wait until the Trainer's batch worker has queued the next epoch
    whole, its batches and its end (an epoch of at most two batches, the
    worker's depth): its spans have then all closed, and it waits for the
    next ``train_epoch``."""
    items = trainer._batches._worker._shared.items
    want = len(trainer.dataset) // trainer.cfg.data.batch_size + 1
    deadline = time.monotonic() + timeout
    while items.qsize() < want:
        assert time.monotonic() < deadline, "the next epoch was never built"
        time.sleep(0.01)


def test_train_epoch_spans_nest_and_count(tmp_path):
    """Two epochs traced, and the worker's third (built ahead while the
    second runs) settled before the trace ends: one ``batch.start`` for the
    worker's life, not one an epoch; the builds of the epoch built ahead
    counted with the rest."""
    trainer = _trainer(tmp_path)
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        ms = [trainer.train_epoch(), trainer.train_epoch()]
        settle(trainer)
    m = ms[0]
    assert m["batches"] >= 2 and ms[1]["batches"] == m["batches"]
    steps = sum(x["batches"] for x in ms)
    spans = _spans(logdir)
    epochs = _named(spans, "train.epoch")
    assert len(epochs) == 2
    unit = epochs[0]["tid"]
    (start,) = _named(spans, "batch.start")
    assert _parents(spans, "batch.start") == {"train.epoch"}
    assert epochs[0]["ts"] <= start["ts"] and start["end"] <= epochs[0]["end"]
    assert not _named(spans, "batch.discard")
    assert len(_named(spans, "batch.wait")) == steps + len(ms)
    assert _parents(spans, "batch.wait") == {"train.epoch"}
    for name in ("step.forward", "step.backward", "step.optim"):
        assert len(_named(spans, name)) == steps, name
        assert _parents(spans, name) == {"train.epoch"}, name
    syncs = _named(spans, "train.sync")
    assert len(syncs) == 2 and _parents(spans, "train.sync") == {"train.epoch"}
    for epoch, sync in zip(epochs, syncs):
        assert epoch["ts"] <= sync["ts"] and sync["end"] <= epoch["end"]
        assert sync["ts"] >= max(s["end"] for s in _named(spans, "step.optim")
                                 if epoch["ts"] <= s["ts"] <= epoch["end"])
    # the worker's spans, on its own thread: three epochs, each with one
    # build more than batches (the last finds the epoch's end)
    builds, stages = _named(spans, "batch.build"), _named(spans, "batch.stage")
    assert len(builds) == 3 * (m["batches"] + 1)
    assert len(stages) == 3 * m["batches"]
    worker = {s["tid"] for s in builds + stages}
    assert len(worker) == 1 and unit not in worker
    assert {s["parent"] for s in builds + stages} == {None}
    for name in ("train.epoch", "batch.wait", "step.forward", "train.sync"):
        assert {s["tid"] for s in _named(spans, name)} == {unit}, name


def test_train_loss_is_the_same_traced(tmp_path):
    off = _trainer(tmp_path / "off")
    on = _trainer(tmp_path / "on")
    m_off = off.train_epoch()
    with trace(str(tmp_path / "trace")):
        m_on = on.train_epoch()
    assert m_on["loss"] == m_off["loss"]
    for a, b in zip(on.state.encoder.parameters(),
                    off.state.encoder.parameters()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_card_dispatch_spans(card, tmp_path):
    """On the card a dispatch enqueues its copy in, the forward and the
    copy out, and resolving it waits for the card."""
    scorer = _part_scorer(card)
    items = _split(2)
    off = _eval_pass(scorer, items)
    calls = scorer.scorer.n_calls
    with trace(str(tmp_path)):
        on = _eval_pass(scorer, items)
    calls = scorer.scorer.n_calls - calls
    np.testing.assert_array_equal(np.concatenate(on[1]),
                                  np.concatenate(off[1]))
    spans = _spans(str(tmp_path))
    for name in ("scorer.h2d", "scorer.forward", "scorer.d2h"):
        assert len(_named(spans, name)) == calls, name
        assert _parents(spans, name) == {"scorer.dispatch"}, name
    assert len(_named(spans, "scorer.wait")) == calls
    assert _named(spans, "scorer.alloc")
    # the reader thread's spans beside the card's events
    (score,) = _named(spans, "eval.score")
    reads = _named(spans, "scorer.read")
    assert len(reads) == len(items)
    assert score["tid"] not in {s["tid"] for s in reads}
    with open(os.path.join(str(tmp_path), profiling.TRACE_FILE)) as f:
        assert any(e.get("cat") == "kernel"
                   for e in json.load(f)["traceEvents"])


@pytest.mark.cuda
@pytest.mark.parametrize("name,copies", [("sht_stn", 3), ("sht_ltn", 0)])
def test_card_operator_spans_and_pad_counters(card, tmp_path, name, copies):
    """One train-mode forward and backward at full width: at d_inner 3027
    (``sht_stn``) 3 padded copies a forward (x into ``w_2``) and 6 a
    backward (dY out of ``w_1``, once for its input and weight gradients,
    and x into ``w_2`` for its weight gradient), each [M, 3027] read and
    written once, the backward's ``linear.pad`` spans on autograd's thread;
    at d_inner 4096 (``sht_ltn``) none.  Under attention dropout every
    layer's attention is one ``attention.plain`` span on the forward's
    thread."""
    from lstc_vad_tpu_torch.ops import cuda_linear

    cfg = preset(name)
    encoder, head = build(cfg, device=card, seed=0)
    encoder.train()
    head.train()
    n, tokens = 64, cfg.data.n_patch * (1 if name == "sht_stn"
                                        else cfg.data.part_len)
    x = torch.randn(n, tokens, cfg.encoder.d_model, device=card)
    m, width = n * (tokens + 1), cfg.encoder.d_inner
    cuda_linear.reset_launches()
    with trace(str(tmp_path)):
        out = head(encoder(x)[:, 0])
        assert cuda_linear.pad_copies == copies
        assert cuda_linear.pad_bytes == copies * 2 * m * width * 4
        out.sum().backward()
        torch.cuda.synchronize(card)
    assert cuda_linear.pad_copies == 3 * copies
    assert cuda_linear.pad_bytes == 3 * copies * 2 * m * width * 4
    spans = _spans(str(tmp_path))
    pads, attn = _named(spans, "linear.pad"), _named(spans, "attention.plain")
    assert len(pads) == 3 * copies
    assert len(attn) == cfg.encoder.n_layers
    forward = {s["tid"] for s in attn}
    assert len(forward) == 1
    if copies:
        # the forward's copies on its thread, the backward's on autograd's
        assert len([s for s in pads if s["tid"] in forward]) == copies
        assert len({s["tid"] for s in pads} - forward) == 1
