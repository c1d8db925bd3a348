"""The chunk packer under the four offline scorers (evaluation/scoring.py
``_Packer``), on the CPU: a ragged split scored at once gives each video
the scores it gets alone, bit for bit, in one device call per ``CHUNK``
rows of a token length.

The split holds a video shorter than one part, a video whose rows fill a
chunk exactly (with chunks of 5; at the default, for the clip and part
scorers), videos that cross chunk boundaries and, where the scorer has
them, tails scored at their own length (no re-window).

The CPU's BLAS sums a one-row product (the head's Linear over a batch of
one) in another order than a many-row one, so the test runs the forward a
row at a time: each row's score is then its own whatever batch carries it,
and any row the packer puts in the wrong place shows as a mismatch."""

import numpy as np
import pytest
import torch

from lstc_vad_tpu_torch.config import preset
from lstc_vad_tpu_torch.evaluation import scoring
from lstc_vad_tpu_torch.evaluation.frame_auc import (part_bounds,
                                                     part_slices,
                                                     ucf_bin_edges)
from lstc_vad_tpu_torch.models import build

TINY = {"encoder.d_model": 16, "encoder.d_inner": 32, "encoder.n_head": 2,
        "encoder.d_k": 8, "encoder.d_v": 8, "encoder.n_layers": 1,
        "head.d_model": 16, "head.hidden_dim": 8, "data.n_patch": 4,
        "data.d_model": 16}
PART_LEN = 3   # the sht_ltn and ucf_ltn presets'
BINS = 15      # UCF bins: five 3-bin parts fill a chunk of 5
BIN_CLIPS = 5  # UCF clip bins: five fill a chunk of 5


def _clip(chunk):
    encoder, head = build(preset("sht_stn", **TINY), "cpu", seed=0)
    scorer = scoring.ClipScorer(encoder, head, 4)
    # the first video's clips fill the first chunk exactly
    lengths = [chunk, 1, 7, 11, 20, 4]
    rows = {4: sum(lengths)}
    return scorer, lengths, rows


def _part(chunk):
    encoder, head = build(preset("sht_ltn", **TINY), "cpu", seed=0)
    scorer = scoring.PartScorer(encoder, head, PART_LEN, 4,
                                tail_rewindow=False)
    # one clip (a part of one short tail); then parts filling a chunk
    lengths = [1, PART_LEN * chunk, 7, 11, 20, 4]
    rows = {}
    for n in lengths:
        for idx in part_slices(n, PART_LEN, tail_rewindow=False)[0]:
            rows[len(idx)] = rows.get(len(idx), 0) + 1
    return scorer, lengths, rows


def _ucf_binned(chunk):
    encoder, head = build(preset("ucf_ltn", **TINY), "cpu", seed=0)
    # the in-training flags: adaptive bins, so a short video has short parts
    scorer = scoring.UCFBinnedScorer(encoder, head, PART_LEN, 4,
                                     max_clips=BINS, l2_normalize=False,
                                     tail_rewindow=False, adaptive_bins=True)
    lengths = [1, BINS, 7, 11, 40, 4]
    rows = {}
    for n in lengths:
        for beg, end in part_bounds(min(BINS, n), PART_LEN):
            rows[end - beg] = rows.get(end - beg, 0) + 1
    return scorer, lengths, rows


def _ucf_clip_bin(chunk):
    encoder, head = build(preset("ucf_stn", **TINY), "cpu", seed=0)
    scorer = scoring.UCFClipBinScorer(encoder, head, 4, max_clips=BIN_CLIPS)
    # no clip at all: no bin to score
    lengths = [0, BIN_CLIPS, 3, 9, 2, 12]
    rows = {1: sum(int((np.diff(ucf_bin_edges(n, BIN_CLIPS)) != 0).sum())
                   for n in lengths)}
    return scorer, lengths, rows


SCORERS = {"clip": _clip, "part": _part, "ucf_binned": _ucf_binned,
           "ucf_clip_bin": _ucf_clip_bin}


@pytest.mark.parametrize("chunk", [5, scoring.CHUNK])
@pytest.mark.parametrize("kind", sorted(SCORERS))
def test_scorers_pack_videos_as_they_score_alone(kind, chunk, monkeypatch):
    monkeypatch.setattr(scoring, "CHUNK", chunk)
    scorer, lengths, rows = SCORERS[kind](chunk)
    forward = scorer.scorer._forward
    monkeypatch.setattr(scorer.scorer, "_forward", lambda x: torch.cat(
        [forward(row) for row in x.split(1)]))
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((n, 4, 16), dtype=np.float32)
             for n in lengths]
    ucf = kind.startswith("ucf")
    items = ([(f, len(f)) for f in feats] if ucf
             else [(lambda f=f: f) for f in feats])
    before = scorer.scorer.n_calls
    together = scorer.score_videos(items)
    calls = scorer.scorer.n_calls - before
    assert calls == sum(-(-n // chunk) for n in rows.values())
    assert len(together) == len(items)
    for got, item in zip(together, items):
        alone = scorer.score_video(*item) if ucf else scorer.score_video(item)
        if kind == "clip":  # scores alone; the others return tuples
            got, alone = (got,), (alone,)
        assert np.isfinite(got[0]).all()
        for a, b in zip(got, alone, strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# The copy threads: ``FILL_MIN_BYTES`` set to one byte sends every copy to
# the pool, set past the split sends none.

def _feats(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, 4, 16), dtype=np.float32)
            for n in lengths]


def _items(kind, feats):
    if kind.startswith("ucf"):
        return [(f, len(f)) for f in feats]
    return [(lambda f=f: f) for f in feats]


def _recorded(scorer, monkeypatch):
    """Each chunk ``scorer`` dispatches, copied as it goes to the device."""
    chunks = []
    dispatch = scorer._dispatch

    def record(tokens):
        chunks.append(tokens.clone() if isinstance(tokens, torch.Tensor)
                      else tokens.copy())
        return dispatch(tokens)

    monkeypatch.setattr(scorer, "_dispatch", record)
    return chunks


@pytest.mark.parametrize("threads", [2, 3])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(SCORERS))
def test_pooled_fill_packs_the_chunks_of_an_inline_fill(kind, wire, threads,
                                                        monkeypatch):
    """Copies of up to 5 rows split into 2 or 3 ranges, the last short; the
    bf16 wire's casts stay on the unit thread whatever their size."""
    monkeypatch.setattr(scoring, "CHUNK", 5)
    monkeypatch.setattr(scoring, "FILL_THREADS", threads)
    monkeypatch.setattr(scoring, "FILL_RANGE_BYTES", 1)
    scorer, lengths, _ = SCORERS[kind](5)
    scorer.scorer.wire = getattr(torch, wire)
    feats = _feats(lengths)
    chunks = _recorded(scorer.scorer, monkeypatch)
    rows_bytes = None
    runs = {}
    for mode, least in (("inline", 1 << 40), ("pooled", 1)):
        monkeypatch.setattr(scoring, "FILL_MIN_BYTES", least)
        del chunks[:]
        pooled = scorer.scorer.fill_pooled_bytes
        inline = scorer.scorer.fill_inline_bytes
        scores = scorer.score_videos(_items(kind, feats))
        pooled = scorer.scorer.fill_pooled_bytes - pooled
        inline = scorer.scorer.fill_inline_bytes - inline
        if mode == "inline":
            assert pooled == 0
            rows_bytes = inline
        elif wire == "bfloat16":  # a cast runs on torch's own threads
            assert pooled == 0 and inline == rows_bytes
        else:
            assert inline == 0 and pooled == rows_bytes
        runs[mode] = (list(chunks), scores)
    (c_in, s_in), (c_pool, s_pool) = runs["inline"], runs["pooled"]
    assert len(c_pool) == len(c_in) >= 2
    for a, b in zip(c_pool, c_in):
        assert type(a) is type(b) and a.shape == b.shape
        if isinstance(a, torch.Tensor):
            assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)
    flat = (lambda s: [np.asarray(x) for v in s for x in
                       ((v,) if kind == "clip" else v)])
    for a, b in zip(flat(s_pool), flat(s_in), strict=True):
        np.testing.assert_array_equal(a, b)


def test_uneven_ranges_land_in_place(monkeypatch):
    """Blocks of 8, 5, 11 and 7 rows in three ranges each, inside a chunk
    with room past them: every range writes its own rows and no more."""
    monkeypatch.setattr(scoring, "CHUNK", 64)
    monkeypatch.setattr(scoring, "FILL_THREADS", 3)
    monkeypatch.setattr(scoring, "FILL_RANGE_BYTES", 1)
    scorer, _, _ = SCORERS["clip"](64)
    chunks = _recorded(scorer.scorer, monkeypatch)
    feats = _feats([8, 5, 11, 7], seed=1)
    for least in (1 << 40, 1):
        monkeypatch.setattr(scoring, "FILL_MIN_BYTES", least)
        scorer.score_videos(_items("clip", feats))
    inline, pooled = chunks
    np.testing.assert_array_equal(pooled, inline)
    np.testing.assert_array_equal(pooled, np.concatenate(feats))


@pytest.mark.parametrize("kind", sorted(SCORERS))
def test_fill_counters_sum_to_the_rows_packed(kind, monkeypatch):
    """Half the copies pooled (those of two rows or more), half inline:
    the two counters together are every row's bytes."""
    monkeypatch.setattr(scoring, "CHUNK", 5)
    scorer, lengths, rows = SCORERS[kind](5)
    # a row's f32 bytes: ``rows`` keys the clip scorer's by tokens, the
    # others' by clips of 4 tokens
    row = {n: n * (1 if kind == "clip" else 4) * 16 * 4 for n in rows}
    for least in (1 << 40, 1, 2 * min(row.values())):
        monkeypatch.setattr(scoring, "FILL_MIN_BYTES", least)
        before = (scorer.scorer.fill_pooled_bytes
                  + scorer.scorer.fill_inline_bytes)
        scorer.score_videos(_items(kind, _feats(lengths)))
        after = (scorer.scorer.fill_pooled_bytes
                 + scorer.scorer.fill_inline_bytes)
        assert after - before == sum(rows[n] * row[n] for n in rows)


class _Hold:
    """``scoring.fill`` that counts the copies made on copy threads and can
    hold the first until ``release`` is set (``held``: its buffer;
    ``held_landed_at``: when it landed), or fail the ``fail``-th."""

    def __init__(self, fail=None, hold=False):
        import threading

        self.fill = scoring.fill
        self.lock = threading.Lock()
        self.release = threading.Event()
        self.fail, self.hold = fail, hold
        self.started = self.landed = 0
        self.held = self.held_landed_at = None

    def __call__(self, buf, index, value):
        import threading
        import time

        if threading.current_thread() is threading.main_thread():
            return self.fill(buf, index, value)
        with self.lock:
            self.started += 1
            n = self.started
        if n == self.fail:
            raise RuntimeError("copy failed")
        if self.hold and n == 1:
            self.held = buf
            assert self.release.wait(30)
        self.fill(buf, index, value)
        with self.lock:
            self.landed += 1
            if self.held is buf:
                self.held_landed_at = time.monotonic()


def _packers(monkeypatch):
    """Every ``_Packer`` made from here on."""
    made = []

    class Packer(scoring._Packer):
        def __init__(self, scorer):
            super().__init__(scorer)
            made.append(self)

    monkeypatch.setattr(scoring, "_Packer", Packer)
    return made


def _settled(packers, hold):
    return (hold.started == hold.landed + (hold.fail is not None
                                           and hold.started >= hold.fail)
            and all(f.done() for p in packers for fs in p._copies.values()
                    for f in fs))


def test_a_failed_copy_raises_on_the_unit_thread(monkeypatch):
    monkeypatch.setattr(scoring, "CHUNK", 5)
    monkeypatch.setattr(scoring, "FILL_MIN_BYTES", 1)
    hold = _Hold(fail=3)
    monkeypatch.setattr(scoring, "fill", hold)
    packers = _packers(monkeypatch)
    scorer, lengths, _ = SCORERS["part"](5)
    with pytest.raises(RuntimeError, match="copy failed"):
        scorer.score_videos(_items("part", _feats(lengths)))
    assert hold.started >= 3 and _settled(packers, hold)


@pytest.mark.parametrize("midway", [False, True])
def test_no_copy_outlives_score_videos(midway, monkeypatch):
    """The first pooled copy is held until a timer lets it go: whether the
    split ends or a loader raises midway, ``score_videos`` leaves only once
    it has landed, no copy is pending then, and its buffer is released
    after it (not before)."""
    import threading
    import time
    import weakref

    monkeypatch.setattr(scoring, "CHUNK", 5)
    monkeypatch.setattr(scoring, "FILL_MIN_BYTES", 1)
    hold = _Hold(hold=True)
    monkeypatch.setattr(scoring, "fill", hold)
    packers = _packers(monkeypatch)
    scorer, lengths, _ = SCORERS["part"](5)
    bufs, released = [], {}
    host_buffer = scorer.scorer.host_buffer

    def tracked(shape):
        buf = host_buffer(shape)
        k = len(bufs)
        bufs.append(weakref.ref(buf))
        weakref.finalize(buf, lambda: released.__setitem__(
            k, time.monotonic()))
        return buf

    monkeypatch.setattr(scorer.scorer, "host_buffer", tracked)
    items = _items("part", _feats(lengths))
    if midway:
        def broken():
            raise OSError("unreadable video")
        items[3] = broken
    timer = threading.Timer(0.3, hold.release.set)
    timer.start()
    try:
        if midway:
            with pytest.raises(OSError, match="unreadable"):
                scorer.score_videos(items)
        else:
            scorer.score_videos(items)
        left = time.monotonic()
    finally:
        hold.release.set()
        timer.join(10)
    assert not timer.is_alive()
    assert hold.held_landed_at is not None and hold.held_landed_at <= left
    (held,) = [k for k, ref in enumerate(bufs) if ref() is hold.held]
    assert _settled(packers, hold)
    del packers[:], hold.held
    import gc
    gc.collect()
    assert released[held] >= hold.held_landed_at


def test_videos_with_pending_copies_stay_under_the_cap(monkeypatch):
    import time

    monkeypatch.setattr(scoring, "CHUNK", 64)
    monkeypatch.setattr(scoring, "FILL_MIN_BYTES", 1)
    monkeypatch.setattr(scoring, "FILL_VIDEOS", 3)
    fill = scoring.fill

    def slow(buf, index, value):
        time.sleep(0.005)
        fill(buf, index, value)

    monkeypatch.setattr(scoring, "fill", slow)
    packers = _packers(monkeypatch)
    pending = []
    add = scoring._Packer.add

    def counted(self, v, i, rows):
        add(self, v, i, rows)
        pending.append(sum(not all(f.done() for f in fs)
                           for fs in self._copies.values()))

    monkeypatch.setattr(scoring._Packer, "add", counted)
    scorer, _, _ = SCORERS["clip"](64)
    feats = _feats([6] * 20)
    got = scorer.score_videos(_items("clip", feats))
    assert max(pending) == 3 and len(pending) == 20
    assert all(len(p._copies) <= 3 for p in packers)
    monkeypatch.setattr(scoring, "FILL_MIN_BYTES", 1 << 40)
    want = scorer.score_videos(_items("clip", feats))
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
