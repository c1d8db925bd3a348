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
