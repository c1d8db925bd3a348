"""Pseudo-label generators — the co-teaching hand-off artifact; PyTorch
counterpart of lstc_vad_tpu/pseudo/generator.py.

Each network scores every TRAIN video; scores above a threshold are kept,
the rest zeroed; the dict {key+'.npy': scores} is saved via np.save
(Train/pseudo_labels_generator_spatio.py:22-89,
Train/pseudo_labels_generator_temporal.py:22-146).  Thresholds from the
README pipeline: STN->LTN 0.9, LTN->STN 0.65 (README.md:27,35).

All train videos' clips (STN) / parts (LTN) stream through the cross-video
batched scorers, one video's features resident at a time.  The scorers hold
their modules, so no params argument is passed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..data.annotations import TrainRecord
from ..evaluation.scoring import ClipScorer, PartScorer, UCFBinnedScorer


def pseudo_scorer(cfg, encoder, head):
    """The scorer that ``cfg``'s model generates pseudo labels with.  STN:
    a ClipScorer of the head's kind (a classifier head must score
    P(abnormal), not out[:, 0]).  LTN: a PartScorer without tail re-window,
    or on UCF a UCFBinnedScorer without L2 norm or re-window whose bin count
    is the config's max_clips (the reference generator hardcodes 32, the
    config default, Train/pseudo_labels_generator_temporal.py:70).  Every
    one takes the config's evaluation wire, ``data.eval_transfer_dtype``."""
    d = cfg.data
    td = d.eval_transfer_dtype
    if cfg.model.startswith("stn"):
        return ClipScorer(encoder, head, d.n_patch, kind=cfg.head.kind,
                          transfer_dtype=td)
    if d.dataset == "UCF":
        return UCFBinnedScorer(encoder, head, d.part_len, d.n_patch,
                               max_clips=cfg.max_clips, l2_normalize=False,
                               tail_rewindow=False, transfer_dtype=td)
    return PartScorer(encoder, head, d.part_len, d.n_patch,
                      tail_rewindow=False, transfer_dtype=td)


def _threshold(scores: np.ndarray, threshold: float) -> np.ndarray:
    """score if score > tau else 0 (pseudo_labels_generator_spatio.py:85-86)."""
    return np.where(scores > threshold, scores, 0.0).astype(np.float32)


def _lazy(store, records: List[TrainRecord]):
    return [(lambda key=rec.key: store.get(key)) for rec in records]


def generate_stn_pseudo_labels(scorer: ClipScorer, store,
                               records: List[TrainRecord],
                               threshold: float = 0.9
                               ) -> Dict[str, np.ndarray]:
    """One clip-level score per train clip, thresholded.  ``scorer`` may
    wrap a Regressor or a Classifier head whose abnormal-class probability
    is taken (the reference's n_layers==1 switch,
    pseudo_labels_generator_spatio.py:54-61,81-84)."""
    per_video = scorer.score_videos(_lazy(store, records))
    return {rec.key + ".npy": _threshold(scores, threshold)
            for rec, scores in zip(records, per_video)}


def generate_ltn_pseudo_labels(scorer, store, records: List[TrainRecord],
                               threshold: float = 0.65,
                               dataset: str = "SHT",
                               segment_len: int = 16
                               ) -> Dict[str, np.ndarray]:
    """Part-level scores thresholded, then expanded to clip resolution:
    SHT/UBnormal repeat each part's score over its clip count
    (pseudo_labels_generator_temporal.py:109-143, NO tail re-window); UCF
    expands each bin-space part over its bins' clip widths
    (:66-107).

    ``scorer``: ``pseudo_scorer`` of an LTN config — PartScorer(
    tail_rewindow=False) for SHT/UBnormal, UCFBinnedScorer(
    l2_normalize=False, tail_rewindow=False) for UCF."""
    out = {}
    lazy = _lazy(store, records)
    if dataset == "UCF":
        items = [(f, rec.n_frames // segment_len)
                 for f, rec in zip(lazy, records)]
        for rec, (part_scores, parts, r) in zip(records,
                                                 scorer.score_videos(items)):
            part_scores = _threshold(part_scores, threshold)
            # The reference saves BIN-resolution scores here (<=32 entries,
            # pseudo_labels_generator_temporal.py:106-107) which its own
            # train dataset then indexes with CLIP indices — a latent
            # IndexError for videos longer than 32 clips.  Each part score
            # is expanded over its bins' clip widths (r[end]-r[beg]) and
            # padded with the last value / trimmed to the stored clip count.
            clip_scores = np.repeat(
                part_scores,
                [int(r[end] - r[beg]) for beg, end in parts]).astype(
                    np.float32)
            feat_len = store.n_clips(rec.key)
            if len(clip_scores) < feat_len:
                pad = np.full(feat_len - len(clip_scores),
                              clip_scores[-1] if len(clip_scores) else 0.0,
                              np.float32)
                clip_scores = np.concatenate([clip_scores, pad])
            out[rec.key + ".npy"] = clip_scores[:feat_len]
        return out
    for rec, (part_scores, counts) in zip(records, scorer.score_videos(lazy)):
        out[rec.key + ".npy"] = np.repeat(_threshold(part_scores, threshold),
                                          counts)
    return out


def save_pseudo_labels(path: str, pseudo: Dict[str, np.ndarray]):
    np.save(path, pseudo)  # np.load(..., allow_pickle=True).tolist() reads it
