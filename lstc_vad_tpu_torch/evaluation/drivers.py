"""Dataset-level evaluation drivers -> frame-level AUC
(lstc_vad_tpu/evaluation/drivers.py:24-85).

Each function reproduces one reference eval loop's score/label assembly, with
the per-part device calls replaced by the batched scorers in
evaluation/scoring.py.  Scores are truncated to the annotation length where
the reference would desync.  The scorers hold their modules, so no params
argument is passed.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

from .frame_auc import expand_scores_to_frames
from .metrics import roc_auc
from .scoring import ClipScorer, PartScorer

Item = Tuple[np.ndarray, Optional[np.ndarray]]  # (feats, per-frame anno|None)


def _concat_auc(scores: List[np.ndarray], labels: List[np.ndarray]) -> float:
    if not scores:
        raise ValueError("no videos to evaluate (the item list is empty — "
                         "check the test split / filters)")
    return roc_auc(np.concatenate(scores), np.concatenate(labels))


def _result(all_scores, all_labels, return_scores, return_labels=False,
            compute_auc=True):
    auc = _concat_auc(all_scores, all_labels) if compute_auc else None
    if return_labels:
        return auc, all_scores, all_labels
    if return_scores:
        return auc, all_scores
    return auc


def _frame_labels(anno, n: int) -> np.ndarray:
    return np.zeros(n) if anno is None else np.asarray(anno[:n],
                                                       dtype=np.float64)


def evaluate_stn(scorer: ClipScorer, items: Iterable[Item],
                 segment_len: int = 16, return_scores: bool = False,
                 return_labels: bool = False, compute_auc: bool = True):
    """STN whole-video eval: clip scores x segment_len vs annotation head
    (Train/spatio_transformer_shanghaitech.py:133-143)."""
    items = list(items)
    per_video = scorer.score_videos([feats for feats, _ in items])
    all_scores, all_labels = [], []
    for clip_scores, (_, anno) in zip(per_video, items):
        s = np.repeat(clip_scores, segment_len)
        lab = _frame_labels(anno, len(s))
        all_scores.append(s[:len(lab)])
        all_labels.append(lab)
    return _result(all_scores, all_labels, return_scores, return_labels,
                   compute_auc)


def evaluate_ltn(scorer: PartScorer, items: Iterable[Item],
                 segment_len: int = 16, return_scores: bool = False,
                 return_labels: bool = False, compute_auc: bool = True):
    """LTN part-chunked eval with tail re-window
    (Test/evaluation_shanghaitech_ubnormal.py:70-95)."""
    items = list(items)
    results = scorer.score_videos([feats for feats, _ in items])
    all_scores, all_labels = [], []
    for (part_scores, counts), (_, anno) in zip(results, items):
        s = expand_scores_to_frames(part_scores, counts, segment_len)
        lab = _frame_labels(anno, len(s))
        all_scores.append(s[:len(lab)])
        all_labels.append(lab)
    return _result(all_scores, all_labels, return_scores, return_labels,
                   compute_auc)
