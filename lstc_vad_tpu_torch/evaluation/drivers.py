"""Dataset-level evaluation drivers -> frame-level AUC
(lstc_vad_tpu/evaluation/drivers.py:24-188).

Each function reproduces one reference eval loop's score/label assembly, with
the per-part device calls replaced by the batched scorers in
evaluation/scoring.py.  Scores are truncated to the annotation length where
the reference would desync.  The scorers hold their modules, so no params
argument is passed.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

from ..utils.profiling import annotate
from .frame_auc import expand_scores_to_frames, ucf_expand
from .metrics import eval_each_part, roc_auc
from .scoring import (ClipScorer, PartScorer, UCFBinnedScorer,
                      UCFClipBinScorer)

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
    with annotate("eval.score"):
        per_video = scorer.score_videos([feats for feats, _ in items])
    with annotate("eval.frames"):
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
    with annotate("eval.score"):
        results = scorer.score_videos([feats for feats, _ in items])
    with annotate("eval.frames"):
        all_scores, all_labels = [], []
        for (part_scores, counts), (_, anno) in zip(results, items):
            s = expand_scores_to_frames(part_scores, counts, segment_len)
            lab = _frame_labels(anno, len(s))
            all_scores.append(s[:len(lab)])
            all_labels.append(lab)
        return _result(all_scores, all_labels, return_scores, return_labels,
                       compute_auc)


def evaluate_multicrop_mean(eval_fn, scorer, items_for_crop,
                            segment_len: int = 16, n_crops: int = 10,
                            return_scores: bool = False,
                            return_labels: bool = False):
    """10-crop averaged evaluation: per-video frame scores averaged over the
    crops (summed in float64, divided by ``n_crops``), then one frame AUC.
    The reference ships tenCrop TEST loaders (utils/load_dataset.py:338-362,
    731-755) but no eval script; this is the JAX package's averaged-crop
    semantics (lstc_vad_tpu/evaluation/drivers.py:88-119), the CLI's
    ``--eval-crop mean``.

    ``eval_fn``: evaluate_stn or evaluate_ltn.  ``items_for_crop(c)`` yields
    that crop's (feats, anno) items (feats may be lazy loaders); the crops
    are scored one pass after another."""
    score_sum, annos = None, None
    for crop in range(n_crops):
        items = list(items_for_crop(crop))
        _, scores = eval_fn(scorer, items, segment_len, return_scores=True,
                            compute_auc=False)
        if score_sum is None:
            score_sum = [np.asarray(s, np.float64) for s in scores]
            annos = [anno for _, anno in items]
        else:
            score_sum = [a + np.asarray(s, np.float64)
                         for a, s in zip(score_sum, scores)]
    all_scores, all_labels = [], []
    for s, anno in zip(score_sum, annos):
        s = s / n_crops
        lab = _frame_labels(anno, len(s))
        all_scores.append(s[:len(lab)])
        all_labels.append(lab)
    return _result(all_scores, all_labels, return_scores, return_labels)


UCFItem = Tuple[np.ndarray, np.ndarray, int]  # (feats, anno, n_clips)


def _ucf_frames(results, items, segment_len: int):
    """Per-video (frame scores, frame labels) of the binned UCF eval
    (``results``, the scorer's), each truncated to the shorter of the
    two."""
    for (part_scores, parts, r), (_, anno, _) in zip(results, items):
        vs = ucf_expand(part_scores, parts, r, anno, segment_len)
        n = min(len(vs.scores), len(vs.labels))
        yield vs.scores[:n], vs.labels[:n]


def evaluate_ucf_ltn(scorer: UCFBinnedScorer, items: Iterable[UCFItem],
                     segment_len: int = 16, return_scores: bool = False,
                     return_labels: bool = False):
    """UCF binned eval: linspace compression + part grouping
    (Test/evaluation_UCF.py:44-87 with the scorer's final-eval flags;
    Train/temporal_transformer_UCF.py:139-172 with in-training flags)."""
    items = list(items)
    with annotate("eval.score"):
        results = scorer.score_videos([(f, n) for f, _, n in items])
    with annotate("eval.frames"):
        pairs = list(_ucf_frames(results, items, segment_len))
        return _result([s for s, _ in pairs], [lab for _, lab in pairs],
                       return_scores, return_labels)


def evaluate_ucf_per_class(scorer: UCFBinnedScorer, items: Iterable[UCFItem],
                           class_names, segment_len: int = 16,
                           n_anomaly_classes: int = 13, logger=None):
    """Per-anomaly-class breakdown (reference eval_each_part,
    utils/eval_utils.py:97-122): per-class AUC / PR-AUC / FAR / score gap,
    plus the Normal class's false-alarm rate.  ``class_names`` aligns with
    ``items``.  Returns (normal_far, mean_pr_auc)."""
    items = list(items)
    with annotate("eval.score"):
        results = scorer.score_videos([(f, n) for f, _, n in items])
    with annotate("eval.frames"):
        scores_dict, labels_dict = {}, {}
        for (s, lab), cls in zip(_ucf_frames(results, items, segment_len),
                                 class_names):
            scores_dict.setdefault(cls, []).extend(s)
            labels_dict.setdefault(cls, []).extend(lab)
        return eval_each_part(labels_dict, scores_dict,
                              n_anomaly_classes=n_anomaly_classes,
                              logger=logger)


def evaluate_ucf_stn(scorer: UCFClipBinScorer, items: Iterable[UCFItem],
                     segment_len: int = 16, return_scores: bool = False,
                     return_labels: bool = False):
    """UCF STN eval: per-bin regressor scores expanded x bin width
    (Train/spatio_transformer_UCF.py:120-137).  Scores and labels assemble
    per video."""
    items = list(items)
    with annotate("eval.score"):
        results = scorer.score_videos([(f, n) for f, _, n in items])
    with annotate("eval.frames"):
        all_scores, all_labels = [], []
        for (scores, bin_ids, r), (_, anno, _) in zip(results, items):
            video_scores, video_labels = [], []
            for score, i in zip(scores, bin_ids):
                width = int(r[i + 1] - r[i]) * segment_len
                lab = np.asarray(
                    anno[r[i] * segment_len:r[i + 1] * segment_len],
                    dtype=np.float64)
                n = min(width, len(lab))
                video_scores.append(np.full(n, score))
                video_labels.append(lab[:n])
            all_scores.append(np.concatenate(video_scores) if video_scores
                              else np.empty(0))
            all_labels.append(np.concatenate(video_labels) if video_labels
                              else np.empty(0))
        return _result(all_scores, all_labels, return_scores, return_labels)
