"""Frame-level metric zoo — pure numpy.

Mirrors the surface of the reference's utils/eval_utils.py:9-148 (f1, rmse,
PR-AUC, ROC-AUC, false-alarm/neg, precision/recall/accuracy/specificity/
sensitivity, score gap, G-mean, F-measure, MCC, pAUC, AP, per-class breakdown).

``roc_auc`` — THE headline metric (eval_utils.py:21-24) — is implemented as the
tie-corrected Mann-Whitney U statistic, which is exactly equal to the area under
the ROC curve that sklearn.metrics.roc_curve+auc computes (verified against
sklearn in tests/test_metrics.py).  No sklearn dependency at runtime.  A copy
of lstc_vad_tpu/evaluation/metrics.py.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "roc_auc", "pr_auc", "average_precision", "f1", "rmse", "false_alarm",
    "false_neg", "precision", "recall", "accuracy", "specificity",
    "sensitivity", "score_gap", "geometric_mean", "f_measure", "mcc",
    "mcc_standard", "p_auc", "classification_accuracy",
    "classification_accuracy_binary", "eval_frame_auc", "eval_each_part",
]


def _as1d(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64).reshape(-1)


def _rankdata_average(x: np.ndarray) -> np.ndarray:
    """Average ranks (1-based), ties share the mean rank."""
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), dtype=np.float64)
    sx = x[order]
    # boundaries of tie groups
    boundary = np.nonzero(np.r_[True, sx[1:] != sx[:-1], True])[0]
    for b, e in zip(boundary[:-1], boundary[1:]):
        ranks[order[b:e]] = 0.5 * (b + 1 + e)
    return ranks


def roc_auc(scores, labels) -> float:
    """Area under the ROC curve, pos_label=1 (reference eval_utils.py:21-24)."""
    s, y = _as1d(scores), _as1d(labels)
    pos = y == 1
    n_pos = int(pos.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = _rankdata_average(s)
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def _pr_curve(scores, labels):
    s, y = _as1d(scores), _as1d(labels)
    order = np.argsort(-s, kind="mergesort")
    y = y[order]
    s = s[order]
    distinct = np.r_[np.nonzero(s[1:] != s[:-1])[0], len(s) - 1]
    tp = np.cumsum(y == 1)[distinct]
    fp = np.cumsum(y != 1)[distinct]
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / max(tp[-1], 1)
    # prepend the (recall=0, precision=1) anchor, as sklearn does
    precision = np.r_[1.0, precision]
    recall = np.r_[0.0, recall]
    return precision, recall


def pr_auc(scores, labels) -> float:
    """Trapezoidal area under the precision-recall curve
    (reference eval_utils.py:16-19 uses metrics.auc(recall, precision))."""
    precision, recall = _pr_curve(scores, labels)
    return float(np.trapezoid(precision, recall))


def average_precision(scores, labels) -> float:
    """Step-interpolated AP (reference cal_AP, eval_utils.py:145-148)."""
    precision, recall = _pr_curve(scores, labels)
    return float(np.sum(np.diff(recall) * precision[1:]))


def _binarize(scores, threshold: float) -> np.ndarray:
    return (_as1d(scores) > threshold).astype(np.float64)


def f1(scores, labels) -> float:
    """Binary F1 on already-binarized scores (reference cal_f1)."""
    s, y = _as1d(scores), _as1d(labels)
    tp = float(np.sum(s * y))
    fp = float(np.sum(s * (1 - y)))
    fn = float(np.sum((1 - s) * y))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def rmse(scores, labels) -> float:
    s, y = _as1d(scores), _as1d(labels)
    return float(np.sqrt(np.mean((s - y) ** 2)))


def false_alarm(scores, labels, threshold: float = 0.5) -> float:
    s, y = _binarize(scores, threshold), _as1d(labels)
    return float(np.sum(s * (1 - y)) / np.sum(1 - y))


def false_neg(scores, labels, threshold: float = 0.5) -> float:
    s, y = _binarize(scores, threshold), _as1d(labels)
    return float(np.sum((1 - s) * y) / np.sum(y))


def precision(scores, labels, threshold: float = 0.5) -> float:
    s, y = _binarize(scores, threshold), _as1d(labels)
    return float(np.sum(s * y) / np.sum(s))


def recall(scores, labels, threshold: float = 0.5) -> float:
    s, y = _binarize(scores, threshold), _as1d(labels)
    tp = np.sum(s * y)
    fn = np.sum((1 - s) * y)
    return float(tp / (tp + fn))


def accuracy(scores, labels, threshold: float = 0.5) -> float:
    s, y = _binarize(scores, threshold), _as1d(labels)
    return float((np.sum(s * y) + np.sum((1 - s) * (1 - y))) / len(s))


def specificity(scores, labels, threshold: float = 0.5) -> float:
    s, y = _binarize(scores, threshold), _as1d(labels)
    return float(np.sum((1 - s) * (1 - y)) / np.sum(1 - y))


def sensitivity(scores, labels, threshold: float = 0.5) -> float:
    s, y = _binarize(scores, threshold), _as1d(labels)
    return float(np.sum(s * y) / np.sum(y))


def score_gap(scores, labels) -> float:
    s, y = _as1d(scores), _as1d(labels).astype(bool)
    return float(np.mean(s[y]) - np.mean(s[~y]))


def geometric_mean(scores, labels, threshold: float = 0.5) -> float:
    return float(np.sqrt(sensitivity(scores, labels, threshold)
                         * specificity(scores, labels, threshold)))


def f_measure(scores, labels, threshold: float = 0.5) -> float:
    p = np.float64(precision(scores, labels, threshold))
    r = np.float64(recall(scores, labels, threshold))
    with np.errstate(invalid="ignore"):
        return float(2 * p * r / (p + r))  # nan when p=r=0, like the reference


def mcc(scores, labels, threshold: float = 0.5) -> float:
    """Matthews correlation coefficient AS THE REFERENCE COMPUTES IT
    (eval_utils.py:82-88).  NOTE: the reference's denominator uses
    (fp+fn) where textbook MCC has (tp+fn); we reproduce the reference
    formula — see ``mcc_standard`` for the textbook one."""
    s, y = _binarize(scores, threshold), _as1d(labels)
    tp = np.sum(s * y)
    tn = np.sum((1 - s) * (1 - y))
    fp = np.sum(s * (1 - y))
    fn = np.sum((1 - s) * y)
    denom = np.sqrt((tp + fp) * (fp + fn) * (tn + fp) * (tn + fn))
    return float((tp * tn - fp * fn) / denom)


def mcc_standard(scores, labels, threshold: float = 0.5) -> float:
    """Textbook MCC (matches sklearn.metrics.matthews_corrcoef)."""
    s, y = _binarize(scores, threshold), _as1d(labels)
    tp = np.sum(s * y)
    tn = np.sum((1 - s) * (1 - y))
    fp = np.sum(s * (1 - y))
    fn = np.sum((1 - s) * y)
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return float((tp * tn - fp * fn) / denom) if denom else 0.0


def p_auc(scores, labels) -> float:
    """'pAUC' as the reference defines it (eval_utils.py:90-95) — a score-mass
    separation statistic, not a partial AUC."""
    s, y = _as1d(scores), _as1d(labels)
    n_pos = np.sum(y)
    n_neg = len(y) - n_pos
    sum_p = np.sum(s[y.astype(bool)])
    sum_n = np.sum(s[(1 - y).astype(bool)])
    return float(0.5 * (sum_p / n_pos - sum_n / n_neg + 1))


def classification_accuracy(logits, labels) -> float:
    """Top-1 accuracy from per-class logits (reference eval_classification,
    eval_utils.py:124-129)."""
    pred = np.argmax(np.asarray(logits), axis=1)
    return float(np.mean(pred == _as1d(labels)))


def classification_accuracy_binary(scores, labels,
                                   threshold: float = 0.5) -> float:
    """Binary accuracy from scalar scores (reference
    eval_classification_binary, eval_utils.py:131-136)."""
    s, y = _as1d(scores), _as1d(labels)
    pos_true = np.sum((y == 1) & (s > threshold))
    neg_true = np.sum((y == 0) & (s < threshold))
    return float((pos_true + neg_true) / len(s))


def eval_frame_auc(scores, labels, logger=None) -> float:
    """Reference ``eval`` wrapper (eval_utils.py:139-143); logger unused there too."""
    del logger
    return roc_auc(scores, labels)


def eval_each_part(labels_dict, scores_dict, n_anomaly_classes: int = 13,
                   logger=None):
    """Per-anomaly-class breakdown (reference eval_utils.py:97-122).

    Returns (normal_false_alarm_rate, mean_pr_auc). ``n_anomaly_classes``
    generalizes the reference's hardcoded 13 (UCF-Crime anomaly class count).
    """
    mean_ap = 0.0
    normal_far = float("nan")
    for key, labels in labels_dict.items():
        score = np.asarray(scores_dict[key], dtype=float)
        labels = np.asarray(labels, dtype=float)
        if key == "Normal":
            normal_far = false_alarm(score, labels)
            msg = f"{key}: FAR {normal_far:.4f}"
        else:
            auc = roc_auc(score, labels)
            ap = pr_auc(score, labels)
            mean_ap += ap
            msg = (f"{key}: AUC {auc:.4f}, PR-AUC {ap:.4f}, "
                   f"FAR {false_alarm(score, labels):.4f}, "
                   f"GAP {score_gap(score, labels):.4f}")
        (logger.info if logger else print)(msg)
    return normal_far, mean_ap / n_anomaly_classes


def bootstrap_auc_ci(per_video_scores, per_video_labels, n_boot: int = 1000,
                     alpha: float = 0.05, seed: int = 0):
    """Video-level bootstrap confidence interval for the frame AUC.

    Videos — not frames — are the unit of independence in VAD test sets
    (frames within a video are heavily correlated), so resampling draws
    whole videos with replacement and recomputes the concatenated frame AUC
    per draw.  Degenerate draws (a resample containing only one class) are
    skipped.  The reference reports point AUCs only (utils/eval_utils.py:
    21-24); this quantifies their spread.  Returns (lo, hi): the
    percentile interval at ``alpha`` (default 95%)."""
    rng = np.random.default_rng(seed)
    n = len(per_video_scores)
    if n == 0:
        return float("nan"), float("nan")
    scores = [np.asarray(s, dtype=np.float64) for s in per_video_scores]
    labels = [np.asarray(la, dtype=np.float64) for la in per_video_labels]
    draws = []
    for _ in range(n_boot):
        idx = rng.integers(0, n, size=n)
        auc = roc_auc(np.concatenate([scores[i] for i in idx]),
                      np.concatenate([labels[i] for i in idx]))
        if not np.isnan(auc):
            draws.append(auc)
    if not draws:
        return float("nan"), float("nan")
    lo, hi = np.percentile(draws, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return float(lo), float(hi)
