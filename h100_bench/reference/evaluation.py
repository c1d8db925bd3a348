"""The plain reference of the LTN evaluation path, in numpy and PyTorch:
part slicing with the tail re-window, frame expansion and the frame AUC
(the original's Test/evaluation_shanghaitech_ubnormal.py:70-95,
utils/eval_utils.py:21-24), one part at a time in its arithmetic, in
blocks of parts on the device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .model import LTN, MatMul, matmul

BLOCK = 512  # parts a reference call


def part_plan(n_clips: int, part_len: int, rewindow: bool = True
              ) -> List[Tuple[np.ndarray, int]]:
    """[(clip indices fed to the model, clips the score stands for)]: part
    i covers [i·pl, min((i+1)·pl, n)); a short last part is fed the last
    ``pl`` clips when ``rewindow``, with Python slice semantics."""
    n_parts = -(-n_clips // part_len)
    clips = np.arange(n_clips)
    out = []
    for i in range(n_parts):
        beg, end = i * part_len, min((i + 1) * part_len, n_clips)
        fed = clips[end - part_len:end] if (end - beg < part_len
                                            and rewindow) else clips[beg:end]
        out.append((fed, end - beg))
    return out


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC AUC as the tie-corrected Mann-Whitney U statistic (ties share
    their mean rank), equal to sklearn's roc_curve + auc."""
    s = np.asarray(scores, np.float64).reshape(-1)
    y = np.asarray(labels, np.float64).reshape(-1)
    pos = y == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    order = np.argsort(s, kind="mergesort")
    sx = s[order]
    edges = np.nonzero(np.r_[True, sx[1:] != sx[:-1], True])[0]
    ranks = np.empty(len(s))
    for b, e in zip(edges[:-1], edges[1:]):
        ranks[order[b:e]] = 0.5 * (b + 1 + e)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def _score_all(model: LTN, W, parts: List[np.ndarray], device,
               mm: MatMul) -> np.ndarray:
    """Scores of ``parts`` ([T, d] arrays of one length), BLOCK at a time."""
    out = []
    for i in range(0, len(parts), BLOCK):
        x = torch.from_numpy(np.stack(parts[i:i + BLOCK])).to(device)
        out.append(model.scores(W, x, mm).cpu().numpy())
    return np.concatenate(out) if out else np.empty(0, np.float32)


def ltn_eval(model: LTN, W, feats: List[np.ndarray], annos, part_len: int,
             n_patch: int, device, mm: MatMul = matmul,
             rewindow: bool = True, segment_len: int = 16):
    """(frame AUC, per-video frame scores, per-video frame labels) of the
    LTN part eval."""
    plans = [part_plan(f.shape[0], part_len, rewindow) for f in feats]
    tokens = [f[fed, :n_patch].reshape(-1, f.shape[-1])
              for f, plan in zip(feats, plans) for fed, _ in plan]
    by_len = {}
    for i, t in enumerate(tokens):
        by_len.setdefault(t.shape[0], []).append(i)
    flat = np.empty(len(tokens), np.float32)
    for ids in by_len.values():
        flat[ids] = _score_all(model, W, [tokens[i] for i in ids], device,
                               mm)
    frames, labels, cursor = [], [], 0
    for plan, anno in zip(plans, annos):
        s = np.concatenate([np.full(count * segment_len, flat[cursor + j],
                                    np.float32)
                            for j, (_, count) in enumerate(plan)])
        cursor += len(plan)
        lab = np.asarray(anno[:len(s)], np.float64)
        frames.append(s[:len(lab)])
        labels.append(lab)
    return (roc_auc(np.concatenate(frames), np.concatenate(labels)), frames,
            labels)

