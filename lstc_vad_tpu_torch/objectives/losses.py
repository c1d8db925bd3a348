"""Training objectives — PyTorch counterpart of
lstc_vad_tpu/objectives/losses.py:32-164, with the reference's quirks kept:

- MIL ranking hinge + L1 sparsity
  (Train/spatio_transformer_shanghaitech.py:21-32,
   Train/temporal_transformer_shanghaitech.py:25-36), the Python loop over
  the batch replaced by one broadcasted pairwise hinge: the same sum over all
  batch_size^2 (normal, abnormal) pairs, the same normalization.
- Soft-label cross-entropy applied to the Classifier's ALREADY-SOFTMAXED
  outputs (Train/temporal_transformer_shanghaitech.py:21-23; the Classifier
  ends in Softmax): ``F.cross_entropy(probs, soft)`` applies log_softmax to
  its input again, and that exact objective is what is computed.
- Class-weighted BCE on pseudo labels for co-teaching
  (Train/spatio_transformer_MIL_CE.py:23-26).
"""

from __future__ import annotations

from typing import Tuple

import torch

Loss = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def mil_ranking_loss(video_scores: torch.Tensor,
                     abnormal_snippet_scores: torch.Tensor,
                     lambda_1: float) -> Loss:
    """Pairwise MIL ranking hinge.  ``video_scores``: [2B], normal videos
    first; ``abnormal_snippet_scores``: any shape, its mean is the L1
    sparsity term.  Returns (loss, hinge_err, sparsity)."""
    b = video_scores.shape[0] // 2
    nor, abn = video_scores[:b], video_scores[b:]
    # sum_i sum_j relu(1 - abn_j + nor_i) / B^2 — all pairs at once
    err = torch.relu(1.0 - abn[None, :] + nor[:, None]).sum() / (b * b)
    spar = abnormal_snippet_scores.mean()
    return err + lambda_1 * spar, err, spar


def stn_mil_loss(snippet_scores: torch.Tensor, part_num: int, part_len: int,
                 lambda_1: float) -> Loss:
    """STN MIL loss on regressor outputs [2B, part_num*part_len]: video
    score = max over parts of the mean over part_len
    (Train/spatio_transformer_shanghaitech.py:22); sparsity over the
    abnormal half."""
    b2 = snippet_scores.shape[0]
    scores = snippet_scores.reshape(b2, part_num, part_len)
    video = scores.mean(-1).amax(-1)
    return mil_ranking_loss(video, snippet_scores[b2 // 2:], lambda_1)


def ltn_mil_loss(part_scores: torch.Tensor, part_num: int,
                 lambda_1: float) -> Loss:
    """LTN MIL loss on the abnormal-class probability, ``part_scores``
    [2B*part_num] flat, normal half first; video score = max over parts
    (Train/temporal_transformer_shanghaitech.py:26).

    REFERENCE QUIRK, kept on purpose: the sparsity term slices the FLAT
    score vector at index batch_size (``abn_pred = y_pred[batch_size:]``,
    temporal_transformer_shanghaitech.py:33), so it averages most of the
    NORMAL videos' part scores too (PARITY.md)."""
    scores = part_scores.reshape(-1, part_num)
    video = scores.amax(-1)
    b = scores.shape[0] // 2
    return mil_ranking_loss(video, part_scores.reshape(-1)[b:], lambda_1)


def coteach_stn_mil_loss(snippet_scores: torch.Tensor, part_num: int,
                         part_len: int, lambda_1: float,
                         flat_sparsity: bool = True) -> Loss:
    """Co-teaching round's STN MIL (Train/spatio_transformer_MIL_CE.py:32-44):
    the video score of ``stn_mil_loss``; the sparsity source depends on the
    dataset branch of the caller's reshape:

    - SHT/UBnormal (``flat_sparsity=True``): the outputs stay flat
      (MIL_CE.py:176), so the slice at batch_size takes nearly all
      normal-video snippet scores too;
    - UCF (``flat_sparsity=False``): the outputs are re-viewed to
      [2B, pn*pl] first (MIL_CE.py:174-175), so the slice is the abnormal
      half."""
    b2 = snippet_scores.shape[0]
    scores = snippet_scores.reshape(b2, part_num, part_len)
    video = scores.mean(-1).amax(-1)
    if flat_sparsity:
        spar_src = snippet_scores.reshape(-1)[b2 // 2:]
    else:
        spar_src = snippet_scores[b2 // 2:].reshape(-1)
    return mil_ranking_loss(video, spar_src, lambda_1)


def soft_cross_entropy_on_probs(probs: torch.Tensor,
                                soft_labels: torch.Tensor) -> torch.Tensor:
    """``F.cross_entropy(probs, soft_labels)`` semantics on probabilities:
    mean_n(-sum_c soft[n, c] * log_softmax(probs)[n, c])."""
    logp = torch.log_softmax(probs, dim=-1)
    return (-(soft_labels * logp).sum(-1)).mean()


def weighted_bce(probs: torch.Tensor, soft_labels: torch.Tensor,
                 lambda_normal: float, lambda_abnormal: float,
                 eps: float = 1e-8) -> torch.Tensor:
    """Class-weighted BCE of regressor scores [2B, P] against soft targets
    [2B, P, 2] = (1 - p, p) (Train/spatio_transformer_MIL_CE.py:23-26)."""
    return (-lambda_normal * soft_labels[..., 0] * torch.log(1.0 - probs + eps)
            - lambda_abnormal * soft_labels[..., 1] * torch.log(probs + eps)
            ).mean()


def build_clip_labels(batch_size: int, part_num: int, part_len: int,
                      abnorm_pseudo: torch.Tensor) -> torch.Tensor:
    """[2B, part_num, 2] soft targets: normal videos hard (1, 0), abnormal
    parts soft (1 - p, p) from clip pseudo scores
    (temporal_transformer_shanghaitech.py:103-112)."""
    norm = torch.zeros(batch_size, part_num, 2, dtype=torch.float32,
                       device=abnorm_pseudo.device)
    norm[:, :, 0] = 1.0
    abnorm = soft_labels_from_pseudo(
        abnorm_pseudo.reshape(batch_size, part_num * part_len), part_len)
    return torch.cat([norm, abnorm.float()], dim=0)


def soft_labels_from_pseudo(pseudo: torch.Tensor, part_len: int
                            ) -> torch.Tensor:
    """Clip pseudo scores [B, part_num*part_len] of abnormal videos ->
    per-part soft (1 - p, p) targets [B, part_num, 2], p = mean over
    part_len (temporal_transformer_shanghaitech.py:106-111)."""
    b = pseudo.shape[0]
    p = pseudo.reshape(b, -1, part_len).mean(-1)
    return torch.stack([1.0 - p, p], dim=-1)
