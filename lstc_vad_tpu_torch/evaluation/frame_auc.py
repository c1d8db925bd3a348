"""Frame-level AUC evaluation helpers (host-side, pure numpy).

The reference evaluates one part per device call in a Python loop
(Test/evaluation_shanghaitech_ubnormal.py:70-94).  This package instead
computes, on host, the *part index matrix* of a video — which clips each part
reads, including the tail re-window — gathers the clips into one batch, and
scores all parts in one device call (evaluation/scoring.py).  The resulting
scores and frame expansion are identical to the reference loop.  A copy of
lstc_vad_tpu/evaluation/frame_auc.py, kept here so that this package imports
nothing of the JAX package.

Semantics reproduced here:

- part chunking: ``n_parts = ceil(n_clips / part_len)``; part i covers clips
  [i*part_len, min((i+1)*part_len, n_clips)).
- tail re-window: when the last part is short, the *features* fed to the model
  are the final ``part_len`` clips of the video, while the *score expansion*
  still uses the short (end-beg) count
  (Train/temporal_transformer_shanghaitech.py:170-179).
  ``tail_rewindow=False`` reproduces the paths that feed the short tail
  directly (pseudo-label generator, Train/pseudo_labels_generator_temporal.py:134;
  co-teaching eval, Train/spatio_transformer_MIL_CE.py:296).
- score -> frame expansion: each part score repeats (end-beg)*segment_len
  times; labels are consumed sequentially from the per-frame annotation.
- UCF long videos: compressed to ``max_clips`` bins via np.linspace before part
  chunking; empty bins re-use the single clip at the bin start
  (Test/evaluation_UCF.py:52-75).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class VideoScores:
    """Per-video frame-level scores and labels, ready for AUC concat."""

    scores: np.ndarray  # [n_frames_scored]
    labels: np.ndarray  # [n_frames_scored]


def n_parts(n_clips: int, part_len: int) -> int:
    """ceil(n_clips / part_len), written as the reference writes it
    (Test/evaluation_shanghaitech_ubnormal.py:74-76)."""
    p = n_clips // part_len
    if p * part_len < n_clips:
        p += 1
    return p


def part_bounds(n_clips: int, part_len: int) -> List[Tuple[int, int]]:
    """[(beg, end)] clip ranges per part; the last may be short."""
    bounds = []
    for i in range(n_parts(n_clips, part_len)):
        beg = i * part_len
        end = n_clips if i == n_parts(n_clips, part_len) - 1 else (i + 1) * part_len
        bounds.append((beg, end))
    return bounds


def part_slices(n_clips: int, part_len: int,
                tail_rewindow: bool = True) -> Tuple[List[np.ndarray], np.ndarray]:
    """Exact-parity clip index lists per part.

    The re-windowed tail uses PYTHON SLICE SEMANTICS on [end-part_len:end] —
    including the negative-start wrap the reference hits when a video is
    shorter than part_len (Test/evaluation_shanghaitech_ubnormal.py:84) —
    so scores match the reference bit-for-bit even on degenerate videos.

    Returns (list of index arrays (len part_len except possibly the tail),
    counts [n_parts] of (end-beg) for score expansion).
    """
    clips = np.arange(n_clips)
    idx_list: List[np.ndarray] = []
    counts = []
    for beg, end in part_bounds(n_clips, part_len):
        counts.append(end - beg)
        if end - beg < part_len and tail_rewindow:
            idx_list.append(clips[end - part_len:end])
        else:
            idx_list.append(clips[beg:end])
    return idx_list, np.asarray(counts, dtype=np.int32)


def expand_scores_to_frames(part_scores: np.ndarray, counts: np.ndarray,
                            segment_len: int) -> np.ndarray:
    """Each part score repeats count*segment_len times
    (Test/evaluation_shanghaitech_ubnormal.py:92)."""
    return np.repeat(np.asarray(part_scores).reshape(-1),
                     np.asarray(counts).reshape(-1) * segment_len)


# ---------------------------------------------------------------------------
# UCF long-video compression
# ---------------------------------------------------------------------------

def ucf_bin_edges(n_clips: int, max_clips: int) -> np.ndarray:
    """r = linspace(0, n_clips, max_clips+1) int32 (Test/evaluation_UCF.py:54)."""
    return np.linspace(0, n_clips, max_clips + 1, dtype=np.int32)


def ucf_bin_pool(feats: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Mean-pool clips into bins; an empty bin re-uses the clip at its start
    (Test/evaluation_UCF.py:66-71).  feats: [n_clips, n_patch, d] ->
    [len(r)-1, n_patch, d]."""
    out = np.empty((len(r) - 1,) + feats.shape[1:], dtype=feats.dtype)
    for i in range(len(r) - 1):
        if r[i] == r[i + 1]:
            out[i] = feats[r[i]]
        else:
            out[i] = feats[r[i]:r[i + 1]].mean(axis=0)
    return out


def ucf_part_plan(max_clips: int, part_len: int) -> List[Tuple[int, int]]:
    """Bin-space part ranges with the overlap tail trick: a short last part
    re-reads the final part_len bins AND expands over the re-read range
    (Test/evaluation_UCF.py:58-65 — note beg is reassigned, so both features
    and frame expansion use [end-part_len, end)).

    ``beg`` clamps at 0 when there are fewer bins than part_len: that region
    is unreachable in the reference (its re-window path hardcodes 32 bins
    and part_len 2, so end-part_len >= 0 always); an unclamped negative beg
    would wrap the numpy bin-edge indexing.  The clamp scores all available
    bins at their true length — the same degenerate-video semantics as the
    SHT tail (part_slices)."""
    parts = []
    for i in range(n_parts(max_clips, part_len)):
        beg = i * part_len
        end = max_clips if i == n_parts(max_clips, part_len) - 1 else (i + 1) * part_len
        if end - beg < part_len:
            beg = max(end - part_len, 0)
        parts.append((beg, end))
    return parts


def ucf_expand(part_scores: np.ndarray, parts: List[Tuple[int, int]],
               r: np.ndarray, anno: np.ndarray,
               segment_len: int) -> VideoScores:
    """UCF frame expansion: part score repeats (r[end]-r[beg])*segment_len
    times; labels sliced [r[beg]*segment_len, r[end]*segment_len)
    (Test/evaluation_UCF.py:83-85)."""
    scores, labels = [], []
    for score, (beg, end) in zip(np.asarray(part_scores).reshape(-1), parts):
        reps = int(r[end] - r[beg]) * segment_len
        scores.append(np.full(reps, score))
        labels.append(np.asarray(anno[r[beg] * segment_len:r[end] * segment_len],
                                 dtype=np.float64))
    return VideoScores(scores=np.concatenate(scores) if scores else np.empty(0),
                       labels=np.concatenate(labels) if labels else np.empty(0))
