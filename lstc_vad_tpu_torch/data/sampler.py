"""Snippet-window sampler: linspace anchors + random jitter.

A copy of lstc_vad_tpu/data/sampler.py:23-57 (numpy only).  Pure function
of an ``np.random.Generator`` — reproduces the reference's ``sample_feat``
index arithmetic exactly (utils/load_dataset.py:69-88):

- ``uniform``: anchors = linspace(0, L-part_len, part_num+1) as ints, plus ONE
  shared random shift ``move`` drawn from [0, (L-part_len)//(part_num+1))
  (0 if that bound is < 1); each anchor expands to ``part_len`` consecutive
  clip indices; only the first ``part_num`` windows are kept.
- ``random``: per-anchor shift in [0, stride) where stride is the distance
  between the first two anchors (0 if anchors collide).

Distribution-equivalent to the reference (same arithmetic, numpy RNG of the
caller's choosing); the reference's exact global-RNG stream is not reproduced —
the north star is metric-level parity (SURVEY §7 'RNG parity-in-distribution').
"""

from __future__ import annotations

import numpy as np


def sample_part_indices(feat_len: int, part_num: int, part_len: int,
                        mode: str, rng: np.random.Generator) -> np.ndarray:
    """Returns int64 [part_num * part_len] clip indices into a video."""
    if feat_len < part_len:
        raise ValueError(f"video of {feat_len} clips shorter than part_len="
                         f"{part_len}; callers must pre-pad (UCF doubles short "
                         f"videos, utils/load_dataset.py:417-418)")
    anchors = np.linspace(0, feat_len - part_len, num=part_num + 1, dtype=int)
    if mode == "uniform":
        bound = (feat_len - part_len) // (part_num + 1)
        move = rng.integers(0, bound) if bound >= 1 else 0
        chosen = (anchors + move).repeat(part_len).reshape(-1, part_len) \
            + np.arange(part_len, dtype=int)
    elif mode == "random":
        chosen = anchors.repeat(part_len).reshape(-1, part_len) \
            + np.arange(part_len, dtype=int)
        stride = chosen[1, 0] - chosen[0, 0]
        if stride > 0:
            move = rng.integers(0, stride, size=part_num + 1) \
                .repeat(part_len).reshape(-1, part_len)
            chosen = chosen + move
    else:
        raise ValueError(f"unknown sample mode {mode!r} (uniform|random)")
    return chosen.reshape(-1)[: part_num * part_len]


def maybe_double_short(feat: np.ndarray, part_len: int) -> np.ndarray:
    """UCF rule: videos with <= part_len clips are doubled clip-wise
    (utils/load_dataset.py:417-418).  The reference doubles ONCE and then
    indexes out of bounds if the video is still too short (e.g. 3 clips with
    part_len 7 -> IndexError mid-epoch); we keep doubling until the window
    fits — strictly a robustness improvement over a reference crash path."""
    while 0 < feat.shape[0] <= part_len:
        feat = np.repeat(feat, 2, axis=0)
    return feat
