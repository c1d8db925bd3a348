"""Synthetic test split at ShanghaiTech scale, made in memory from a seed.

For runs on a machine that holds neither the dataset nor h5py: 107 test
videos (63 normal, 44 abnormal, as ShanghaiTech's weakly supervised test
split) of 10-37 clips each, ~2,550 clips in all (SHT has 40,791 test frames,
2,549 clips of 16 frames); each clip is 16 patches x 2048 I3D-width f32
features.  Abnormal videos carry a per-frame mask with one anomalous
interval.  The weights that score them are random too, so the AUC measures
nothing but agreement between two runs.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

N_VIDEOS, N_NORMAL = 107, 63
N_PATCH, D_FEAT, SEGMENT_LEN = 16, 2048, 16


def sht_test_split(seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[(features [n_clips, 16, 2048] f32, per-frame labels [n_clips*16])],
    the item layout the eval drivers take."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(N_VIDEOS):
        n_clips = int(rng.integers(10, 38))
        feats = rng.standard_normal((n_clips, N_PATCH, D_FEAT),
                                    dtype=np.float32)
        labels = np.zeros(n_clips * SEGMENT_LEN)
        if i >= N_NORMAL:
            n_frames = n_clips * SEGMENT_LEN
            start = int(rng.integers(0, n_frames // 2))
            stop = int(rng.integers(start + SEGMENT_LEN, n_frames + 1))
            labels[start:stop] = 1.0
        items.append((feats, labels))
    return items
