"""The plain reference of the training batches: balanced normal/abnormal
pairs over a per-epoch permutation, ``part_num`` windows of ``part_len``
clips a video (the original's utils/load_dataset.py:49-106, sample_feat),
drawn from one numpy generator seeded with the data seed in the order the
original's dataset draws them: the two permutations when the dataset is
made and after each epoch; per pair, the normal video's window shift, then
the abnormal one's.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np


def window_indices(feat_len: int, part_num: int, part_len: int,
                   rng: np.random.Generator) -> np.ndarray:
    """The "uniform" windows: anchors linspace(0, L - pl, pn + 1) as ints,
    one shift drawn from [0, (L - pl) // (pn + 1)) (none when that bound is
    under 1), each anchor expanded to ``part_len`` clips, the first
    ``part_num`` windows kept."""
    anchors = np.linspace(0, feat_len - part_len, num=part_num + 1,
                          dtype=int)
    bound = (feat_len - part_len) // (part_num + 1)
    move = rng.integers(0, bound) if bound >= 1 else 0
    chosen = (anchors + move)[:, None] + np.arange(part_len)
    return chosen.reshape(-1)[:part_num * part_len]


def epochs(normal_clips: List[int], abnormal_clips: List[int],
           batch: int, part_num: int, part_len: int, seed: int
           ) -> Iterator[List[Tuple[Tuple[int, np.ndarray],
                                    Tuple[int, np.ndarray]]]]:
    """Each epoch's batches, one after another: a batch is ``batch`` pairs
    ((normal video, clip indices), (abnormal video, clip indices)); an
    epoch has min(#normal, #abnormal) // batch batches."""
    rng = np.random.default_rng(seed)
    n_pairs = min(len(normal_clips), len(abnormal_clips))
    while True:
        norm_perm = rng.permutation(len(normal_clips))
        abn_perm = rng.permutation(len(abnormal_clips))
        epoch = []
        for start in range(0, n_pairs - n_pairs % batch, batch):
            pairs = []
            for item in range(start, start + batch):
                nv, av = int(norm_perm[item]), int(abn_perm[item])
                ni = window_indices(normal_clips[nv], part_num, part_len, rng)
                ai = window_indices(abnormal_clips[av], part_num, part_len,
                                    rng)
                pairs.append(((nv, ni), (av, ai)))
            epoch.append(pairs)
        yield epoch
