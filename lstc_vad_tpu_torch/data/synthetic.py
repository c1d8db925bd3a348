"""Synthetic ShanghaiTech-scale splits, made in memory from a numpy seed.

For runs on a machine that holds neither the dataset nor h5py.  Each clip is
16 patches x 2048 I3D-width f32 features; each abnormal video carries a
per-frame mask with one anomalous interval.  The weights that score them are
random too, so an AUC measures nothing but agreement between two runs.

- Test split (``sht_test_split``): 107 videos (63 normal, 44 abnormal, as
  ShanghaiTech's weakly supervised test split) of 10-37 clips each, ~2,550
  clips in all (SHT has 40,791 test frames, 2,549 clips of 16 frames).
- Train split (``sht_train_split``): 238 videos, 175 normal and 63 abnormal,
  the size of SH_Train_new.txt (SURVEY.md §2.7).  The real train videos'
  lengths are not in the repo: their clip counts are drawn from
  ``TRAIN_CLIPS`` (40-110, mean 75), a stand-in range.  That is about 17,500
  clips (17,521 at seed 0), 2.1 GiB of f32 features in host RAM.  ``write_train_files`` writes
  the ``key,label`` list and the abnormal videos' ``<key>.npy`` masks, so a
  Trainer reads the split through its usual ``data.train_txt`` /
  ``data.test_mask_dir`` and a ``SyntheticStore`` passed as ``store=``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from .annotations import TrainRecord
from .datasets import TestVideo

N_VIDEOS, N_NORMAL = 107, 63
N_TRAIN, N_TRAIN_NORMAL = 238, 175
TRAIN_CLIPS = (40, 111)  # [low, high) clips per train video: a stand-in
N_PATCH, D_FEAT, SEGMENT_LEN = 16, 2048, 16


class SyntheticStore:
    """Features held in memory, with ``FeatureStore``'s ``get`` / ``n_clips``
    interface."""

    def __init__(self, feats: Dict[str, np.ndarray]):
        self.feats = feats

    def get(self, key: str) -> np.ndarray:
        return self.feats[key]

    def n_clips(self, key: str) -> int:
        return self.feats[key].shape[0]

    @property
    def nbytes(self) -> int:
        return sum(f.nbytes for f in self.feats.values())


def _video(rng: np.random.Generator, n_clips: int, abnormal: bool
           ) -> Tuple[np.ndarray, np.ndarray]:
    feats = rng.standard_normal((n_clips, N_PATCH, D_FEAT), dtype=np.float32)
    labels = np.zeros(n_clips * SEGMENT_LEN)
    if abnormal:
        n_frames = n_clips * SEGMENT_LEN
        start = int(rng.integers(0, n_frames // 2))
        stop = int(rng.integers(start + SEGMENT_LEN, n_frames + 1))
        labels[start:stop] = 1.0
    return feats, labels


def sht_test_split(seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[(features [n_clips, 16, 2048] f32, per-frame labels [n_clips*16])],
    the item layout the eval drivers take."""
    rng = np.random.default_rng(seed)
    return [_video(rng, int(rng.integers(10, 38)), i >= N_NORMAL)
            for i in range(N_VIDEOS)]


def as_test_videos(items: List[Tuple[np.ndarray, np.ndarray]]
                   ) -> List[TestVideo]:
    """The test split as the Trainer's ``test_videos=``."""
    return [TestVideo(f"test_{i:03d}", labels, i >= N_NORMAL, len(labels),
                      len(feats), loader=(lambda f=feats: f))
            for i, (feats, labels) in enumerate(items)]


def sht_train_split(seed: int = 0) -> Tuple[SyntheticStore,
                                             List[TrainRecord],
                                             Dict[str, np.ndarray]]:
    """(store, records, per-frame masks of the abnormal videos)."""
    rng = np.random.default_rng(seed)
    feats, records, masks = {}, [], {}
    for i in range(N_TRAIN):
        abnormal = i >= N_TRAIN_NORMAL
        key = f"train_{i:03d}"
        feats[key], labels = _video(rng, int(rng.integers(*TRAIN_CLIPS)),
                                    abnormal)
        records.append(TrainRecord(key, abnormal))
        if abnormal:
            masks[key] = labels
    return SyntheticStore(feats), records, masks


def write_train_files(root: str, records: List[TrainRecord],
                      masks: Dict[str, np.ndarray]) -> Tuple[str, str]:
    """Write ``<root>/train.txt`` (``key,label`` lines, the SHT train-list
    format) and ``<root>/masks/<key>.npy``; returns (train_txt, mask_dir)."""
    mask_dir = os.path.join(root, "masks")
    os.makedirs(mask_dir, exist_ok=True)
    train_txt = os.path.join(root, "train.txt")
    with open(train_txt, "w") as f:
        for r in records:
            f.write(f"{r.key},{int(r.is_abnormal)}\n")
    for key, mask in masks.items():
        np.save(os.path.join(mask_dir, key + ".npy"), mask)
    return train_txt, mask_dir
