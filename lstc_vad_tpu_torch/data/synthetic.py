"""Synthetic ShanghaiTech- and UCF-Crime-scale splits, made from a numpy seed.

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
  ``TRAIN_CLIPS`` (40-110, mean 75), a stand-in range.  That is about
  17,800 clips (17,840 at seed 0), 2.2 GiB of f32 features in host RAM.
  ``write_train_files`` writes the ``key,label`` list and the abnormal
  videos' ``<key>.npy`` masks, so a Trainer reads the split through its usual ``data.train_txt`` /
  ``data.test_mask_dir`` and a ``SyntheticStore`` passed as ``store=``.
- UCF test split (``ucf_test_split``): 290 videos (150 normal, 140 abnormal,
  as UCF-Crime's test list) of 9 patches x 2048 features.  The real test
  videos' lengths are not in the repo: their clip counts are drawn from
  ``UCF_TEST_CLIPS`` (16-464, mean 240), a stand-in range: 73,082 clips at
  seed 0, 5.4 GB of f32 features if held at once.  So each video's features
  are made when its loader is called, from (seed, index), uniform in [0, 1) (the
  I3D features are non-negative; uniform draws are also four times quicker
  to make than normal ones), and dropped after use.  Each video carries
  ``n_frames = 16 * clips + (0..15)`` and, if abnormal, a per-frame mask
  with one anomalous interval.  The same videos serve as train records
  (``TrainRecord`` with ``n_frames``) for UCF pseudo-label generation.
- tenCrop test split (``sht_tencrop_test_split``): the test split's 107
  videos and clip counts with ten crops per clip, [n_clips, 10, 16, 2048]
  each: ~2,550 clips, 3.4 GB of f32 features held at once (a crop-major
  evaluation reads every video once per crop, so making them on each read
  would cost ten times the generation).  The same videos serve as tenCrop
  train records, with their masks.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .annotations import TrainRecord
from .datasets import TestVideo

N_VIDEOS, N_NORMAL = 107, 63
N_TRAIN, N_TRAIN_NORMAL = 238, 175
TRAIN_CLIPS = (40, 111)  # [low, high) clips per train video: a stand-in
N_PATCH, D_FEAT, SEGMENT_LEN = 16, 2048, 16
N_UCF_TEST, N_UCF_NORMAL, UCF_N_PATCH = 290, 150, 9
UCF_TEST_CLIPS = (16, 465)  # [low, high) clips per UCF test video: a stand-in


class SyntheticStore:
    """Features held in memory, with ``FeatureStore``'s ``get`` / ``n_clips``
    interface; tenCrop features are [n_clips, 10, n_patch, d] and ``get``
    takes a ``crop``."""

    def __init__(self, feats: Dict[str, np.ndarray]):
        self.feats = feats

    def get(self, key: str, crop: Optional[int] = None) -> np.ndarray:
        feat = self.feats[key]
        return feat if crop is None else feat[:, crop]

    def n_clips(self, key: str) -> int:
        return self.feats[key].shape[0]

    @property
    def nbytes(self) -> int:
        return sum(f.nbytes for f in self.feats.values())


class LazyStore:
    """``FeatureStore``'s ``get`` / ``n_clips`` over features made on each
    ``get`` from (seed, the video's index): nothing is held."""

    def __init__(self, seed: int, clips: Dict[str, int], n_patch: int):
        self.seed = seed
        self.clips = clips
        self.n_patch = n_patch
        self._index = {key: i for i, key in enumerate(clips)}

    def get(self, key: str) -> np.ndarray:
        rng = np.random.default_rng([self.seed, self._index[key]])
        return rng.random((self.clips[key], self.n_patch, D_FEAT),
                          dtype=np.float32)

    def n_clips(self, key: str) -> int:
        return self.clips[key]


def _video(rng: np.random.Generator, n_clips: int, abnormal: bool,
           crops: Tuple[int, ...] = ()) -> Tuple[np.ndarray, np.ndarray]:
    feats = rng.standard_normal((n_clips, *crops, N_PATCH, D_FEAT),
                                dtype=np.float32)
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


def sht_tencrop_test_split(seed: int = 0) -> Tuple[
        SyntheticStore, List[TestVideo], List[TrainRecord],
        Dict[str, np.ndarray]]:
    """(tenCrop store, test videos whose ``feat`` is [n_clips, 10, 16,
    2048], the same videos as train records, the abnormal ones' per-frame
    masks)."""
    rng = np.random.default_rng(seed)
    items = [_video(rng, int(rng.integers(10, 38)), i >= N_NORMAL, (10,))
             for i in range(N_VIDEOS)]
    videos = as_test_videos(items)
    store = SyntheticStore({v.key: f for v, (f, _) in zip(videos, items)})
    records = [TrainRecord(v.key, v.is_abnormal) for v in videos]
    masks = {v.key: v.anno for v in videos if v.is_abnormal}
    return store, videos, records, masks


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


def ucf_test_split(seed: int = 0) -> Tuple[LazyStore, List[TestVideo],
                                           List[TrainRecord]]:
    """(store, test videos with per-frame labels, the same videos as train
    records)."""
    rng = np.random.default_rng(seed)
    clips, annos, n_frames = {}, {}, {}
    for i in range(N_UCF_TEST):
        key = (f"Normal_Videos_{i:03d}" if i < N_UCF_NORMAL
               else f"Anomaly_{i:03d}")
        n = int(rng.integers(*UCF_TEST_CLIPS))
        frames = n * SEGMENT_LEN + int(rng.integers(0, SEGMENT_LEN))
        anno = np.zeros(frames)
        if i >= N_UCF_NORMAL:
            start = int(rng.integers(0, frames // 2))
            anno[start:int(rng.integers(start + SEGMENT_LEN, frames + 1))] = 1
        clips[key], annos[key], n_frames[key] = n, anno, frames
    store = LazyStore(seed, clips, UCF_N_PATCH)
    videos = [TestVideo(key, annos[key], i >= N_UCF_NORMAL, n_frames[key],
                        clips[key], loader=(lambda key=key: store.get(key)))
              for i, key in enumerate(clips)]
    records = [TrainRecord(key, i >= N_UCF_NORMAL, n_frames[key])
               for i, key in enumerate(clips)]
    return store, videos, records
