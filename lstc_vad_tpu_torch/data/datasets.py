"""Balanced-pair training dataset and test-video loading — a copy of
lstc_vad_tpu/data/datasets.py:29-158, 161-262 (numpy only).

Training contract (all reference train datasets share it,
utils/load_dataset.py:49-106): item i pairs the i-th video of a per-epoch
random permutation of the normal videos with the i-th of the abnormal
permutation; length = min(#normal, #abnormal); each video contributes
``part_num`` windows of ``part_len`` consecutive clips (data/sampler.py), the
first ``n_patch`` patches kept; labels come from the pseudo-label dict when
given (entries of shape [L] or [L,2] — last column used), else constant 0/1.
With a tenCrop store a crop is drawn per pair (SHT/UBnormal) or per video
(UCF) from the dataset's own generator, in the JAX package's order, so the
batches stay bit-equal.  Over a store with the gather fast paths
(data/packed.py ``PackedStore``), and with no crop and no doubling, only the
window indices are drawn on the host: per item through ``store.gather``,
or for a whole batch through ``get_batch`` and one native
``store.gather_batch`` call.  Both draw from the generator in the per-item
order, so every path gives the same batches bit for bit.

Test videos carry per-frame annotations: zeros(n_frames) for normal, the GT
mask .npy (SHT/UBnormal, utils/load_dataset.py:119-126) or GT h5 row (UCF,
:485-489) for abnormal.  Any store with ``get(key)`` and ``n_clips(key)``
serves, including an in-memory one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .annotations import (TrainRecord, parse_sht_test, parse_sht_train,
                          parse_ubnormal, parse_ucf_test, parse_ucf_train)
from .sampler import maybe_double_short, sample_part_indices


def load_pseudo_labels(path: str) -> Dict[str, np.ndarray]:
    """Pseudo-label artifact: a dict {key+'.npy': scores} saved via np.save
    (Train/pseudo_labels_generator_spatio.py:88-89)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Can NOT open the pseudo labels file: {path}")
    return np.load(path, allow_pickle=True).tolist()


def _labels_for(pseudo: Optional[np.ndarray], feat_len: int,
                is_abnormal: bool) -> np.ndarray:
    if pseudo is None:
        fill = 1.0 if is_abnormal else 0.0
        return np.full(feat_len, fill, dtype=np.float32)
    labs = np.asarray(pseudo, dtype=np.float32)
    if labs.ndim == 2 and labs.shape[-1] == 2:
        labs = labs[:, -1]
    return labs.reshape(-1)


class PairedTrainDataset:
    """Normal/abnormal balanced pairs with per-epoch reshuffling.
    ``double_short``: the UCF rule, videos of at most ``part_len`` clips are
    doubled clip-wise (data/sampler.py::maybe_double_short).
    ``ten_crop``: the store holds tenCrop features; each draw takes one crop
    by ``rng.integers(0, 10)``, shared by the normal/abnormal pair
    (SHT/UBnormal, utils/load_dataset.py:223-225,720-722) or, with
    ``crop_per_video``, drawn per video (UCF, :413-415)."""

    def __init__(self, records: Sequence[TrainRecord], store,
                 part_num: int, part_len: int, n_patch: int, sample: str,
                 pseudo_labels: Optional[Dict[str, np.ndarray]] = None,
                 ten_crop: bool = False, double_short: bool = False,
                 crop_per_video: bool = False, seed: int = 0):
        self.normal = [r for r in records if not r.is_abnormal]
        self.abnormal = [r for r in records if r.is_abnormal]
        self.store = store
        self.part_num = part_num
        self.part_len = part_len
        self.n_patch = n_patch
        self.sample = sample
        self.pseudo_labels = pseudo_labels
        self.ten_crop = ten_crop
        self.double_short = double_short
        self.crop_per_video = crop_per_video
        self.rng = np.random.default_rng(seed)
        self.shuffle_keys()

    def __len__(self) -> int:
        return min(len(self.normal), len(self.abnormal))

    def shuffle_keys(self):
        """Per-epoch reshuffle, called by the train loop like the reference's
        dataloader.dataset.shuffle_keys() (spatio_transformer_shanghaitech.py:115)."""
        self._norm_perm = self.rng.permutation(len(self.normal))
        self._abnorm_perm = self.rng.permutation(len(self.abnormal))

    def _pseudo_for(self, key: str) -> Optional[np.ndarray]:
        if self.pseudo_labels is None:
            return None
        if key + ".npy" in self.pseudo_labels:
            return self.pseudo_labels[key + ".npy"]
        return self.pseudo_labels[key]

    def _sample_video(self, rec: TrainRecord, crop: Optional[int]):
        if (hasattr(self.store, "gather") and crop is None
                and not self.double_short):
            # index-only sampling and one gather call, no whole-video copy
            feat_len = self.store.n_clips(rec.key)
            labs = _labels_for(self._pseudo_for(rec.key), feat_len,
                               rec.is_abnormal)
            idx = sample_part_indices(feat_len, self.part_num, self.part_len,
                                      self.sample, self.rng)
            return self.store.gather(rec.key, idx, self.n_patch), labs[idx]
        feat = (self.store.get(rec.key) if crop is None
                else self.store.get(rec.key, crop=crop))
        labs = _labels_for(self._pseudo_for(rec.key), feat.shape[0],
                           rec.is_abnormal)
        if self.double_short:
            feat = maybe_double_short(feat, self.part_len)
            # keep pseudo labels aligned with the doubled clips (the
            # reference doubles only the features and would IndexError here)
            while len(labs) < feat.shape[0]:
                labs = np.repeat(labs, 2)
            labs = labs[:feat.shape[0]]
        idx = sample_part_indices(feat.shape[0], self.part_num, self.part_len,
                                  self.sample, self.rng)
        feat = feat[idx]
        if feat.ndim == 3:
            feat = feat[:, :self.n_patch, :]
        return np.ascontiguousarray(feat, dtype=np.float32), labs[idx]

    def _draw_crop(self) -> Optional[int]:
        return int(self.rng.integers(0, 10)) if self.ten_crop else None

    def __getitem__(self, item: int):
        crop = self._draw_crop()
        nf, nl = self._sample_video(self.normal[self._norm_perm[item]], crop)
        if self.crop_per_video:
            crop = self._draw_crop()
        af, al = self._sample_video(self.abnormal[self._abnorm_perm[item]],
                                    crop)
        return nf, nl, af, al

    def get_batch(self, start: int, stop: int):
        """Items ``start..stop-1`` stacked as (norm_feats, norm_labs,
        abnorm_feats, abnorm_labs) through one ``store.gather_batch`` call,
        or None when the store has no batch gather or the dataset crops or
        doubles (the caller then builds the batch per item).  The window
        indices are drawn per item, normal then abnormal, as
        ``__getitem__`` draws them."""
        if not (hasattr(self.store, "gather_batch") and not self.ten_crop
                and not self.double_short):
            return None
        n = stop - start
        keys: list = [None] * (2 * n)
        idx = np.empty((2 * n, self.part_num * self.part_len), dtype=np.int64)
        labs = np.empty((2 * n, idx.shape[1]), dtype=np.float32)
        for j, item in enumerate(range(start, stop)):
            for half, (recs, perm) in enumerate(
                    ((self.normal, self._norm_perm),
                     (self.abnormal, self._abnorm_perm))):
                rec = recs[perm[item]]
                feat_len = self.store.n_clips(rec.key)
                row = sample_part_indices(feat_len, self.part_num,
                                          self.part_len, self.sample,
                                          self.rng)
                # normals fill rows [0, n), abnormals [n, 2n)
                slot = j + half * n
                keys[slot] = rec.key
                idx[slot] = row
                labs[slot] = _labels_for(self._pseudo_for(rec.key), feat_len,
                                         rec.is_abnormal)[row]
        _, _, d_model = self.store.shape(keys[0])
        feats = self.store.gather_batch(keys, idx, self.n_patch, d_model)
        return feats[:n], labs[:n], feats[n:], labs[n:]


@dataclasses.dataclass
class TestVideo:
    """Lazy test-split handle: annotations + clip count are resident, the
    feature array is fetched from the store per ``.feat`` access, so a split
    never holds more than the video being scored in RAM.  ``cache=True``
    memoizes the first fetch instead: in-training eval re-scores the split
    every ``inter_epoch`` epochs."""

    __test__ = False  # not a pytest class despite the Test* name

    key: str
    anno: np.ndarray       # per-frame 0/1
    is_abnormal: bool
    n_frames: Optional[int] = None
    n_clips: Optional[int] = None
    loader: Optional[Callable[[], np.ndarray]] = None
    cache: bool = False
    _feat: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def feat(self) -> np.ndarray:
        """[n_clips, n_patch, d] (or tenCrop [n_clips, 10, n_patch, d]),
        read from the store (memoized when ``cache``)."""
        if self._feat is not None:
            return self._feat
        f = self.loader()
        if self.cache:
            self._feat = f
        return f


def load_test_videos(dataset: str, test_txt: str, store,
                     mask_dir: str = "", mask_h5: str = "",
                     cache: bool = False) -> List[TestVideo]:
    """Test split as lazy handles with per-frame GT, per dataset format;
    ``cache`` as in ``TestVideo``."""

    def lazy(key: str) -> Callable[[], np.ndarray]:
        return lambda: store.get(key)

    videos: List[TestVideo] = []
    if dataset == "SHT":
        for rec in parse_sht_test(test_txt):
            if rec.is_abnormal:
                anno = np.load(os.path.join(mask_dir, rec.key + ".npy"))
            else:
                anno = np.zeros(rec.n_frames)
            videos.append(TestVideo(rec.key, anno, rec.is_abnormal,
                                    rec.n_frames, store.n_clips(rec.key),
                                    lazy(rec.key), cache))
    elif dataset == "UBnormal":
        for rec in parse_ubnormal(test_txt):
            # test loader keys on the "abnormal" prefix (load_dataset.py:617)
            abnormal = rec.key.split("_")[0] == "abnormal"
            if abnormal:
                anno = np.load(os.path.join(mask_dir, rec.key + ".npy"))
            else:
                if rec.n_frames is None:
                    raise ValueError(
                        f"{test_txt}: normal test video {rec.key!r} has no "
                        "frame count (expected 'key,n_frames' lines, "
                        "utils/load_dataset.py:613-617)")
                anno = np.zeros(int(rec.n_frames))
            videos.append(TestVideo(rec.key, anno, abnormal, rec.n_frames,
                                    store.n_clips(rec.key), lazy(rec.key),
                                    cache))
    elif dataset == "UCF":
        import h5py

        with h5py.File(mask_h5, "r") as gt:
            for rec in parse_ucf_test(test_txt):
                if rec.is_abnormal:
                    anno = gt[rec.key + ".npy"][:]
                else:
                    anno = np.zeros(rec.n_frames)
                videos.append(TestVideo(rec.key, anno, rec.is_abnormal,
                                        rec.n_frames, store.n_clips(rec.key),
                                        lazy(rec.key), cache))
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    return videos


def load_train_records(dataset: str, train_txt: str) -> List[TrainRecord]:
    if dataset == "SHT":
        return parse_sht_train(train_txt)
    if dataset == "UCF":
        return parse_ucf_train(train_txt)
    if dataset == "UBnormal":
        return parse_ubnormal(train_txt)
    raise ValueError(f"unknown dataset {dataset!r}")
