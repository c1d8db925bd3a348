"""Test-video loading — the evaluation side of lstc_vad_tpu/data/datasets.py
(``TestVideo``, ``load_test_videos``, :161-252).

Test videos carry per-frame annotations: zeros(n_frames) for normal, the GT
mask .npy (SHT/UBnormal, utils/load_dataset.py:119-126) or GT h5 row (UCF,
:485-489) for abnormal.  Any store with ``get(key)`` and ``n_clips(key)``
serves, including an in-memory one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional

import numpy as np

from .annotations import parse_sht_test, parse_ubnormal, parse_ucf_test


@dataclasses.dataclass
class TestVideo:
    """Lazy test-split handle: annotations + clip count are resident, the
    feature array is fetched from the store per ``.feat`` access, so a split
    never holds more than the video being scored in RAM."""

    __test__ = False  # not a pytest class despite the Test* name

    key: str
    anno: np.ndarray       # per-frame 0/1
    is_abnormal: bool
    n_frames: Optional[int] = None
    n_clips: Optional[int] = None
    loader: Optional[Callable[[], np.ndarray]] = None

    @property
    def feat(self) -> np.ndarray:
        """[n_clips, n_patch, d], read from the store."""
        return self.loader()


def load_test_videos(dataset: str, test_txt: str, store,
                     mask_dir: str = "", mask_h5: str = "") -> List[TestVideo]:
    """Test split as lazy handles with per-frame GT, per dataset format."""

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
                                    lazy(rec.key)))
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
                                    store.n_clips(rec.key), lazy(rec.key)))
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
                                        lazy(rec.key)))
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    return videos
