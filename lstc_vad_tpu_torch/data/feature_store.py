"""HDF5 feature store: pre-extracted I3D clip features keyed by "<video>.npy".

A copy of lstc_vad_tpu/data/feature_store.py: features are read per video on
``get(key)`` (the reference's ``h5[key + '.npy']`` convention,
utils/load_dataset.py:285-286), or, for the ``eager_keys`` given, read once
into RAM when the store opens, as the reference's SHT/UBnormal train sets do
(:29-48).  A tenCrop store (``ten_crop=True``) reshapes each video to
[-1, 10, n_patch, d_model]; ``get(key, crop=c)`` selects one crop, as the
reference's tenCrop loaders do (:168,172,413), and ``CropView`` fixes the crop
for the paths that need one.  ``h5py`` is imported when a store opens, so
importing the package does not need it.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

import numpy as np


class FeatureStore:
    """HDF5-backed feature store.  Keys are stored WITHOUT the ".npy"
    suffix; ``get`` appends it."""

    def __init__(self, h5_path: str,
                 eager_keys: Optional[Iterable[str]] = None,
                 ten_crop: bool = False, n_patch: Optional[int] = None,
                 d_model: Optional[int] = None):
        import h5py

        self._ten_crop = ten_crop
        self._n_patch = n_patch
        self._d_model = d_model
        self._lock = threading.Lock()
        self._h5 = h5py.File(h5_path, "r")
        self._cache: Dict[str, np.ndarray] = {}
        for key in eager_keys or ():
            self._cache[key] = self._read(key)

    def _read(self, key: str) -> np.ndarray:
        with self._lock:  # h5py handles are not thread-safe
            feat = self._h5[key + ".npy"][:]
        if self._ten_crop:
            feat = feat.reshape(-1, 10, self._n_patch, self._d_model)
        return feat

    def get(self, key: str, crop: Optional[int] = None) -> np.ndarray:
        """[n_clips, n_patch, d], or for a tenCrop store
        [n_clips, 10, n_patch, d] — [n_clips, n_patch, d] with ``crop``."""
        feat = self._cache.get(key)
        if feat is None:
            feat = self._read(key)
        if self._ten_crop and crop is not None:
            feat = feat[:, crop]
        return feat

    def n_clips(self, key: str) -> int:
        """Clip count from h5 metadata only — no feature read."""
        feat = self._cache.get(key)
        if feat is not None:
            return feat.shape[0]
        with self._lock:
            shape = self._h5[key + ".npy"].shape
        if self._ten_crop:
            return int(np.prod(shape)) // (10 * self._n_patch * self._d_model)
        return shape[0]

    def close(self):
        self._h5.close()


class CropView:
    """Fix one tenCrop crop index over any store: ``get`` returns 3-D
    [n_clips, n_patch, d] features.  The eval and pseudo-label paths use it
    where they need a deterministic crop (the reference ships no tenCrop eval
    semantics)."""

    def __init__(self, store, crop: int):
        self._store = store
        self._crop = crop

    def get(self, key: str, crop: Optional[int] = None) -> np.ndarray:
        return self._store.get(key, crop=self._crop if crop is None else crop)

    def n_clips(self, key: str) -> int:
        return self._store.n_clips(key)
