"""HDF5 feature store: pre-extracted I3D clip features keyed by "<video>.npy".

A copy of lstc_vad_tpu/data/feature_store.py::FeatureStore without the
tenCrop layout: features are read per video on ``get(key)`` (the reference's
``h5[key + '.npy']`` convention, utils/load_dataset.py:285-286), or, for the
``eager_keys`` given, read once into RAM when the store opens, as the
reference's SHT/UBnormal train sets do (:29-48).  ``h5py`` is imported when a
store opens, so importing the package does not need it.  The tenCrop layout
and ``CropView`` are not ported yet (ROADMAP A14).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

import numpy as np


class FeatureStore:
    """HDF5-backed feature store.  Keys are stored WITHOUT the ".npy"
    suffix; ``get`` appends it."""

    def __init__(self, h5_path: str,
                 eager_keys: Optional[Iterable[str]] = None):
        import h5py

        self._lock = threading.Lock()
        self._h5 = h5py.File(h5_path, "r")
        self._cache: Dict[str, np.ndarray] = {}
        for key in eager_keys or ():
            self._cache[key] = self._read(key)

    def _read(self, key: str) -> np.ndarray:
        with self._lock:  # h5py handles are not thread-safe
            return self._h5[key + ".npy"][:]

    def get(self, key: str) -> np.ndarray:
        feat = self._cache.get(key)
        return self._read(key) if feat is None else feat

    def n_clips(self, key: str) -> int:
        """Clip count from h5 metadata only — no feature read."""
        feat = self._cache.get(key)
        if feat is not None:
            return feat.shape[0]
        with self._lock:
            return self._h5[key + ".npy"].shape[0]

    def close(self):
        self._h5.close()
