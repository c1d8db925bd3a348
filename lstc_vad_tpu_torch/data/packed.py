"""Packed feature store: a flat binary ``.lstcpack`` file and its native
mmap gather — a copy of lstc_vad_tpu/data/packed.py:23-328 (numpy only).

``pack_h5`` converts a reference-format HDF5 feature file into the pack once
(h5py is imported inside it, so this module imports without h5py: the card's
machine has none); ``PackedStore`` then serves the training hot loop through
the package's own C++ reader (``csrc/packstore.cpp``, built with g++ at first
use into ``_build/``, ops/_build.py, and bound with ctypes): zero-copy mmap
reads, a whole batch gathered in one multi-threaded native call, no h5py lock
and no per-item Python allocations.  A pack written by either package is
byte-identical and readable by the other.

One deliberate difference from the JAX package: there, a failed build of the
native reader quietly falls back to the numpy reader.  Here the numpy reader
(``_NumpyPack``) runs only when asked (``use_native=False``); with
``use_native=True`` a failed build raises with the compiler's output, so a
run never hides which reader it used.  A native open that fails on a
resource (``PS_ERR_IO``: fd limit, mmap exhaustion) on a pack the numpy
reader has just validated still degrades to numpy, as in the JAX package,
and ``native`` says so.

Drop-in for data.FeatureStore: ``get(key[, crop])``, ``n_clips(key)``,
``shape(key)``, ``keys()``, ``close()``, plus the gather fast paths.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

MAGIC = b"LSTCPK01"
_ALIGN = 64
PS_ERR_IO = 1  # csrc/packstore.cpp ps_open_checked's error enum


class PackFormatError(ValueError):
    """Raised for a structurally invalid .lstcpack (truncated, bit-flipped,
    or hostile): both readers fully validate the header, the index walk and
    every payload extent at open, so corruption is a clean Python exception
    — never a native crash or an out-of-bounds read."""


# ---------------------------------------------------------------- writer

def write_pack(path: str, videos: Iterable[Tuple[str, np.ndarray]]):
    """videos: iterable of (key, float32 [n_clips, n_patch, d_model])."""
    index = []
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", 0))   # n_videos placeholder
        f.write(struct.pack("<Q", 0))   # index_offset placeholder
        seen = set()
        for key, feat in videos:
            feat = np.ascontiguousarray(feat, dtype=np.float32)
            if feat.ndim != 3:
                raise ValueError(f"{key}: expected 3-D [clips, patch, d], "
                                 f"got {feat.shape}")
            if key in seen:
                raise ValueError(f"duplicate key {key!r} (readers reject "
                                 "duplicate-key packs)")
            seen.add(key)
            pad = (-f.tell()) % _ALIGN
            f.write(b"\0" * pad)
            index.append((key, f.tell()) + feat.shape)
            f.write(feat.data)  # the bytes of tobytes(), without the copy
        index_offset = f.tell()
        for key, offset, n_clips, n_patch, d_model in index:
            kb = key.encode()
            f.write(struct.pack("<I", len(kb)))
            f.write(kb)
            f.write(struct.pack("<QIII", offset, n_clips, n_patch, d_model))
        f.seek(len(MAGIC))
        f.write(struct.pack("<I", len(index)))
        f.write(struct.pack("<Q", index_offset))


def pack_h5(h5_path: str, pack_path: str,
            keys: Optional[Iterable[str]] = None):
    """Convert a reference h5 (datasets named '<key>.npy') into a pack."""
    import h5py

    with h5py.File(h5_path, "r") as h5:
        names = list(h5.keys()) if keys is None else [k + ".npy" for k in keys]

        def gen():
            for name in names:
                key = name[:-4] if name.endswith(".npy") else name
                yield key, h5[name][:]

        write_pack(pack_path, gen())


# ---------------------------------------------------------------- native

def _load_lib() -> ctypes.CDLL:
    """The native reader, built from ``csrc/packstore.cpp`` if needed;
    raises with the compiler's output when the build fails."""
    from ..ops import _build

    lib = _build.load("packstore")
    lib.ps_open_checked.restype = ctypes.c_void_p
    lib.ps_open_checked.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_int32)]
    lib.ps_close.restype = None
    lib.ps_close.argtypes = [ctypes.c_void_p]
    lib.ps_get.restype = ctypes.c_int
    lib.ps_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.POINTER(ctypes.c_float)]
    lib.ps_gather.restype = ctypes.c_int
    lib.ps_gather.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.c_int32, ctypes.c_int32,
                              ctypes.POINTER(ctypes.c_float)]
    lib.ps_gather_pair_batch.restype = ctypes.c_int
    lib.ps_gather_pair_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
    return lib


def _float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class _NumpyPack:
    """Pure-numpy reader of the pack format.

    Mirrors the native reader's validation (csrc/packstore.cpp
    ps_open_checked): a bounds-checked index walk and payload-extent
    checks, so a corrupt pack raises PackFormatError at construction."""

    def __init__(self, path: str):
        try:
            self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        except (OSError, ValueError) as e:  # an empty file raises ValueError
            raise PackFormatError(f"{path}: unreadable pack: {e}") from e
        size = self._mm.shape[0]
        if size < 20 or bytes(self._mm[:8]) != MAGIC:
            raise PackFormatError(f"{path}: not a LSTCPK01 pack "
                                  f"(size {size})")
        raw = bytes(self._mm[:20])
        n_videos, = struct.unpack_from("<I", raw, 8)
        index_offset, = struct.unpack_from("<Q", raw, 12)
        if index_offset > size:
            raise PackFormatError(
                f"{path}: index offset {index_offset} beyond file size "
                f"{size}")
        self.index: Dict[str, Tuple[int, int, int, int]] = {}
        buf = bytes(self._mm[index_offset:])
        pos = 0
        for i in range(n_videos):
            if pos + 4 > len(buf):
                raise PackFormatError(
                    f"{path}: truncated index at entry {i}/{n_videos}")
            key_len, = struct.unpack_from("<I", buf, pos)
            pos += 4
            if pos + key_len + 20 > len(buf):
                raise PackFormatError(
                    f"{path}: truncated index entry {i}/{n_videos} "
                    f"(key_len {key_len})")
            try:
                key = buf[pos:pos + key_len].decode()
            except UnicodeDecodeError as e:
                raise PackFormatError(
                    f"{path}: undecodable key in entry {i}") from e
            pos += key_len
            offset, n_clips, n_patch, d_model = struct.unpack_from(
                "<QIII", buf, pos)
            pos += 20
            nbytes = n_clips * n_patch * d_model * 4  # no overflow in Python
            if offset + nbytes > size:
                raise PackFormatError(
                    f"{path}: entry {key!r} extent [{offset}, "
                    f"{offset + nbytes}) beyond file size {size}")
            if key in self.index:
                # both readers must agree which entry wins; the native map
                # keeps the first, a dict would keep the last — a shape
                # disagreement there is a caller-buffer overflow in ps_get
                raise PackFormatError(f"{path}: duplicate key {key!r} "
                                      f"at index entry {i}")
            self.index[key] = (offset, n_clips, n_patch, d_model)

    def shape(self, key):
        _, n_clips, n_patch, d_model = self.index[key]
        return n_clips, n_patch, d_model

    def view(self, key) -> np.ndarray:
        offset, n_clips, n_patch, d_model = self.index[key]
        nbytes = n_clips * n_patch * d_model * 4
        return self._mm[offset:offset + nbytes].view(np.float32).reshape(
            n_clips, n_patch, d_model)


class PackedStore:
    """FeatureStore-compatible reader over a .lstcpack file; ``native``
    says whether the C++ reader serves it."""

    def __init__(self, pack_path: str, use_native: bool = True,
                 ten_crop: bool = False, n_patch: Optional[int] = None,
                 d_model: Optional[int] = None):
        self.path = pack_path
        self._ten_crop = ten_crop
        self._tc_patch = n_patch
        self._tc_d = d_model
        self._lib = _load_lib() if use_native else None
        self._np = _NumpyPack(pack_path)  # validates the format up front
        self._handle = None
        if self._lib is not None:
            err = ctypes.c_int32(0)
            self._handle = self._lib.ps_open_checked(pack_path.encode(),
                                                     ctypes.byref(err))
            if not self._handle and err.value != PS_ERR_IO:
                # a FORMAT disagreement (header, index, extent, duplicate
                # key): the numpy reader accepted a pack the native walk
                # rejects — never degrade to the slow path for that.  Only a
                # resource failure on a pack numpy just validated degrades.
                raise PackFormatError(
                    f"{pack_path}: native reader rejected the pack "
                    f"(code {err.value}) that the numpy reader validated")
        self.native = bool(self._handle)

    # -- FeatureStore interface

    def shape(self, key: str):
        """(n_clips, n_patch, d_model) as stored (before the tenCrop
        reshape)."""
        return self._np.shape(key)

    def keys(self):
        """All video keys in the pack."""
        return list(self._np.index.keys())

    def n_clips(self, key: str) -> int:
        shape = self._np.shape(key)
        if self._ten_crop:
            # by total size, like FeatureStore.n_clips and get()'s own
            # reshape(-1, 10, p, d): right for both first-axis-stacked
            # [10*n, p, d] and patch-folded [n, 10*p, d] layouts
            return int(np.prod(shape)) // (10 * self._tc_patch * self._tc_d)
        return shape[0]

    def get(self, key: str, crop: Optional[int] = None) -> np.ndarray:
        n_clips, n_patch, d_model = self._np.shape(key)
        if self.native:
            out = np.empty((n_clips, n_patch, d_model), np.float32)
            if self._lib.ps_get(self._handle, key.encode(),
                                _float_ptr(out)) != 0:
                raise KeyError(key)
        else:
            out = np.array(self._np.view(key))
        if self._ten_crop:
            out = out.reshape(-1, 10, self._tc_patch, self._tc_d)
            if crop is not None:
                out = out[:, crop]
        return out

    # -- native fast paths

    def gather(self, key: str, indices: np.ndarray,
               n_patch_out: int) -> np.ndarray:
        """The clips ``indices`` of ``key``, sliced to ``n_patch_out``
        patches: the sampler's window gather, in one native call."""
        n_clips, n_patch, d_model = self._np.shape(key)
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        if not self.native:
            return np.array(self._np.view(key)[indices, :n_patch_out, :])
        out = np.empty((len(indices), n_patch_out, d_model), np.float32)
        rc = self._lib.ps_gather(
            self._handle, key.encode(),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(indices), n_patch_out, _float_ptr(out))
        if rc != 0:
            raise KeyError(f"{key} (rc={rc})")
        return out

    def gather_batch(self, keys, indices: np.ndarray, n_patch_out: int,
                     d_model: int, n_threads: int = 0) -> np.ndarray:
        """One native call per training batch.  ``indices``: [n_items,
        idx_per_item] int64 -> [n_items, idx_per_item, n_patch_out,
        d_model] float32.  ``n_threads`` <= 0: the host's core count."""
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        n_items, idx_per_item = indices.shape
        out = np.empty((n_items, idx_per_item, n_patch_out, d_model),
                       np.float32)
        if not self.native:
            for i, key in enumerate(keys):
                out[i] = self.gather(key, indices[i], n_patch_out)
            return out
        key_arr = (ctypes.c_char_p * n_items)(*[k.encode() for k in keys])
        rc = self._lib.ps_gather_pair_batch(
            self._handle, key_arr, n_items,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            idx_per_item, n_patch_out, d_model, _float_ptr(out), n_threads)
        if rc != 0:
            raise RuntimeError(f"gather_batch failed rc={rc}")
        return out

    def close(self):
        if self.native:
            self._lib.ps_close(self._handle)
            self._handle = None
            self.native = False
