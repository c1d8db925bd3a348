"""Dataset integrity validation (CLI ``validate-data``) — a copy of
lstc_vad_tpu/data/validate.py:35-230 over this package's stores.

The reference fails on inconsistent data with raw KeyErrors deep inside
training (h5[key+'.npy'] at utils/load_dataset.py:42,285-286,409) or an
``exit(-1)`` (missing pseudo-label file, :22-23).  This walks every
annotation, feature, mask and pseudo-label artifact a config points at —
metadata only (stored shapes, no feature reads), so it is fast even on
hour-scale UCF stores — and reports every problem at once instead of dying
on the first.  The store is the ``.lstcpack`` of ``data.pack_path`` when it
is set (no h5py needed), else the HDF5 file of ``data.h5_path``; the UCF
ground-truth h5 is opened only when ``data.test_mask_h5`` is set.

Checked:
- the store opens; every train/test txt key exists in it;
- stored shapes: 3-D [n_clips, n_patch, d], patch axis >= data.n_patch,
  d == data.d_model; tenCrop stores divisible into (-1, 10, n_patch, d);
- videos shorter than part_len (fatal for the SHT/UBnormal sampler; UCF
  doubles them — utils/load_dataset.py:417-418);
- balanced pairing is possible (>=1 normal and >=1 abnormal train video);
- frame masks: per-video .npy present for abnormal SHT/UBnormal test videos
  (and its length vs the feature clip count), GT-h5 rows for abnormal UCF;
- pseudo labels: every train video covered, entry length == clip count
  (or the doubled count for short UCF videos).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..config import TrainConfig
from .annotations import parse_sht_test, parse_ucf_test
from .datasets import load_pseudo_labels, load_train_records


def _open_store(d):
    if d.pack_path:
        from .packed import PackedStore

        return PackedStore(d.pack_path, ten_crop=d.ten_crop,
                           n_patch=d.n_patch, d_model=d.d_model)
    from .feature_store import FeatureStore

    return FeatureStore(d.h5_path, ten_crop=d.ten_crop, n_patch=d.n_patch,
                        d_model=d.d_model)


def validate_data(cfg: TrainConfig) -> Tuple[List[str], dict]:
    """Returns (problems, stats).  Empty ``problems`` == consistent."""
    d = cfg.data
    problems: List[str] = []
    stats = {"train_videos": 0, "test_videos": 0, "clips": 0}

    try:
        store = _open_store(d)
    except Exception as e:
        return [f"store: cannot open "
                f"{d.pack_path or d.h5_path!r}: {e}"], stats
    store_keys = set(store.keys())
    stats["store_videos"] = len(store_keys)

    def clip_count(key: str) -> int:
        n = store.n_clips(key)
        stats["clips"] += n
        return n

    def check_key(key: str, where: str) -> bool:
        if key not in store_keys:
            problems.append(f"{where}: key {key!r} not in the feature store")
            return False
        try:
            shape = store.shape(key)
        except KeyError:
            # present under its raw name but not resolvable through the
            # reference access convention h5[key + '.npy']
            problems.append(
                f"{where}: {key!r} is stored without the '.npy' dataset "
                "suffix (reference convention, utils/load_dataset.py:42)")
            return False
        if d.ten_crop:
            if int(np.prod(shape)) % (10 * d.n_patch * d.d_model):
                problems.append(
                    f"{where}: {key!r} stored shape {shape} does not reshape "
                    f"to (-1, 10, {d.n_patch}, {d.d_model}) (tenCrop)")
                return False
            return True
        if len(shape) != 3:
            problems.append(f"{where}: {key!r} stored shape {shape} is not "
                            "3-D [n_clips, n_patch, d_model]")
            return False
        if shape[1] < d.n_patch:
            problems.append(f"{where}: {key!r} has {shape[1]} patches < "
                            f"data.n_patch={d.n_patch}")
        if shape[2] != d.d_model:
            problems.append(f"{where}: {key!r} has d_model {shape[2]} != "
                            f"data.d_model={d.d_model}")
        return True

    # ------------------------------------------------------------- train
    pseudo = None
    if d.pseudo_labels_path:
        try:
            pseudo = load_pseudo_labels(d.pseudo_labels_path)
        except Exception as e:
            problems.append(f"pseudo labels: {e}")

    if d.train_txt:
        try:
            records = load_train_records(d.dataset, d.train_txt)
        except Exception as e:
            records = []
            problems.append(f"train txt {d.train_txt!r}: {e}")
        stats["train_videos"] = len(records)
        n_normal = sum(not r.is_abnormal for r in records)
        n_abnormal = len(records) - n_normal
        stats["train_normal"], stats["train_abnormal"] = n_normal, n_abnormal
        if records and (n_normal == 0 or n_abnormal == 0):
            problems.append(
                f"train split: balanced pairing needs >=1 normal and >=1 "
                f"abnormal video, got {n_normal}/{n_abnormal}")
        for r in records:
            if not check_key(r.key, "train"):
                continue
            n = clip_count(r.key)
            if n == 0:
                problems.append(f"train: {r.key!r} has 0 stored clips")
                continue
            if n < d.part_len and d.dataset != "UCF":
                problems.append(
                    f"train: {r.key!r} has {n} clips < part_len="
                    f"{d.part_len} (only the UCF loader doubles short "
                    "videos, utils/load_dataset.py:417-418)")
            if pseudo is not None:
                entry = pseudo.get(r.key + ".npy", pseudo.get(r.key))
                if entry is None:
                    problems.append(
                        f"pseudo labels: no entry for train video {r.key!r}")
                    continue
                m = np.asarray(entry).shape[0]  # entries are [L] or [L, 2]
                doubled = n
                # mirror sampler.maybe_double_short exactly: it doubles
                # while <= part_len (a video of exactly part_len clips IS
                # doubled), so validate must expect the same final length
                while d.dataset == "UCF" and 0 < doubled <= d.part_len:
                    doubled *= 2
                if m not in (n, doubled):
                    problems.append(
                        f"pseudo labels: {r.key!r} has {m} entries, expected "
                        f"{n}" + (f" (or {doubled} after short-video "
                                  "doubling)" if doubled != n else ""))

    # -------------------------------------------------------------- test
    if d.test_txt:
        if d.dataset == "UCF":
            try:
                recs = parse_ucf_test(d.test_txt)
            except Exception as e:
                recs = []
                problems.append(f"test txt {d.test_txt!r}: {e}")
            stats["test_videos"] = len(recs)
            gt = None
            if d.test_mask_h5:
                import h5py

                try:
                    gt = h5py.File(d.test_mask_h5, "r")
                except Exception as e:
                    problems.append(
                        f"GT h5 {d.test_mask_h5!r}: cannot open: {e}")
            elif any(r.is_abnormal for r in recs):
                problems.append("test split has abnormal videos but no "
                                "data.test_mask_h5 configured")
            for r in recs:
                check_key(r.key, "test")
                if r.is_abnormal and gt is not None \
                        and r.key + ".npy" not in gt:
                    problems.append(f"GT h5: no frame mask for abnormal "
                                    f"test video {r.key!r}")
            if gt is not None:
                gt.close()
        else:
            if d.dataset == "SHT":
                try:
                    recs = parse_sht_test(d.test_txt)
                except Exception as e:
                    recs = []
                    problems.append(f"test txt {d.test_txt!r}: {e}")
            else:  # UBnormal: same txt format as train, abnormal by prefix
                try:
                    recs = load_train_records("UBnormal", d.test_txt)
                except Exception as e:
                    recs = []
                    problems.append(f"test txt {d.test_txt!r}: {e}")
            stats["test_videos"] = len(recs)
            for r in recs:
                abnormal = (r.is_abnormal if d.dataset == "SHT"
                            else r.key.split("_")[0] == "abnormal")
                ok = check_key(r.key, "test")
                if not abnormal:
                    # normal videos take their anno length from n_frames
                    # (load_test_videos builds zeros(n_frames))
                    if d.dataset == "UBnormal" and r.n_frames is None:
                        problems.append(
                            f"test: normal video {r.key!r} has no frame "
                            "count (expected 'key,n_frames' lines)")
                    continue
                mask_path = os.path.join(d.test_mask_dir, r.key + ".npy")
                if not os.path.exists(mask_path):
                    problems.append(f"mask dir: missing frame mask "
                                    f"{mask_path!r} for abnormal test video")
                elif ok:
                    n = store.n_clips(r.key)
                    try:
                        # same np.load semantics as the runtime loader
                        # (datasets.py load_test_videos: allow_pickle=False
                        # default) — a pickled/object mask must fail HERE,
                        # not at eval startup
                        mask = np.load(mask_path)
                    except Exception as e:
                        problems.append(
                            f"mask {mask_path!r}: not loadable with the "
                            f"runtime's np.load (allow_pickle=False): {e}")
                        continue
                    # eval consumes anno[: n_clips*segment_len] slices; a
                    # mask shorter than ONE clip can't score anything
                    if np.asarray(mask).reshape(-1).shape[0] < d.segment_len:
                        problems.append(
                            f"mask {mask_path!r}: {np.size(mask)} frames < "
                            f"segment_len={d.segment_len} "
                            f"(features have {n} clips)")
    store.close()
    return problems, stats
