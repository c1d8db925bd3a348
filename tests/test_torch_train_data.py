"""The PyTorch package's training data path against the JAX package's
(lstc_vad_tpu/data/{sampler,datasets,pipeline,feature_store}.py).

Everything before the device is numpy on both sides, so the check is
bit-equality for the same seed: window index plans, short-video doubling,
the paired dataset's items and batches over several reshuffled epochs (with
and without pseudo labels, with UCF's doubling), the train-record parsers
and the pseudo-label loader.  The prefetcher hands out the batches the
iterator builds, propagates a worker's error and stops its thread when the
consumer leaves early.
"""

import threading
from dataclasses import astuple

import numpy as np
import pytest
import torch

from fixtures import make_sht_like, make_ubnormal_like, make_ucf_like
from lstc_vad_tpu.data import datasets as jd
from lstc_vad_tpu.data import sampler as js
from lstc_vad_tpu.data.feature_store import FeatureStore as JaxStore
from lstc_vad_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from lstc_vad_tpu_torch.data import datasets as pd
from lstc_vad_tpu_torch.data import sampler as ps
from lstc_vad_tpu_torch.data import synthetic
from lstc_vad_tpu_torch.data.feature_store import FeatureStore
from lstc_vad_tpu_torch.data.pipeline import BatchIterator, Prefetcher


@pytest.mark.parametrize("mode", ["uniform", "random"])
@pytest.mark.parametrize("feat_len,part_num,part_len",
                         [(7, 16, 7), (12, 3, 2), (48, 16, 3), (100, 16, 7),
                          (300, 16, 3), (23, 4, 5)])
def test_sampler_plans_equal_jax(mode, feat_len, part_num, part_len):
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        np.testing.assert_array_equal(
            ps.sample_part_indices(feat_len, part_num, part_len, mode, a),
            js.sample_part_indices(feat_len, part_num, part_len, mode, b))


@pytest.mark.parametrize("n", [1, 3, 7, 8, 20])
def test_double_short_equals_jax(n):
    feat = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    np.testing.assert_array_equal(ps.maybe_double_short(feat, 7),
                                  js.maybe_double_short(feat, 7))


def test_sampler_short_video_raises():
    with pytest.raises(ValueError, match="shorter than part_len"):
        ps.sample_part_indices(2, 4, 3, "uniform", np.random.default_rng())


def _pair(root, dataset, pseudo=None, sample="uniform", part_len=2):
    """(port dataset, JAX dataset) over the same files and seed."""
    if dataset == "UCF":
        h5, train_txt, _, _ = make_ucf_like(root, n_clips=(1, 12))
    elif dataset == "UBnormal":
        h5, train_txt, _, _ = make_ubnormal_like(root)
    else:
        h5, train_txt, _, _ = make_sht_like(root)
    records = pd.load_train_records(dataset, train_txt)
    assert [astuple(r) for r in records] == [
        astuple(r) for r in jd.load_train_records(dataset, train_txt)]
    kw = dict(part_num=3, part_len=part_len, n_patch=2, sample=sample,
              pseudo_labels=pseudo, double_short=dataset == "UCF", seed=5)
    ours = pd.PairedTrainDataset(records, FeatureStore(h5), **kw)
    ref = jd.PairedTrainDataset(records, JaxStore(h5), **kw)
    return ours, ref, records


@pytest.mark.parametrize("dataset", ["SHT", "UBnormal", "UCF"])
@pytest.mark.parametrize("sample", ["uniform", "random"])
def test_paired_dataset_batches_equal_jax(tmp_path, dataset, sample):
    ours, ref, _ = _pair(str(tmp_path), dataset, sample=sample,
                         part_len=7 if dataset == "UCF" else 2)
    assert len(ours) == len(ref) > 0
    for _ in range(3):  # epochs, reshuffled in between
        got = list(BatchIterator(ours, 2, drop_last=False))
        want = list(JaxBatchIterator(ref, 2, drop_last=False))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        ours.shuffle_keys()
        ref.shuffle_keys()


def test_paired_dataset_pseudo_labels_equal_jax(tmp_path):
    h5, train_txt, _, _ = make_sht_like(str(tmp_path / "d"))
    records = pd.load_train_records("SHT", train_txt)
    store = FeatureStore(h5)
    rng = np.random.default_rng(1)
    pseudo = {}
    for i, r in enumerate(records):
        n = store.n_clips(r.key)
        # both artifact layouts: [L] scores and [L, 2] (last column used)
        pseudo[r.key + ".npy"] = (rng.random(n) if i % 2
                                  else rng.random((n, 2)))
    store.close()  # _pair writes the same files again
    path = str(tmp_path / "pseudo.npy")
    np.save(path, pseudo, allow_pickle=True)
    loaded = pd.load_pseudo_labels(path)
    ref_loaded = jd.load_pseudo_labels(path)
    assert loaded.keys() == ref_loaded.keys()
    ours, ref, _ = _pair(str(tmp_path / "d"), "SHT", pseudo=loaded)
    for i in range(len(ours)):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        pd.load_pseudo_labels(str(tmp_path / "missing.npy"))


def test_feature_store_eager_keys_read_once(tmp_path):
    h5, train_txt, _, _ = make_sht_like(str(tmp_path))
    keys = [r.key for r in pd.load_train_records("SHT", train_txt)]
    lazy = FeatureStore(h5)
    eager = FeatureStore(h5, eager_keys=keys[:2])
    want = {k: lazy.get(k) for k in keys}
    eager.close()  # eager keys are served from memory after this
    for k in keys[:2]:
        np.testing.assert_array_equal(eager.get(k), want[k])
        assert eager.n_clips(k) == want[k].shape[0]
    assert eager.get(keys[0]) is eager.get(keys[0])
    lazy.close()


def test_test_video_cache(tmp_path):
    h5, _, test_txt, mask_dir = make_sht_like(str(tmp_path))
    store = FeatureStore(h5)
    cached = pd.load_test_videos("SHT", test_txt, store, mask_dir=mask_dir,
                                 cache=True)
    lazy = pd.load_test_videos("SHT", test_txt, store, mask_dir=mask_dir)
    assert cached[0].feat is cached[0].feat
    assert lazy[0].feat is not lazy[0].feat
    np.testing.assert_array_equal(cached[0].feat, lazy[0].feat)


def test_prefetcher_yields_the_iterators_batches(tmp_path):
    ours, _, _ = _pair(str(tmp_path), "SHT")
    direct = list(BatchIterator(ours, 2))
    ours.rng = np.random.default_rng(5)  # replay the same epoch
    ours.shuffle_keys()
    fetched = list(Prefetcher(BatchIterator(ours, 2), torch.device("cpu")))
    assert len(fetched) == len(direct) > 0
    for got, want in zip(fetched, direct):
        for t, a in zip(got, want):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), a)


def test_prefetcher_propagates_errors():
    def boom():
        yield tuple(np.zeros((1, 2), np.float32) for _ in range(4))
        raise RuntimeError("disk gone")

    it = iter(Prefetcher(boom(), torch.device("cpu")))
    next(it)
    with pytest.raises(RuntimeError, match="disk gone"):
        next(it)


def test_prefetcher_stops_its_thread_on_early_exit():
    def endless():
        while True:
            yield tuple(np.zeros((1, 2), np.float32) for _ in range(4))

    before = threading.active_count()
    it = iter(Prefetcher(endless(), torch.device("cpu"), depth=2))
    next(it)
    it.close()  # the consumer leaves: the worker must exit
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before


def test_synthetic_train_split_layout(tmp_path, monkeypatch):
    """ShanghaiTech's train-list size at a narrow feature width."""
    monkeypatch.setattr(synthetic, "D_FEAT", 4)
    store, records, masks = synthetic.sht_train_split(0)
    assert len(records) == 238
    assert sum(not r.is_abnormal for r in records) == 175
    assert set(masks) == {r.key for r in records if r.is_abnormal}
    lo, hi = synthetic.TRAIN_CLIPS
    for r in records:
        f = store.get(r.key)
        assert lo <= store.n_clips(r.key) < hi
        assert f.shape[1:] == (16, 4) and f.dtype == np.float32
        if r.is_abnormal:
            assert masks[r.key].shape == (16 * f.shape[0],)
            assert 0 < masks[r.key].sum() < masks[r.key].size
    train_txt, mask_dir = synthetic.write_train_files(str(tmp_path),
                                                      records, masks)
    assert pd.load_train_records("SHT", train_txt) == records
    key = next(iter(masks))
    np.testing.assert_array_equal(np.load(f"{mask_dir}/{key}.npy"),
                                  masks[key])
    again = synthetic.sht_train_split(0)[0]
    np.testing.assert_array_equal(again.get(key), store.get(key))
