"""The Trainer's batch worker builds each next epoch while the current one
runs (data/pipeline.py::EpochPrefetcher): its batches and the dataset's
sampling state after every epoch equal a plain loop's (``BatchIterator``
over the epoch, then ``shuffle_keys``) and the JAX package's, on every
batch path; a dataset that no longer draws what the prepared epoch was
drawn from drops it; and dropping or closing the Trainer ends the worker.

Between epochs the tests wait until the worker has queued the next epoch
whole (``settle``), so the counts they read do not depend on timing."""

import copy
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from fixtures import make_sht_like
from lstc_vad_tpu.data import datasets as jd
from lstc_vad_tpu.data.feature_store import FeatureStore as JaxStore
from lstc_vad_tpu.data.packed import PackedStore as JaxPackedStore
from lstc_vad_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from lstc_vad_tpu_torch.config import preset, replace
from lstc_vad_tpu_torch.data import datasets as pd
from lstc_vad_tpu_torch.data.feature_store import FeatureStore
from lstc_vad_tpu_torch.data.packed import PackedStore, pack_h5
from lstc_vad_tpu_torch.data.pipeline import BatchIterator
from lstc_vad_tpu_torch.train.driver import Trainer

from test_torch_spans import TINY, settle

CASES = ["items", "packed", "ucf_tencrop", "pseudo", "bf16"]
KW = dict(part_num=4, part_len=3, n_patch=4, sample="uniform", seed=7)


def _sources(root, case):
    """(port dataset maker, JAX dataset maker, config overrides): the
    same records, features and sampling settings on both sides."""
    tencrop = case == "ucf_tencrop"
    # UCF's doubling takes videos of at most part_len clips
    h5, train_txt, _, mask_dir = make_sht_like(
        root, n_normal=5, n_abnormal=5, ten_crop=tencrop,
        n_clips=(2, 12) if tencrop else (6, 20))
    kw = dict(KW)
    if case == "packed":
        pack = f"{root}/feats.lstcpack"
        pack_h5(h5, pack)
        stores = PackedStore(pack), JaxPackedStore(pack)
    elif tencrop:
        kw.update(ten_crop=True, double_short=True, crop_per_video=True)
        stores = (FeatureStore(h5, ten_crop=True, n_patch=4, d_model=16),
                  JaxStore(h5, ten_crop=True, n_patch=4, d_model=16))
    else:
        stores = FeatureStore(h5), JaxStore(h5)
    if case == "pseudo":
        rng = np.random.default_rng(2)
        kw["pseudo_labels"] = {
            r.key + ".npy": rng.random(stores[0].n_clips(r.key))
            for r in pd.load_train_records("SHT", train_txt)}

    def port():
        return pd.PairedTrainDataset(
            pd.load_train_records("SHT", train_txt), stores[0], **kw)

    def jax():
        return jd.PairedTrainDataset(
            jd.load_train_records("SHT", train_txt), stores[1], **kw)

    overrides = {"data.train_txt": train_txt, "data.test_mask_dir": mask_dir,
                 "data.part_num": KW["part_num"],
                 "data.part_len": KW["part_len"]}
    if case == "bf16":
        overrides["data.transfer_dtype"] = "bfloat16"
    return port, jax, overrides


def _trainer(root, case):
    """A CPU Trainer on the case's dataset, recording every batch its step
    takes, and a port and a JAX twin of that dataset."""
    port, jax, overrides = _sources(root, case)
    cfg = preset("sht_ltn", **TINY, **overrides,
                 model_save_dir=f"{root}/ckpt")
    trainer = Trainer(cfg, store=object(), test_videos=[], device="cpu")
    trainer.dataset = port()
    seen = []
    step = trainer.step_fn

    def recording(state, *batch):
        seen.append([t.clone() for t in batch])
        return step(state, *batch)

    trainer.step_fn = recording
    return trainer, seen, port(), jax()


def _expect(batch, dtype):
    """A plain loop's numpy batch as the step takes it: the features in
    the wire's type."""
    return [torch.from_numpy(a).to(dtype if i in (0, 2) else None)
            for i, a in enumerate(batch)]


def _assert_batches(seen, want, dtype):
    assert len(seen) == len(want) > 0
    for got, batch in zip(seen, want):
        for t, e in zip(got, _expect(batch, dtype)):
            assert t.dtype == e.dtype and torch.equal(t, e)


def _assert_same_state(ds, twin):
    assert ds.rng.bit_generator.state == twin.rng.bit_generator.state
    np.testing.assert_array_equal(ds._norm_perm, twin._norm_perm)
    np.testing.assert_array_equal(ds._abnorm_perm, twin._abnorm_perm)


@pytest.mark.parametrize("case", CASES)
def test_epochs_equal_a_plain_loop_and_jax(tmp_path, case):
    trainer, seen, twin, ref = _trainer(str(tmp_path), case)
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    for epoch in range(5):
        seen.clear()
        m = trainer.train_epoch()
        want = list(BatchIterator(twin, 2))
        twin.shuffle_keys()
        jax_want = list(JaxBatchIterator(ref, 2))
        ref.shuffle_keys()
        assert m["batches"] == len(want) == len(jax_want) == 2
        for ours, theirs in zip(want, jax_want):
            for a, b in zip(ours, theirs):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        _assert_batches(seen, want, dtype)
        _assert_same_state(trainer.dataset, twin)
        assert trainer.dataset.rng.bit_generator.state == \
            ref.rng.bit_generator.state
        assert m["ahead_discarded"] == 0
        assert m["batches_ahead"] == (m["batches"] if epoch else 0)
        settle(trainer)
    trainer.close()


def test_epochs_equal_a_plain_loop_under_thread_switching(tmp_path):
    """Forty epochs back to back, nothing waited for, the interpreter
    switching threads every 10 us: whatever the worker has built when an
    epoch begins, the batches and the sampling state are a plain loop's.
    The step only records its batch."""
    trainer, seen, twin, _ = _trainer(str(tmp_path), "packed")
    trainer.step_fn = lambda state, *batch: (
        seen.append([t.clone() for t in batch]), (state, {}))[1]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        deadline = time.monotonic() + 60
        for _ in range(40):
            seen.clear()
            m = trainer.train_epoch()
            want = list(BatchIterator(twin, 2))
            twin.shuffle_keys()
            _assert_batches(seen, want, torch.float32)
            _assert_same_state(trainer.dataset, twin)
            assert m["ahead_discarded"] == 0
            assert time.monotonic() < deadline
    finally:
        sys.setswitchinterval(interval)
        trainer.close()


def _relabel(ds):
    ds.pseudo_labels = {r.key: np.full(ds.store.n_clips(r.key), 0.25,
                                       np.float32)
                        for r in ds.normal + ds.abnormal}


# what a caller changes between two epochs, and whether the prepared
# epoch survives it
CHANGES = {
    "rng": (lambda t, ds: setattr(ds, "rng", np.random.default_rng(99)),
            True),
    "labels": (lambda t, ds: _relabel(ds), True),
    "perm": (lambda t, ds: setattr(ds, "_norm_perm", ds._norm_perm[::-1]),
             True),
    "batch_size": (lambda t, ds: setattr(
        t, "cfg", replace(t.cfg, **{"data.batch_size": 3})), True),
    "rng_copy": (lambda t, ds: setattr(ds, "rng", copy.deepcopy(ds.rng)),
                 False),
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_a_changed_dataset_drops_the_prepared_epoch(tmp_path, change):
    """A caller that replaces the generator, the labels or a permutation,
    or changes the batch size, between two epochs: the prepared epoch is
    dropped and the epoch built from the dataset as it is, as a plain
    loop builds it; the next epoch is prepared again.  A generator
    replaced by a copy in the same state keeps it."""
    trainer, seen, twin, _ = _trainer(str(tmp_path), "items")
    edit, drops = CHANGES[change]
    trainer.train_epoch()
    list(BatchIterator(twin, 2))
    twin.shuffle_keys()
    settle(trainer)
    edit(trainer, trainer.dataset)
    if change != "batch_size":
        edit(trainer, twin)
    size = trainer.cfg.data.batch_size
    for epoch in range(2):
        seen.clear()
        m = trainer.train_epoch()
        want = list(BatchIterator(twin, size))
        twin.shuffle_keys()
        _assert_batches(seen, want, torch.float32)
        _assert_same_state(trainer.dataset, twin)
        dropped = drops and epoch == 0
        assert m["ahead_discarded"] == (2 if dropped else 0)
        assert m["batches_ahead"] == (0 if dropped else m["batches"])
        settle(trainer)
    trainer.close()


def _threads_back_to(before, timeout=30.0):
    deadline = time.monotonic() + timeout
    while threading.active_count() > before:
        assert time.monotonic() < deadline, "the batch worker still runs"
        time.sleep(0.05)


def test_dropping_the_trainer_ends_its_worker(tmp_path):
    before = threading.active_count()
    trainer, _, _, _ = _trainer(str(tmp_path), "items")
    trainer.train_epoch()
    settle(trainer)
    assert threading.active_count() == before + 1
    items = trainer._batches._worker._shared.items
    staged = [weakref.ref(t) for kind, value, _ in list(items.queue)
              if kind == "batch" for t in value[0]]
    assert len(staged) == 2 * 4
    del trainer, items
    _threads_back_to(before)
    assert all(ref() is None for ref in staged)


def test_fit_and_close_stop_the_worker(tmp_path):
    before = threading.active_count()
    trainer, _, _, _ = _trainer(str(tmp_path), "items")
    trainer.cfg = replace(trainer.cfg, eval_train_split=False)
    trainer.fit(2)
    _threads_back_to(before)
    trainer.train_epoch()  # a new worker, as from a fresh Trainer
    assert threading.active_count() == before + 1
    trainer.close()
    _threads_back_to(before)


def test_a_worker_error_reaches_train_epoch_and_ends_the_worker(tmp_path):
    before = threading.active_count()
    trainer, _, twin, _ = _trainer(str(tmp_path), "items")
    trainer.train_epoch()
    settle(trainer)

    class Gone:
        def get(self, key, crop=None):
            raise OSError("disk gone")

        def n_clips(self, key):
            return twin.store.n_clips(key)

    trainer.dataset.store = Gone()  # the prepared epoch is dropped too
    with pytest.raises(OSError, match="disk gone"):
        trainer.train_epoch()
    _threads_back_to(before)


def test_close_waits_for_a_build_in_flight_before_the_store_closes(
        tmp_path):
    """``train_epoch`` returns with the worker inside the pack's gather of
    the next epoch: ``Trainer.close`` returns only after that gather, with
    the thread ended, so the store can then be closed under no reader."""
    before = threading.active_count()
    trainer, _, _, _ = _trainer(str(tmp_path), "packed")
    store = trainer.dataset.store
    gather, calls, inside = store.gather_batch, [], []
    entered, release = threading.Event(), threading.Event()

    def held(*args, **kwargs):
        calls.append(1)
        inside.append(1)
        try:
            if len(calls) > 2:  # the next epoch's first gather
                entered.set()
                release.wait(30)
            return gather(*args, **kwargs)
        finally:
            inside.pop()

    store.gather_batch = held
    trainer.train_epoch()
    assert entered.wait(30)
    timer = threading.Timer(0.2, release.set)
    timer.start()
    trainer.close()
    assert release.is_set() and not inside
    timer.join()
    assert threading.active_count() == before
    store.close()


def test_fit_that_raises_stops_the_worker(tmp_path):
    """An evaluation's callback raises after the first epoch, while the
    worker builds the second: ``fit`` stops the worker on its way out."""
    before = threading.active_count()
    trainer, _, _, _ = _trainer(str(tmp_path), "items")
    trainer.cfg = replace(trainer.cfg, eval_train_split=False,
                          inter_epoch=1)

    def fail(trainer, result, entry):
        assert trainer._batches._worker is not None
        raise RuntimeError("stop here")

    with pytest.raises(RuntimeError, match="stop here"):
        trainer.fit(3, on_eval=fail)
    assert trainer._batches._worker is None
    assert threading.active_count() == before
