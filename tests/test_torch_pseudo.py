"""The PyTorch package's pseudo-label generators against the JAX package's
(lstc_vad_tpu/pseudo/generator.py), on the fuzz shapes of
tests/test_pseudo_parity.py and on tests/fixtures.py::make_ucf_like with
videos longer than 32 clips (the regression of
tests/test_pseudo_coteach.py:100-131).

Both sides score the same features with the same weights (JAX init, mapped
by ckpt/interop.py).  The raw scores (a threshold of -1 keeps every entry)
agree within atol 2e-5, the tolerance of tests/test_pseudo_parity.py.  The
thresholds sit at the median raw score, so both kept and zeroed entries
occur; the thresholded labels agree within 2e-5, and their zero patterns
are equal apart from entries whose reference score lies within 2e-5 of the
threshold.
"""

import jax
import numpy as np
import pytest

from fixtures import make_ucf_like
from lstc_vad_tpu.config import preset as jax_preset
from lstc_vad_tpu.data.annotations import TrainRecord
from lstc_vad_tpu.data.datasets import (load_pseudo_labels as
                                        jax_load_pseudo_labels)
from lstc_vad_tpu.data.datasets import load_train_records
from lstc_vad_tpu.data.feature_store import FeatureStore as JaxFeatureStore
from lstc_vad_tpu.evaluation import scoring as jax_scoring
from lstc_vad_tpu.models import Encoder as JaxEncoder
from lstc_vad_tpu.models import make_head as jax_make_head
from lstc_vad_tpu.pseudo import generator as jax_generator
from lstc_vad_tpu_torch.config import preset as port_preset
from lstc_vad_tpu_torch.data import FeatureStore, load_pseudo_labels
from lstc_vad_tpu_torch.pseudo import (generate_ltn_pseudo_labels,
                                       generate_stn_pseudo_labels,
                                       pseudo_scorer, save_pseudo_labels)

from test_torch_eval_slice import _port_models

ATOL = 2e-5
SMALL = {"encoder.d_model": 16, "encoder.d_inner": 24, "encoder.n_head": 2,
         "encoder.d_k": 8, "encoder.d_v": 8, "encoder.n_layers": 1,
         "head.d_model": 16, "head.hidden_dim": 8, "data.d_model": 16}


class ArrayStore:
    def __init__(self, videos):
        self.videos = videos

    def get(self, key):
        return self.videos[key]

    def n_clips(self, key):
        return self.videos[key].shape[0]


def models(preset_name, **overrides):
    """A small preset's JAX config, (encoder, head, params) and the port's
    modules holding the same weights."""
    cfg = jax_preset(preset_name, **{**SMALL, **overrides})
    d = cfg.data
    enc = JaxEncoder(cfg.encoder)
    head = jax_make_head(cfg.head.kind, cfg.head.d_model, cfg.head.hidden_dim)
    n_tok = d.n_patch * (1 if cfg.model == "stn" else d.part_len)
    x = np.zeros((1, n_tok, d.d_model), np.float32)
    params = {"encoder": enc.init(jax.random.PRNGKey(0), x)["params"],
              "head": head.init(jax.random.PRNGKey(1), x[:, 0])["params"]}
    params = jax.tree.map(np.asarray, params)
    return cfg, (enc, head, params), _port_models(cfg, params)


def port_scorer(preset_name, modules, **overrides):
    """The port's pseudo-label scorer of the same small preset."""
    return pseudo_scorer(port_preset(preset_name, **{**SMALL, **overrides}),
                         *modules)


def fuzz_videos(rng, n_patch, lengths):
    videos = {f"v{i}": rng.standard_normal((n, n_patch, 16)).astype(
        np.float32) for i, n in enumerate(lengths)}
    records = [TrainRecord(key=k, is_abnormal=(i % 2 == 0))
               for i, k in enumerate(videos)]
    return ArrayStore(videos), records


def median_threshold(raw):
    return float(np.median(np.concatenate(list(raw.values()))))


def assert_labels_match(ours, ref, raw_ref, tau, atol=ATOL):
    """Thresholded dicts: same keys and shapes; values within ``atol``;
    zero patterns equal outside ``atol`` of ``tau``; both kept and zeroed
    entries present."""
    assert ours.keys() == ref.keys()
    kept = zeroed = 0
    for key, want in ref.items():
        got, raw = ours[key], raw_ref[key]
        assert got.shape == want.shape == raw.shape, key
        assert got.dtype == np.float32
        clear = np.abs(raw - tau) > atol
        np.testing.assert_array_equal(got[clear] == 0, want[clear] == 0,
                                      err_msg=key)
        np.testing.assert_allclose(got[clear], want[clear], rtol=0,
                                   atol=atol, err_msg=key)
        assert ((got == 0) | (got > tau)).all()
        kept += int((want[clear] > 0).sum())
        zeroed += int((want[clear] == 0).sum())
    assert kept and zeroed, (kept, zeroed)


def assert_raw_match(ours, ref, atol=ATOL):
    assert ours.keys() == ref.keys()
    for key, want in ref.items():
        np.testing.assert_allclose(ours[key], want, rtol=0, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("kind", ["regressor", "classifier"])
def test_stn_generator_matches_jax(kind):
    overrides = {"data.n_patch": 4, "head.kind": kind}
    cfg, (jenc, jhead, params), modules = models("sht_stn", **overrides)
    store, records = fuzz_videos(np.random.default_rng(0), 4,
                                 [5, 14, 1, 9, 12, 7])
    ref_scorer = jax_scoring.ClipScorer(jenc, jhead, 4, kind=kind)
    scorer = port_scorer("sht_stn", modules, **overrides)
    raw_ref = jax_generator.generate_stn_pseudo_labels(
        params, ref_scorer, store, records, -1.0)
    assert_raw_match(generate_stn_pseudo_labels(scorer, store, records, -1.0),
                     raw_ref)
    tau = median_threshold(raw_ref)
    ref = jax_generator.generate_stn_pseudo_labels(params, ref_scorer, store,
                                                   records, tau)
    ours = generate_stn_pseudo_labels(scorer, store, records, tau)
    assert_labels_match(ours, ref, raw_ref, tau)
    for rec in records:  # one score per clip
        assert ours[rec.key + ".npy"].shape == (store.n_clips(rec.key),)


def test_ltn_generator_matches_jax():
    """SHT/UBnormal: parts without tail re-window, each part's score over
    its clip count (videos shorter than a part and with short tails)."""
    cfg, (jenc, jhead, params), modules = models("sht_ltn",
                                                 **{"data.n_patch": 4})
    pl = cfg.data.part_len
    store, records = fuzz_videos(np.random.default_rng(1), 4,
                                 [5, 15, 2, 9, 13, 1, 11, 30])
    ref_scorer = jax_scoring.PartScorer(jenc, jhead, pl, 4,
                                        tail_rewindow=False)
    scorer = port_scorer("sht_ltn", modules, **{"data.n_patch": 4})
    raw_ref = jax_generator.generate_ltn_pseudo_labels(
        params, ref_scorer, store, records, -1.0)
    assert_raw_match(generate_ltn_pseudo_labels(scorer, store, records, -1.0),
                     raw_ref)
    tau = median_threshold(raw_ref)
    ref = jax_generator.generate_ltn_pseudo_labels(params, ref_scorer, store,
                                                   records, tau)
    ours = generate_ltn_pseudo_labels(scorer, store, records, tau)
    assert_labels_match(ours, ref, raw_ref, tau)
    for rec in records:  # constant within each full part
        labels = ours[rec.key + ".npy"]
        assert labels.shape == (store.n_clips(rec.key),)
        for p in range(len(labels) // pl):
            assert (labels[p * pl:(p + 1) * pl] == labels[p * pl]).all()


@pytest.mark.parametrize("max_clips", [8, 32])
def test_ltn_generator_ucf_branch_matches_jax(tmp_path, max_clips):
    """UCF: part scores expanded over their bins' clip widths, padded with
    the last value and trimmed to the stored clip count — clip resolution
    for videos longer than the bin count."""
    h5, train_txt, _, _ = make_ucf_like(str(tmp_path), n_normal=4,
                                        n_abnormal=4, n_patch=9, d_model=16,
                                        n_clips=(35, 60))
    cfg, (jenc, jhead, params), modules = models("ucf_ltn",
                                                 max_clips=max_clips)
    d = cfg.data
    records = load_train_records("UCF", train_txt)
    jstore, store = JaxFeatureStore(h5), FeatureStore(h5)
    kw = dict(max_clips=max_clips, l2_normalize=False, tail_rewindow=False)
    ref_scorer = jax_scoring.UCFBinnedScorer(jenc, jhead, d.part_len,
                                             d.n_patch, **kw)
    scorer = port_scorer("ucf_ltn", modules, max_clips=max_clips)

    def ref(tau):
        return jax_generator.generate_ltn_pseudo_labels(
            params, ref_scorer, jstore, records, tau, dataset="UCF")

    def ours(tau):
        return generate_ltn_pseudo_labels(scorer, store, records, tau,
                                          dataset="UCF")

    raw_ref = ref(-1.0)
    assert_raw_match(ours(-1.0), raw_ref)
    tau = median_threshold(raw_ref)
    got = ours(tau)
    assert_labels_match(got, ref(tau), raw_ref, tau)
    for rec in records:
        assert len(got[rec.key + ".npy"]) == store.n_clips(rec.key) > 32
    jstore.close()
    store.close()


def test_pseudo_files_cross_load(tmp_path):
    """A file the port saves is what the JAX package's loader reads, and
    the other way round."""
    rng = np.random.default_rng(3)
    pseudo = {f"k{i}.npy": rng.random(n).astype(np.float32)
              for i, n in enumerate([3, 17, 1])}
    ours, theirs = str(tmp_path / "port.npy"), str(tmp_path / "jax.npy")
    save_pseudo_labels(ours, pseudo)
    jax_generator.save_pseudo_labels(theirs, pseudo)
    for loaded in (jax_load_pseudo_labels(ours), load_pseudo_labels(theirs)):
        assert loaded.keys() == pseudo.keys()
        for k, v in pseudo.items():
            np.testing.assert_array_equal(loaded[k], v)
            assert loaded[k].dtype == np.float32
