"""The PyTorch package's co-teaching driver against the JAX package's
(lstc_vad_tpu/pseudo/coteach.py): three rounds — STN, LTN on the STN's
labels, STN-BCE on the LTN's — on tests/fixtures.py::make_sht_like and on
make_ucf_like (the pattern of tests/test_pseudo_coteach.py:76-97, 151-187).

Every dropout is off, and each port round starts from the weights the JAX
round started from: a test-local driver subclass loads them in
``_trainer``.  Per-round losses agree at rel 2e-4 and AUCs within 1e-4; the
artifacts' values within 1e-4, and an entry kept on one side and zeroed on
the other must lie within 1e-4 of the threshold.  The thresholds sit near
the median raw score of these small models, so both kept and zeroed entries
occur.
"""

import json
import os

import jax
import numpy as np
import pytest

from fixtures import make_sht_like, make_ucf_like
from lstc_vad_tpu.config import (DataConfig, EncoderConfig, HeadConfig,
                                 TrainConfig)
from lstc_vad_tpu.config import replace as jax_replace
from lstc_vad_tpu.pseudo import CoTeachingDriver as JaxDriver
from lstc_vad_tpu_torch.ckpt.interop import state_dict_from_jax
from lstc_vad_tpu_torch.data import FeatureStore, load_test_videos
from lstc_vad_tpu_torch.pseudo import CoTeachingDriver

from test_torch_train_step import port_config

ATOL = 1e-4
SMALL_ENC = dict(d_model=16, d_inner=32, n_head=2, d_k=8, d_v=8, n_layers=1,
                 attn_impl="xla", attn_dropout=0.0, fc_dropout=0.0,
                 ffn_dropout=0.0, position_dropout=0.0)


class RecordingJaxDriver(JaxDriver):
    """Keeps each round's initial weights."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.initial = []

    def _trainer(self, cfg):
        trainer = super()._trainer(cfg)
        self.initial.append(jax.tree.map(np.asarray, trainer.state.params))
        return trainer


class FromJaxDriver(CoTeachingDriver):
    """Starts each round from the JAX round's initial weights."""

    def __init__(self, *args, initial, **kw):
        super().__init__(*args, **kw)
        self._initial = list(initial)

    def _trainer(self, cfg):
        trainer = super()._trainer(cfg)
        params = self._initial.pop(0)
        enc_sd, head_sd = state_dict_from_jax(params["encoder"],
                                              params["head"], cfg.encoder,
                                              cfg.head.kind)
        trainer.state.encoder.load_state_dict(enc_sd, strict=True)
        trainer.state.head.load_state_dict(head_sd, strict=True)
        return trainer


def _cfg(root, model, data, **kw):
    ltn = model == "ltn"
    enc = EncoderConfig(ffn_layernorm=True, mha_layernorm=ltn,
                        relative_pe=ltn, window_size=4,
                        window_depth=data.part_len if ltn else 3,
                        weight_init=not ltn, **SMALL_ENC)
    head = HeadConfig(kind="classifier" if ltn else "regressor", d_model=16,
                      hidden_dim=8, dropout=0.0)
    return TrainConfig(model=model, encoder=enc, head=head, data=data,
                       epochs=1, inter_epoch=1, save_threshold=2.0,
                       model_save_dir=os.path.join(root, "ckpt"), **kw)


def sht_configs(root):
    h5, train_txt, test_txt, mask_dir = make_sht_like(
        root, n_patch=4, d_model=16, n_clips=(14, 30))
    data = DataConfig(dataset="SHT", h5_path=h5, train_txt=train_txt,
                      test_txt=test_txt, test_mask_dir=mask_dir + "/",
                      n_patch=4, d_model=16, part_num=4, part_len=3,
                      batch_size=2)
    return _cfg(root, "stn", data), _cfg(root, "ltn", data)


def ucf_configs(root):
    h5, train_txt, test_txt, gt_h5 = make_ucf_like(
        root, n_patch=3, d_model=16, n_clips=(8, 40))
    data = DataConfig(dataset="UCF", h5_path=h5, train_txt=train_txt,
                      test_txt=test_txt, test_mask_h5=gt_h5, n_patch=3,
                      d_model=16, part_num=4, part_len=5, batch_size=2,
                      eager=False)
    kw = dict(eval_train_split=False, max_clips=8)
    return (_cfg(root, "stn", data, **kw),
            _cfg(root, "ltn", jax_replace(data, part_len=2), **kw))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _assert_artifact_matches(ours_path, ref_path, tau):
    ours = np.load(ours_path, allow_pickle=True).tolist()
    ref = np.load(ref_path, allow_pickle=True).tolist()
    assert ours.keys() == ref.keys()
    kept = zeroed = 0
    for key, want in ref.items():
        got = ours[key]
        assert got.shape == want.shape and got.dtype == np.float32
        flipped = (got == 0) != (want == 0)
        # kept on one side, zeroed on the other: only at the threshold
        assert (np.abs(np.maximum(got, want)[flipped] - tau) <= ATOL).all()
        np.testing.assert_allclose(got[~flipped], want[~flipped], rtol=0,
                                   atol=ATOL, err_msg=key)
        kept += int((want > 0).sum())
        zeroed += int((want == 0).sum())
    assert kept and zeroed, (kept, zeroed)


def _run_both(tmp_path, configs, stn_threshold, ltn_threshold):
    jstn, jltn = configs(str(tmp_path / "data"))
    ref_log, log = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    ref = RecordingJaxDriver(jax_replace(jstn, metrics_jsonl=ref_log),
                             jax_replace(jltn, metrics_jsonl=ref_log),
                             str(tmp_path / "jax"), stn_threshold,
                             ltn_threshold)
    ref_trainers = ref.run(rounds=3, stn_epochs=2, ltn_epochs=2)
    ours = FromJaxDriver(port_config(jax_replace(jstn, metrics_jsonl=log)),
                         port_config(jax_replace(jltn, metrics_jsonl=log)),
                         str(tmp_path / "port"), stn_threshold,
                         ltn_threshold, device="cpu", initial=ref.initial)
    trainers = ours.run(rounds=3, stn_epochs=2, ltn_epochs=2)

    assert [t.cfg.model for t in trainers] == \
        [t.cfg.model for t in ref_trainers] == ["stn", "ltn", "stn_bce"]
    assert trainers[1].cfg.data.pseudo_labels_path == ours.stn_pseudo_path
    assert trainers[2].cfg.data.pseudo_labels_path == ours.ltn_pseudo_path
    assert not trainers[1].cfg.eval_tail_rewindow
    got, want = _records(log), _records(ref_log)
    assert [r["kind"] for r in got] == [r["kind"] for r in want] == \
        ["train", "eval"] * 6
    for g, w in zip(got, want):
        if g["kind"] == "train":
            assert g["loss"] == pytest.approx(w["loss"], rel=2e-4)
        else:
            assert abs(g["auc_test"] - w["auc_test"]) <= 1e-4
            assert abs(g["auc_train"] - w["auc_train"]) <= 1e-4
    _assert_artifact_matches(ours.stn_pseudo_path, ref.stn_pseudo_path,
                             stn_threshold)
    _assert_artifact_matches(ours.ltn_pseudo_path, ref.ltn_pseudo_path,
                             ltn_threshold)
    # the rounds share one store and one test split
    assert trainers[0].store is trainers[1].store is trainers[2].store
    assert trainers[0].test_videos is trainers[1].test_videos \
        is trainers[2].test_videos
    assert [r["model"] for r in ours.rounds] == ["stn", "ltn", "stn_bce"]
    assert all(r["pseudo_encoder_calls"] >= 1 and 0 < r["kept"] < 1
               for r in ours.rounds)
    return trainers, ours


def test_coteaching_three_rounds_matches_jax(tmp_path):
    trainers, driver = _run_both(tmp_path, sht_configs, 0.555, 0.34)
    # one entry per train video, one value per clip
    pseudo = np.load(driver.stn_pseudo_path, allow_pickle=True).tolist()
    assert {k[:-4] for k in pseudo} == {r.key for r in
                                        trainers[0].train_records}
    for key, labels in pseudo.items():
        assert len(labels) == trainers[0].store.n_clips(key[:-4])


def test_coteaching_ucf_three_rounds_matches_jax(tmp_path):
    trainers, driver = _run_both(tmp_path, ucf_configs, 0.5, 0.39)
    # the STN-BCE round evaluates with 21 bins (spatio_transformer_MIL_CE.py
    # :230); its labels are at clip resolution whatever a video's length
    assert trainers[2].cfg.max_clips == 21 and trainers[0].cfg.max_clips == 8
    assert trainers[2].scorer.max_clips == 21
    pseudo = np.load(driver.ltn_pseudo_path, allow_pickle=True).tolist()
    for key, labels in pseudo.items():
        assert len(labels) == trainers[0].store.n_clips(key[:-4])


def test_callers_store_and_split_serve_every_round(tmp_path):
    jstn, jltn = sht_configs(str(tmp_path / "data"))
    store = FeatureStore(jstn.data.h5_path)
    videos = load_test_videos("SHT", jstn.data.test_txt, store,
                              mask_dir=jstn.data.test_mask_dir)
    driver = CoTeachingDriver(port_config(jstn), port_config(jltn),
                              str(tmp_path / "w"), 0.555, 0.34,
                              device="cpu", store=store, test_videos=videos)
    trainers = driver.run(rounds=2, stn_epochs=1, ltn_epochs=1)
    assert all(t.store is store and t.test_videos is videos
               for t in trainers)
    assert os.path.exists(driver.stn_pseudo_path)
    assert os.path.exists(driver.ltn_pseudo_path)
    store.close()


def test_driver_needs_a_card_unless_told_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    jstn, jltn = sht_configs(str(tmp_path / "data"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        CoTeachingDriver(port_config(jstn), port_config(jltn),
                         str(tmp_path / "w"))
