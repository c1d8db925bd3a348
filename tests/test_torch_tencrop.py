"""tenCrop stores in the PyTorch package against the JAX package, on
tests/fixtures.py::make_sht_like(ten_crop=True): the store's layout and
``CropView``, paired training batches (the pair-shared crop draw and UCF's
per-video draw, bit-equal), a tenCrop STN ``fit(2)`` against the JAX Trainer
(tests/test_train_e2e.py:138, every dropout off), the pinned
``GOLDEN_TENCROP`` AUCs (tests/test_golden_pipeline.py:172-212) reached
through the port's Trainer, ``evaluate --eval-crop 0|mean`` against the JAX
``cmd_evaluate`` (frame scores within 1e-5, AUC within 1e-4, the bar of
tests/test_torch_eval_slice.py), pseudo labels through ``CropView`` against
the JAX generator (atol 2e-5, tests/test_torch_pseudo.py) and three
co-teaching rounds against the JAX driver (tests/test_torch_coteach.py).
"""

import contextlib
import io

import jax
import numpy as np
import pytest

from fixtures import make_sht_like
from lstc_vad_tpu.ckpt.torch_export import save_torch_checkpoint
from lstc_vad_tpu.cli.main import main as jax_main
from lstc_vad_tpu.config import (DataConfig, EncoderConfig, HeadConfig,
                                 TrainConfig)
from lstc_vad_tpu.config import preset as jax_preset
from lstc_vad_tpu.config import replace as jax_replace
from lstc_vad_tpu.data import datasets as jd
from lstc_vad_tpu.data.feature_store import CropView as JaxCropView
from lstc_vad_tpu.data.feature_store import FeatureStore as JaxStore
from lstc_vad_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from lstc_vad_tpu.evaluation import scoring as jax_scoring
from lstc_vad_tpu.models import Encoder as JaxEncoder
from lstc_vad_tpu.models import make_head as jax_make_head
from lstc_vad_tpu.pseudo import generator as jax_generator
from lstc_vad_tpu.train.driver import Trainer as JaxTrainer
from lstc_vad_tpu_torch import cli
from lstc_vad_tpu_torch.ckpt.interop import state_dict_from_jax
from lstc_vad_tpu_torch.data import datasets as pd
from lstc_vad_tpu_torch.data import synthetic
from lstc_vad_tpu_torch.data.feature_store import CropView, FeatureStore
from lstc_vad_tpu_torch.data.pipeline import BatchIterator
from lstc_vad_tpu_torch.evaluation.drivers import (evaluate_multicrop_mean,
                                                   evaluate_stn)
from lstc_vad_tpu_torch.pseudo import (generate_ltn_pseudo_labels,
                                       generate_stn_pseudo_labels)
from lstc_vad_tpu_torch.train.driver import Trainer

import test_torch_coteach as coteach
from test_golden_pipeline import GOLDEN_TENCROP, SMALL_ENC
from test_torch_pseudo import (assert_labels_match, assert_raw_match,
                               median_threshold, models, port_scorer)
from test_torch_train_step import flat_from_jax, named_params, port_config

SMALL = {"encoder.d_model": 32, "encoder.d_inner": 48, "encoder.n_head": 2,
         "encoder.d_k": 16, "encoder.d_v": 16, "encoder.n_layers": 2,
         "head.d_model": 32, "head.hidden_dim": 16, "data.n_patch": 16,
         "data.d_model": 32, "data.ten_crop": True}
SET_FLAGS = [a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]


@pytest.fixture(scope="module")
def tencrop(tmp_path_factory):
    """A tenCrop set at 4 patches x 16 (h5, train_txt, test_txt, masks)."""
    return make_sht_like(str(tmp_path_factory.mktemp("tc")), n_patch=4,
                         d_model=16, n_clips=(14, 30), ten_crop=True)


@pytest.fixture(scope="module")
def tencrop_wide(tmp_path_factory):
    """The same layout at the SMALL eval width (16 patches x 32)."""
    return make_sht_like(str(tmp_path_factory.mktemp("tcw")), n_patch=16,
                         d_model=32, ten_crop=True)


def test_store_layout_and_crop_view_equal_jax(tencrop):
    h5, train_txt, _, _ = tencrop
    ours = FeatureStore(h5, ten_crop=True, n_patch=4, d_model=16)
    ref = JaxStore(h5, ten_crop=True, n_patch=4, d_model=16)
    for rec in pd.load_train_records("SHT", train_txt):
        full = ours.get(rec.key)
        assert full.ndim == 4 and full.shape[1:] == (10, 4, 16)
        np.testing.assert_array_equal(full, ref.get(rec.key))
        assert ours.n_clips(rec.key) == ref.n_clips(rec.key) == len(full)
        for crop in (0, 7):
            np.testing.assert_array_equal(ours.get(rec.key, crop=crop),
                                          ref.get(rec.key, crop=crop))
            view, ref_view = CropView(ours, crop), JaxCropView(ref, crop)
            np.testing.assert_array_equal(view.get(rec.key),
                                          ref_view.get(rec.key))
            assert view.get(rec.key).shape == (len(full), 4, 16)
            assert view.n_clips(rec.key) == len(full)
    eager = FeatureStore(h5, ten_crop=True, n_patch=4, d_model=16,
                         eager_keys=[rec.key])
    np.testing.assert_array_equal(eager.get(rec.key, crop=2),
                                  ref.get(rec.key, crop=2))
    for s in (ours, ref, eager):
        s.close()


@pytest.mark.parametrize("crop_per_video", [False, True])
def test_paired_tencrop_batches_equal_jax(tencrop, crop_per_video):
    """The crop is drawn from the dataset's generator between the index
    plans: shared by a pair (SHT/UBnormal) or per video (UCF, with its
    short-video doubling): the batches stay bit-equal to JAX."""
    h5, train_txt, _, _ = tencrop
    records = pd.load_train_records("SHT", train_txt)
    kw = dict(part_num=3, part_len=2, n_patch=2, sample="uniform",
              ten_crop=True, double_short=crop_per_video,
              crop_per_video=crop_per_video, seed=5)
    ours = pd.PairedTrainDataset(
        records, FeatureStore(h5, ten_crop=True, n_patch=4, d_model=16),
        **kw)
    ref = jd.PairedTrainDataset(
        records, JaxStore(h5, ten_crop=True, n_patch=4, d_model=16), **kw)
    for _ in range(3):
        got = list(BatchIterator(ours, 2, drop_last=False))
        want = list(JaxBatchIterator(ref, 2, drop_last=False))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g[0].shape[1:] == (6, 2, 16)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        ours.shuffle_keys()
        ref.shuffle_keys()
    assert ours.rng.bit_generator.state == ref.rng.bit_generator.state


def _stn_cfg(fixture, tmp_path, **kw):
    """The tenCrop STN config of tests/test_train_e2e.py:138."""
    h5_path, train_txt, test_txt, mask_dir = fixture
    enc = EncoderConfig(ffn_layernorm=True, **SMALL_ENC)
    return TrainConfig(
        model="stn", encoder=enc,
        head=HeadConfig(kind="regressor", d_model=16, hidden_dim=8),
        data=DataConfig(dataset="SHT", h5_path=h5_path, train_txt=train_txt,
                        test_txt=test_txt, test_mask_dir=mask_dir + "/",
                        n_patch=4, d_model=16, part_num=4, part_len=3,
                        batch_size=2, ten_crop=True, eval_crop=0),
        epochs=2, inter_epoch=1, save_threshold=2.0, eval_train_split=False,
        model_save_dir=str(tmp_path / "ckpt"), **kw)


def _load(trainer, params):
    """Load JAX ``params`` into the port Trainer's modules."""
    enc_sd, head_sd = state_dict_from_jax(params["encoder"], params["head"],
                                          trainer.cfg.encoder,
                                          trainer.cfg.head.kind)
    trainer.state.encoder.load_state_dict(enc_sd, strict=True)
    trainer.state.head.load_state_dict(head_sd, strict=True)


def test_tencrop_stn_fit_matches_jax(tencrop, tmp_path):
    cfg = _stn_cfg(tencrop, tmp_path)
    cfg = jax_replace(cfg, **{k: 0.0 for k in (
        "encoder.attn_dropout", "encoder.fc_dropout", "encoder.ffn_dropout",
        "encoder.position_dropout", "head.dropout")})
    jtrainer = JaxTrainer(cfg)
    trainer = Trainer(port_config(cfg), device="cpu")
    _load(trainer, jax.tree.map(np.asarray, jtrainer.state.params))
    ref, ours = jtrainer.fit(2), trainer.fit(2)
    assert ours.steps == ref.steps == 2
    for got, want in zip(ours.history, ref.history):
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-4)
        assert abs(got["auc_test"] - want["auc_test"]) <= 1e-4
    final = flat_from_jax(jax.tree.map(np.asarray, jtrainer.state.params),
                          "regressor")
    params = named_params(trainer.state)
    for name, want in final.items():
        np.testing.assert_allclose(params[name].detach().numpy(), want,
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_golden_tencrop_aucs_through_the_port_trainer(tmp_path):
    """The JAX Trainer's golden run (its dropout masks are its own), then
    the port's Trainer on those weights: the crop-0 evaluation and the
    10-crop mean give the pinned AUCs."""
    fixture = make_sht_like(str(tmp_path), n_patch=4, d_model=16,
                            n_clips=(14, 30), seed=7, ten_crop=True)
    cfg = jax_replace(_stn_cfg(fixture, tmp_path), inter_epoch=10,
                      seed=3, **{"encoder.weight_init": True,
                                 "data.seed": 11})
    jtrainer = JaxTrainer(cfg)
    jtrainer.fit(epochs=2)
    assert jtrainer.evaluate("test") == pytest.approx(
        GOLDEN_TENCROP["crop0"], abs=1e-6)
    trainer = Trainer(port_config(cfg), device="cpu", eval_only=True)
    _load(trainer, jax.tree.map(np.asarray, jtrainer.state.params))
    assert trainer.evaluate("test") == pytest.approx(
        GOLDEN_TENCROP["crop0"], abs=1e-4)

    def items_for_crop(c):
        return [((lambda v=v, c=c: v.feat[:, c]), v.anno)
                for v in trainer.test_videos]

    mean = evaluate_multicrop_mean(evaluate_stn, trainer.scorer,
                                   items_for_crop, cfg.data.segment_len)
    assert mean == pytest.approx(GOLDEN_TENCROP["mean"], abs=1e-4)


def test_tencrop_evaluation_needs_an_explicit_crop(tencrop, tmp_path):
    cfg = port_config(jax_replace(_stn_cfg(tencrop, tmp_path),
                                  **{"data.eval_crop": None}))
    trainer = Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="eval_crop"):
        trainer.evaluate("test")
    from lstc_vad_tpu_torch.config import replace

    trainer = Trainer(replace(cfg, **{"data.eval_crop": 3}), device="cpu")
    assert 0.0 <= trainer.evaluate("test") <= 1.0
    # the crop's features, 3-D, reach the scorer
    feat = trainer._test_items()[0][0]()
    np.testing.assert_array_equal(feat, trainer.test_videos[0].feat[:, 3])


def _jax_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_main(argv) == 0
    return out.getvalue()


def _port_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main([*argv, "--device", "cpu"]) == 0
    return out.getvalue()


def _auc(stdout):
    return float([ln for ln in stdout.splitlines()
                  if ln.startswith("auc = ")][-1].split("=")[1])


def _reference_ckpt(preset_name, root):
    """JAX weights of the small preset as the reference's two files."""
    cfg = jax_preset(preset_name, **SMALL)
    d = cfg.data
    enc = JaxEncoder(cfg.encoder)
    head = jax_make_head(cfg.head.kind, cfg.head.d_model, cfg.head.hidden_dim)
    n_tok = d.n_patch * (1 if cfg.model == "stn" else d.part_len)
    x = np.zeros((1, n_tok, d.d_model), np.float32)
    params = {"encoder": enc.init(jax.random.PRNGKey(0), x)["params"],
              "head": head.init(jax.random.PRNGKey(1), x[:, 0])["params"]}
    enc_path, head_path = str(root / "e.ckpt"), str(root / "h.ckpt")
    save_torch_checkpoint(jax.tree.map(np.asarray, params), enc_path,
                          head_path, cfg.head.kind, encoder_cfg=cfg.encoder)
    return ["--torch-ckpt", "--encoder-ckpt", enc_path, "--head-ckpt",
            head_path]


@pytest.mark.parametrize("preset_name,crop", [("sht_ltn", "0"),
                                              ("sht_ltn", "mean"),
                                              ("sht_stn", "mean")])
def test_evaluate_eval_crop_matches_jax(tencrop_wide, tmp_path, preset_name,
                                        crop):
    h5, _, test_txt, mask_dir = tencrop_wide
    args = ["evaluate", "--preset", preset_name, "--h5", h5, "--test-txt",
            test_txt, "--mask-dir", mask_dir, "--eval-crop", crop,
            *_reference_ckpt(preset_name, tmp_path), *SET_FLAGS]
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "jax.npz")
    ref = _jax_cli([*args, "--dump-scores", theirs])
    got = _port_cli([*args, "--dump-scores", ours])
    assert abs(_auc(got) - _auc(ref)) <= 1e-4
    got_scores, want_scores = np.load(ours), np.load(theirs)
    assert sorted(got_scores.files) == sorted(want_scores.files)
    for key in want_scores.files:
        np.testing.assert_allclose(got_scores[key], want_scores[key], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("kind", ["stn", "ltn"])
def test_tencrop_pseudo_labels_through_crop_view_match_jax(tencrop, kind):
    h5, train_txt, _, _ = tencrop
    name = f"sht_{kind}"
    overrides = {"data.n_patch": 4}
    cfg, (jenc, jhead, params), modules = models(name, **overrides)
    records = pd.load_train_records("SHT", train_txt)
    store = CropView(FeatureStore(h5, ten_crop=True, n_patch=4, d_model=16),
                     3)
    ref_store = JaxCropView(JaxStore(h5, ten_crop=True, n_patch=4,
                                     d_model=16), 3)
    scorer = port_scorer(name, modules, **overrides)
    if kind == "stn":
        ref_scorer = jax_scoring.ClipScorer(jenc, jhead, 4,
                                            kind=cfg.head.kind)

        def ref_gen(tau):
            return jax_generator.generate_stn_pseudo_labels(
                params, ref_scorer, ref_store, records, tau)

        def gen(tau):
            return generate_stn_pseudo_labels(scorer, store, records, tau)
    else:
        ref_scorer = jax_scoring.PartScorer(jenc, jhead, cfg.data.part_len,
                                            4, tail_rewindow=False)

        def ref_gen(tau):
            return jax_generator.generate_ltn_pseudo_labels(
                params, ref_scorer, ref_store, records, tau)

        def gen(tau):
            return generate_ltn_pseudo_labels(scorer, store, records, tau)
    raw_ref = ref_gen(-1.0)
    assert_raw_match(gen(-1.0), raw_ref)
    tau = median_threshold(raw_ref)
    assert_labels_match(gen(tau), ref_gen(tau), raw_ref, tau)
    for rec in records:  # one label per clip of the crop
        assert raw_ref[rec.key + ".npy"].shape == (store.n_clips(rec.key),)


def test_gen_pseudo_cli_reads_the_eval_crop(tencrop_wide, tmp_path):
    h5, train_txt, _, _ = tencrop_wide
    out = str(tmp_path / "stn.npy")
    _port_cli(["gen-pseudo", "--preset", "sht_stn", "--kind", "stn",
               "--h5", h5, "--train-txt", train_txt, "--threshold", "-1",
               "--out", out, "--set", "data.eval_crop=2", *SET_FLAGS])
    from lstc_vad_tpu_torch.config import preset
    from lstc_vad_tpu_torch.data import load_pseudo_labels
    from lstc_vad_tpu_torch.pseudo import pseudo_scorer
    from lstc_vad_tpu_torch.train.state import create_train_state

    cfg = preset("sht_stn", **SMALL)
    state = create_train_state(cfg, device="cpu")
    store = FeatureStore(h5, ten_crop=True, n_patch=16, d_model=32)
    records = pd.load_train_records("SHT", train_txt)
    want = generate_stn_pseudo_labels(
        pseudo_scorer(cfg, state.encoder.eval(), state.head.eval()),
        CropView(store, 2), records, -1.0)
    got = load_pseudo_labels(out)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)


def tencrop_configs(root):
    h5, train_txt, test_txt, mask_dir = make_sht_like(
        root, n_patch=4, d_model=16, n_clips=(14, 30), ten_crop=True)
    data = DataConfig(dataset="SHT", h5_path=h5, train_txt=train_txt,
                      test_txt=test_txt, test_mask_dir=mask_dir + "/",
                      n_patch=4, d_model=16, part_num=4, part_len=3,
                      batch_size=2, ten_crop=True, eval_crop=1)
    return coteach._cfg(root, "stn", data), coteach._cfg(root, "ltn", data)


def test_tencrop_coteaching_three_rounds_matches_jax(tmp_path):
    """Training draws crops, evaluations and pseudo labels read crop 1
    (``CropView``): three rounds as the JAX driver runs them."""
    trainers, driver = coteach._run_both(tmp_path, tencrop_configs, 0.5,
                                         0.4)
    pseudo = np.load(driver.stn_pseudo_path, allow_pickle=True).tolist()
    for key, labels in pseudo.items():
        assert len(labels) == trainers[0].store.n_clips(key[:-4])


def test_synthetic_tencrop_split_layout(monkeypatch):
    monkeypatch.setattr(synthetic, "D_FEAT", 4)
    store, videos, records, masks = synthetic.sht_tencrop_test_split(0)
    assert len(videos) == len(records) == 107
    assert sum(v.is_abnormal for v in videos) == 44 == len(masks)
    for v, r in zip(videos, records):
        assert (r.key, r.is_abnormal) == (v.key, v.is_abnormal)
        assert v.feat.shape == (v.n_clips, 10, 16, 4)
        np.testing.assert_array_equal(store.get(v.key, crop=4),
                                      v.feat[:, 4])
        assert v.anno.shape == (16 * v.n_clips,)
    again = synthetic.sht_tencrop_test_split(0)[0]
    np.testing.assert_array_equal(again.get(videos[5].key),
                                  store.get(videos[5].key))
