"""The PyTorch package's UCF path against the JAX package's: the binned and
clip-bin scorers, the three UCF eval drivers and a UCF ``Trainer.fit(2)``.

Both stacks score the same features with the same weights (JAX init, mapped
by ckpt/interop.py), every dropout off.  Per-part and frame scores agree
within atol 1e-5 and AUCs within 1e-4 (the tolerances of
tests/test_torch_eval_slice.py); the Trainers' per-epoch losses at rel 2e-4
and AUCs within 1e-4, the final parameters at rtol 1e-3 / atol 1e-5 (those of
tests/test_torch_trainer.py).
"""

import jax
import numpy as np
import pytest

from fixtures import make_ucf_like
from lstc_vad_tpu.cli.main import _ucf_final_eval_shapes
from lstc_vad_tpu.config import preset as jax_preset
from lstc_vad_tpu.data.annotations import parse_ucf_test
from lstc_vad_tpu.data.datasets import load_test_videos as jax_load_videos
from lstc_vad_tpu.data.feature_store import FeatureStore as JaxFeatureStore
from lstc_vad_tpu.evaluation import drivers as jax_drivers
from lstc_vad_tpu.evaluation import scoring as jax_scoring
from lstc_vad_tpu.models import Encoder as JaxEncoder
from lstc_vad_tpu.models import make_head as jax_make_head
from lstc_vad_tpu.train.driver import Trainer as JaxTrainer
from lstc_vad_tpu_torch.config import PRESETS
from lstc_vad_tpu_torch.config import preset as port_preset
from lstc_vad_tpu_torch.data import FeatureStore, load_test_videos
from lstc_vad_tpu_torch.evaluation import drivers, scoring
from lstc_vad_tpu_torch.evaluation.scoring import (UCFBinnedScorer,
                                                   UCFClipBinScorer,
                                                   ucf_final_eval_scorer,
                                                   ucf_final_eval_shapes)
from lstc_vad_tpu_torch.ops import cuda_attention
from lstc_vad_tpu_torch.train.driver import Trainer

from test_torch_eval_slice import _port_models
from test_torch_train_step import (flat_from_jax, named_params, port_config,
                                   port_state)

# ucf-shaped small models: 9 patches, 3-D RPE
SMALL = {"encoder.d_model": 32, "encoder.d_inner": 48, "encoder.n_head": 2,
         "encoder.d_k": 16, "encoder.d_v": 16, "encoder.n_layers": 2,
         "head.d_model": 32, "head.hidden_dim": 16, "data.n_patch": 9,
         "data.d_model": 32}
NO_DROPOUT = {"encoder.attn_dropout": 0.0, "encoder.fc_dropout": 0.0,
              "encoder.ffn_dropout": 0.0, "encoder.position_dropout": 0.0,
              "head.dropout": 0.0}
FINAL = {"encoder.window_depth": 2, "data.part_len": 2}  # cli/main.py:243
# (features stored, n_clips the scorer is told): shorter than one clip
# (n_frames // 16 == 0), fewer clips than bins, a few around 32, long ones
SHAPES = [(1, 0), (2, 1), (5, 5), (9, 7), (31, 31), (33, 33), (40, 38),
          (70, 70), (130, 130)]
# the scorer's three flag sets (scoring.py UCFBinnedScorer docstring)
FLAG_SETS = {
    "final": dict(l2_normalize=True, tail_rewindow=True, adaptive_bins=False),
    "in_training": dict(l2_normalize=False, tail_rewindow=False,
                        adaptive_bins=True),
    "pseudo": dict(l2_normalize=False, tail_rewindow=False,
                   adaptive_bins=False),
}


@pytest.fixture(scope="module")
def ucf(tmp_path_factory):
    return make_ucf_like(str(tmp_path_factory.mktemp("ucf")), n_patch=9,
                         d_model=32, n_clips=(3, 45))


def _models(preset_name, **overrides):
    """JAX config and weights of a small UCF preset, and the port's modules
    holding the same weights."""
    cfg = jax_preset(preset_name, **SMALL, **overrides)
    d = cfg.data
    enc = JaxEncoder(cfg.encoder)
    head = jax_make_head(cfg.head.kind, cfg.head.d_model, cfg.head.hidden_dim)
    n_tok = d.n_patch * (1 if cfg.model == "stn" else d.part_len)
    x = np.zeros((1, n_tok, d.d_model), np.float32)
    params = {"encoder": enc.init(jax.random.PRNGKey(0), x)["params"],
              "head": head.init(jax.random.PRNGKey(1), x[:, 0])["params"]}
    params = jax.tree.map(np.asarray, params)
    return cfg, (enc, head, params), _port_models(cfg, params)


def _videos(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((f, 9, 32), dtype=np.float32), n) for f, n in SHAPES]


@pytest.mark.parametrize("max_clips", [8, 32])
@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_binned_scorer_matches_jax(flags, max_clips):
    kw = FLAG_SETS[flags]
    cfg, (jenc, jhead, params), (enc, head) = _models(
        "ucf_ltn", **(FINAL if flags == "final" else {}))
    d = cfg.data
    ref = jax_scoring.UCFBinnedScorer(jenc, jhead, d.part_len, d.n_patch,
                                      max_clips=max_clips, **kw)
    ours = UCFBinnedScorer(enc, head, d.part_len, d.n_patch,
                           max_clips=max_clips, **kw)
    items = _videos()
    want = ref.score_videos(params, items)
    # lazy loaders, as the eval drivers pass them
    got = ours.score_videos([((lambda f=f: f), n) for f, n in items])
    assert len(got) == len(want)
    for (s, parts, r), (rs, rparts, rr) in zip(got, want):
        assert parts == rparts
        np.testing.assert_array_equal(r, rr)
        np.testing.assert_allclose(s, rs, rtol=0, atol=1e-5)
    assert ours.scorer.n_calls >= 1 and cuda_attention.launches == 0
    # one video alone scores as it does among the others
    s, parts, _ = ours.score_video(*items[5])
    np.testing.assert_allclose(s, want[5][0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("preset_name", sorted(PRESETS))
def test_final_eval_shapes_match_jax(preset_name):
    """The UCF LTN final eval's shapes are the JAX CLI's, for every
    preset (the others are returned as they are), and its scorer carries
    the final-eval flags."""
    ours = ucf_final_eval_shapes(port_preset(preset_name))
    ref = _ucf_final_eval_shapes(jax_preset(preset_name))
    assert (ours.encoder.window_depth, ours.data.part_len) == (
        ref.encoder.window_depth, ref.data.part_len)
    assert ours == ucf_final_eval_shapes(ours)
    if preset_name == "ucf_ltn":
        assert (ours.encoder.window_depth, ours.data.part_len) == (2, 2)
        _, _, (enc, head) = _models("ucf_ltn", **FINAL)
        scorer = ucf_final_eval_scorer(ours, enc, head)
        assert (scorer.part_len, scorer.n_patch, scorer.max_clips) == (
            2, ours.data.n_patch, ours.max_clips)
        assert dict(l2_normalize=scorer.scorer.l2_normalize,
                    tail_rewindow=scorer.tail_rewindow,
                    adaptive_bins=scorer.adaptive_bins) == FLAG_SETS["final"]
    else:
        assert ours == port_preset(preset_name)


def test_binned_scorer_flushes_a_window_of_videos(monkeypatch):
    """With chunks of a few parts, the scores stay the same: the chunk
    bounds what is resident, not what is computed."""
    cfg, (jenc, jhead, params), (enc, head) = _models("ucf_ltn")
    d = cfg.data
    items = _videos(1)
    full = UCFBinnedScorer(enc, head, d.part_len, d.n_patch,
                           **FLAG_SETS["pseudo"])
    want = full.score_videos(items)
    monkeypatch.setattr(scoring, "CHUNK", 12)
    windowed = UCFBinnedScorer(enc, head, d.part_len, d.n_patch,
                               **FLAG_SETS["pseudo"])
    got = windowed.score_videos(items)
    assert windowed.scorer.n_calls > full.scorer.n_calls
    for (s, _, _), (ws, _, _) in zip(got, want):
        np.testing.assert_allclose(s, ws, rtol=0, atol=1e-6)


@pytest.mark.parametrize("max_clips", [21, 32])
def test_clip_bin_scorer_matches_jax(max_clips):
    cfg, (jenc, jhead, params), (enc, head) = _models("ucf_stn")
    ref = jax_scoring.UCFClipBinScorer(jenc, jhead, cfg.data.n_patch,
                                       max_clips)
    ours = UCFClipBinScorer(enc, head, cfg.data.n_patch, max_clips)
    items = _videos(2)
    want = ref.score_videos(params, items)
    got = ours.score_videos(items)
    for (s, bins, r), (rs, rbins, rr) in zip(got, want):
        np.testing.assert_array_equal(bins, rbins)
        np.testing.assert_array_equal(r, rr)
        np.testing.assert_allclose(s, rs, rtol=0, atol=1e-5)
    # the video shorter than one clip scores nothing
    assert got[0][0].shape == (0,) and got[0][1].shape == (0,)
    s, bins, _ = ours.score_video(*items[3])
    np.testing.assert_allclose(s, want[3][0], rtol=0, atol=1e-5)


def _split(ucf, jax_store=False):
    h5, _, test_txt, gt = ucf
    store = (JaxFeatureStore if jax_store else FeatureStore)(h5)
    load = jax_load_videos if jax_store else load_test_videos
    videos = load("UCF", test_txt, store, mask_h5=gt)
    items = [(v.feat, v.anno, v.n_frames // 16) for v in videos]
    store.close()
    return items


def _assert_same(ours, ref):
    auc, scores = ours
    ref_auc, ref_scores = ref
    assert len(scores) == len(ref_scores)
    for a, b in zip(scores, ref_scores):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert abs(auc - ref_auc) <= 1e-4


def test_evaluate_ucf_ltn_matches_jax(ucf):
    cfg, (jenc, jhead, params), (enc, head) = _models("ucf_ltn", **FINAL)
    d = cfg.data
    ref = jax_drivers.evaluate_ucf_ltn(
        params, jax_scoring.UCFBinnedScorer(jenc, jhead, 2, d.n_patch),
        _split(ucf, jax_store=True), return_scores=True)
    port_cfg = ucf_final_eval_shapes(port_preset("ucf_ltn", **SMALL))
    ours = drivers.evaluate_ucf_ltn(
        ucf_final_eval_scorer(port_cfg, enc, head), _split(ucf),
        return_scores=True)
    _assert_same(ours, ref)


def test_evaluate_ucf_stn_matches_jax(ucf):
    cfg, (jenc, jhead, params), (enc, head) = _models("ucf_stn")
    n_patch = cfg.data.n_patch
    ref = jax_drivers.evaluate_ucf_stn(
        params, jax_scoring.UCFClipBinScorer(jenc, jhead, n_patch),
        _split(ucf, jax_store=True), return_scores=True)
    ours = drivers.evaluate_ucf_stn(UCFClipBinScorer(enc, head, n_patch),
                                    _split(ucf), return_scores=True)
    _assert_same(ours, ref)
    _, _, labels = drivers.evaluate_ucf_stn(
        UCFClipBinScorer(enc, head, n_patch), _split(ucf),
        return_labels=True)
    assert [len(x) for x in labels] == [len(x) for x in ours[1]]


def test_evaluate_ucf_per_class_matches_jax(ucf, capsys):
    cfg, (jenc, jhead, params), (enc, head) = _models("ucf_ltn", **FINAL)
    d = cfg.data
    classes = [r.class_name for r in parse_ucf_test(ucf[2])]
    far, mean_ap = jax_drivers.evaluate_ucf_per_class(
        params, jax_scoring.UCFBinnedScorer(jenc, jhead, 2, d.n_patch),
        _split(ucf, jax_store=True), classes, n_anomaly_classes=1)
    ref_table = capsys.readouterr().out
    got_far, got_ap = drivers.evaluate_ucf_per_class(
        UCFBinnedScorer(enc, head, 2, d.n_patch), _split(ucf), classes,
        n_anomaly_classes=1)
    assert capsys.readouterr().out.splitlines()[0].split(":")[0] == \
        ref_table.splitlines()[0].split(":")[0]
    assert abs(got_far - far) <= 1e-4 and abs(got_ap - mean_ap) <= 1e-4
    assert np.isfinite(got_ap)


@pytest.mark.parametrize("preset_name", ["ucf_ltn", "ucf_stn"])
def test_ucf_trainer_matches_jax(ucf, tmp_path, preset_name):
    h5, train_txt, test_txt, gt = ucf
    overrides = {**SMALL, **NO_DROPOUT, "data.h5_path": h5,
                 "data.train_txt": train_txt, "data.test_txt": test_txt,
                 "data.test_mask_h5": gt, "data.batch_size": 2,
                 "inter_epoch": 1, "model_save_dir": str(tmp_path / "ckpt")}
    jcfg = jax_preset(preset_name, **overrides)
    jtrainer = JaxTrainer(jcfg)
    pcfg = port_config(jcfg)
    trainer = Trainer(pcfg, device="cpu")
    loaded = port_state(pcfg, jax.tree.map(np.asarray,
                                           jtrainer.state.params))
    trainer.state.encoder.load_state_dict(loaded.encoder.state_dict())
    trainer.state.head.load_state_dict(loaded.head.state_dict())

    ref = jtrainer.fit(2)
    ours = trainer.fit(2)
    assert ours.steps == ref.steps == 2
    assert len(ours.history) == len(ref.history) == 2
    for got, want in zip(ours.history, ref.history):
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-4)
        assert abs(got["auc_test"] - want["auc_test"]) <= 1e-4
        assert got["auc_train"] == want["auc_train"] == 0.0
    final = flat_from_jax(jax.tree.map(np.asarray, jtrainer.state.params),
                          pcfg.head.kind)
    params = named_params(trainer.state)
    for name, want in final.items():
        np.testing.assert_allclose(params[name].detach().numpy(), want,
                                   rtol=1e-3, atol=1e-5, err_msg=name)
    # UCF trains on doubled short videos, as the JAX dataset does
    assert trainer.dataset.double_short
