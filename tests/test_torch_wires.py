"""The wire types (``data.transfer_dtype``, ``data.eval_transfer_dtype``) and
the f32 evaluation of any train config, against the JAX package.

- The evaluation wire (fault C4 of ROADMAP.md §C): a Trainer with
  ``data.eval_transfer_dtype="bfloat16"`` scores bf16-rounded features, as
  the JAX Trainer's scorers do (lstc_vad_tpu/evaluation/scoring.py:191-195
  casts on the host, :111-114 upcasts on the device).  Its frame scores
  equal JAX's within the eval slice's atol 1e-5 and its AUC within 1e-4
  (tests/test_torch_eval_slice.py), and differ from the f32 wire's
  (tests/test_eval_drivers.py:229).  ``evaluate`` and ``gen-pseudo`` honour
  the knob the same way.
- The training wire casts the two feature arrays of each batch on the host
  (round to nearest even, what ml_dtypes gives the JAX Prefetcher) and
  leaves the labels alone; it never reaches the evaluation scorers.
- A Trainer with bf16 compute, remat and cast_sr evaluates through the f32
  twin of its encoder: the same scores, bit for bit, as an f32 Trainer
  holding the same weights.
"""

import contextlib
import io

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from fixtures import make_sht_like
from lstc_vad_tpu.config import preset as jax_preset
from lstc_vad_tpu.data.pipeline import Prefetcher as JaxPrefetcher
from lstc_vad_tpu.evaluation import drivers as jax_drivers
from lstc_vad_tpu.train.driver import Trainer as JaxTrainer
from lstc_vad_tpu_torch import cli
from lstc_vad_tpu_torch.ckpt import save_checkpoint
from lstc_vad_tpu_torch.data import Prefetcher
from lstc_vad_tpu_torch.evaluation import drivers
from lstc_vad_tpu_torch.evaluation.scoring import ucf_final_eval_scorer
from lstc_vad_tpu_torch.pseudo import pseudo_scorer
from lstc_vad_tpu_torch.train.driver import Trainer

from test_torch_train_step import port_config, port_state

SMALL = {"encoder.d_model": 32, "encoder.d_inner": 48, "encoder.n_head": 2,
         "encoder.d_k": 16, "encoder.d_v": 16, "encoder.n_layers": 2,
         "head.d_model": 32, "head.hidden_dim": 16, "data.n_patch": 16,
         "data.d_model": 32}
SET_FLAGS = [a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]


@pytest.fixture(scope="module")
def sht(tmp_path_factory):
    return make_sht_like(str(tmp_path_factory.mktemp("sht")), n_patch=16,
                         d_model=32)


def _cfg(sht, **kw):
    h5, train_txt, test_txt, mask_dir = sht
    return jax_preset("sht_ltn", **SMALL, **{
        "data.h5_path": h5, "data.train_txt": train_txt,
        "data.test_txt": test_txt, "data.test_mask_dir": mask_dir}, **kw)


def _port_trainer(jcfg, params, **kw):
    """An eval-only port Trainer of ``jcfg`` (port knobs ``kw``) holding the
    JAX ``params``."""
    pcfg = port_config(jcfg)
    if kw:
        from lstc_vad_tpu_torch.config import replace

        pcfg = replace(pcfg, **kw)
    trainer = Trainer(pcfg, device="cpu", eval_only=True)
    loaded = port_state(pcfg, params)
    trainer.state.encoder.load_state_dict(loaded.encoder.state_dict())
    trainer.state.head.load_state_dict(loaded.head.state_dict())
    return trainer


def _scores(trainer):
    return drivers.evaluate_ltn(trainer.scorer, trainer._test_items(),
                                return_scores=True)


def test_eval_wire_is_honoured_as_jax_honours_it(sht):
    """Fault C4: the port used to ignore data.eval_transfer_dtype, scoring
    the f32 features whatever it said."""
    jcfg = _cfg(sht, **{"data.eval_transfer_dtype": "bfloat16"})
    jtrainer = JaxTrainer(jcfg, eval_only=True)
    assert jtrainer.scorer.scorer.transfer_dtype == "bfloat16"
    params = jax.tree.map(np.asarray, jtrainer.state.params)
    items = [(v.feat, v.anno) for v in jtrainer.test_videos]
    ref_auc, ref = jax_drivers.evaluate_ltn(params, jtrainer.scorer, items,
                                            return_scores=True)

    trainer = _port_trainer(jcfg, params)
    auc, ours = _scores(trainer)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert abs(auc - ref_auc) <= 1e-4
    assert trainer.evaluate("test") == pytest.approx(auc, abs=1e-12)

    f32 = _port_trainer(jcfg, params,
                        **{"data.eval_transfer_dtype": "float32"})
    _, f32_scores = _scores(f32)
    assert not np.allclose(np.concatenate(ours),
                           np.concatenate(f32_scores), atol=1e-9)
    assert trainer.scorer.scorer.wire == torch.bfloat16


def test_train_wire_stays_out_of_the_eval_scorers(sht):
    cfg = port_config(_cfg(sht, **{"data.transfer_dtype": "bfloat16"}))
    trainer = Trainer(cfg, device="cpu", eval_only=True)
    assert trainer.scorer.scorer.wire == torch.float32
    enc, head = trainer.scoring_modules()
    assert pseudo_scorer(cfg, enc, head).scorer.wire == torch.float32
    from lstc_vad_tpu_torch.config import replace

    cfg = replace(cfg, **{"data.eval_transfer_dtype": "bfloat16"})
    assert pseudo_scorer(cfg, enc, head).scorer.wire == torch.bfloat16
    ucf = replace(cfg, **{"data.dataset": "UCF"})
    assert ucf_final_eval_scorer(ucf, enc, head).scorer.wire == \
        torch.bfloat16


def test_prefetcher_casts_the_features_on_the_host_as_jax_does():
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((2, 6, 4, 16)).astype(np.float32),
             rng.random((2, 6)).astype(np.float32),
             rng.standard_normal((2, 6, 4, 16)).astype(np.float32),
             rng.random((2, 6)).astype(np.float32))
    (ours,) = list(Prefetcher([batch], "cpu", feature_dtype=torch.bfloat16))
    (ref,) = list(JaxPrefetcher([batch], to_device=False,
                                feature_dtype=ml_dtypes.bfloat16))
    for i, (got, want) in enumerate(zip(ours, ref)):
        if i in (0, 2):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy().view(np.uint16),
                np.asarray(want).view(np.uint16))
        else:  # labels keep their type
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_compute_trainer_evaluates_as_the_f32_trainer(sht):
    """The eval twin: bf16 compute, remat and cast_sr leave evaluation,
    pseudo-label scoring and scoring_modules in f32, bit for bit."""
    jcfg = _cfg(sht)
    params = jax.tree.map(np.asarray,
                          JaxTrainer(jcfg, eval_only=True).state.params)
    f32 = _port_trainer(jcfg, params)
    knobs = _port_trainer(jcfg, params, **{
        "encoder.compute_dtype": "bfloat16", "encoder.remat": True,
        "encoder.cast_sr": True})
    assert knobs.eval_encoder is not knobs.state.encoder
    assert knobs.eval_encoder.cfg == f32.state.encoder.cfg
    auc, scores = _scores(knobs)
    ref_auc, ref = _scores(f32)
    assert auc == ref_auc
    for a, b in zip(scores, ref):
        np.testing.assert_array_equal(a, b)
    enc, _ = knobs.scoring_modules()
    assert enc.cfg.compute_dtype == "float32" and not enc.cfg.remat


def _cli_scores(sht, tmp_path, ckpt, name, *extra):
    h5, _, test_txt, mask_dir = sht
    dump = str(tmp_path / f"{name}.npz")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["evaluate", "--preset", "sht_ltn", "--h5", h5,
                         "--test-txt", test_txt, "--mask-dir", mask_dir,
                         "--ckpt", ckpt, "--device", "cpu",
                         "--dump-scores", dump, *SET_FLAGS, *extra]) == 0
    with np.load(dump) as f:
        return {k: f[k] for k in f.files}


def test_cli_evaluate_and_gen_pseudo_honour_the_eval_wire(sht, tmp_path):
    jcfg = _cfg(sht, **{"data.eval_transfer_dtype": "bfloat16"})
    params = jax.tree.map(np.asarray,
                          JaxTrainer(jcfg, eval_only=True).state.params)
    trainer = _port_trainer(jcfg, params)
    ckpt = str(tmp_path / "w.pt")
    save_checkpoint(ckpt, trainer.params())
    _, want = _scores(trainer)
    bf16 = _cli_scores(sht, tmp_path, ckpt, "bf16", "--set",
                       "data.eval_transfer_dtype=bfloat16")
    f32 = _cli_scores(sht, tmp_path, ckpt, "f32")
    keys = [v.key for v in trainer.test_videos]
    for key, w in zip(keys, want):
        np.testing.assert_allclose(bf16[key], w, rtol=0, atol=1e-6)
    assert not all(np.allclose(bf16[k], f32[k], atol=1e-9) for k in keys)

    h5, train_txt = sht[:2]
    labels = {}
    for wire in ("bfloat16", "float32"):
        out = str(tmp_path / f"{wire}.npy")
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["gen-pseudo", "--preset", "sht_ltn", "--kind",
                             "ltn", "--h5", h5, "--train-txt", train_txt,
                             "--ckpt", ckpt, "--out", out, "--device",
                             "cpu", "--threshold", "0.0", *SET_FLAGS,
                             "--set",
                             f"data.eval_transfer_dtype={wire}"]) == 0
        labels[wire] = np.load(out, allow_pickle=True).item()
    assert labels["bfloat16"].keys() == labels["float32"].keys()
    assert not all(np.allclose(labels["bfloat16"][k], labels["float32"][k],
                               atol=1e-9) for k in labels["float32"])


def test_cli_serve_takes_the_knobs_and_serves_f32_on_the_eval_wire(
        sht, tmp_path, monkeypatch):
    """``serve`` with bf16 compute and a bf16 eval wire: the f32 twin of the
    model scores the bf16-rounded clips, as a library StreamingScorer of the
    f32 modules on the bf16 wire does."""
    import json

    from lstc_vad_tpu_torch.serving import StreamingScorer, serve_jsonl

    jcfg = _cfg(sht)
    params = jax.tree.map(np.asarray,
                          JaxTrainer(jcfg, eval_only=True).state.params)
    trainer = _port_trainer(jcfg, params)
    ckpt = str(tmp_path / "w.pt")
    save_checkpoint(ckpt, trainer.params())
    clips = np.random.default_rng(4).standard_normal((8, 16, 32)).astype(
        np.float32)
    script = "".join(json.dumps({"op": "push", "stream": f"s{i % 2}",
                                 "feat": clip.tolist()}) + "\n"
                     for i, clip in enumerate(clips))
    script += json.dumps({"op": "end_all"}) + "\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(script))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["serve", "--preset", "sht_ltn", "--ckpt", ckpt,
                         "--device", "cpu", *SET_FLAGS, "--set",
                         "encoder.compute_dtype=bfloat16", "--set",
                         "data.eval_transfer_dtype=bfloat16"]) == 0
    d = trainer.cfg.data
    ref = StreamingScorer(trainer.state.encoder, trainer.state.head,
                          d.part_len, d.n_patch, d.d_model,
                          transfer_dtype="bfloat16")
    want = io.StringIO()
    serve_jsonl(ref, io.StringIO(script), want)
    assert out.getvalue() == want.getvalue()
