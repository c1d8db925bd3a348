"""``python -m lstc_vad_tpu_torch`` subcommands on the CPU, each in a
subprocess with ``--device cpu``: the train -> gen-pseudo -> evaluate chain
through ``--ckpt`` files, gen-pseudo against the library's generators in
this process (labels within 1e-6, the zero pattern equal apart from entries
at the threshold, AUC within 1e-6: the same weights and arithmetic, summed
in another process), coteach, and the UCF evaluate against the JAX
package's ``cmd_evaluate`` (AUC within 1e-4, frame scores within 1e-5 — the
tolerances of tests/test_torch_eval_slice.py).
"""

import contextlib
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from fixtures import make_sht_like, make_ucf_like
from lstc_vad_tpu.ckpt.torch_export import save_torch_checkpoint
from lstc_vad_tpu.cli.main import main as jax_main
from lstc_vad_tpu.config import preset as jax_preset
from lstc_vad_tpu.models import Encoder as JaxEncoder
from lstc_vad_tpu.models import make_head as jax_make_head
from lstc_vad_tpu_torch import cli
from lstc_vad_tpu_torch.ckpt import load_checkpoint, save_checkpoint
from lstc_vad_tpu_torch.config import preset
from lstc_vad_tpu_torch.data import load_pseudo_labels
from lstc_vad_tpu_torch.evaluation.drivers import evaluate_ltn
from lstc_vad_tpu_torch.evaluation.scoring import ClipScorer, PartScorer
from lstc_vad_tpu_torch.pseudo import (generate_ltn_pseudo_labels,
                                       generate_stn_pseudo_labels)
from lstc_vad_tpu_torch.train.driver import Trainer

from test_torch_pseudo import assert_labels_match

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"encoder.d_model": 32, "encoder.d_inner": 48, "encoder.n_head": 2,
         "encoder.d_k": 16, "encoder.d_v": 16, "encoder.n_layers": 2,
         "head.d_model": 32, "head.hidden_dim": 16, "data.d_model": 32}
SHT_SMALL = {**SMALL, "data.n_patch": 16}
UCF_SMALL = {**SMALL, "data.n_patch": 9}


def flags(overrides):
    return [a for k, v in overrides.items() for a in ("--set", f"{k}={v}")]


def run(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "lstc_vad_tpu_torch", *args,
                          "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res


def auc_of(stdout):
    return float([ln for ln in stdout.splitlines()
                  if ln.startswith("auc = ")][-1].split("=")[1])


@pytest.fixture(scope="module")
def sht(tmp_path_factory):
    return make_sht_like(str(tmp_path_factory.mktemp("sht")), n_patch=16,
                         d_model=32)


def _data_flags(sht):
    h5, train_txt, test_txt, mask_dir = sht
    return ["--h5", h5, "--train-txt", train_txt, "--test-txt", test_txt,
            "--mask-dir", mask_dir]


def _trainer(sht, preset_name):
    h5, train_txt, test_txt, mask_dir = sht
    cfg = preset(preset_name, **SHT_SMALL, **{
        "data.h5_path": h5, "data.train_txt": train_txt,
        "data.test_txt": test_txt, "data.test_mask_dir": mask_dir})
    return Trainer(cfg, device="cpu", eval_only=True)


def _median(pseudo):
    return float(np.median(np.concatenate(list(pseudo.values()))))


def test_train_gen_pseudo_evaluate_chain(sht, tmp_path):
    """train --save-best writes a params file that gen-pseudo and evaluate
    read with --ckpt; a full state from --save-state reads the same."""
    best, state = str(tmp_path / "best.pt"), str(tmp_path / "state.pt")
    common = ["--preset", "sht_ltn", *_data_flags(sht), *flags(SHT_SMALL)]
    run("train", *common, "--batch-size", "2", "--epochs", "2",
        "--save-dir", str(tmp_path / "ckpt"), "--set", "inter_epoch=1",
        "--save-best", best, "--save-state", state)

    # the library with the same weights
    trainer = _trainer(sht, "sht_ltn")
    load_checkpoint(best, trainer.state)
    d = trainer.cfg.data
    scorer = PartScorer(trainer.state.encoder, trainer.state.head,
                        d.part_len, d.n_patch, tail_rewindow=False)
    raw = generate_ltn_pseudo_labels(scorer, trainer.store,
                                     trainer.train_records, -1.0)
    tau = _median(raw)
    want = generate_ltn_pseudo_labels(scorer, trainer.store,
                                      trainer.train_records, tau)
    want_auc = evaluate_ltn(trainer.scorer, trainer._test_items())

    out = str(tmp_path / "ltn_pseudo.npy")
    res = run("gen-pseudo", *common, "--kind", "ltn", "--ckpt", best,
              "--threshold", str(tau), "--out", out)
    assert "RANDOM-INIT" not in res.stderr
    assert_labels_match(load_pseudo_labels(out), want, raw, tau, atol=1e-6)

    for ckpt in (best, state):
        res = run("evaluate", *common, "--ckpt", ckpt)
        assert auc_of(res.stdout) == pytest.approx(want_auc, abs=1e-6)


def test_gen_pseudo_stn_gives_the_librarys_dict(sht, tmp_path):
    trainer = _trainer(sht, "sht_stn")
    path = str(tmp_path / "stn.pt")
    save_checkpoint(path, trainer.params())
    scorer = ClipScorer(trainer.state.encoder, trainer.state.head,
                        trainer.cfg.data.n_patch)
    raw = generate_stn_pseudo_labels(scorer, trainer.store,
                                     trainer.train_records, -1.0)
    tau = _median(raw)
    want = generate_stn_pseudo_labels(scorer, trainer.store,
                                      trainer.train_records, tau)
    out = str(tmp_path / "stn_pseudo.npy")
    run("gen-pseudo", "--preset", "sht_stn", *_data_flags(sht),
        *flags(SHT_SMALL), "--kind", "stn", "--ckpt", path, "--threshold",
        str(tau), "--out", out)
    assert_labels_match(load_pseudo_labels(out), want, raw, tau, atol=1e-6)


def test_coteach_writes_both_artifacts(sht, tmp_path):
    work = str(tmp_path / "work")
    run("coteach", "--stn-preset", "sht_stn", "--ltn-preset", "sht_ltn",
        "--workdir", work, *_data_flags(sht), *flags(SHT_SMALL),
        "--batch-size", "2", "--rounds", "2", "--stn-epochs", "1",
        "--ltn-epochs", "1", "--set", "inter_epoch=1",
        "--set", f"model_save_dir={tmp_path / 'ckpt'}")
    keys = {ln.split(",")[0] + ".npy" for ln in open(sht[1]).read().split()}
    for name in ("stn_pseudo.npy", "ltn_pseudo.npy"):
        pseudo = load_pseudo_labels(os.path.join(work, name))
        assert set(pseudo) == keys, name


@pytest.fixture(scope="module")
def ucf_ckpt(tmp_path_factory):
    """A UCF-shaped set and a reference-format checkpoint of JAX weights at
    the UCF LTN final-eval shapes (part_len 2, window_depth 2)."""
    root = tmp_path_factory.mktemp("ucf")
    h5, _, test_txt, gt = make_ucf_like(str(root), n_patch=9, d_model=32,
                                        n_clips=(3, 45))
    cfg = jax_preset("ucf_ltn", **UCF_SMALL, **{"encoder.window_depth": 2,
                                                "data.part_len": 2})
    enc = JaxEncoder(cfg.encoder)
    head = jax_make_head(cfg.head.kind, cfg.head.d_model, cfg.head.hidden_dim)
    x = np.zeros((1, 18, 32), np.float32)
    params = {"encoder": enc.init(jax.random.PRNGKey(0), x)["params"],
              "head": head.init(jax.random.PRNGKey(1), x[:, 0])["params"]}
    enc_path, head_path = str(root / "e.ckpt"), str(root / "h.ckpt")
    save_torch_checkpoint(jax.tree.map(np.asarray, params), enc_path,
                          head_path, "classifier", encoder_cfg=cfg.encoder)
    return ["--preset", "ucf_ltn", "--h5", h5, "--test-txt", test_txt,
            "--mask-h5", gt, "--torch-ckpt", "--encoder-ckpt", enc_path,
            "--head-ckpt", head_path, *flags(UCF_SMALL)]


def _jax_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_main(argv) == 0
    return out.getvalue()


def test_ucf_evaluate_matches_jax(ucf_ckpt, tmp_path):
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "jax.npz")
    extra = ["--bootstrap", "20"]
    ref = _jax_cli(["evaluate", *ucf_ckpt, *extra, "--dump-scores", theirs])
    res = run("evaluate", *ucf_ckpt, *extra, "--dump-scores", ours)
    assert abs(auc_of(res.stdout) - auc_of(ref)) <= 1e-4
    ci = [ln for ln in res.stdout.splitlines() if ln.startswith("95% CI")]
    assert ci == [ln for ln in ref.splitlines() if ln.startswith("95% CI")]
    got, want = np.load(ours), np.load(theirs)
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)


def test_ucf_evaluate_per_class_matches_jax(ucf_ckpt):
    args = [*ucf_ckpt, "--per-class", "--n-anomaly-classes", "1"]
    ref = _jax_cli(["evaluate", *args]).splitlines()[-1]
    got = run("evaluate", *args).stdout.splitlines()[-1]
    assert got.startswith("Normal FAR ")
    values = [float(w.strip(",")) for w in got.split()[2::3]]
    ref_values = [float(w.strip(",")) for w in ref.split()[2::3]]
    np.testing.assert_allclose(values, ref_values, rtol=0, atol=1.5e-4)


@pytest.mark.parametrize("argv,match", [
    (["export-aot", "--preset", "sht_ltn", "--ckpt", "c", "--out", "a",
      "--platforms", "tpu,cpu"], "device-portable"),
    (["serve", "--preset", "sht_ltn", "--backend", "s"], "hold no device"),
    (["train", "--preset", "sht_ltn", "--mesh", "2x1"], "A18"),
    (["serve-backend", "--preset", "sht_ltn", "--socket", "s", "--mesh",
      "2x1"], "A18"),
    (["coteach", "--stn-preset", "sht_stn", "--ltn-preset", "sht_ltn",
      "--workdir", "w", "--multihost", "auto"], "A18"),
    (["evaluate", "--preset", "sht_ltn", "--eval-crop", "mean"],
     "needs a tenCrop store"),
    (["evaluate", "--preset", "sht_ltn", "--eval-crop", "10"], "0-9"),
    (["gen-pseudo", "--preset", "sht_ltn", "--kind", "ltn", "--out", "o",
      "--train-txt", "t", "--set", "data.ten_crop=true"], "eval_crop"),
    (["evaluate", "--preset", "sht_ltn", "--artifact", "a", "--ckpt", "c"],
     "already contains the params"),
    (["gen-pseudo", "--preset", "sht_stn", "--kind", "ltn", "--out", "o"],
     "does not match"),
    (["evaluate", "--preset", "sht_ltn", "--per-class"], "UCF"),
    (["evaluate", "--preset", "sht_ltn", "--torch-ckpt"], "both"),
])
def test_cli_refuses_with_the_roadmap_item(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main([*argv, "--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["train", "--preset", "sht_ltn"],
    ["gen-pseudo", "--preset", "sht_ltn", "--kind", "ltn", "--out", "o.npy"],
    ["coteach", "--stn-preset", "sht_stn", "--ltn-preset", "sht_ltn",
     "--workdir", "w"],
])
def test_subcommands_need_a_card_unless_told_cpu(sht, tmp_path, argv):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = [a if a not in ("o.npy", "w") else str(tmp_path / a)
            for a in argv]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main([*argv, *_data_flags(sht), *flags(SHT_SMALL)])
