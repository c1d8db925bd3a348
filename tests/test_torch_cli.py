"""``python -m lstc_vad_tpu_torch`` subcommands on the CPU, each in a
subprocess with ``--device cpu``: the train -> gen-pseudo -> evaluate chain
through ``--ckpt`` files, gen-pseudo against the library's generators in
this process (labels within 1e-6, the zero pattern equal apart from entries
at the threshold, AUC within 1e-6: the same weights and arithmetic, summed
in another process), coteach, and the UCF evaluate against the JAX
package's ``cmd_evaluate`` (AUC within 1e-4, frame scores within 1e-5 — the
tolerances of tests/test_torch_eval_slice.py).  Then the rest of the CLI:
``--log-dir`` on every subcommand with the common flags and the config lines
``train`` logs (those of the JAX ``log_config``), ``export-torch`` against
the JAX ``save_torch_checkpoint`` (keys and values equal) and ``evaluate
--torch-ckpt`` on its files against ``--ckpt``, ``info``, ``profile`` and
``sweep`` against the JAX ``cmd_sweep`` (Trainer tolerances: AUCs within
1e-4), all in this process on the CPU.
"""

import argparse
import contextlib
import io
import json
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


TRAIN_KNOBS = {"encoder.compute_dtype": "bfloat16", "encoder.remat": "true",
               "encoder.cast_sr": "true", "data.transfer_dtype": "bfloat16"}


def test_train_with_the_train_knobs_then_export_aot(sht, tmp_path):
    """``train`` with bf16 compute, remat, cast_sr and a bf16 wire runs in a
    subprocess; ``export-aot`` of that config writes f32 eval programs
    (lstc_vad_tpu/cli/main.py:903-905), which score as the f32 config's
    artifact from the same weights, bit for bit, and evaluate gives the f32
    config's AUC."""
    best = str(tmp_path / "best.pt")
    res = run("train", "--preset", "sht_ltn", *_data_flags(sht),
              *flags(SHT_SMALL), *flags(TRAIN_KNOBS), "--batch-size", "2",
              "--epochs", "2", "--set", "inter_epoch=1", "--save-dir",
              str(tmp_path / "ckpt"), "--save-best", best)
    assert "test AUC" in res.stderr
    from lstc_vad_tpu_torch.export import load_scorer

    arts = {}
    for name, extra in (("knobs", flags(TRAIN_KNOBS)), ("f32", [])):
        arts[name] = str(tmp_path / name)
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["export-aot", "--preset", "sht_ltn", "--ckpt",
                             best, "--out", arts[name], "--device", "cpu",
                             *flags(SHT_SMALL), *extra]) == 0
    tokens = np.random.default_rng(0).standard_normal(
        (5, 48, 32)).astype(np.float32)
    got, want = (load_scorer(arts[n], device="cpu").score(tokens)
                 for n in ("knobs", "f32"))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    aucs = [auc_of(run("evaluate", "--preset", "sht_ltn", *_data_flags(sht),
                       *flags(SHT_SMALL), *extra, "--ckpt", best).stdout)
            for extra in (flags(TRAIN_KNOBS), [])]
    assert aucs[0] == aucs[1]


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
    (["sweep", "--preset", "sht_ltn", "--grid", "optim.lr_encoder=1e-4",
      "--mesh", "auto"], "A18"),
    (["sweep", "--preset", "sht_ltn"], "at least one --grid"),
])
def test_cli_refuses_with_the_roadmap_item(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main([*argv, "--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["train", "--preset", "sht_ltn"],
    ["gen-pseudo", "--preset", "sht_ltn", "--kind", "ltn", "--out", "o.npy"],
    ["coteach", "--stn-preset", "sht_stn", "--ltn-preset", "sht_ltn",
     "--workdir", "w"],
    ["profile", "--preset", "sht_ltn", "--out", "w"],
    ["sweep", "--preset", "sht_ltn", "--grid", "optim.lr_encoder=1e-4"],
    ["export-torch", "--preset", "sht_ltn", "--ckpt", "o.npy",
     "--encoder-out", "e", "--head-out", "h"],
])
def test_subcommands_need_a_card_unless_told_cpu(sht, tmp_path, argv):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = [a if a not in ("o.npy", "w") else str(tmp_path / a)
            for a in argv]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main([*argv, *_data_flags(sht), *flags(SHT_SMALL)])


# ------------------------------------------------- the rest of the CLI

COMMON_SUBCOMMANDS = {
    "train": ("cmd_train", []),
    "gen-pseudo": ("cmd_gen_pseudo", ["--kind", "ltn", "--out", "o"]),
    "evaluate": ("cmd_evaluate", []),
    "export-aot": ("cmd_export_aot", ["--ckpt", "c", "--out", "a"]),
    "serve": ("cmd_serve", []),
    "serve-backend": ("cmd_serve_backend", ["--socket", "s"]),
    "validate-data": ("cmd_validate_data", []),
    "export-torch": ("cmd_export_torch", ["--ckpt", "c", "--encoder-out",
                                          "e", "--head-out", "h"]),
    "profile": ("cmd_profile", ["--out", "p"]),
    "sweep": ("cmd_sweep", ["--grid", "optim.lr_encoder=1e-4"]),
}


@pytest.mark.parametrize("sub", sorted(COMMON_SUBCOMMANDS))
def test_every_subcommand_with_the_common_flags_takes_log_dir(sub,
                                                              monkeypatch):
    fn, extra = COMMON_SUBCOMMANDS[sub]
    seen = []
    monkeypatch.setattr(cli, fn, lambda args: seen.append(args) or 0)
    assert cli.main([sub, "--preset", "sht_ltn", *extra,
                     "--log-dir", "logs"]) == 0
    assert seen[0].log_dir == "logs"


def _log_lines(path):
    """A log file's messages, the ``[time] `` prefix dropped."""
    with open(path) as f:
        return [ln.split("] ", 1)[1] for ln in f.read().splitlines()]


def test_train_logs_the_config_as_jax_log_config(sht, tmp_path):
    """``train --log-dir`` writes one file holding every config field, the
    lines the JAX ``log_config`` writes for the same flags, then the run's
    own lines (C3)."""
    from lstc_vad_tpu.cli.main import _apply_common as jax_apply_common
    from lstc_vad_tpu.utils.logging import get_logger as jax_get_logger
    from lstc_vad_tpu.utils.logging import log_config as jax_log_config

    h5, train_txt, test_txt, mask_dir = sht
    save_dir, logs = str(tmp_path / "ckpt"), str(tmp_path / "logs")
    argv = ["--preset", "sht_ltn", *_data_flags(sht), "--batch-size", "2",
            "--epochs", "1", "--save-dir", save_dir, *flags(SHT_SMALL)]
    run("train", *argv, "--log-dir", logs)
    (ours,) = os.listdir(logs)
    ns = argparse.Namespace(
        h5=h5, train_txt=train_txt, test_txt=test_txt, mask_dir=mask_dir,
        mask_h5=None, pseudo_labels=None, batch_size=2, seed=None, epochs=1,
        save_dir=save_dir, metrics_jsonl=None, set=flags(SHT_SMALL)[1::2])
    jax_logger = jax_get_logger("jax_config", log_dir=str(tmp_path / "jax"),
                                filename="config.log")
    jax_log_config(jax_logger, jax_apply_common(jax_preset("sht_ltn"), ns))
    for h in jax_logger.handlers:
        h.flush()
    want = _log_lines(str(tmp_path / "jax" / "config.log"))
    got = _log_lines(os.path.join(logs, ours))
    assert len(want) > 40 and got[:len(want)] == want
    assert any("best test AUC" in ln for ln in got[len(want):])


@pytest.fixture(scope="module")
def jax_weights():
    """JAX init params of the small sht_ltn and their port state."""
    from lstc_vad_tpu.train.state import create_train_state as jax_state

    from test_torch_train_step import port_config, port_state

    jcfg = jax_preset("sht_ltn", **SHT_SMALL)
    params = jax.tree.map(np.asarray, jax_state(jcfg)[0].params)
    return jcfg, params, port_state(port_config(jcfg), params)


@pytest.mark.parametrize("change", [
    {}, {"encoder.mha_layernorm": False, "encoder.ffn_layernorm": False,
         "encoder.input_layernorm": True}, {"encoder.ffn_need": False}])
def test_export_torch_writes_the_jax_files(tmp_path, change):
    """export-torch on a params file and on a full-state file: the same
    keys and values as the JAX ``save_torch_checkpoint`` from the same
    parameters, loading ``strict=True`` into fresh modules."""
    from lstc_vad_tpu.train.state import create_train_state as jax_state
    from lstc_vad_tpu_torch.train.state import create_train_state

    from test_torch_train_step import port_config, port_state

    jcfg = jax_preset("sht_ltn", **SHT_SMALL, **change)
    params = jax.tree.map(np.asarray, jax_state(jcfg)[0].params)
    pcfg = port_config(jcfg)
    state = port_state(pcfg, params)
    want_enc, want_head = str(tmp_path / "je.ckpt"), str(tmp_path / "jh.ckpt")
    save_torch_checkpoint(params, want_enc, want_head, jcfg.head.kind,
                          encoder_cfg=jcfg.encoder)
    sets = flags({**SHT_SMALL, **change})
    for kind, obj in (("params", {"encoder": state.encoder.state_dict(),
                                  "head": state.head.state_dict()}),
                      ("state", state)):
        ckpt = str(tmp_path / f"{kind}.pt")
        save_checkpoint(ckpt, obj)
        enc_out, head_out = (str(tmp_path / f"{kind}_{m}.ckpt")
                             for m in ("e", "h"))
        assert cli.main(["export-torch", "--preset", "sht_ltn", "--ckpt",
                         ckpt, "--encoder-out", enc_out, "--head-out",
                         head_out, "--device", "cpu", *sets]) == 0
        for got_path, want_path in ((enc_out, want_enc),
                                    (head_out, want_head)):
            got = torch_load(got_path)
            want = torch_load(want_path)
            assert sorted(got) == sorted(want), got_path
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k].numpy(),
                                              want[k].numpy(), err_msg=k)
        fresh = create_train_state(pcfg, device="cpu", seed=3)
        fresh.encoder.load_state_dict(torch_load(enc_out), strict=True)
        fresh.head.load_state_dict(torch_load(head_out), strict=True)


def torch_load(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def test_evaluate_torch_ckpt_of_export_torch_gives_the_ckpt_auc(
        sht, tmp_path, jax_weights):
    """The two files export-torch writes, read by ``evaluate --torch-ckpt``,
    give the AUC of ``evaluate --ckpt`` on the checkpoint they came from;
    with --log-dir, evaluate writes a log file."""
    _, _, state = jax_weights
    ckpt = str(tmp_path / "best.pt")
    save_checkpoint(ckpt, {"encoder": state.encoder.state_dict(),
                           "head": state.head.state_dict()})
    enc, head = str(tmp_path / "e.ckpt"), str(tmp_path / "h.ckpt")
    common = ["--preset", "sht_ltn", *_data_flags(sht), "--device", "cpu",
              *flags(SHT_SMALL)]
    assert cli.main(["export-torch", *common, "--ckpt", ckpt,
                     "--encoder-out", enc, "--head-out", head]) == 0

    def auc(*extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli.main(["evaluate", *common, *extra]) == 0
        return auc_of(out.getvalue())

    logs = str(tmp_path / "logs")
    want = auc("--ckpt", ckpt)
    assert auc("--torch-ckpt", "--encoder-ckpt", enc, "--head-ckpt", head,
               "--log-dir", logs) == want
    assert len(os.listdir(logs)) == 1


def test_info_on_the_cpu(capsys):
    assert cli.main(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "lstc_vad_tpu_torch" in out and "device cpu" in out
    assert "attention (attention.cu)" in out
    assert "packstore (packstore.cpp)" in out
    assert "--mesh auto would build data=1 x model=1" in out
    assert "sht_ltn" in out


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_profile_writes_a_trace(tmp_path, capsys, mode):
    out_dir = str(tmp_path / "prof")
    assert cli.main(["profile", "--preset", "sht_ltn", "--mode", mode,
                     "--steps", "2", "--eval-batch", "4", "--batch-size",
                     "2", "--out", out_dir, "--device", "cpu",
                     *flags(SHT_SMALL)]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["mode"] == mode and report["steps"] == 2
    assert report["attention_launches"] == 0  # the CPU runs no kernel
    assert report["device_busy_ms"] is None  # no device metric off the card
    with open(os.path.join(out_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_sweep_matches_jax_cmd_sweep(sht, tmp_path, monkeypatch,
                                     jax_weights):
    """Both sweeps train each combination from the same JAX init (the
    port's runs load it, as the parity tests do) with dropout off: the same
    records, AUCs within 1e-4, and the same ranking."""
    from lstc_vad_tpu_torch.train import driver

    jcfg, params, state = jax_weights

    class FromJaxInit(driver.Trainer):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            self.state.encoder.load_state_dict(state.encoder.state_dict())
            self.state.head.load_state_dict(state.head.state_dict())

    monkeypatch.setattr(driver, "Trainer", FromJaxInit)
    no_dropout = {"encoder.attn_dropout": 0.0, "encoder.fc_dropout": 0.0,
                  "encoder.ffn_dropout": 0.0, "encoder.position_dropout": 0.0,
                  "head.dropout": 0.0}
    argv = ["sweep", "--preset", "sht_ltn", *_data_flags(sht),
            "--batch-size", "2", "--epochs", "2", "--save-dir",
            str(tmp_path / "ckpt"), *flags({**SHT_SMALL, **no_dropout}),
            "--set", "inter_epoch=1", "--grid", "optim.lr_encoder=1e-3,1e-1",
            "--grid", "optim.lr_head=1e-2"]
    ours, theirs = str(tmp_path / "ours.jsonl"), str(tmp_path / "j.jsonl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_main([*argv, "--out", theirs]) == 0
    want_table = out.getvalue().split("rank ")[1].splitlines()[1:]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main([*argv, "--out", ours, "--device", "cpu"]) == 0
    got_table = out.getvalue().split("rank ")[1].splitlines()[1:]
    got = [json.loads(ln) for ln in open(ours)]
    want = [json.loads(ln) for ln in open(theirs)]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k.endswith("_auc"):
                assert abs(g[k] - w[k]) <= 1e-4, k
            else:
                assert g[k] == w[k], k
    # the ranking: each row's overrides, after rank, gate and test AUC
    assert [ln.split(None, 3)[3] for ln in got_table] == \
        [ln.split(None, 3)[3] for ln in want_table]


def test_gen_pseudo_and_coteach_from_a_pack_equal_from_the_h5(sht, tmp_path,
                                                              jax_weights):
    """``--set data.pack_path=...`` in place of ``--h5``: gen-pseudo writes
    the same labels, and a co-teaching round the same two artifacts."""
    from lstc_vad_tpu_torch.data.packed import pack_h5

    h5, train_txt, test_txt, mask_dir = sht
    pack = str(tmp_path / "feats.lstcpack")
    pack_h5(h5, pack)
    _, _, state = jax_weights
    ckpt = str(tmp_path / "w.pt")
    save_checkpoint(ckpt, {"encoder": state.encoder.state_dict(),
                           "head": state.head.state_dict()})
    lists = ["--train-txt", train_txt, "--test-txt", test_txt, "--mask-dir",
             mask_dir, "--device", "cpu", *flags(SHT_SMALL)]
    outputs = []
    for source in (["--h5", h5], ["--set", f"data.pack_path={pack}"]):
        out = str(tmp_path / f"ltn{len(outputs)}.npy")
        work = str(tmp_path / f"work{len(outputs)}")
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["gen-pseudo", "--preset", "sht_ltn", *source,
                             *lists, "--kind", "ltn", "--ckpt", ckpt,
                             "--out", out]) == 0
            assert cli.main(["coteach", "--stn-preset", "sht_stn",
                             "--ltn-preset", "sht_ltn", "--workdir", work,
                             *source, *lists, "--batch-size", "2",
                             "--rounds", "2", "--stn-epochs", "1",
                             "--ltn-epochs", "1", "--set", "inter_epoch=1",
                             "--set", f"model_save_dir={work}/ckpt"]) == 0
        outputs.append([load_pseudo_labels(p) for p in (
            out, os.path.join(work, "stn_pseudo.npy"),
            os.path.join(work, "ltn_pseudo.npy"))])
    for got, want in zip(*outputs):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
