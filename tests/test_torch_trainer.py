"""The PyTorch package's Trainer against the JAX package's
(lstc_vad_tpu/train/driver.py), end to end on a ShanghaiTech-shaped
synthetic set (tests/fixtures.py).

Both trainers start from the same weights (JAX init, mapped by
ckpt/interop.py), draw the same batches (the numpy sampler, same seed) and
run 2 epochs with every dropout off and an evaluation after each.  Per-epoch
losses agree at rel 2e-4, test and train AUCs within 1e-4, the final
parameters at rtol 1e-3 / atol 1e-5 (the train-step tolerances).  The
same holds with the features read from a ``.lstcpack`` made from the h5
(both Trainers then batch through their packs' native gathers).  Then
``python -m lstc_vad_tpu_torch train --device cpu`` runs on the same set,
from the h5 and from the pack.
"""

import json
import logging
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fixtures import make_sht_like
from lstc_vad_tpu.config import preset as jax_preset
from lstc_vad_tpu.train.driver import Trainer as JaxTrainer
from lstc_vad_tpu_torch.ckpt import load_checkpoint
from lstc_vad_tpu_torch.config import preset, replace
from lstc_vad_tpu_torch.data.packed import (PackedStore, PackFormatError,
                                            pack_h5)
from lstc_vad_tpu_torch.train.driver import Trainer

from test_torch_train_step import (flat_from_jax, named_params, port_config,
                                   port_state)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"encoder.d_model": 32, "encoder.d_inner": 48, "encoder.n_head": 2,
         "encoder.d_k": 16, "encoder.d_v": 16, "encoder.n_layers": 2,
         "head.d_model": 32, "head.hidden_dim": 16, "data.n_patch": 16,
         "data.d_model": 32}
NO_DROPOUT = {"encoder.attn_dropout": 0.0, "encoder.fc_dropout": 0.0,
              "encoder.ffn_dropout": 0.0, "encoder.position_dropout": 0.0,
              "head.dropout": 0.0}
SET_FLAGS = [a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]


@pytest.fixture(scope="module")
def sht(tmp_path_factory):
    return make_sht_like(str(tmp_path_factory.mktemp("sht")), n_patch=16,
                         d_model=32)


def _overrides(sht, tmp_path):
    h5, train_txt, test_txt, mask_dir = sht
    return {**SMALL, **NO_DROPOUT, "data.h5_path": h5,
            "data.train_txt": train_txt, "data.test_txt": test_txt,
            "data.test_mask_dir": mask_dir, "data.batch_size": 2,
            "inter_epoch": 1, "model_save_dir": str(tmp_path / "ckpt")}


@pytest.fixture(scope="module")
def sht_pack(sht, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pack") / "feats.lstcpack")
    pack_h5(sht[0], path)
    return path


def _fit_against_jax(jcfg):
    """The JAX Trainer and the port's, from the same JAX weights, fit 2
    epochs; their losses, AUCs and final parameters must agree.  Returns
    the port's Trainer."""
    jtrainer = JaxTrainer(jcfg)
    pcfg = port_config(jcfg)
    trainer = Trainer(pcfg, device="cpu")
    params0 = jax.tree.map(np.asarray, jtrainer.state.params)
    loaded = port_state(pcfg, params0)
    trainer.state.encoder.load_state_dict(loaded.encoder.state_dict())
    trainer.state.head.load_state_dict(loaded.head.state_dict())

    ref = jtrainer.fit(2)
    ours = trainer.fit(2)
    assert ours.steps == ref.steps == 2
    assert len(ours.history) == len(ref.history) == 2
    for got, want in zip(ours.history, ref.history):
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-4)
        assert abs(got["auc_test"] - want["auc_test"]) <= 1e-4
        assert abs(got["auc_train"] - want["auc_train"]) <= 1e-4
    params = named_params(trainer.state)
    final = flat_from_jax(jax.tree.map(np.asarray, jtrainer.state.params),
                          pcfg.head.kind)
    for name, want in final.items():
        np.testing.assert_allclose(params[name].detach().numpy(), want,
                                   rtol=1e-3, atol=1e-5, err_msg=name)
    assert trainer.best_params is not None and trainer.eval_seconds > 0
    return trainer


@pytest.mark.parametrize("preset_name", ["sht_ltn", "sht_stn"])
def test_trainer_matches_jax(sht, tmp_path, preset_name):
    _fit_against_jax(jax_preset(preset_name, **_overrides(sht, tmp_path)))


def test_trainer_from_a_pack_matches_jax(sht, sht_pack, tmp_path):
    """``data.pack_path`` set: both Trainers read the same pack (batches
    through get_batch and the native gather) and agree as from the h5."""
    trainer = _fit_against_jax(jax_preset(
        "sht_ltn", **_overrides(sht, tmp_path), **{"data.pack_path":
                                                   sht_pack}))
    assert isinstance(trainer.store, PackedStore) and trainer.store.native


def test_trainer_with_a_bf16_train_wire_matches_jax(sht, tmp_path):
    """``data.transfer_dtype="bfloat16"``: both Prefetchers round the batch
    features to bf16 on the host and both steps take them into the encoder
    as bf16, so the two Trainers agree at the f32 bars above."""
    trainer = _fit_against_jax(jax_preset(
        "sht_ltn", **_overrides(sht, tmp_path),
        **{"data.transfer_dtype": "bfloat16"}))
    seen = []
    hook = trainer.state.encoder.register_forward_hook(
        lambda m, i, o: seen.append(i[0].dtype))
    trainer.train_epoch()
    hook.remove()
    assert seen == [torch.bfloat16]


def test_evaluate_runs_in_eval_mode_and_steps_in_train_mode(sht, tmp_path):
    cfg = preset("sht_ltn", **_overrides(sht, tmp_path))
    trainer = Trainer(cfg, device="cpu")
    modules = (trainer.state.encoder, trainer.state.head)
    first = trainer.evaluate("test")
    assert not any(m.training for m in modules)
    seen = []
    hook = trainer.state.encoder.register_forward_hook(
        lambda m, i, o: seen.append(m.training))
    trainer.train_epoch()
    hook.remove()
    assert seen == [True]
    trainer.evaluate("test")
    assert seen == [True] and not any(m.training for m in modules)
    assert np.isfinite(first)


def test_metrics_jsonl_best_params_and_iteration_log(sht, tmp_path, caplog):
    path = str(tmp_path / "m.jsonl")
    cfg = preset("sht_ltn", **_overrides(sht, tmp_path), metrics_jsonl=path,
                 log_every_step=1)
    trainer = Trainer(cfg, device="cpu")
    with caplog.at_level(logging.INFO, logger="lstc_vad_tpu_torch"):
        result = trainer.fit(2)
    assert caplog.text.count("[iter ") == 2
    with open(path) as f:
        records = [json.loads(line) for line in f]
    assert [r["kind"] for r in records] == ["train", "eval", "train", "eval"]
    assert records[2]["step"] == 2 and "snippets_per_sec" in records[0]
    best_epoch = result.best_train_epoch
    assert result.history[best_epoch]["auc_train"] == result.best_train_auc


@pytest.mark.parametrize("change,error,match", [
    ({"data.dataset": "UCF", "eval_train_split": True}, ValueError,
     "UCF has no train-split"),
    ({"data.pack_path": "missing.lstcpack"}, PackFormatError,
     "unreadable pack"),
    ({"data.test_mask_dir": ""}, ValueError, "test_mask_dir"),
    ({"data.train_txt": ""}, ValueError, "train_txt"),
])
def test_trainer_refuses_what_is_not_ported(sht, tmp_path, change, error,
                                            match):
    cfg = preset("sht_ltn", **{**_overrides(sht, tmp_path), **change})
    with pytest.raises(error, match=match):
        Trainer(cfg, device="cpu")


def test_eval_only_builds_no_dataset_and_no_step(sht, tmp_path):
    cfg = preset("sht_ltn", **{**_overrides(sht, tmp_path),
                               "data.train_txt": ""})
    trainer = Trainer(cfg, device="cpu", eval_only=True)
    assert trainer.dataset is None and trainer.step_fn is None
    assert trainer.train_records == []
    # the test split streams: nothing is memoized by an evaluation
    assert np.isfinite(trainer.evaluate("test"))
    assert all(v._feat is None for v in trainer.test_videos)


def test_fit_calls_on_eval_after_each_evaluation(sht, tmp_path):
    cfg = preset("sht_stn", **{**_overrides(sht, tmp_path), "inter_epoch": 2})
    trainer = Trainer(cfg, device="cpu")
    calls = []
    result = trainer.fit(3, on_eval=lambda *a: calls.append(a))
    assert [entry["epoch"] for _, _, entry in calls] == [0, 2]
    assert all(t is trainer and r is result for t, r, _ in calls)
    assert [entry for _, _, entry in calls] == result.history


def test_scoring_modules_hold_the_best_weights_apart(sht, tmp_path):
    """Pseudo labels are scored by a copy holding ``best_params``; the
    Trainer's own modules keep their weights and their mode."""
    cfg = preset("sht_ltn", **_overrides(sht, tmp_path))
    trainer = Trainer(cfg, device="cpu")
    trainer.fit(1)
    live = {k: v.clone() for k, v in trainer.params()["head"].items()}
    trainer.best_params = {
        name: {k: v + 1.0 if v.is_floating_point() else v
               for k, v in sd.items()}
        for name, sd in trainer.params().items()}
    trainer.state.head.train()
    encoder, head = trainer.scoring_modules()
    assert not encoder.training and not head.training
    assert encoder is not trainer.state.encoder
    for name, module in (("encoder", encoder), ("head", head)):
        for k, v in module.state_dict().items():
            assert torch.equal(v, trainer.best_params[name][k]), (name, k)
    for k, v in live.items():
        assert torch.equal(trainer.params()["head"][k], v), k
    assert trainer.state.head.training


def test_autosave_resume_equals_an_uninterrupted_fit(sht, tmp_path,
                                                     monkeypatch):
    """fit(3, autosave_every=1) saves in the background at the top of
    epochs 1 and 2; restoring that autosave (and the sampler's state at
    that point) and fitting the last epoch gives the uninterrupted run's
    parameters exactly.  Each background write is held back until the
    next evaluation, so the next epoch's steps have updated the live state
    in place before it starts: the file must still hold the state as it
    was when the save began."""
    import copy
    import threading

    from lstc_vad_tpu_torch.ckpt import io as ckpt_io

    cfg = preset("sht_ltn", **{**_overrides(sht, tmp_path),
                               **{"encoder.attn_dropout": 0.2,
                                  "head.dropout": 0.6}})
    straight = Trainer(cfg, device="cpu")
    straight.fit(3)

    gate, write = threading.Event(), ckpt_io._write

    def gated_write(payload, dest):
        assert gate.wait(timeout=60)
        gate.clear()
        write(payload, dest)

    monkeypatch.setattr(ckpt_io, "_write", gated_write)
    autosaved = Trainer(cfg, device="cpu")
    at_epoch_1 = {}

    def on_eval(trainer, result, entry):
        if entry["epoch"] == 1:  # the state the epoch-2 autosave writes
            ds = trainer.dataset
            at_epoch_1.update(
                rng=copy.deepcopy(ds.rng), perms=(ds._norm_perm.copy(),
                                                  ds._abnorm_perm.copy()),
                params={k: p.detach().clone() for k, p in
                        named_params(trainer.state).items()})
        if entry["epoch"] >= 1:
            gate.set()  # let the autosave of this epoch's top write

    autosaved.fit(3, on_eval=on_eval, autosave_every=1)
    for name, p in named_params(autosaved.state).items():
        assert torch.equal(p, named_params(straight.state)[name]), name
    path = os.path.join(cfg.model_save_dir, "autosave")
    assert os.path.isfile(path) and not os.path.exists(path + ".next")
    saved = load_checkpoint(path)
    assert saved["step"] == 2
    for name, want in at_epoch_1["params"].items():
        group, key = name.split(".", 1)
        assert torch.equal(saved[group][key], want), name

    resumed = Trainer(replace(cfg, seed=5), device="cpu")
    resumed.restore_state(path)
    resumed.dataset.rng = at_epoch_1["rng"]
    resumed.dataset._norm_perm, resumed.dataset._abnorm_perm = \
        at_epoch_1["perms"]
    resumed.fit(1)
    assert resumed.state.step == straight.state.step == 3
    for name, p in named_params(resumed.state).items():
        assert torch.equal(p, named_params(straight.state)[name]), name


def test_trainer_needs_a_card_unless_told_cpu(sht, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(preset("sht_ltn", **_overrides(sht, tmp_path)))


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "lstc_vad_tpu_torch", "train",
                          *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stderr


def test_cli_train_on_the_cpu(sht, tmp_path):
    h5, train_txt, test_txt, mask_dir = sht
    state, best = str(tmp_path / "state.pt"), str(tmp_path / "best.pt")
    jsonl = str(tmp_path / "m.jsonl")
    common = ["--preset", "sht_ltn", "--device", "cpu", "--h5", h5,
              "--train-txt", train_txt, "--test-txt", test_txt,
              "--mask-dir", mask_dir, "--batch-size", "2",
              "--save-dir", str(tmp_path / "ckpt"), *SET_FLAGS]
    log = _cli(*common, "--epochs", "2", "--metrics-jsonl", jsonl,
               "--save-state", state, "--save-best", best,
               "--set", "inter_epoch=1")
    assert "best test AUC" in log
    with open(jsonl) as f:
        assert [json.loads(x)["kind"] for x in f] == ["train", "eval"] * 2
    saved = load_checkpoint(state)
    assert saved["step"] == 2 and set(saved["optimizer"]) == {
        "state", "param_groups"}
    assert set(load_checkpoint(best)) == {"encoder", "head"}
    log = _cli(*common, "--epochs", "1", "--resume", state,
               "--save-state", state)
    assert "at step 2" in log
    assert load_checkpoint(state)["step"] == 3


def test_cli_train_from_a_pack_equals_from_the_h5(sht, sht_pack, tmp_path):
    """``train --set data.pack_path=...`` logs the same epochs as ``train
    --h5``: the same batches, so the same losses and AUCs."""
    h5, train_txt, test_txt, mask_dir = sht
    common = ["--preset", "sht_ltn", "--device", "cpu", "--train-txt",
              train_txt, "--test-txt", test_txt, "--mask-dir", mask_dir,
              "--batch-size", "2", "--epochs", "2", "--set", "inter_epoch=1",
              "--save-dir", str(tmp_path / "ckpt"), *SET_FLAGS]
    records = []
    for source in (["--h5", h5], ["--set", f"data.pack_path={sht_pack}"]):
        jsonl = str(tmp_path / f"m{len(records)}.jsonl")
        _cli(*common, *source, "--metrics-jsonl", jsonl)
        with open(jsonl) as f:
            records.append([{k: v for k, v in json.loads(line).items()
                             if k in ("kind", "loss", "auc_test",
                                      "auc_train")} for line in f])
    assert records[0] == records[1] and len(records[0]) == 4


def test_cli_train_rejects_unported_presets():
    from lstc_vad_tpu_torch import cli

    # a mesh larger than the one launched process
    with pytest.raises(SystemExit, match="torchrun"):
        cli.main(["train", "--preset", "sht_ltn", "--device", "cpu",
                  "--mesh", "2x2"])
    with pytest.raises(SystemExit, match="unknown config path"):
        cli.main(["train", "--preset", "sht_ltn", "--device", "cpu",
                  "--set", "optim.nope=1"])


def test_port_config_twin_is_exact():
    """The twin the parity tests build has every field of the port's
    preset: the two config trees have not drifted apart."""
    twin = port_config(jax_preset("sht_ltn"))
    assert twin == replace(preset("sht_ltn"), **{"encoder.attn_impl": "auto"})
