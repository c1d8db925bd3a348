"""Multi-process runs of the PyTorch package through its CLI and its
checkpoints, on the CPU over gloo:

- ``train --multihost 127.0.0.1:PORT --num-processes 2 --process-id i`` in
  two processes: both log the ``multihost:`` line and the same best AUC,
  and rank 0's metrics equal a one-process run's (the presets' dropouts
  on);
- two co-teaching rounds the same way, writing the shared artifacts behind
  the barrier;
- a checkpoint written under a 2x2 mesh loads in one process bit for bit,
  and one written by one process loads under the mesh bit for bit;
- the argparse tree equals the JAX CLI's on ``--mesh``, ``--multihost``,
  ``--num-processes`` and ``--process-id`` (the two differ only by the
  port's ``--device``).

Every child has its own deadline (120 s) and is killed past it.
"""

import argparse
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from fixtures import make_sht_like
from lstc_vad_tpu_torch.ckpt import load_checkpoint, save_checkpoint
from lstc_vad_tpu_torch.parallel import dryrun
from lstc_vad_tpu_torch.train.state import create_train_state
from lstc_vad_tpu_torch.train.steps import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"encoder.d_model": 16, "encoder.d_inner": 32, "encoder.n_head": 2,
         "encoder.d_k": 8, "encoder.d_v": 8, "encoder.n_layers": 1,
         "head.d_model": 16, "head.hidden_dim": 8, "data.n_patch": 4,
         "data.d_model": 16, "data.part_num": 4, "data.part_len": 3,
         "encoder.window_depth": 3}
SET_FLAGS = [a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]
TIMEOUT = 120


@pytest.fixture(scope="module")
def sht(tmp_path_factory):
    return make_sht_like(str(tmp_path_factory.mktemp("sht")), n_patch=4,
                         d_model=16, n_clips=(14, 30))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(argvs, cwd):
    """Each argv as ``python -m lstc_vad_tpu_torch`` at once; their
    (returncode, stdout + stderr), all killed past the deadline."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "lstc_vad_tpu_torch",
                               *argv], cwd=cwd, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _data_flags(sht):
    h5, train_txt, test_txt, mask_dir = sht
    return ["--h5", h5, "--train-txt", train_txt, "--test-txt", test_txt,
            "--mask-dir", mask_dir, "--batch-size", "2", "--device", "cpu",
            *SET_FLAGS]


def _multihost(n):
    port = _free_port()
    return [["--multihost", f"127.0.0.1:{port}", "--num-processes", str(n),
             "--process-id", str(i)] for i in range(n)]


def test_cli_train_multihost_two_processes(sht, tmp_path):
    common = ["train", "--preset", "sht_ltn", "--epochs", "1",
              *_data_flags(sht)]
    (rc,  out), = _run([[*common, "--metrics-jsonl",
                         str(tmp_path / "one.jsonl")]], str(tmp_path))
    assert rc == 0, out
    runs = _run([[*common, "--metrics-jsonl", str(tmp_path / "mh.jsonl"),
                  *mh] for mh in _multihost(2)], str(tmp_path))
    best = []
    for i, (rc, out) in enumerate(runs):
        assert rc == 0, out
        assert f"multihost: process {i}/2, global mesh data=1 model=2" in out
        best.append(re.findall(r"best test AUC (\S+)", out))
    assert best[0] == best[1] and best[0]

    def evals(name):
        with open(tmp_path / name) as f:
            return [r for r in map(json.loads, f) if r["kind"] == "eval"]

    one, mh = evals("one.jsonl"), evals("mh.jsonl")  # rank 0 wrote it once
    assert len(one) == len(mh) == 1
    assert mh[0]["auc_test"] == pytest.approx(one[0]["auc_test"], abs=1e-6)
    assert mh[0]["loss"] == pytest.approx(one[0]["loss"], rel=1e-4)


def test_cli_coteach_multihost_two_processes(sht, tmp_path):
    work = tmp_path / "work"
    common = ["coteach", "--stn-preset", "sht_stn", "--ltn-preset",
              "sht_ltn", "--workdir", str(work), "--rounds", "2",
              "--stn-epochs", "1", "--ltn-epochs", "1", "--stn-threshold",
              "0.5", "--ltn-threshold", "0.4", *_data_flags(sht)]
    runs = _run([[*common, *mh] for mh in _multihost(2)], str(tmp_path))
    aucs = []
    for rc, out in runs:
        assert rc == 0, out
        assert "co-teaching round 1 complete" in out
        aucs.append(re.findall(r"test AUC (\S+)", out))
    assert aucs[0] == aucs[1] and len(aucs[0]) >= 2
    for name in ("stn_pseudo.npy", "ltn_pseudo.npy"):
        labels = np.load(work / name, allow_pickle=True).tolist()
        assert labels and all(np.isfinite(v).all() for v in labels.values())


def _same(got: dict, want: dict):
    assert got["step"] == want["step"]
    for part in ("encoder", "head"):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=k)
    assert len(got["sums"]) == len(want["sums"])
    for a, b in zip(got["sums"], want["sums"]):
        np.testing.assert_array_equal(a, b)


def _from_file(payload) -> dict:
    return {"step": payload["step"],
            "encoder": {k: v.numpy() for k, v in payload["encoder"].items()},
            "head": {k: v.numpy() for k, v in payload["head"].items()},
            "sums": [s["sum"].numpy() for _, s in
                     sorted(payload["optimizer"]["state"].items())]}


def test_checkpoint_under_a_mesh_loads_in_one_process(tmp_path):
    cfg = dryrun.tiny_ltn_config(batch_size=4)
    path = str(tmp_path / "state.pt")
    out = dryrun.spawn(dryrun.run_checkpoint, 4, (cfg, path, (2, 2)))
    assert not os.path.exists(path + ".next")
    written = _from_file(load_checkpoint(path))
    for got in out:  # every rank gathered the same whole state
        _same(got, written)
    state = load_checkpoint(path, create_train_state(cfg, "cpu"))
    assert state.step == 1
    assert torch.equal(state.encoder.layer_stack[0].slf_attn.w_qs.weight,
                       torch.from_numpy(written["encoder"][
                           "layer_stack.0.slf_attn.w_qs.weight"]))


def test_checkpoint_of_one_process_loads_under_a_mesh(tmp_path):
    cfg = dryrun.tiny_ltn_config(batch_size=4)
    path = str(tmp_path / "state.pt")
    state = create_train_state(cfg, "cpu")
    make_train_step(cfg)(state, *dryrun._batch(cfg, seed=3))
    save_checkpoint(path, state)
    want = _from_file(load_checkpoint(path))
    for got in dryrun.spawn(dryrun.run_load_checkpoint, 4,
                            (cfg, path, (2, 2))):
        _same(got, want)


def _subcommands(main):
    """{subcommand: option strings} of a CLI's argparse tree, captured at
    parse time."""
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        seen["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            main(["info"])
    finally:
        argparse.ArgumentParser.parse_args = orig
    sub = next(a for a in seen["parser"]._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {o for act in p._actions for o in act.option_strings}
            for name, p in sub.choices.items()}


def test_parser_matches_jax_on_the_multi_device_flags():
    from lstc_vad_tpu.cli.main import main as jax_main
    from lstc_vad_tpu_torch.cli import main as port_main

    jax_tree, port_tree = _subcommands(jax_main), _subcommands(port_main)
    flags = {"--mesh", "--multihost", "--num-processes", "--process-id"}
    for name, opts in jax_tree.items():
        assert opts & flags == port_tree[name] & flags, name
        assert port_tree[name] - opts <= {"--device"}, name
        assert opts - port_tree[name] == set(), name
    assert set(port_tree) == set(jax_tree)
    assert port_tree["benchmark"] == jax_tree["benchmark"]
    assert "--mesh" in port_tree["sweep"] and "--mesh" in port_tree["train"]
    assert "--multihost" in port_tree["coteach"]


@pytest.mark.parametrize("argv,match", [
    (["train", "--preset", "sht_ltn", "--mesh", "2x2"], "torchrun"),
    (["train", "--preset", "sht_ltn", "--mesh", "1x1", "--multihost",
      "auto"], "drop --mesh"),
    (["train", "--preset", "sht_ltn", "--multihost", "127.0.0.1:1"],
     "--num-processes and --process-id"),
    (["evaluate", "--preset", "sht_ltn", "--mesh", "1x1", "--artifact",
      "a"], "drop one"),
    (["gen-pseudo", "--preset", "sht_ltn", "--kind", "ltn", "--out", "o",
      "--mesh", "1x1", "--artifact", "a"], "drop one"),
    (["train", "--preset", "sht_ltn", "--mesh", "1x3"], "divide the head"),
    (["train", "--preset", "sht_ltn", "--mesh", "two"], "DPxTP"),
])
def test_cli_refuses_a_wrong_mesh(argv, match):
    from lstc_vad_tpu_torch import cli

    with pytest.raises(SystemExit, match=match):
        cli.main([*argv, "--device", "cpu"])
    assert not torch.distributed.is_initialized()
