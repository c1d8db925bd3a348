"""Checkpoints of the PyTorch package (lstc_vad_tpu_torch/ckpt/io.py), with
the guarantees of the JAX package's lstc_vad_tpu/ckpt/orbax_io.py:

- a save -> load round trip restores parameters, Adagrad state, step and
  seed exactly, and a resumed state takes the same next step (dropout on);
- a save goes through ``<path>.next`` and parks the old file at ``.old``, so
  a crash leaves one whole checkpoint that the load finds;
- the parameters' state_dicts keep the reference's key layout.
"""

import logging
import os
import threading

import numpy as np
import pytest
import torch

from fixtures import make_sht_like
from lstc_vad_tpu_torch.ckpt import io as ckpt_io
from lstc_vad_tpu_torch.ckpt import (load_checkpoint, save_checkpoint,
                                     wait_for_saves)
from lstc_vad_tpu_torch.config import preset, replace
from lstc_vad_tpu_torch.models import Encoder
from lstc_vad_tpu_torch.train import create_train_state, make_train_step
from lstc_vad_tpu_torch.train.driver import Trainer

from test_torch_train_step import batch, jax_config, named_params, port_config
from test_torch_trainer import SMALL

CFG = port_config(jax_config(
    "ltn", **{"encoder.attn_dropout": 0.2, "encoder.fc_dropout": 0.2,
              "encoder.ffn_dropout": 0.1, "head.dropout": 0.6}))


def _trained(seed=0, steps=2):
    state = create_train_state(CFG, device="cpu", seed=seed)
    step = make_train_step(CFG)
    for i in range(steps):
        step(state, *batch(np.random.default_rng(i)))
    return state


def _assert_same_state(a, b):
    assert (a.step, a.seed) == (b.step, b.seed)
    pa, pb = named_params(a), named_params(b)
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
        sa = a.optimizer.state.get(pa[name], {})
        sb = b.optimizer.state.get(pb[name], {})
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(torch.as_tensor(sa[k]),
                               torch.as_tensor(sb[k])), (name, k)


def test_round_trip_restores_the_full_state(tmp_path):
    state = _trained()
    path = str(tmp_path / "state.pt")
    save_checkpoint(path, state)
    assert os.listdir(tmp_path) == ["state.pt"]  # no .next / .old left
    fresh = create_train_state(CFG, device="cpu", seed=99)
    restored = load_checkpoint(path, fresh)
    assert restored is fresh
    _assert_same_state(restored, state)


def test_resume_takes_the_same_next_step(tmp_path):
    state = _trained()
    path = str(tmp_path / "state.pt")
    save_checkpoint(path, state)
    resumed = load_checkpoint(path, create_train_state(CFG, device="cpu",
                                                       seed=5))
    step = make_train_step(CFG)
    data = batch(np.random.default_rng(10))
    _, m1 = step(state, *data)
    _, m2 = step(resumed, *data)
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_same_state(state, resumed)


def test_params_checkpoint_keeps_the_reference_layout(tmp_path):
    state = _trained(steps=1)
    path = str(tmp_path / "params.pt")
    save_checkpoint(path, {"encoder": state.encoder.state_dict(),
                           "head": state.head.state_dict()})
    saved = load_checkpoint(path)
    assert set(saved) == {"encoder", "head"}
    # a fresh module of the reference layout takes it strictly
    enc = Encoder(CFG.encoder, device="cpu")
    enc.load_state_dict(saved["encoder"], strict=True)
    assert "layer_stack.0.slf_attn.relative_position_bias_table" in saved[
        "encoder"]
    # loading parameters into a state leaves its step and optimizer alone
    fresh = create_train_state(CFG, device="cpu", seed=3)
    load_checkpoint(path, fresh)
    assert fresh.step == 0
    for name, p in named_params(fresh).items():
        assert torch.equal(p, named_params(state)[name]), name


@pytest.mark.parametrize("leftover", [".next", ".old"])
def test_leftover_next_or_old_is_restored(tmp_path, caplog, leftover):
    """A crash after the new file was written but before its promotion
    leaves ``.next``; one between parking and promotion leaves ``.old``."""
    state = _trained(steps=1)
    path = str(tmp_path / "state.pt")
    save_checkpoint(path, state)
    os.replace(path, path + leftover)
    with caplog.at_level(logging.WARNING, logger="lstc_vad_tpu_torch"):
        restored = load_checkpoint(path, create_train_state(CFG, "cpu", 4))
    _assert_same_state(restored, state)
    assert "fallback" in caplog.text and leftover in caplog.text


def test_unreadable_checkpoint_falls_back_to_old(tmp_path):
    old = _trained(steps=1)
    path = str(tmp_path / "state.pt")
    save_checkpoint(path, old)
    os.replace(path, path + ".old")
    with open(path, "wb") as f:
        f.write(b"half a file")
    restored = load_checkpoint(path, create_train_state(CFG, "cpu", 4))
    _assert_same_state(restored, old)


def test_save_keeps_the_old_checkpoint_until_the_new_one_is_whole(
        tmp_path, monkeypatch):
    first = _trained(steps=1)
    path = str(tmp_path / "state.pt")
    save_checkpoint(path, first)

    def crash(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_io, "_replace_keeping_old", crash)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(path, _trained(steps=2))
    # the committed checkpoint is untouched; the new one waits in .next
    restored = load_checkpoint(path, create_train_state(CFG, "cpu", 4))
    _assert_same_state(restored, first)
    assert os.path.exists(path + ".next")


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none.pt"))


def test_async_save_copies_before_returning(tmp_path, monkeypatch):
    """The background write holds the state as it was at the call: a step
    that updates the parameters and Adagrad's sums in place before the
    write starts changes nothing in the file."""
    state = _trained(steps=1)
    before = {k: v.detach().clone() for k, v in named_params(state).items()}
    sums = {k: state.optimizer.state[p]["sum"].clone()
            for k, p in named_params(state).items()}
    path = str(tmp_path / "state.pt")
    gate, write = threading.Event(), ckpt_io._write

    def gated_write(payload, dest):
        assert gate.wait(timeout=60)
        write(payload, dest)

    monkeypatch.setattr(ckpt_io, "_write", gated_write)
    save_checkpoint(path, state, asynchronous=True)
    make_train_step(CFG)(state, *batch(np.random.default_rng(7)))
    gate.set()  # the write starts after the in-place update
    wait_for_saves()
    assert sorted(os.listdir(tmp_path)) == ["state.pt"]
    restored = load_checkpoint(path, create_train_state(CFG, "cpu", 4))
    assert restored.step == 1
    for name, p in named_params(restored).items():
        assert torch.equal(p, before[name]), name
        assert torch.equal(restored.optimizer.state[p]["sum"], sums[name])


def test_failed_background_write_raises_at_wait(tmp_path, monkeypatch):
    state = _trained(steps=1)
    path = str(tmp_path / "state.pt")
    save_checkpoint(path, state)

    def crash(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_io, "_replace_keeping_old", crash)
    save_checkpoint(path, _trained(steps=2), asynchronous=True)
    with pytest.raises(OSError, match="disk full"):
        wait_for_saves()
    wait_for_saves()  # raised once; the failed save is dropped
    # the committed checkpoint is untouched
    restored = load_checkpoint(path, create_train_state(CFG, "cpu", 4))
    _assert_same_state(restored, state)


def test_failed_background_write_raises_at_the_next_save(tmp_path,
                                                        monkeypatch):
    path = str(tmp_path / "state.pt")
    calls = []

    def crash_once(src, dst):
        calls.append(dst)
        if len(calls) == 1:
            raise OSError("disk full")
        os.replace(src, dst)

    monkeypatch.setattr(ckpt_io, "_replace_keeping_old", crash_once)
    save_checkpoint(path, _trained(steps=1), asynchronous=True)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(path, _trained(steps=2), asynchronous=True)
    second = _trained(steps=2)
    save_checkpoint(path, second, asynchronous=True)
    wait_for_saves()
    _assert_same_state(load_checkpoint(path, create_train_state(CFG, "cpu",
                                                                4)), second)


def test_trainer_save_and_restore_state(tmp_path):
    h5,train_txt, test_txt, mask_dir = make_sht_like(
        str(tmp_path / "d"), n_patch=16, d_model=32)
    cfg = preset("sht_ltn", **SMALL, **{
        "data.h5_path": h5, "data.train_txt": train_txt,
        "data.test_txt": test_txt, "data.test_mask_dir": mask_dir,
        "data.batch_size": 2})
    a = Trainer(cfg, device="cpu")
    a.fit(1)
    path = str(tmp_path / "s.pt")
    a.save_state(path)
    b = Trainer(replace(cfg, seed=1), device="cpu")  # other weights, seed
    b.restore_state(path)
    _assert_same_state(a.state, b.state)
