"""The PyTorch package's Trainer, scorers, co-teaching and train step on a
(data, model) mesh of gloo processes on the CPU, held to the same run in one
process, as tests/test_trainer_mesh.py holds the JAX package's mesh Trainer
to its single-device run.

Every multi-process run goes through parallel/dryrun.py::spawn: a
``file://`` rendezvous under a fresh directory (no TCP port to collide under
xdist), the package's own worker functions (the children import neither JAX
nor the test modules), and a deadline of its own that kills the children.
"""

import math

import numpy as np
import pytest
import torch

import test_train_e2e as e2e
from fixtures import make_sht_like
from lstc_vad_tpu_torch.config import replace
from lstc_vad_tpu_torch.parallel import dryrun
from lstc_vad_tpu_torch.train.driver import Trainer
from test_golden_pipeline import _cfg as golden_cfg
from test_torch_train_step import port_config


def _cfg(tmp_path, model, **kw):
    """tests/test_train_e2e.py's config (SMALL_ENC, the presets' dropouts
    on) in the port's dataclasses."""
    return replace(port_config(e2e._cfg(tmp_path, model)), **kw)


def test_trainer_on_mesh_matches_single_process(tmp_path):
    """A 2x2 Trainer's epoch with dropout on equals the unsharded one: the
    masks are drawn at the global shapes from the same generators, the MIL
    loss sees the whole batch, and the gradients are summed over "data"."""
    cfg = _cfg(tmp_path / "data", "stn")
    assert cfg.encoder.attn_dropout > 0 and cfg.head.dropout > 0
    plain = Trainer(cfg, device="cpu")
    r_plain = plain.fit(epochs=1)
    out = dryrun.spawn(dryrun.run_trainer, 4, (cfg, 1, (2, 2)))
    want = dryrun.full_params(plain.state)
    for rank, got in enumerate(out):
        h, hp = got["history"][0], r_plain.history[0]
        assert h["loss"] == pytest.approx(hp["loss"], rel=1e-4), rank
        assert h["auc_test"] == pytest.approx(hp["auc_test"], abs=1e-6)
        assert set(got["params"]) == set(want)
        for name, value in want.items():
            np.testing.assert_allclose(got["params"][name], value,
                                       rtol=2e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_remat_trainer_on_mesh_matches_single_process(tmp_path, shape):
    """With ``encoder.remat`` the layers are recomputed in the backward,
    outside the step's forward: the recompute must draw the same global
    masks as the forward did, so a remat Trainer's epoch on a mesh (dropout
    on) equals the remat one without."""
    cfg = _cfg(tmp_path / "data", "stn", **{"encoder.remat": True})
    plain = Trainer(cfg, device="cpu")
    r_plain = plain.fit(epochs=1)
    want = dryrun.full_params(plain.state)
    for got in dryrun.spawn(dryrun.run_trainer, 2, (cfg, 1, shape)):
        h, hp = got["history"][0], r_plain.history[0]
        assert h["loss"] == pytest.approx(hp["loss"], rel=1e-4)
        assert h["auc_test"] == pytest.approx(hp["auc_test"], abs=1e-6)
        for name, value in want.items():
            np.testing.assert_allclose(got["params"][name], value,
                                       rtol=2e-4, atol=1e-5, err_msg=name)


def test_mesh_sharded_eval_matches(tmp_path):
    """Evaluation with data-sharded batches over a 2x2 mesh gives the
    unsharded AUC, on every process."""
    cfg = _cfg(tmp_path / "data", "ltn")
    want = Trainer(cfg, device="cpu", eval_only=True).evaluate("test")
    got = dryrun.spawn(dryrun.run_evaluate, 4, (cfg, (2, 2)))
    for auc in got:
        assert auc == pytest.approx(want, abs=1e-6)


def test_coteach_rounds_on_mesh(tmp_path):
    """Two co-teaching rounds with every round's Trainer on a 2x2 mesh
    (CLI ``coteach --mesh``): finite AUCs, the same on every process, and
    the artifacts written by rank 0 behind the barrier."""
    fixture = make_sht_like(str(tmp_path), n_patch=4, d_model=16,
                            n_clips=(14, 30), seed=7)
    stn = port_config(golden_cfg("stn", fixture, tmp_path))
    ltn = port_config(golden_cfg("ltn", fixture, tmp_path))
    out = dryrun.spawn(dryrun.run_coteach, 4,
                       (stn, ltn, str(tmp_path / "work"), 2, (2, 2)))
    for got in out:
        assert len(got["aucs"]) == 2
        assert all(math.isfinite(a) for a in got["aucs"])
        assert got["aucs"] == out[0]["aucs"]
        assert set(got["pseudo"]) == {"stn_pseudo.npy", "ltn_pseudo.npy"}


def _weights(cfg):
    from lstc_vad_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, "cpu", seed=4)
    return (state.encoder.state_dict(), state.head.state_dict())


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_step_gradients_and_clip_norm_match(shape):
    """One LTN step's loss and gradients (after the sum over "data") equal
    the single-process ones, with dropout on (trouble spot: the MIL hinge
    over the global batch); so do the norms the per-group clip uses, where
    the model shards' squares are summed over "model" and a replicated
    parameter is counted once."""
    cfg = dryrun.tiny_ltn_config(batch_size=4)
    weights = _weights(cfg)
    want = dryrun.run_grads(cfg, weights)
    n = shape[0] * shape[1]
    for got in dryrun.spawn(dryrun.run_grads, n, (cfg, weights, shape)):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert set(got["grads"]) == set(want["grads"])
        for name, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name], g, rtol=1e-4,
                                       atol=1e-6, err_msg=name)
        assert len(got["clip_norms"]) == 2
        np.testing.assert_allclose(got["clip_norms"], want["clip_norms"],
                                   rtol=1e-5)


def test_mesh_of_one_process_is_the_unsharded_step():
    """On a (1, 1) mesh every axis has one rank: no collective runs, every
    mask is drawn as the unsharded modules draw it and each Linear runs
    whole, so the step (dropout on) gives the single-process loss,
    gradients and clip norms bit for bit (both on one thread, as spawn
    runs its processes: the CPU kernels' sums follow the thread count)."""
    cfg = dryrun.tiny_ltn_config(batch_size=4)
    weights = _weights(cfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = dryrun.run_grads(cfg, weights)
    finally:
        torch.set_num_threads(threads)
    got, = dryrun.spawn(dryrun.run_grads, 1, (cfg, weights, (1, 1)))
    assert got["loss"] == want["loss"]
    assert got["clip_norms"] == want["clip_norms"]
    for name, g in want["grads"].items():
        np.testing.assert_array_equal(got["grads"][name], g, err_msg=name)


def test_bf16_sr_step_on_data_axis_matches():
    """A bf16 stochastic-rounding step on a 2x1 mesh: the SR noise is drawn
    at the global shapes like the dropout masks, so the loss equals the
    single-process step's.  Each rank's weight gradients are bf16 products
    over its own rows, rounded before the sum over "data", so they agree to
    a bf16 ulp of the largest entry."""
    cfg = replace(dryrun.tiny_ltn_config(batch_size=4),
                  **{"encoder.compute_dtype": "bfloat16",
                     "encoder.cast_sr": True})
    weights = _weights(cfg)
    want = dryrun.run_grads(cfg, weights)
    for got in dryrun.spawn(dryrun.run_grads, 2, (cfg, weights, (2, 1))):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        for name, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name], g, rtol=2 ** -7,
                                       atol=2 ** -7 * np.abs(g).max(),
                                       err_msg=name)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_remat_bf16_sr_step_on_mesh_matches(shape):
    """A remat bf16 stochastic-rounding step with dropout on: the recompute
    re-enters the step's layout, so it draws the forward's masks and SR
    noise, and the step's loss and gradients on the mesh are those of the
    same step without remat, bit for bit.  On the data axis both also equal
    the single-process remat step (to a bf16 ulp of the largest gradient,
    as above); on the model axis each rank's bf16 partial product is
    rounded before the sum, so only the remat equality is exact there."""
    cfg = replace(dryrun.tiny_ltn_config(batch_size=4),
                  **{"encoder.compute_dtype": "bfloat16",
                     "encoder.cast_sr": True, "encoder.remat": True})
    assert cfg.encoder.attn_dropout > 0
    weights = _weights(cfg)
    got = dryrun.spawn(dryrun.run_grads, 2, (cfg, weights, shape))
    no_remat = dryrun.spawn(dryrun.run_grads, 2, (
        replace(cfg, **{"encoder.remat": False}), weights, shape))
    for g, w in zip(got, no_remat):
        assert g["loss"] == w["loss"]
        for name, value in w["grads"].items():
            np.testing.assert_array_equal(g["grads"][name], value,
                                          err_msg=name)
    if shape[1] > 1:
        return
    want = dryrun.run_grads(cfg, weights)
    for g in got:
        assert g["loss"] == pytest.approx(want["loss"], rel=1e-5)
        for name, value in want["grads"].items():
            np.testing.assert_allclose(g["grads"][name], value, rtol=2 ** -7,
                                       atol=2 ** -7 * np.abs(value).max(),
                                       err_msg=name)


def test_step_refuses_a_whole_batch_on_a_data_axis():
    """On a data axis of 2 the step takes this process's feature rows; a
    whole batch is refused, naming to_global."""
    with pytest.raises(RuntimeError, match="to_global"):
        dryrun.spawn(dryrun.run_whole_batch_step, 2,
                     (dryrun.tiny_ltn_config(batch_size=4),))


def test_unsharded_state_is_unchanged():
    """Without a mesh the modules are as they were: the same names and
    shapes, no model axis."""
    from lstc_vad_tpu_torch.train.state import create_train_state

    cfg = dryrun.tiny_ltn_config()
    state = create_train_state(cfg, "cpu")
    assert state.mesh is None
    for m in state.encoder.modules():
        assert getattr(m, "tp", None) is None
    assert state.head.tp is None
    assert state.encoder.layer_stack[0].slf_attn.w_qs.weight.shape == (
        cfg.encoder.n_head * cfg.encoder.d_k, cfg.encoder.d_model)
    assert not hasattr(state.encoder, "mesh")
    assert torch.is_tensor(state.encoder.layer_stack[0].slf_attn
                           .relative_position_bias_table)
