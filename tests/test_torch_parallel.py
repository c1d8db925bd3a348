"""The PyTorch package's mesh layer (lstc_vad_tpu_torch/parallel/) against
the JAX package's (lstc_vad_tpu/parallel/): the factorization, the
tensor-parallel rules mapped through ckpt/interop.py, the global mesh, and
the multi-chip surface (train step, sharded evaluation, pseudo labels) on
2, 3 and 4 gloo processes against one process, and on 4 against the JAX
package's single-device surface from the same weights, at the bars of
lstc_vad_tpu/parallel/dryrun.py::assert_surface_matches.
"""

import inspect
import operator
import time

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from lstc_vad_tpu.parallel import dryrun as jax_dryrun
from lstc_vad_tpu.parallel.mesh import (factor_devices as jax_factor,
                                        param_sharding_rules as jax_rules)
from lstc_vad_tpu.train.state import create_train_state as jax_state
from lstc_vad_tpu_torch.ckpt.interop import (encoder_state_dict_from_jax,
                                             head_state_dict_from_jax,
                                             state_dict_from_jax)
from lstc_vad_tpu_torch.config import replace
from lstc_vad_tpu_torch.parallel import dryrun
from lstc_vad_tpu_torch.parallel.distributed import make_global_mesh
from lstc_vad_tpu_torch.parallel.mesh import (factor_devices,
                                              param_sharding_rules)
from test_torch_train_step import port_config

NO_DROPOUT = {"encoder.attn_dropout": 0.0, "encoder.fc_dropout": 0.0,
              "encoder.ffn_dropout": 0.0, "encoder.position_dropout": 0.0,
              "head.dropout": 0.0}


def test_factor_devices():
    cases = [((1,), (1, 1)), ((2,), (1, 2)), ((4,), (2, 2)), ((8,), (2, 4)),
             ((16,), (4, 4)), ((32,), (8, 4)), ((3,), (3, 1)),
             ((6, 8), (3, 2))]
    for args, want in cases:
        assert factor_devices(*args) == want == jax_factor(*args)
    assert factor_devices(16, max_model=8) == (2, 8)


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _set(tree, path, value):
    *head, last = path.split("/")
    for k in head:
        tree = tree[k]
    tree[last] = value


def test_sharding_rules_split_what_jax_splits():
    """Every JAX leaf mapped through the interop (kernels transposed): the
    port splits exactly the tensors the JAX rules split, on the dim the JAX
    split axis lands on, and replicates the rest."""
    cfg = jax_dryrun.tiny_ltn_config()
    params = jax.tree.map(np.asarray, jax_state(cfg)[0].params)
    zeros = jax.tree.map(np.zeros_like, params)
    split = 0
    for path, leaf in _paths(params):
        probe = jax.tree.map(np.copy, zeros)
        marked = np.arange(1, leaf.size + 1, dtype=np.float32).reshape(
            leaf.shape)
        _set(probe, path, marked)
        sd = {**{k: v for k, v in encoder_state_dict_from_jax(
            probe["encoder"]).items()},
              **{k: v for k, v in head_state_dict_from_jax(
                  probe["head"], "classifier").items()}}
        (key, tensor), = [(k, v) for k, v in sd.items() if v.any()]
        spec = jax_rules(path)
        dim = param_sharding_rules(key)
        if "model" not in spec:
            assert dim is None, (path, key)
            continue
        split += 1
        axis = list(spec).index("model")
        half = leaf.shape[axis] // 2
        want = set(np.take(marked, range(half), axis=axis).ravel())
        got = set(tensor.numpy().take(range(half), axis=dim).ravel())
        assert got == want, (path, key, dim)
    # per layer: q, k, v, fc, the bias table, w_1 (kernel, bias), w_2;
    # the head's first Linear (kernel, bias) and its second
    assert split == 8 * cfg.encoder.n_layers + 3


def test_rules_by_name():
    assert param_sharding_rules("layer_stack.0.slf_attn.w_qs.weight") == 0
    assert param_sharding_rules("layer_stack.2.slf_attn.fc.weight") == 1
    assert param_sharding_rules(
        "layer_stack.0.slf_attn.relative_position_bias_table") == 1
    assert param_sharding_rules("layer_stack.1.pos_ffn.w_1.bias") == 0
    assert param_sharding_rules("layer_stack.1.pos_ffn.w_2.bias") is None
    assert param_sharding_rules(
        "layer_stack.1.pos_ffn.layer_norm.weight") is None
    assert param_sharding_rules("classifier.3.weight") == 1
    assert param_sharding_rules("classifier.3.bias") is None
    assert param_sharding_rules("classifier.5.weight") is None
    assert param_sharding_rules(
        "layer_stack.0.slf_attn.relative_position_index") is None
    assert jax_rules("head/mlp/linear_2/kernel") == P()


def test_make_global_mesh_matches_factor_devices_default():
    """On 4 processes of one host the global mesh is data=2 x model=2, as
    factor_devices(4); joining again is a no-op; the cap tracks
    factor_devices'."""
    for got in dryrun.spawn(dryrun.run_global_mesh, 4, (8,)):
        assert got == {"shape": (2, 2), "rejoined": False}
    assert inspect.signature(
        make_global_mesh).parameters["max_model"].default == \
        inspect.signature(factor_devices).parameters["max_model"].default


@pytest.fixture(scope="module")
def single():
    return dryrun.run_multichip_surface(1, batch_size=6)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_surface_on_n_processes_matches_one(single, n):
    """2 (1x2), 3 (3x1) and 4 (2x2) processes against one, with the
    presets' dropouts on."""
    assert dryrun.tiny_ltn_config().encoder.attn_dropout > 0
    for rank, out in enumerate(dryrun.spawn(dryrun.run_multichip_surface, n,
                                            (n, 6))):
        assert out["n_pseudo_videos"] == 2
        dryrun.assert_surface_matches(single, out, f"{n} processes, "
                                                   f"rank {rank}")


def test_surface_on_4_processes_matches_jax(monkeypatch):
    """The port's 2x2 surface from the JAX package's initial weights
    against the JAX package's single-device surface, both dropout-free
    (the two packages draw different masks)."""
    orig = jax_dryrun.tiny_ltn_config

    def tiny(**kw):
        from lstc_vad_tpu.config import replace as jax_replace

        return jax_replace(orig(**kw), **NO_DROPOUT)

    monkeypatch.setattr(jax_dryrun, "tiny_ltn_config", tiny)
    jcfg = tiny(batch_size=4)
    params = jax.tree.map(np.asarray, jax_state(jcfg)[0].params)
    base = jax_dryrun.run_multichip_surface(1, batch_size=4)
    pcfg = replace(port_config(jcfg), **{"encoder.attn_impl": "plain"})
    weights = state_dict_from_jax(params["encoder"], params["head"],
                                  pcfg.encoder, pcfg.head.kind)
    for rank, out in enumerate(dryrun.spawn(
            dryrun.run_multichip_surface, 4, (4, 4, weights, pcfg))):
        dryrun.assert_surface_matches(base, out, f"vs JAX, rank {rank}")


def test_assert_surface_matches_rejects_a_wrong_sharding(single):
    dryrun.assert_surface_matches(single, single, "self")
    with pytest.raises(AssertionError):
        dryrun.assert_surface_matches(single, dict(single,
                                                   loss=single["loss"] + 0.1))
    key = next(iter(single["pseudo"]))
    with pytest.raises(AssertionError):
        dryrun.assert_surface_matches(single, dict(single, pseudo={
            **single["pseudo"], key: single["pseudo"][key] + 0.05}))


def test_spawn_kills_on_its_deadline_and_reports_a_failed_rank():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not end"):
        dryrun.spawn(time.sleep, 2, (60,), timeout=3)
    assert time.monotonic() - t0 < 30
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        dryrun.spawn(operator.truediv, 2, (1, 0))
