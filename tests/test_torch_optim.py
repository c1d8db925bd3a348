"""The PyTorch package's two-group Adagrad against the JAX package's
(lstc_vad_tpu/train/optim.py).

Both optimizers take the same three gradient streams, drawn with numpy in
the shape of a small LTN model's parameters and scaled so that clipping
engages, from the same parameters.  Parameters and Adagrad accumulators
(JAX's ``sum_of_squares`` trees, mapped by ckpt/interop.py) agree at rtol
1e-5 / atol 1e-7, the tolerance of tests/test_optim.py.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from lstc_vad_tpu.train.optim import make_optimizer as jax_optimizer
from lstc_vad_tpu.train.state import create_train_state as jax_state
from lstc_vad_tpu_torch.train.optim import clip_gradients, make_optimizer

from test_torch_train_step import (assert_state_matches, flat_from_jax,
                                   jax_config, named_params, port_config,
                                   port_state)

RTOL, ATOL = 1e-5, 1e-7


@pytest.mark.parametrize("clip_grad", [True, False])
@pytest.mark.parametrize("initial_accumulator", [0.0, 0.1])
def test_two_group_adagrad_matches_jax(clip_grad, initial_accumulator):
    jcfg = jax_config("ltn", **{"optim.clip_grad": clip_grad,
                                "optim.initial_accumulator":
                                    initial_accumulator})
    params = jax.tree.map(np.asarray, jax_state(jcfg)[0].params)
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 50)
                          .astype(np.float32), params) for _ in range(3)]

    tx = jax_optimizer(jcfg.optim)
    jparams, opt_state = params, tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    pcfg = port_config(jcfg)
    state = port_state(pcfg, params)
    by_name = named_params(state)
    for g in grads:
        state.optimizer.zero_grad(set_to_none=True)
        for name, value in flat_from_jax(g, pcfg.head.kind).items():
            by_name[name].grad = torch.from_numpy(value.copy())
        clip_gradients(pcfg.optim, state.optimizer)
        state.optimizer.step()
    assert_state_matches(state, jparams, opt_state, pcfg.head.kind, RTOL,
                         ATOL)


def test_groups_rates_and_rule():
    """Two named groups at the config's rates, torch's Adagrad rule with the
    config's eps, decay and initial accumulator."""
    pcfg = port_config(jax_config("stn", **{"optim.initial_accumulator":
                                                0.25}))
    state = port_state(pcfg, jax.tree.map(
        np.asarray, jax_state(jax_config("stn"))[0].params))
    opt = make_optimizer(pcfg.optim, state.encoder, state.head)
    assert isinstance(opt, torch.optim.Adagrad)
    groups = {g["name"]: g for g in opt.param_groups}
    assert groups["encoder"]["lr"] == pcfg.optim.lr_encoder
    assert groups["head"]["lr"] == pcfg.optim.lr_head
    for g in groups.values():
        assert g["weight_decay"] == pcfg.optim.weight_decay
        assert g["eps"] == pcfg.optim.adagrad_eps
        assert g["initial_accumulator_value"] == 0.25
    assert len(groups["encoder"]["params"]) == len(
        list(state.encoder.parameters()))


def test_clipping_is_per_group_and_before_decay():
    """Each group's raw gradients are scaled to norm clip_norm on their own;
    a group under the limit is left as it is."""
    pcfg = port_config(jax_config("stn", **{"optim.clip_grad": True,
                                            "optim.clip_norm": 1.0}))
    state = port_state(pcfg, jax.tree.map(
        np.asarray, jax_state(jax_config("stn"))[0].params))
    for p in state.encoder.parameters():
        p.grad = torch.full_like(p, 10.0)
    head_grads = [torch.full_like(p, 1e-4) for p in state.head.parameters()]
    for p, g in zip(state.head.parameters(), head_grads):
        p.grad = g.clone()
    clip_gradients(pcfg.optim, state.optimizer)
    norm = torch.sqrt(sum((p.grad ** 2).sum()
                          for p in state.encoder.parameters()))
    assert float(norm) == pytest.approx(1.0, rel=1e-5)
    for p, g in zip(state.head.parameters(), head_grads):
        assert torch.equal(p.grad, g)
