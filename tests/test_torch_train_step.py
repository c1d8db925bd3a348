"""The PyTorch package's train steps against the JAX package's
(lstc_vad_tpu/train/steps.py), one LTN, STN and STN-BCE step each.

Both steps start from the same parameters (JAX init, mapped by
ckpt/interop.py) and take the same numpy batch with every dropout off.  The
loss agrees at rel 2e-4, the new parameters and Adagrad accumulators at
rtol 1e-3 / atol 1e-5: the tolerances of tests/test_train_step_parity.py,
which holds the JAX step to the reference's torch step.  With dropout on,
the masks come from a generator seeded from (seed, step): a step is
repeatable and leaves the process-wide generators as they were.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from lstc_vad_tpu.config import (DataConfig, EncoderConfig, HeadConfig,
                                 LossConfig, OptimConfig, TrainConfig)
from lstc_vad_tpu.train.state import create_train_state as jax_state
from lstc_vad_tpu.train.steps import (make_ltn_train_step,
                                      make_stn_bce_train_step,
                                      make_stn_train_step)
from lstc_vad_tpu_torch import config as pc
from lstc_vad_tpu_torch.ckpt.interop import (encoder_state_dict_from_jax,
                                             head_state_dict_from_jax,
                                             state_dict_from_jax)
from lstc_vad_tpu_torch.ops import cuda_attention
from lstc_vad_tpu_torch.train import create_train_state, make_train_step

PN, PL, NP, D = 3, 2, 4, 16
LOSS_REL = 2e-4
RTOL, ATOL = 1e-3, 1e-5


def jax_config(model: str, **kw) -> TrainConfig:
    """The small configs of tests/test_train_step_parity.py."""
    ltn = model == "ltn"
    enc = EncoderConfig(d_model=D, d_inner=24, n_head=2, d_k=8, d_v=8,
                        n_layers=2 if model == "stn" else 1,
                        ffn_layernorm=True, mha_layernorm=model != "stn_bce",
                        weight_init=model == "stn", relative_pe=ltn,
                        window_size=4, window_depth=PL, attn_dropout=0.0,
                        fc_dropout=0.0, ffn_dropout=0.0, attn_impl="xla")
    cfg = TrainConfig(
        model=model, encoder=enc,
        head=HeadConfig(kind="classifier" if ltn else "regressor",
                        d_model=D, hidden_dim=8, dropout=0.0),
        data=DataConfig(n_patch=NP, part_num=PN, part_len=PL, d_model=D,
                        batch_size=2),
        optim=OptimConfig(lr_encoder=1e-3, lr_head=1e-2, weight_decay=1e-3,
                          clip_grad=model == "stn", clip_norm=10.0),
        loss=LossConfig(lambda_1=0.01, lambda_mil=1.0, lambda_ce=0.8,
                        lambda_bce=1.0, lambda_normal=0.2,
                        lambda_abnormal=2.0),
        donate=False)
    from lstc_vad_tpu.config import replace

    return replace(cfg, **kw) if kw else cfg


def port_config(jcfg):
    """The port's twin of a JAX config tree."""
    def conv(obj):
        if not dataclasses.is_dataclass(obj):
            return obj
        kw = {f.name: conv(getattr(obj, f.name))
              for f in dataclasses.fields(obj)}
        return getattr(pc, type(obj).__name__)(**kw)

    return conv(jcfg)


def port_state(pcfg, params, seed=0):
    """A CPU train state holding the JAX ``params``."""
    state = create_train_state(pcfg, device="cpu", seed=seed)
    enc_sd, head_sd = state_dict_from_jax(params["encoder"], params["head"],
                                          pcfg.encoder, pcfg.head.kind)
    state.encoder.load_state_dict(enc_sd, strict=True)
    state.head.load_state_dict(head_sd, strict=True)
    return state


def flat_from_jax(tree, kind):
    """{"encoder.<key>" / "head.<key>": array} of a params-shaped JAX tree
    (params, grads or accumulators), through the interop mapping."""
    out = {f"encoder.{k}": v.numpy() for k, v in
           encoder_state_dict_from_jax(tree["encoder"]).items()}
    out.update({f"head.{k}": v.numpy() for k, v in
                head_state_dict_from_jax(tree["head"], kind).items()})
    return out


def named_params(state):
    return {**{f"encoder.{k}": p for k, p in
               state.encoder.named_parameters()},
            **{f"head.{k}": p for k, p in state.head.named_parameters()}}


def jax_accumulators(opt_state):
    """The Adagrad sums of a two-group JAX optimizer state, as one params
    tree."""
    from lstc_vad_tpu.train.optim import ScaleByRssTorchState

    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, ScaleByRssTorchState))
        if isinstance(s, ScaleByRssTorchState)]
    sums = {}
    for s in found:
        for group in ("encoder", "head"):
            sub = s.sum_of_squares[group]
            if jax.tree_util.tree_leaves(sub):  # the other group's: masked
                sums[group] = sub
    return sums


def assert_state_matches(state, jax_params, jax_opt_state, kind, rtol, atol):
    """Every parameter JAX has, and its Adagrad sum, against the port's;
    the parameters JAX does not have were never updated."""
    ref_params = flat_from_jax(jax.tree.map(np.asarray, jax_params), kind)
    ref_sums = flat_from_jax(jax.tree.map(np.asarray,
                                          jax_accumulators(jax_opt_state)),
                             kind)
    params = named_params(state)
    for name, ref in ref_params.items():
        p = params[name]
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=rtol,
                                   atol=atol, err_msg=name)
        np.testing.assert_allclose(state.optimizer.state[p]["sum"].numpy(),
                                   ref_sums[name], rtol=rtol, atol=atol,
                                   err_msg=f"accumulator of {name}")
    for name in set(params) - set(ref_params):
        assert params[name].grad is None, name


def batch(rng, b=2):
    norm = rng.standard_normal((b, PN * PL, NP, D)).astype(np.float32)
    abnorm = rng.standard_normal((b, PN * PL, NP, D)).astype(np.float32)
    pseudo = rng.random((b, PN * PL)).astype(np.float32)
    return norm, np.zeros_like(pseudo), abnorm, pseudo


JAX_STEPS = {"ltn": make_ltn_train_step, "stn": make_stn_train_step,
             "stn_bce": make_stn_bce_train_step}


@pytest.mark.parametrize("model", ["ltn", "stn", "stn_bce"])
def test_train_step_matches_jax(model):
    jcfg = jax_config(model)
    jstate, enc, head, tx = jax_state(jcfg)
    params0 = jax.tree.map(np.asarray, jstate.params)
    data = batch(np.random.default_rng(1))
    new_jstate, jmetrics = JAX_STEPS[model](enc, head, jcfg, tx)(jstate,
                                                                 *data)

    pcfg = port_config(jcfg)
    state = port_state(pcfg, params0)
    state, metrics = make_train_step(pcfg)(state, *data)

    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        assert not v.requires_grad
        assert float(v) == pytest.approx(float(jmetrics[k]), rel=LOSS_REL,
                                         abs=1e-7), k
    assert state.step == int(new_jstate.step) == 1
    assert_state_matches(state, new_jstate.params, new_jstate.opt_state,
                         pcfg.head.kind, RTOL, ATOL)


@pytest.mark.parametrize("model", ["ltn", "stn"])
def test_every_parameter_jax_trains_gets_a_gradient(model):
    """With attention dropout off the step's attention is the kernel's
    autograd Function (its CPU path): each parameter JAX trains has a
    gradient, the rest (modules the config leaves unused) have none."""
    jcfg = jax_config(model)
    params0 = jax.tree.map(np.asarray, jax_state(jcfg)[0].params)
    pcfg = port_config(jcfg)
    state = port_state(pcfg, params0)
    make_train_step(pcfg).grads(state, *batch(np.random.default_rng(2)))
    with_grad = {n for n, p in named_params(state).items()
                 if p.grad is not None}
    assert with_grad == set(flat_from_jax(params0, pcfg.head.kind))
    assert cuda_attention.launches == 0  # the CPU path launches nothing


def _dropout_config():
    return port_config(jax_config(
        "ltn", **{"encoder.attn_dropout": 0.2, "encoder.fc_dropout": 0.2,
                  "encoder.ffn_dropout": 0.1, "head.dropout": 0.6}))


def test_dropout_step_is_repeatable_and_leaves_global_rng_alone():
    pcfg = _dropout_config()
    data = batch(np.random.default_rng(3))
    a = create_train_state(pcfg, device="cpu", seed=7)
    b = copy.deepcopy(a)
    step = make_train_step(pcfg)
    torch.manual_seed(123)
    before = torch.get_rng_state()
    _, ma = step(a, *data)
    assert torch.equal(torch.get_rng_state(), before)
    _, mb = step(b, *data)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for (name, pa), pb in zip(named_params(a).items(),
                              named_params(b).values()):
        assert torch.equal(pa, pb), name


def test_dropout_masks_change_with_step_and_seed():
    pcfg = _dropout_config()
    data = batch(np.random.default_rng(4))
    base = create_train_state(pcfg, device="cpu", seed=7)
    step = make_train_step(pcfg)
    losses = []
    for seed, at in ((7, 0), (7, 5), (8, 0)):
        s = copy.deepcopy(base)
        s.seed, s.step = seed, at
        losses.append(float(step.grads(s, *data)["loss"]))
    assert len(set(losses)) == 3, losses


def test_unknown_model_raises():
    with pytest.raises(ValueError, match="unknown model"):
        make_train_step(pc.replace(port_config(jax_config("ltn")),
                                   model="mlp"))
