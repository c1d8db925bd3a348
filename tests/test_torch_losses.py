"""The PyTorch package's losses against the JAX package's
(lstc_vad_tpu/objectives/losses.py), value for value and gradient for
gradient.

Every function gets the same numpy inputs on both sides.  Values agree at
rel 1e-6 (the tolerance of tests/test_losses.py, which holds the JAX losses
to the reference's torch code).  Gradients of a fixed random weighting of
every output, ``jax.grad`` against autograd, agree at rtol 1e-5 / atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstc_vad_tpu.objectives import losses as J
from lstc_vad_tpu_torch.objectives import losses as T

VALUE_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
B, PN, PL = 4, 5, 3


def _cases(rng):
    """name -> (differentiable numpy inputs, jax fn, torch fn)."""
    u = lambda *shape: rng.random(shape).astype(np.float32)  # noqa: E731
    soft = u(2 * B * PN, 1)
    soft = np.concatenate([1 - soft, soft], -1)
    return {
        "mil_ranking_loss": (
            [u(2 * B), u(B, PN)],
            lambda v, a: J.mil_ranking_loss(v, a, 0.01),
            lambda v, a: T.mil_ranking_loss(v, a, 0.01)),
        "stn_mil_loss": (
            [u(2 * B, PN * PL)],
            lambda s: J.stn_mil_loss(s, PN, PL, 0.01),
            lambda s: T.stn_mil_loss(s, PN, PL, 0.01)),
        "ltn_mil_loss": (
            [u(2 * B * PN)],
            lambda s: J.ltn_mil_loss(s, PN, 0.01),
            lambda s: T.ltn_mil_loss(s, PN, 0.01)),
        "coteach_stn_mil_loss_flat": (
            [u(2 * B, PN * PL)],
            lambda s: J.coteach_stn_mil_loss(s, PN, PL, 0.01, True),
            lambda s: T.coteach_stn_mil_loss(s, PN, PL, 0.01, True)),
        "coteach_stn_mil_loss_half": (
            [u(2 * B, PN * PL)],
            lambda s: J.coteach_stn_mil_loss(s, PN, PL, 0.01, False),
            lambda s: T.coteach_stn_mil_loss(s, PN, PL, 0.01, False)),
        "soft_cross_entropy_on_probs": (
            [u(2 * B * PN, 2), soft],
            J.soft_cross_entropy_on_probs, T.soft_cross_entropy_on_probs),
        "weighted_bce": (
            [u(2 * B, PN), soft.reshape(2 * B, PN, 2)],
            lambda p, s: J.weighted_bce(p, s, 0.2, 2.0),
            lambda p, s: T.weighted_bce(p, s, 0.2, 2.0)),
        "build_clip_labels": (
            [u(B, PN * PL)],
            lambda p: J.build_clip_labels(B, PN, PL, p),
            lambda p: T.build_clip_labels(B, PN, PL, p)),
        "soft_labels_from_pseudo": (
            [u(B, PN * PL)],
            lambda p: J.soft_labels_from_pseudo(p, PL),
            lambda p: T.soft_labels_from_pseudo(p, PL)),
    }


NAMES = sorted(_cases(np.random.default_rng(0)))


def _outputs(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_values_match_jax(name, seed):
    inputs, jax_fn, torch_fn = _cases(np.random.default_rng(seed))[name]
    ref = _outputs(jax_fn(*inputs))
    ours = _outputs(torch_fn(*(torch.from_numpy(a) for a in inputs)))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=VALUE_RTOL,
                                   atol=0)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_gradients_match_jax(name, seed):
    rng = np.random.default_rng(seed)
    inputs, jax_fn, torch_fn = _cases(rng)[name]
    shapes = [np.shape(o) for o in _outputs(jax_fn(*inputs))]
    weights = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def jax_objective(*xs):
        return sum(jnp.sum(o * w) for o, w in zip(_outputs(jax_fn(*xs)),
                                                  weights))

    ref = jax.grad(jax_objective, argnums=tuple(range(len(inputs))))(
        *inputs)
    xs = [torch.from_numpy(a).requires_grad_() for a in inputs]
    objective = sum((o * torch.from_numpy(w)).sum()
                    for o, w in zip(_outputs(torch_fn(*xs)), weights))
    ours = torch.autograd.grad(objective, xs)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
