"""Training steps for STN and LTN — PyTorch counterpart of
lstc_vad_tpu/train/steps.py:57-179.

A step is the forward (encoder + head), the loss, the backward, the optional
per-group clipping and the Adagrad update, as the reference does per batch in
Train/spatio_transformer_shanghaitech.py:89-109 /
temporal_transformer_shanghaitech.py:99-142.  It updates the state in place
and returns ``(state, metrics)`` with the JAX step's metric keys; the metrics
are detached device tensors, so nothing inside a step waits for the device.

Dropout.  The JAX step folds the step number into the state's key
(``fold_in(state.rng, state.step)``).  Here every mask of a step (position,
attention inside ``plain_sdpa``, fc, FFN and head) is drawn from PyTorch's
default generators, re-seeded from (run seed, step) inside
``torch.random.fork_rng``: the same state and batch give the same step, a
resumed run draws the same masks, and the process-wide generators are left as
they were.  The masks are not JAX's; parity of the dropout stream is
distributional, as it is between the JAX package and the reference
(lstc_vad_tpu/train/steps.py:35-36).

Every stochastic rounding noise draw of a ``cast_sr`` step (ops/sr.py) comes
from the same default generators, which is also what lets
``encoder.remat`` recompute a layer with the same masks and noise.

On a mesh (``state.mesh``) a step takes this process's rows of the
features and the whole batch's labels (parallel/multihost.py::to_global).
Its forward runs the tensor-parallel modules; the head's outputs of every
data rank are gathered, in the global batch's order, before the loss, which
is then the unsharded step's function of the whole batch on every process
(the MIL hinge pairs every normal video with every abnormal one); the
gradients, partial sums over each rank's rows, are summed over "data"; and
every dropout mask is drawn at its global shape from the same generators and
sliced (parallel/tp.py), so the step is the unsharded step whatever the
partition.

Attention in a step dispatches as everywhere (ops/attention.py::sdpa): with
attention dropout on (0.1-0.2 at the presets) it takes the plain path, as
the JAX package does; with it off, the Hopper kernel of the compute type
runs the forward (twice per layer under remat: the recompute runs it again)
and autograd through ``plain_sdpa`` the backward (ops/cuda_attention.py).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..objectives.losses import (build_clip_labels, coteach_stn_mil_loss,
                                 ltn_mil_loss, soft_cross_entropy_on_probs,
                                 stn_mil_loss, weighted_bce)
from ..parallel import tp as tpc
from ..utils.profiling import annotate
from .optim import clip_gradients
from .state import TrainState

Metrics = Dict[str, torch.Tensor]


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


@contextlib.contextmanager
def step_rng(seed: int, step: int, device: torch.device):
    """Seed the default generators of the CPU and of ``device`` for one step,
    and restore them afterwards."""
    s = step_seed(seed, step)
    if device.type != "cuda":
        with torch.random.fork_rng(devices=[]):
            torch.random.default_generator.manual_seed(s)
            yield
        return
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with torch.random.fork_rng(devices=[index]), torch.cuda.device(index):
        torch.random.default_generator.manual_seed(s)
        torch.cuda.manual_seed(s)
        yield


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    """A batch element on ``device`` in f32, but for a bf16 tensor: the
    features of a bf16 wire enter the encoder as bf16, as the JAX step
    takes them."""
    bf16 = isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
    return torch.as_tensor(x, dtype=torch.bfloat16 if bf16 else
                           torch.float32, device=device)


def _data_axis(state: TrainState):
    return None if state.mesh is None else tpc.mesh_axis(state.mesh, "data")


def _scores(state: TrainState, x: torch.Tensor) -> torch.Tensor:
    """The head's outputs of the whole batch: on a mesh, every data rank's
    rows (normal videos, then abnormal), gathered in the global order."""
    return tpc.gather_batch(state.head(state.encoder(x)[:, 0, :]),
                            _data_axis(state), blocks=2)


class TrainStep:
    """``step(state, norm_feats, norm_labs, abnorm_feats, abnorm_labs)`` ->
    ``(state, metrics)``; feats [B, pn*pl, n_patch, d], labels [B, pn*pl],
    as numpy arrays or tensors.  ``grads`` runs the forward and backward
    alone and leaves the gradients in ``.grad``."""

    def __init__(self, cfg: TrainConfig,
                 loss_fn: Callable[..., Tuple[torch.Tensor, Metrics]]):
        self.cfg = cfg
        self.loss_fn = loss_fn

    def grads(self, state: TrainState, norm_feats, norm_labs, abnorm_feats,
              abnorm_labs) -> Metrics:
        dev = state.device
        norm_feats, norm_labs, abnorm_feats, abnorm_labs = (
            _as_tensor(x, dev) for x in (norm_feats, norm_labs, abnorm_feats,
                                         abnorm_labs))
        # a step always trains with dropout on, as the JAX step passes
        # deterministic=False; evaluation switches the modules back
        state.encoder.train()
        state.head.train()
        state.optimizer.zero_grad(set_to_none=True)
        data = _data_axis(state)
        layout = None
        if data is not None:
            if norm_feats.shape[0] * data.size != norm_labs.shape[0]:
                raise ValueError(
                    f"on a mesh a step takes this process's rows of the "
                    f"features ({norm_feats.shape[0]} of a data axis of "
                    f"{data.size}) and the whole batch's labels "
                    f"({norm_labs.shape[0]}): parallel/multihost.py::"
                    "to_global")
            layout = tpc.BatchLayout(data.rank, data.size, blocks=2)
        with annotate("step.forward"):
            with step_rng(state.seed, state.step, dev), \
                    tpc.batch_layout(layout):
                loss, metrics = self.loss_fn(state, norm_feats, norm_labs,
                                             abnorm_feats, abnorm_labs)
        with annotate("step.backward"):
            loss.backward()
            if data is not None:
                tpc.all_reduce_grads(
                    [p for g in state.optimizer.param_groups
                     for p in g["params"]], data)
        return {k: v.detach() for k, v in metrics.items()}

    def __call__(self, state: TrainState, *batch) -> Tuple[TrainState,
                                                            Metrics]:
        metrics = self.grads(state, *batch)
        with annotate("step.optim"):
            clip_gradients(self.cfg.optim, state.optimizer, state.mesh)
            state.optimizer.step()
        state.step += 1
        return state, metrics


def make_stn_train_step(cfg: TrainConfig) -> TrainStep:
    """Pure-MIL STN step; the labels are unused."""
    pn, pl = cfg.data.part_num, cfg.data.part_len
    n_patch, d = cfg.data.n_patch, cfg.encoder.d_model
    lam1 = cfg.loss.lambda_1

    def loss_fn(state, norm_feats, norm_labs, abnorm_feats, abnorm_labs):
        feats = torch.cat([norm_feats, abnorm_feats])
        b2 = feats.shape[0]
        scores = _scores(state, feats.reshape(b2 * pn * pl, n_patch, d))
        loss, err, spar = stn_mil_loss(scores.reshape(-1, pn * pl), pn, pl,
                                       lam1)
        return loss, {"loss": loss, "err": err, "l1": spar}

    return TrainStep(cfg, loss_fn)


def make_stn_bce_train_step(cfg: TrainConfig) -> TrainStep:
    """Co-teaching STN round: MIL + class-weighted BCE of the part-mean score
    against the LTN's soft pseudo labels
    (Train/spatio_transformer_MIL_CE.py:166-181, even rounds)."""
    pn, pl = cfg.data.part_num, cfg.data.part_len
    n_patch, d = cfg.data.n_patch, cfg.encoder.d_model
    lc = cfg.loss
    # the reference re-views UCF outputs to 3-D before its MIL loss, so its
    # sparsity slice takes the abnormal half; SHT/UBnormal stay flat
    flat_sparsity = cfg.data.dataset != "UCF"

    def loss_fn(state, norm_feats, norm_labs, abnorm_feats, abnorm_labs):
        clip_labs = build_clip_labels(norm_labs.shape[0], pn, pl,
                                      abnorm_labs)
        feats = torch.cat([norm_feats, abnorm_feats])
        b2 = feats.shape[0]
        scores = _scores(state, feats.reshape(b2 * pn * pl, n_patch, d))
        scores = scores.reshape(-1, pn * pl)
        mil, err, spar = coteach_stn_mil_loss(scores, pn, pl, lc.lambda_1,
                                              flat_sparsity=flat_sparsity)
        bce = weighted_bce(scores.reshape(-1, pn, pl).mean(-1), clip_labs,
                           lc.lambda_normal, lc.lambda_abnormal)
        loss = lc.lambda_bce * bce + mil
        return loss, {"loss": loss, "mil": mil, "bce": bce, "err": err,
                      "l1": spar}

    return TrainStep(cfg, loss_fn)


def make_ltn_train_step(cfg: TrainConfig) -> TrainStep:
    """LTN: soft pseudo-label CE + MIL on the abnormal-class probability.
    Normal videos get hard (1, 0) targets per part, abnormal parts soft
    (1 - p, p), p the mean clip pseudo score over part_len
    (Train/temporal_transformer_shanghaitech.py:103-112)."""
    pn, pl = cfg.data.part_num, cfg.data.part_len
    n_patch, d = cfg.data.n_patch, cfg.encoder.d_model
    lc = cfg.loss

    def loss_fn(state, norm_feats, norm_labs, abnorm_feats, abnorm_labs):
        clip_labs = build_clip_labels(norm_labs.shape[0], pn, pl,
                                      abnorm_labs)
        feats = torch.cat([norm_feats, abnorm_feats])
        b2 = feats.shape[0]
        probs = _scores(state, feats.reshape(b2 * pn, pl * n_patch, d))
        probs = probs.reshape(-1, 2)
        mil, err, spar = ltn_mil_loss(probs[:, 1], pn, lc.lambda_1)
        if lc.temporal_only:
            ce = torch.zeros((), device=probs.device)
        else:
            ce = soft_cross_entropy_on_probs(probs,
                                             clip_labs.reshape(-1, 2))
        loss = lc.lambda_mil * mil + lc.lambda_ce * ce
        return loss, {"loss": loss, "mil": mil, "ce": ce, "err": err,
                      "l1": spar}

    return TrainStep(cfg, loss_fn)


def make_train_step(cfg: TrainConfig) -> TrainStep:
    """The step of ``cfg.model``: "ltn", "stn" or "stn_bce"."""
    makers = {"ltn": make_ltn_train_step, "stn": make_stn_train_step,
              "stn_bce": make_stn_bce_train_step}
    if cfg.model not in makers:
        raise ValueError(f"unknown model {cfg.model!r}; expected one of "
                         f"{sorted(makers)}")
    return makers[cfg.model](cfg)
