"""Multi-process rehearsal: the whole multi-device surface over N processes
on the CPU (gloo) — counterpart of lstc_vad_tpu/parallel/dryrun.py.

``spawn(fn, n, args)`` starts ``n`` processes joined in one gloo group
(a ``file://`` rendezvous in a fresh directory, so no port is taken),
calls ``fn(*args)`` in each and returns their results in rank order; it
kills them all and raises when any fails or the deadline passes.  ``fn``
lives in this package, so a child imports nothing but the package.

The surface (``run_multichip_surface``) is one LTN train step (forward,
backward, two-group Adagrad) on the tiny structurally complete config, then
the data-parallel evaluation to frame AUC, then an LTN pseudo-label pass.
``assert_surface_matches`` holds a sharded run to the single-process one at
the JAX package's bars.  The ``run_*`` functions below drive the Trainer,
co-teaching, checkpoints and the step's gradients the same way.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import (DataConfig, EncoderConfig, HeadConfig, LossConfig,
                      OptimConfig, TrainConfig)
from .mesh import factor_devices, make_mesh

SPAWN_TIMEOUT = 120.0


def _child(rank: int, world: int, init: str, fn: Callable, args, out: str,
           threads: int):
    torch.set_num_threads(threads)
    try:
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, n_procs: int, args: Sequence = (),
          timeout: float = SPAWN_TIMEOUT, threads: int = 1) -> list:
    """``fn(*args)`` in each of ``n_procs`` gloo processes; their results in
    rank order.  Raises RuntimeError with a failed rank's traceback, or
    TimeoutError after ``timeout`` seconds, having killed every child."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="lstc-spawn-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(r, n_procs, init, fn, tuple(args), tmp,
                                   threads))
                 for r in range(n_procs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
                if p.exitcode is None:
                    raise TimeoutError(
                        f"{fn.__name__} on {n_procs} processes did not end "
                        f"within {timeout} s")
                if p.exitcode != 0:
                    break  # a failed rank may leave the others waiting
            for r, p in enumerate(procs):
                if p.exitcode not in (None, 0):
                    err = os.path.join(tmp, f"{r}.err")
                    why = (open(err).read() if os.path.exists(err)
                           else f"exit code {p.exitcode}")
                    raise RuntimeError(f"{fn.__name__}, rank {r} of "
                                       f"{n_procs}:\n{why}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(n_procs):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def run_mesh(shape: Optional[Tuple[int, int]] = None, n_head: int = 8,
             device_type: str = "cpu"):
    """The mesh of the current process group (``shape``, or the
    ``factor_devices`` split of its size); None outside one."""
    if not dist.is_initialized():
        return None
    shape = shape or factor_devices(dist.get_world_size(), n_head)
    return make_mesh(*shape, device_type=device_type)


def tiny_ltn_config(n_head: int = 8, batch_size: int = 8) -> TrainConfig:
    part_len, n_patch = 3, 4
    return TrainConfig(
        model="ltn",
        encoder=EncoderConfig(d_model=64, d_inner=128, n_head=n_head,
                              d_k=16, d_v=16, n_layers=2,
                              mha_layernorm=True, ffn_layernorm=True,
                              relative_pe=True, window_size=4,
                              window_depth=part_len, attn_impl="xla"),
        head=HeadConfig(kind="classifier", d_model=64, hidden_dim=32),
        data=DataConfig(n_patch=n_patch, part_num=4, part_len=part_len,
                        d_model=64, batch_size=batch_size),
        optim=OptimConfig(clip_grad=True),
        loss=LossConfig(),
        donate=False,
    )


def load_weights(state, weights, mesh):
    """Full reference-layout ``(encoder, head)`` state_dicts into ``state``
    (this process's shards on a mesh)."""
    from .mesh import local_state_dict

    for module, sd in zip((state.encoder, state.head), weights):
        module.load_state_dict(sd if mesh is None
                               else local_state_dict(sd, mesh), strict=True)


def full_params(state):
    """The state's parameters whole, as numpy arrays (a collective on a
    mesh)."""
    from .mesh import full_state_dict

    out = {}
    for name, module in (("encoder", state.encoder), ("head", state.head)):
        sd = module.state_dict()
        if state.mesh is not None:
            sd = full_state_dict(sd, state.mesh)
        out.update({f"{name}.{k}": v.detach().cpu().numpy()
                    for k, v in sd.items()})
    return out


def run_multichip_step(n_devices: int, batch_size: Optional[int] = None,
                       return_state: bool = False, weights=None,
                       cfg: Optional[TrainConfig] = None,
                       device: str = "cpu"):
    """ONE full LTN train step on the (data, model) mesh of ``n_devices``
    processes (the current group's; no mesh when there is none and
    ``n_devices`` is 1), from ``weights`` (full state_dicts) or the seed's
    init.  Returns the metrics (and, with ``return_state``, (state, mesh,
    cfg))."""
    from ..train.state import create_train_state
    from ..train.steps import make_ltn_train_step
    from .multihost import to_global

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"{n_devices} devices asked for; the run has "
                         f"{world} processes")
    data_ax, _ = factor_devices(n_devices)
    if batch_size is None:
        batch_size = max(2 * data_ax, 2)
    if cfg is None:
        cfg = tiny_ltn_config(batch_size=batch_size)
    mesh = run_mesh(factor_devices(n_devices, cfg.encoder.n_head),
                    device_type=torch.device(device).type)
    state = create_train_state(cfg, device, mesh=mesh)
    if weights is not None:
        load_weights(state, weights, mesh)
    d = cfg.data
    b = d.batch_size
    rng = np.random.default_rng(0)
    shape = (b, d.part_num * d.part_len, d.n_patch, cfg.encoder.d_model)
    norm = rng.standard_normal(shape, dtype=np.float32)
    abnorm = rng.standard_normal(shape, dtype=np.float32)
    labs = rng.random((b, d.part_num * d.part_len)).astype(np.float32)
    batch = (norm, labs, abnorm, labs)
    if mesh is not None:
        batch = to_global(batch, mesh)
    state, metrics = make_ltn_train_step(cfg)(state, *batch)
    out = {k: float(v) for k, v in metrics.items()}
    assert np.isfinite(out["loss"]), out
    if return_state:
        return out, (state, mesh, cfg)
    return out


class _ArrayStore:
    """Minimal in-memory feature store for the pseudo-label pass."""

    def __init__(self, feats: dict):
        self._feats = feats

    def get(self, key):
        return self._feats[key]

    def n_clips(self, key):
        return len(self._feats[key])


def run_multichip_surface(n_devices: int, batch_size: Optional[int] = None,
                          weights=None, cfg: Optional[TrainConfig] = None,
                          device: str = "cpu") -> dict:
    """The whole surface on one mesh: the train step, then the sharded
    evaluation (PartScorer.score_videos -> frame AUC over ragged videos:
    the tail re-window and a short video), then an LTN pseudo-label pass
    (tails fed short).  Returns {'loss', 'eval_auc', 'n_pseudo_videos',
    'pseudo_threshold', 'pseudo'}; asserts everything finite.  The same
    numpy draws as the JAX function, so the two compare on the same
    weights."""
    from ..data.annotations import TrainRecord
    from ..evaluation.drivers import evaluate_ltn
    from ..evaluation.scoring import PartScorer
    from ..pseudo.generator import generate_ltn_pseudo_labels

    metrics, (state, mesh, cfg) = run_multichip_step(
        n_devices, batch_size=batch_size, return_state=True,
        weights=weights, cfg=cfg, device=device)
    d = cfg.data
    rng = np.random.default_rng(1)
    scorer = PartScorer(state.encoder, state.head, d.part_len, d.n_patch)
    items = []
    for n_clips in (2 * d.part_len + 1, 5 * d.part_len, d.part_len - 1):
        feats = rng.standard_normal(
            (n_clips, d.n_patch, cfg.encoder.d_model)).astype(np.float32)
        anno = (rng.random(n_clips * 16) < 0.5).astype(np.float64)
        items.append((feats, anno))
    auc = evaluate_ltn(scorer, items)
    assert np.isfinite(auc), auc

    gen_scorer = PartScorer(state.encoder, state.head, d.part_len, d.n_patch,
                            tail_rewindow=False)
    store = _ArrayStore({
        f"v{i}": rng.standard_normal(
            (n, d.n_patch, cfg.encoder.d_model)).astype(np.float32)
        for i, n in enumerate((2 * d.part_len, 3 * d.part_len + 2))})
    records = [TrainRecord("v0", False), TrainRecord("v1", True)]
    threshold = 0.4
    pseudo = generate_ltn_pseudo_labels(gen_scorer, store, records,
                                        threshold=threshold)
    assert set(pseudo) == {"v0.npy", "v1.npy"}
    for key, scores in pseudo.items():
        assert len(scores) == store.n_clips(key[:-4]), (key, len(scores))
        assert np.all(np.isfinite(scores)), key
    return {"loss": metrics["loss"], "eval_auc": float(auc),
            "n_pseudo_videos": len(pseudo), "pseudo_threshold": threshold,
            "pseudo": {k: np.asarray(v) for k, v in pseudo.items()}}


def assert_surface_matches(base: dict, out: dict, label: str = "") -> None:
    """Two ``run_multichip_surface`` results (same seeds and batch size,
    different meshes) agree: partitioning changes the layout, never the
    math.  The bars allow f32 reduction-order noise only."""
    lb, lo = base["loss"], out["loss"]
    assert abs(lo - lb) <= 1e-4 * max(abs(lb), 1e-8), (
        f"{label}: sharded loss {lo!r} != single-process loss {lb!r}")
    assert abs(out["eval_auc"] - base["eval_auc"]) <= 5e-3, (
        f"{label}: sharded eval AUC {out['eval_auc']!r} != "
        f"single-process {base['eval_auc']!r}")
    assert set(out["pseudo"]) == set(base["pseudo"]), label
    thr = base.get("pseudo_threshold", 0.4)
    for key in base["pseudo"]:
        a, b = base["pseudo"][key], out["pseudo"][key]
        close = np.isclose(a, b, rtol=1e-3, atol=1e-4)
        # pseudo labels are thresholded (score or 0): a score within f32
        # noise of the threshold may zero on one mesh and not the other
        straddle = (((a == 0) | (b == 0))
                    & (np.abs(np.maximum(a, b) - thr) < 1e-3))
        assert np.all(close | straddle), (
            f"{label}: pseudo labels for {key} diverge under sharding: "
            f"{a} vs {b}")


# ------------------------------------------------- the Trainer and friends

def run_trainer(cfg: TrainConfig, epochs: int,
                shape: Optional[Tuple[int, int]] = None) -> dict:
    """``Trainer(cfg, mesh=).fit(epochs)`` on the CPU; its history, test
    AUC and whole parameters."""
    from ..train.driver import Trainer

    mesh = run_mesh(shape, cfg.encoder.n_head)
    trainer = Trainer(cfg, device="cpu", mesh=mesh)
    result = trainer.fit(epochs=epochs)
    return {"history": result.history,
            "auc": trainer.evaluate("test") if trainer.test_videos else None,
            "params": full_params(trainer.state)}


def run_evaluate(cfg: TrainConfig, shape: Optional[Tuple[int, int]] = None
                 ) -> float:
    """A fresh eval-only Trainer's test AUC (the seed's weights)."""
    from ..train.driver import Trainer

    mesh = run_mesh(shape, cfg.encoder.n_head)
    return Trainer(cfg, device="cpu", mesh=mesh,
                   eval_only=True).evaluate("test")


def run_coteach(stn_cfg: TrainConfig, ltn_cfg: TrainConfig, workdir: str,
                rounds: int, shape: Optional[Tuple[int, int]] = None,
                stn_threshold: float = 0.5,
                ltn_threshold: float = 0.4) -> dict:
    """``rounds`` co-teaching rounds of one epoch each; every round's test
    AUC and the last artifacts."""
    from ..pseudo import CoTeachingDriver

    mesh = run_mesh(shape, stn_cfg.encoder.n_head)
    driver = CoTeachingDriver(stn_cfg, ltn_cfg, workdir,
                              stn_threshold=stn_threshold,
                              ltn_threshold=ltn_threshold, device="cpu",
                              mesh=mesh)
    trainers = driver.run(rounds=rounds, stn_epochs=1, ltn_epochs=1)
    pseudo = {}
    for path in (driver.stn_pseudo_path, driver.ltn_pseudo_path):
        if os.path.exists(path):
            pseudo[os.path.basename(path)] = np.load(
                path, allow_pickle=True).tolist()
    return {"aucs": [t.evaluate("test") for t in trainers],
            "pseudo": pseudo}


def run_checkpoint(cfg: TrainConfig, path: str,
                   shape: Optional[Tuple[int, int]] = None,
                   weights=None) -> dict:
    """One train step on the mesh, then the state saved to ``path``;
    returns the whole state gathered in memory (parameters, Adagrad sums,
    step) to hold the file against."""
    from ..ckpt.io import _payload, save_checkpoint
    from ..train.state import create_train_state
    from ..train.steps import make_train_step
    from .multihost import to_global

    mesh = run_mesh(shape, cfg.encoder.n_head)
    state = create_train_state(cfg, "cpu", mesh=mesh)
    if weights is not None:
        load_weights(state, weights, mesh)
    batch = _batch(cfg, seed=3)
    if mesh is not None:
        batch = to_global(batch, mesh)
    make_train_step(cfg)(state, *batch)
    save_checkpoint(path, state)
    payload = _payload(state, mesh)
    return {"encoder": _numpy(payload["encoder"]),
            "head": _numpy(payload["head"]),
            "sums": [s["sum"].numpy().copy()
                     for _, s in sorted(payload["optimizer"]["state"].items())],
            "step": payload["step"]}


def run_load_checkpoint(cfg: TrainConfig, path: str,
                        shape: Optional[Tuple[int, int]] = None) -> dict:
    """A state on the mesh loaded from ``path``, then gathered whole."""
    from ..ckpt.io import _payload, load_checkpoint
    from ..train.state import create_train_state

    mesh = run_mesh(shape, cfg.encoder.n_head)
    state = load_checkpoint(path, create_train_state(cfg, "cpu", mesh=mesh))
    payload = _payload(state, mesh)
    return {"encoder": _numpy(payload["encoder"]),
            "head": _numpy(payload["head"]),
            "sums": [s["sum"].numpy().copy()
                     for _, s in sorted(payload["optimizer"]["state"].items())],
            "step": payload["step"]}


def _numpy(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _batch(cfg: TrainConfig, seed: int):
    d = cfg.data
    rng = np.random.default_rng(seed)
    shape = (d.batch_size, d.part_num * d.part_len, d.n_patch,
             cfg.encoder.d_model)
    labs = rng.random((d.batch_size, d.part_num * d.part_len)).astype(
        np.float32)
    return (rng.standard_normal(shape, dtype=np.float32), labs,
            rng.standard_normal(shape, dtype=np.float32), labs)


def run_grads(cfg: TrainConfig, weights,
              shape: Optional[Tuple[int, int]] = None) -> dict:
    """One step's loss, whole gradients (after the sum over "data") and the
    clip norm of each parameter group, from ``weights``."""
    from ..train.optim import clip_gradients
    from ..train.state import create_train_state
    from ..train.steps import make_train_step
    from .mesh import full_state_dict
    from .multihost import to_global

    mesh = run_mesh(shape, cfg.encoder.n_head)
    state = create_train_state(cfg, "cpu", mesh=mesh)
    load_weights(state, weights, mesh)
    batch = _batch(cfg, seed=5)
    if mesh is not None:
        batch = to_global(batch, mesh)
    metrics = make_train_step(cfg).grads(state, *batch)
    grads = {}
    for name, module in (("encoder", state.encoder), ("head", state.head)):
        sd = {k: p.grad for k, p in module.named_parameters()
              if p.grad is not None}
        if mesh is not None:
            sd = full_state_dict(sd, mesh)
        grads.update({f"{name}.{k}": v.numpy().copy()
                      for k, v in sd.items()})
    norms = clip_gradients(cfg.optim, state.optimizer, mesh)
    return {"loss": float(metrics["loss"]), "grads": grads,
            "clip_norms": [None if n is None else float(n) for n in norms]}


def run_whole_batch_step(cfg: TrainConfig):
    """A step on a data axis given the whole batch (it must refuse)."""
    from ..train.state import create_train_state
    from ..train.steps import make_train_step

    mesh = run_mesh((dist.get_world_size(), 1), cfg.encoder.n_head)
    state = create_train_state(cfg, "cpu", mesh=mesh)
    make_train_step(cfg)(state, *_batch(cfg, seed=0))


def run_global_mesh(n_head: int = 8) -> dict:
    """``make_global_mesh`` over the current group, and whether joining
    again is the no-op it should be."""
    from .distributed import initialize_multihost, make_global_mesh

    mesh = make_global_mesh(n_head)
    return {"shape": (mesh.size(0), mesh.size(1)),
            "rejoined": initialize_multihost(device="cpu")}


def imported_modules() -> list:
    """Every module this process has imported."""
    return sorted(sys.modules)
