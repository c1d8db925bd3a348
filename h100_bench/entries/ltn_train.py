"""Entry ``ltn_train``: ``Trainer.train_epoch`` repeated for the window,
``fit``'s inner loop without its evaluations, at the configuration's
dropouts: balanced pairs through ``BatchIterator`` and the ``Prefetcher``,
the LTN step (forward, MIL + soft CE, backward, two-group Adagrad).  Counts
each step's 2 · batch · part_num · part_len clips as ``snippets``.

Set-up builds one ``Trainer`` on the benchmark's weights and split, drives
it through its first epoch (the warm-up) through the window's own call,
and hands that same object to the window, whose first units are epochs 2
to the mix's ``check_steps``.  The reference follows those epochs from the
same weights and inputs, working out the batches itself
(reference/sampling.py).  Compared, each relative to the reference:
``loss_gap``, the first epoch's loss; ``grad_gap``, the worst leaf's root
of Adagrad's accumulated squares after the first epoch (one step at these
mixes: the norm of the first gradient as Adagrad takes it, weight decay
added; the program's read from its optimizer state), against the larger
of the leaf's reference norm and the median leaf's; ``change_gap``, the
median leaf's gap of the norm of the parameters' change over the
``check_steps`` epochs, the parameters copied inside the window's unit
that ends them, each leaf on the same scale.  Leaves whose reference gradient is under a thousandth of the
median leaf's (the configuration's unused LayerNorm) are left out of the
change.

The later epochs' losses and the worst leaf's change are not compared:
Adagrad's first step moves each element by lr times the sign of its
gradient, so an element whose gradient is zero to rounding steps either
way, and both swing from seed to seed on sound runs (PERF.md §2).  They
are kept for the record (``later_loss_gaps``, ``worst_change``).
"""

from __future__ import annotations

import math
import os
import tempfile
import time

import numpy as np
import torch

from h100_bench.harness import data
from h100_bench.harness.cell import Cell as Base
from h100_bench.harness.cell import load_weights, program_config, worst
from h100_bench.harness.peaks import flops_per_tokens
from h100_bench.reference import sampling
from h100_bench.reference.model import (LTN, adagrad, f32_exact, ltn_loss,
                                        step_seed)

FLAT_LEAF = 1e-3  # a leaf below this share of the median gradient is flat


class _Store:
    """Features in host memory by key: ``get`` and ``n_clips``."""

    def __init__(self, feats):
        self.feats = feats

    def get(self, key, crop=None):
        return self.feats[key]

    def n_clips(self, key):
        return self.feats[key].shape[0]


def leaf_gaps(got: dict, want: dict, keep) -> dict:
    """{leaf: |‖got‖ - ‖want‖|} over the leaves in ``keep``, each against
    the larger of its reference norm and the median leaf's."""
    median = float(np.median([want[k] for k in keep]))
    return {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30)
            for k in keep}


class Cell(Base):
    @property
    def min_units(self):
        return max(self.traffic["check_steps"] - 1, 1)

    def inputs(self):
        p = self.p
        self.split = data.make_split(self.traffic["split"], self.seed,
                                     p["data.n_patch"], p["encoder.d_model"],
                                     self.device)
        self.weights = data.make_weights(p, self.seed, self.device)
        self.data_seed = data.stream_seed(self.seed, 10)
        self.run_seed = data.stream_seed(self.seed, 11)

    def build(self):
        from lstc_vad_tpu_torch.config import replace
        from lstc_vad_tpu_torch.train.driver import Trainer

        p, s = self.p, self.split
        self._tmp = tempfile.TemporaryDirectory(prefix="h100_bench_")
        root = self._tmp.name
        train_txt = os.path.join(root, "train.txt")
        with open(train_txt, "w") as f:
            f.writelines(f"{k},{int(a)}\n" for k, a in zip(s.keys, s.abnormal))
        for k, a, anno in zip(s.keys, s.abnormal, s.annos):
            if a:
                np.save(os.path.join(root, k + ".npy"), anno)
        cfg = replace(program_config(self.spec["config"]),
                      **{"data.train_txt": train_txt,
                         "data.test_mask_dir": root,
                         "data.seed": self.data_seed,
                         "seed": self.run_seed})
        self.trainer = Trainer(cfg, store=_Store(dict(zip(s.keys, s.feats))),
                               test_videos=[], device=self.device)
        st = self.trainer.state
        load_weights(st.encoder, st.head, self.weights)
        step = 2 * p["data.batch_size"] * p["data.part_num"]
        tokens = p["data.part_len"] * p["data.n_patch"] + 1
        self.step_flops = 3 * step * flops_per_tokens(p, tokens)
        self.step_snippets = step * p["data.part_len"]
        self.warm_from = time.perf_counter()
        # the check's first epoch, through the window's own call
        self.named = {**{f"encoder.{k}": v
                         for k, v in st.encoder.named_parameters()},
                      **{f"head.{k}": v
                         for k, v in st.head.named_parameters()}}
        self.losses, self.after_check = [], None
        self._record(self.trainer.train_epoch()["loss"])
        opt = self.trainer.state.optimizer.state
        self.grad_norms = {k: float(opt[v]["sum"].sum().sqrt())
                           for k, v in self.named.items()}

    def _record(self, loss):
        """One checked epoch's loss; after the last, the parameters."""
        self.losses.append(loss)
        if len(self.losses) == self.traffic["check_steps"]:
            with torch.no_grad():
                self.after_check = {k: v.detach().clone()
                                    for k, v in self.named.items()}

    def unit(self):
        m = self.trainer.train_epoch()
        if not math.isfinite(m["loss"]):
            raise FloatingPointError(f"train loss {m['loss']}")
        if len(self.losses) < self.traffic["check_steps"]:
            self._record(m["loss"])
        return {"snippets": m["batches"] * self.step_snippets,
                "model_flops": m["batches"] * self.step_flops,
                "steps": m["batches"]}

    def outputs(self):
        w0 = data.flat(self.weights)
        with torch.no_grad():
            change = {k: float((v - w0[k]).norm())
                      for k, v in self.after_check.items()}
        return {"losses": self.losses, "grad": self.grad_norms,
                "change": change}

    def release(self):
        del self.trainer, self.named, self.after_check
        self._tmp.cleanup()
        torch.cuda.empty_cache()

    def _batch(self, pairs, which):
        """Features [B, pn·pl, n_patch, d] and labels [B, pn·pl] of one
        side of a batch's pairs, from the split's host arrays."""
        p = self.p
        vids = self.normal if which == 0 else self.abnormal
        idx = [pair[which] for pair in pairs]
        feats = np.stack([self.split.feats[vids[v]][i, :p["data.n_patch"]]
                          for v, i in idx])
        labels = np.full(feats.shape[:2], float(which), np.float32)
        return (torch.from_numpy(feats).to(self.device),
                torch.from_numpy(labels).to(self.device))

    def reference(self, mm):
        f32_exact()
        p = self.p
        s = self.split
        self.normal = [i for i, a in enumerate(s.abnormal) if not a]
        self.abnormal = [i for i, a in enumerate(s.abnormal) if a]
        model = LTN(p, self.device)
        W = {k: v.clone() for k, v in data.flat(self.weights).items()}
        acc = {k: torch.zeros_like(v) for k, v in W.items()}
        unused = set(data.unused(p))
        bsz, pn, pl = p["data.batch_size"], p["data.part_num"], \
            p["data.part_len"]
        batches = sampling.epochs([s.clips[i] for i in self.normal],
                                  [s.clips[i] for i in self.abnormal],
                                  bsz, pn, pl, self.data_seed)
        losses, grad_norms, step = [], None, 0
        for epoch in range(self.traffic["check_steps"]):
            for pairs in next(batches):
                loss = self._step(model, W, acc, unused, pairs, step, mm)
                step += 1
            losses.append(loss)
            if epoch == 0:
                grad_norms = {k: float(a.sum().sqrt()) for k, a in acc.items()}
        w0 = data.flat(self.weights)
        with torch.no_grad():
            change = {k: float((W[k] - w0[k]).norm()) for k in W}
        return {"losses": losses, "grad": grad_norms, "change": change}

    def _step(self, model, W, acc, unused, pairs, step, mm) -> float:
        """One reference step on ``pairs``, updating ``W`` and ``acc`` in
        place; returns the loss."""
        p = self.p
        bsz, pn, pl = len(pairs), p["data.part_num"], p["data.part_len"]
        nf, _ = self._batch(pairs, 0)
        af, al = self._batch(pairs, 1)
        x = torch.cat([nf, af]).reshape(2 * bsz * pn, pl * p["data.n_patch"],
                                        -1)
        names = [k for k in W if k not in unused]
        leaves = {k: (v.detach().requires_grad_() if k in names else v)
                  for k, v in W.items()}
        torch.manual_seed(step_seed(self.run_seed, step))
        probs = model.head(leaves, model.encoder(leaves, x, mm, True)
                           [:, 0, :], mm, True)
        loss = ltn_loss(probs, bsz, pn, pl, al, p)
        grads = dict.fromkeys(W)
        grads.update(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        with torch.no_grad():
            adagrad(W, grads, acc, p)
        return float(loss.detach())

    def compare(self, got, want):
        gaps = [abs(g - w) / max(abs(w), 1e-30)
                for g, w in zip(got["losses"], want["losses"])]
        if len(got["losses"]) != len(want["losses"]):
            gaps = [math.inf]
        self.later_loss_gaps = gaps[1:]
        grads = want["grad"]
        median = float(np.median(list(grads.values())))
        moving = [k for k, g in grads.items() if g >= FLAT_LEAF * median]
        grad = leaf_gaps(got["grad"], grads, list(grads))
        change = leaf_gaps(got["change"], want["change"], moving)
        self.grad_leaf = max(grad, key=grad.get)
        self.worst_change = max(change.items(), key=lambda kv: kv[1])
        return {"loss_gap": worst(gaps[:1]), "grad_gap": worst(grad.values()),
                "change_gap": float(np.median(list(change.values())))}

    def failed(self, got):
        return sum(1 for x in got["losses"] if not math.isfinite(x))
