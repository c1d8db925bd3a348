"""Entry ``stn_train``: ``Trainer.train_epoch`` of the STN repeated for the
window, ``ltn_train``'s protocol at the STN's shapes: balanced pairs through
the Trainer's batch worker, the STN step (forward over one sequence a clip,
the MIL loss, backward, two-group Adagrad) at the configuration's dropouts.

A step takes 2 · batch · part_num · part_len clips, each a sequence of
``n_patch`` + 1 tokens (8,960 of 17 at the cell's shape), counted as
``snippets``; ``model_flops`` is three forwards of them.  ``pad_bytes`` is
the window's increase in ``ops/cuda_linear.py::pad_bytes`` (the GEMM's
copies into a padded row stride at d_inner 3027), left out where the
program has no such counter.

The check is ``ltn_train``'s: set-up runs epoch 1 through the window's own
call, the window's first units epochs 2 to ``check_steps``; the reference
(reference/stn.py) follows them from the same weights and batches, and
``loss_gap``, ``grad_gap`` and ``change_gap`` are compared as there.
"""

from __future__ import annotations

import torch

from h100_bench.entries import ltn_train
from h100_bench.harness import data
from h100_bench.harness.peaks import flops_per_tokens
from h100_bench.reference import sampling
from h100_bench.reference.model import adagrad, f32_exact, step_seed
from h100_bench.reference.stn import STN, stn_loss


def _pad_bytes():
    """The program's ``pad_bytes`` counter, or None where it has none."""
    from lstc_vad_tpu_torch.ops import cuda_linear

    return getattr(cuda_linear, "pad_bytes", None)


class Cell(ltn_train.Cell):
    def build(self):
        super().build()
        p = self.p
        step = 2 * p["data.batch_size"] * p["data.part_num"] \
            * p["data.part_len"]
        # ltn_train's count is of parts of part_len clips: one clip a
        # sequence here
        self.step_flops = 3 * step * flops_per_tokens(p, p["data.n_patch"]
                                                      + 1)

    def unit(self):
        before = _pad_bytes()
        counts = super().unit()
        if before is not None:
            counts["pad_bytes"] = _pad_bytes() - before
        return counts

    def reference(self, mm):
        f32_exact()
        p = self.p
        s = self.split
        self.normal = [i for i, a in enumerate(s.abnormal) if not a]
        self.abnormal = [i for i, a in enumerate(s.abnormal) if a]
        model = STN(p, self.device)
        W = {k: v.clone() for k, v in data.flat(self.weights).items()}
        acc = {k: torch.zeros_like(v) for k, v in W.items()}
        unused = set(data.unused(p))
        batches = sampling.epochs([s.clips[i] for i in self.normal],
                                  [s.clips[i] for i in self.abnormal],
                                  p["data.batch_size"], p["data.part_num"],
                                  p["data.part_len"], self.data_seed)
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
        """One reference step on ``pairs``: every clip of the batch one
        sequence, normal videos first; updates ``W`` and ``acc`` in place
        and returns the loss."""
        p = self.p
        bsz = len(pairs)
        nf, _ = self._batch(pairs, 0)
        af, _ = self._batch(pairs, 1)
        clips = torch.cat([nf, af]).reshape(-1, p["data.n_patch"],
                                            nf.shape[-1])
        del nf, af
        names = [k for k in W if k not in unused]
        leaves = {k: (v.detach().requires_grad_() if k in names else v)
                  for k, v in W.items()}
        torch.manual_seed(step_seed(self.run_seed, step))
        scores = model.forward(leaves, clips, mm, True)
        loss = stn_loss(scores, bsz, p["data.part_num"], p["data.part_len"],
                        p)
        grads = dict.fromkeys(W)
        grads.update(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        with torch.no_grad():
            adagrad(W, grads, acc, p)
        return float(loss.detach())
