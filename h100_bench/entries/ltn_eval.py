"""Entry ``ltn_eval``: the LTN evaluation pass, ``evaluate_ltn`` over a
``PartScorer``, repeated for the window.  Each pass scores every part of
every video of the split (tail re-window as the mix says), expands the
part scores to frames and takes the frame AUC, as ``evaluate`` and ``fit``
do.  Counts a pass's clips as ``snippets``.

Compared once the window has closed, every pass against the reference on
the same weights and features: ``score_gap``, the widest gap of a frame
score; ``labels_off``, the frames whose label differs from the
reference's (exact: limit 0); ``auc_gap``, the widest gap between a pass's
AUC and the reference's AUC of that pass's own frame scores (exact but for
float64 rounding).  The AUC is held to its own scores, not to the
reference's: a score moved by f32 rounding may pass a near-equal one that
stands for hundreds of frames, which moves the AUC by ~1e-6 on sound runs,
while the scores themselves are held by ``score_gap``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100_bench.harness import data
from h100_bench.harness.cell import Cell as Base
from h100_bench.harness.cell import load_weights, program_config, worst
from h100_bench.harness.peaks import flops_per_tokens
from h100_bench.reference.evaluation import ltn_eval, roc_auc
from h100_bench.reference.model import LTN, f32_exact


def _gap(got, want, reduce) -> float:
    """``reduce(program, reference)`` over the videos of one pass, the
    worst; inf when a video's frame count differs."""
    if len(got) != len(want):
        return float("inf")
    gaps = []
    for g, w in zip(got, want):
        g = np.asarray(g, np.float64)
        if g.shape != w.shape:
            return float("inf")
        gaps.append(float(reduce(g, w)) if g.size else 0.0)
    return worst(gaps)


class Cell(Base):
    def inputs(self):
        p = self.p
        self.split = data.make_split(self.traffic["split"], self.seed,
                                     p["data.n_patch"], p["encoder.d_model"],
                                     self.device)
        self.weights = data.make_weights(p, self.seed, self.device)

    def _parts(self):
        pl = self.p["data.part_len"]
        return sum(-(-c // pl) for c in self.split.clips)

    def build(self):
        from lstc_vad_tpu_torch.evaluation.scoring import PartScorer
        from lstc_vad_tpu_torch.models import build

        p = self.p
        cfg = program_config(self.spec["config"])
        encoder, head = build(cfg, self.device, seed=0)
        load_weights(encoder, head, self.weights)
        self.scorer = PartScorer(encoder, head, p["data.part_len"],
                                 p["data.n_patch"],
                                 tail_rewindow=self.traffic["tail_rewindow"])
        self.items = list(zip(self.split.feats, self.split.annos))
        tokens = p["data.part_len"] * p["data.n_patch"] + 1
        self.counts = {"snippets": float(sum(self.split.clips)),
                       "model_flops": self._parts()
                       * flops_per_tokens(p, tokens)}
        self.warm_from = time.perf_counter()
        self.results = []
        self._pass()  # warm: the window's shapes and kernels

    def _pass(self):
        from lstc_vad_tpu_torch.evaluation.drivers import evaluate_ltn

        return evaluate_ltn(self.scorer, self.items,
                            self.p["data.segment_len"], return_labels=True)

    def unit(self):
        self.results.append(self._pass())
        return dict(self.counts)

    def outputs(self):
        return self.results

    def release(self):
        del self.scorer
        torch.cuda.empty_cache()

    def reference(self, mm):
        f32_exact()
        p = self.p
        model = LTN(p, self.device)
        W = data.flat(self.weights)
        return [ltn_eval(model, W, self.split.feats, self.split.annos,
                         p["data.part_len"], p["data.n_patch"], self.device,
                         mm, self.traffic["tail_rewindow"],
                         p["data.segment_len"])]

    def compare(self, got, want):
        """Every pass ``got`` [(auc, frame scores, frame labels)] against
        the reference's one pass ``want``."""
        _, w_frames, w_labels = want[0]
        flat = np.concatenate(w_labels)
        return {
            "score_gap": worst(_gap(f, w_frames,
                                    lambda g, w: np.abs(g - w).max())
                               for _, f, _ in got),
            "labels_off": worst(_gap(lab, w_labels,
                                     lambda g, w: (g != w).sum())
                                for _, _, lab in got),
            "auc_gap": worst(abs(a - roc_auc(np.concatenate(f), flat))
                             for a, f, _ in got)}

    def failed(self, got):
        """Passes with a non-finite AUC or a video missing."""
        return sum(1 for auc, frames, _ in got
                   if not np.isfinite(auc) or len(frames) != len(self.items))
