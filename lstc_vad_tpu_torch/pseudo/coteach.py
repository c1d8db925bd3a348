"""Co-teaching driver: alternate STN/LTN training, each supervising the other
through thresholded pseudo labels — PyTorch counterpart of
lstc_vad_tpu/pseudo/coteach.py.

Reproduces the README pipeline (README.md:22-35) as one driver, with the
committed round driver's semantics (Train/spatio_transformer_MIL_CE.py: even
rounds after the first retrain the STN with MIL + weighted BCE on the LTN's
pseudo labels; odd rounds retrain the LTN with MIL + soft CE on the STN's).

Artifacts land in ``workdir``: stn_pseudo.npy / ltn_pseudo.npy (np.save dict
format, loadable by the reference's datasets and by the JAX package).
Pseudo labels are scored by a separate eval copy of each round's best
weights (``Trainer.scoring_modules``), so a round's Trainer keeps its own
final weights.  On a mesh (``mesh=``) every round's Trainer is laid out on
it and scores data parallel; rank 0 writes each artifact, and every process
waits at a barrier before the next round reads it (JAX pseudo/coteach.py:
159-174).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import TrainConfig, replace
from ..data.feature_store import CropView
from ..device import resolve_device
from ..parallel.multihost import barrier, is_writer
from ..train.driver import Trainer
from .generator import (generate_ltn_pseudo_labels, generate_stn_pseudo_labels,
                        pseudo_scorer, save_pseudo_labels)


class CoTeachingDriver:
    """``store`` / ``test_videos``: a feature store and test split every
    round uses instead of opening ``data.h5_path`` and reading
    ``data.test_txt`` (an in-memory store on a machine without h5py).
    Without them, rounds whose data configs match share the first one's.

    ``rounds``: one record per finished round of ``run`` — the model, host
    wall seconds of training (evaluations included) and of pseudo-label
    generation, the encoder calls and the share of entries kept of the
    pseudo-label pass, and on the card the round's peak device memory."""

    def __init__(self, stn_cfg: TrainConfig, ltn_cfg: TrainConfig,
                 workdir: str, stn_threshold: float = 0.9,
                 ltn_threshold: float = 0.65, logger=None, device="cuda",
                 store=None, test_videos=None, mesh=None):
        self.stn_cfg = stn_cfg
        self.mesh = mesh
        self.ltn_cfg = ltn_cfg
        self.device = resolve_device(device)
        self.workdir = workdir
        self.stn_threshold = stn_threshold
        self.ltn_threshold = ltn_threshold
        self.logger = logger or logging.getLogger("lstc_vad_tpu_torch")
        os.makedirs(workdir, exist_ok=True)
        self.stn_pseudo_path = os.path.join(workdir, "stn_pseudo.npy")
        self.ltn_pseudo_path = os.path.join(workdir, "ltn_pseudo.npy")
        self.last_stn: Optional[Trainer] = None
        self.last_ltn: Optional[Trainer] = None
        self.rounds: List[Dict] = []
        # shared across rounds: run() keeps every round's Trainer alive (the
        # caller scores them afterwards), so each round would otherwise add
        # a full eager train cache + memoized test split to host RSS.  A
        # signature of None marks a caller's store / split, used by every
        # round.
        self._store, self._test_videos = store, test_videos
        self._store_sig = None if store is not None else ()
        self._tv_sig = None if test_videos is not None else ()

    def _trainer(self, cfg: TrainConfig) -> Trainer:
        """Build a round's Trainer, reusing the previous round's feature
        store / test split when the data config still matches."""
        d = cfg.data
        store_sig = (d.pack_path, d.h5_path, d.ten_crop, d.n_patch,
                     d.d_model, d.eager)
        tv_sig = store_sig + (d.dataset, d.test_txt, d.test_mask_dir,
                              d.test_mask_h5)
        trainer = Trainer(
            cfg, logger=self.logger, device=self.device, mesh=self.mesh,
            store=self._store if self._store_sig in (None, store_sig)
            else None,
            test_videos=(self._test_videos if self._tv_sig in (None, tv_sig)
                         else None))
        if self._store_sig is not None:
            self._store, self._store_sig = trainer.store, store_sig
        if self._tv_sig is not None:
            self._test_videos, self._tv_sig = trainer.test_videos, tv_sig
        return trainer

    # ------------------------------------------------------------ phases

    def train_stn(self, epochs: int, use_ltn_pseudo: bool) -> Trainer:
        """Bootstrap round: pure MIL.  Later rounds: MIL + BCE on the LTN's
        pseudo labels (spatio_transformer_MIL_CE.py:166-181)."""
        cfg = self.stn_cfg
        if use_ltn_pseudo:
            kw = {"data.pseudo_labels_path": self.ltn_pseudo_path}
            if cfg.data.dataset == "UCF":
                # the MIL_CE even-round UCF eval hardcodes 21 bins
                # (spatio_transformer_MIL_CE.py:230), unlike the standalone
                # STN script's 32
                kw["max_clips"] = 21
            cfg = replace(cfg, model="stn_bce", **kw)
        trainer = self._trainer(cfg)
        trainer.fit(epochs=epochs)
        self.last_stn = trainer
        return trainer

    def train_ltn(self, epochs: int) -> Trainer:
        """LTN round: MIL + soft CE on the STN's pseudo labels
        (temporal_transformer_shanghaitech.py:103-134)."""
        # the committed round driver's eval feeds short tails without
        # re-windowing (Train/spatio_transformer_MIL_CE.py:296)
        cfg = replace(self.ltn_cfg, eval_tail_rewindow=False,
                      **{"data.pseudo_labels_path": self.stn_pseudo_path})
        trainer = self._trainer(cfg)
        trainer.fit(epochs=epochs)
        self.last_ltn = trainer
        return trainer

    def _pseudo_store(self, trainer: Trainer):
        """tenCrop stores need a fixed crop for deterministic pseudo labels
        (no committed reference tenCrop generator semantics)."""
        d = trainer.cfg.data
        if d.ten_crop:
            if d.eval_crop is None:
                raise ValueError("tenCrop co-teaching needs data.eval_crop")
            return CropView(trainer.store, d.eval_crop)
        return trainer.store

    def _save(self, path: str, pseudo: Dict[str, np.ndarray]):
        """Write the artifact (rank 0 on a mesh), then, on a mesh, wait
        until every process may read it."""
        if is_writer(self.mesh):
            save_pseudo_labels(path, pseudo)
        if self.mesh is not None:
            barrier()

    def generate_stn_pseudo(self, trainer: Trainer
                            ) -> Tuple[Dict[str, np.ndarray], int]:
        """STN pseudo labels from the round's best weights, saved to
        ``stn_pseudo_path``.  Returns (labels, encoder calls)."""
        store = self._pseudo_store(trainer)
        scorer = pseudo_scorer(trainer.cfg, *trainer.scoring_modules())
        pseudo = generate_stn_pseudo_labels(scorer, store,
                                            trainer.train_records,
                                            self.stn_threshold)
        self._save(self.stn_pseudo_path, pseudo)
        self.logger.info("STN pseudo labels -> %s", self.stn_pseudo_path)
        return pseudo, scorer.scorer.n_calls

    def generate_ltn_pseudo(self, trainer: Trainer
                            ) -> Tuple[Dict[str, np.ndarray], int]:
        """LTN pseudo labels from the round's best weights, saved to
        ``ltn_pseudo_path``.  Returns (labels, encoder calls)."""
        d = trainer.cfg.data
        store = self._pseudo_store(trainer)
        scorer = pseudo_scorer(trainer.cfg, *trainer.scoring_modules())
        pseudo = generate_ltn_pseudo_labels(
            scorer, store, trainer.train_records, self.ltn_threshold,
            dataset=d.dataset, segment_len=d.segment_len)
        self._save(self.ltn_pseudo_path, pseudo)
        self.logger.info("LTN pseudo labels -> %s", self.ltn_pseudo_path)
        return pseudo, scorer.scorer.n_calls

    # ------------------------------------------------------------ loop

    def run(self, rounds: int, stn_epochs: int, ltn_epochs: int
            ) -> List[Trainer]:
        """round 0: STN(MIL) -> STN pseudo; round 1: LTN -> LTN pseudo;
        round 2: STN(MIL+BCE) -> STN pseudo; round 3: LTN -> ...; etc.
        Returns every round's Trainer."""
        results = []
        on_card = self.device.type == "cuda"
        for round_i in range(rounds):
            if on_card:
                torch.cuda.reset_peak_memory_stats(self.device)
            t0 = time.perf_counter()
            if round_i % 2 == 0:
                trainer = self.train_stn(stn_epochs,
                                         use_ltn_pseudo=(round_i > 0))
                t1 = time.perf_counter()
                pseudo, calls = self.generate_stn_pseudo(trainer)
            else:
                trainer = self.train_ltn(ltn_epochs)
                t1 = time.perf_counter()
                pseudo, calls = self.generate_ltn_pseudo(trainer)
            t2 = time.perf_counter()
            values = np.concatenate(list(pseudo.values()))
            self.rounds.append({
                "round": round_i, "model": trainer.cfg.model,
                "fit_seconds": t1 - t0, "pseudo_seconds": t2 - t1,
                "pseudo_encoder_calls": calls,
                "kept": float(np.mean(values > 0)) if len(values) else 0.0,
                "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                               if on_card else None)})
            results.append(trainer)
            self.logger.info("co-teaching round %d complete", round_i)
        return results
