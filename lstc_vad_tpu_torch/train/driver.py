"""Generic training driver: one loop serves STN and LTN — PyTorch counterpart
of lstc_vad_tpu/train/driver.py:36-427.

Replaces the reference's copy-pasted per-dataset train scripts
(Train/spatio_transformer_*.py, Train/temporal_transformer_*.py) with one
parameterized loop: balanced-pair batches through the prefetching pipeline,
the train step of ``cfg.model``, evaluation every ``inter_epoch`` epochs over
the test (and optionally train) split, AUC-gated checkpoints, and an
asynchronous autosave of the full state every N epochs.

SHT, UBnormal and UCF are ported, tenCrop stores included (a crop drawn per
training pair or video; evaluation at the fixed ``data.eval_crop``).
Features come from ``data.pack_path`` (a ``.lstcpack``, data/packed.py:
batches through its native gather, no h5py) when it is set, else from the
HDF5 file ``data.h5_path``.  Not yet: a device mesh (ROADMAP A18).

Wire types: ``data.transfer_dtype="bfloat16"`` casts each batch's features on
the host before the copy (the Prefetcher), so they enter the encoder as
bf16; ``data.eval_transfer_dtype`` is the evaluation's own knob, handed to
every scorer, so the training one never moves evaluation scores.

Evaluation is f32 whatever the training knobs: the scorers run the encoder's
f32, no-remat, no-SR twin (models/encoder.py::eval_twin), which shares the
train weights, and ``scoring_modules`` builds the same configuration.

Modes: a step puts the modules in train mode (train/steps.py) and
``evaluate`` puts them in eval mode, so in-training evaluation runs without
dropout and its attention takes the Hopper kernel.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..ckpt.io import load_checkpoint, save_checkpoint, wait_for_saves
from ..config import TrainConfig
from ..data import (BatchIterator, FeatureStore, PackedStore,
                    PairedTrainDataset, Prefetcher, load_pseudo_labels,
                    load_test_videos, load_train_records)
from ..device import resolve_device
from ..evaluation.drivers import (evaluate_ltn, evaluate_stn,
                                  evaluate_ucf_ltn, evaluate_ucf_stn)
from ..evaluation.scoring import (ClipScorer, PartScorer, UCFBinnedScorer,
                                  UCFClipBinScorer)
from ..models import build
from ..models.encoder import eval_config, eval_twin
from ..utils.misc import resolve_dtype
from .state import create_train_state
from .steps import make_train_step


@dataclasses.dataclass
class TrainResult:
    best_test_auc: float = 0.0
    best_test_epoch: int = 0
    best_train_auc: float = 0.0
    best_train_epoch: int = 0
    history: List[Dict] = dataclasses.field(default_factory=list)
    steps: int = 0


class Trainer:
    """Owns dataset, state, step and eval scorer for one config, on
    ``device`` (the card unless told the CPU).

    ``store`` / ``test_videos``: reuse a feature store (any object with
    ``get`` and ``n_clips``) and a test split instead of opening
    ``data.pack_path`` or ``data.h5_path`` and reading ``data.test_txt`` —
    co-teaching keeps every round's Trainer alive, and shares them
    (pseudo/coteach.py).

    ``eval_only``: build no paired dataset and no train step, read the test
    split lazily, and allow an empty train list (the evaluate and
    gen-pseudo paths)."""

    def __init__(self, cfg: TrainConfig, logger=None, store=None,
                 test_videos=None, device="cuda", eval_only: bool = False):
        self.cfg = cfg
        self.logger = logger or logging.getLogger("lstc_vad_tpu_torch")
        self.device = resolve_device(device)
        self.best_params = None  # snapshot at the best gate AUC (fit)
        self.eval_seconds = 0.0  # host wall time spent in evaluate()
        d = cfg.data

        if not eval_only and cfg.eval_train_split:
            # fail fast: the first train-split eval otherwise surfaces this
            # AFTER inter_epoch epochs of compute
            if d.dataset == "UCF":
                raise ValueError("UCF has no train-split evaluation "
                                 "(set eval_train_split=False)")
            if not d.test_mask_dir:
                raise ValueError(
                    "eval_train_split=True scores abnormal train videos "
                    "against frame masks (Train/spatio_transformer_"
                    "shanghaitech.py:148-168): set data.test_mask_dir or "
                    "eval_train_split=False")
        records = (load_train_records(d.dataset, d.train_txt)
                   if d.train_txt else [])
        if not records and not eval_only:
            raise ValueError("training requires data.train_txt")
        if store is not None:
            self.store = store
        elif d.pack_path:
            self.store = PackedStore(d.pack_path, ten_crop=d.ten_crop,
                                     n_patch=d.n_patch, d_model=d.d_model)
        else:
            eager = d.eager and records and not eval_only
            self.store = FeatureStore(
                d.h5_path, eager_keys=[r.key for r in records] if eager
                else None, ten_crop=d.ten_crop, n_patch=d.n_patch,
                d_model=d.d_model)
        self.dataset = None
        if not eval_only:
            pseudo = (load_pseudo_labels(d.pseudo_labels_path)
                      if d.pseudo_labels_path else None)
            self.dataset = PairedTrainDataset(
                records, self.store, part_num=d.part_num, part_len=d.part_len,
                n_patch=d.n_patch, sample=d.sample, pseudo_labels=pseudo,
                ten_crop=d.ten_crop, double_short=(d.dataset == "UCF"),
                crop_per_video=(d.dataset == "UCF"), seed=d.seed)
        self.train_records = records
        self._train_masks: Dict[str, np.ndarray] = {}

        # in-training eval re-scores the split every inter_epoch epochs:
        # with data.eager (SHT/UBnormal presets) memoize its features; UCF
        # (eager=False) and one-shot eval_only runs stream
        if test_videos is not None:
            self.test_videos = test_videos
        else:
            self.test_videos = load_test_videos(
                d.dataset, d.test_txt, self.store, mask_dir=d.test_mask_dir,
                mask_h5=d.test_mask_h5,
                cache=d.eager and not eval_only) if d.test_txt else []

        self.state = create_train_state(cfg, self.device)
        self.step_fn = None if eval_only else make_train_step(cfg)
        # the f32 twin of the train encoder, sharing its weights
        self.eval_encoder = eval_twin(self.state.encoder)
        self.scorer = self._build_scorer()

    def _build_scorer(self):
        cfg, d = self.cfg, self.cfg.data
        # the eval wire is its own knob, never data.transfer_dtype
        enc, head = self.eval_encoder, self.state.head
        td = d.eval_transfer_dtype
        if cfg.model.startswith("stn"):
            if d.dataset == "UCF":
                return UCFClipBinScorer(enc, head, d.n_patch, cfg.max_clips,
                                        transfer_dtype=td)
            # kind: an n_layers==1 classifier head scores P(abnormal)
            return ClipScorer(enc, head, d.n_patch, kind=cfg.head.kind,
                              transfer_dtype=td)
        if d.dataset == "UCF":
            # in-training eval flags (Train/temporal_transformer_UCF.py)
            return UCFBinnedScorer(enc, head, d.part_len, d.n_patch,
                                   max_clips=cfg.max_clips,
                                   l2_normalize=False, tail_rewindow=False,
                                   adaptive_bins=True, transfer_dtype=td)
        return PartScorer(enc, head, d.part_len, d.n_patch,
                          tail_rewindow=cfg.eval_tail_rewindow,
                          transfer_dtype=td)

    def scoring_modules(self):
        """A separate encoder and head on the Trainer's device, in eval
        mode, with the evaluation knobs (f32, no remat, no SR) and holding
        ``best_params`` (the live weights when no evaluation has improved):
        what co-teaching scores pseudo labels with, while the Trainer's own
        modules stay as they are."""
        cfg = self.cfg
        params = self.best_params or self.params()
        encoder, head = build(dataclasses.replace(
            cfg, encoder=eval_config(cfg.encoder)), device=self.device,
            seed=cfg.seed)
        encoder.load_state_dict(params["encoder"], strict=True)
        head.load_state_dict(params["head"], strict=True)
        return encoder, head

    # ---------------------------------------------------------------- eval

    def _eval_feat(self, feat):
        """tenCrop stores yield 4-D [n_clips, 10, n_patch, d] features; the
        reference ships no tenCrop eval script, so evaluation needs an
        explicit crop (data.eval_crop)."""
        d = self.cfg.data
        if not d.ten_crop:
            return feat
        if d.eval_crop is None:
            raise ValueError("tenCrop evaluation needs data.eval_crop (0-9): "
                             "the reference has no committed tenCrop eval "
                             "semantics")
        return feat[:, d.eval_crop]

    def _lazy_feat(self, v):
        """Zero-arg loader of a test video's features at the eval crop:
        the scorers stream one video at a time."""
        return lambda: self._eval_feat(v.feat)

    def _test_items(self):
        d = self.cfg.data
        if d.dataset == "UCF":
            # STN in-training eval bins from the annotation frame count
            # (Train/spatio_transformer_UCF.py:121-122); LTN from the
            # feature-array clip count (Train/temporal_transformer_UCF.py:
            # 143-145)
            stn = self.cfg.model.startswith("stn")
            return [(self._lazy_feat(v), v.anno,
                     v.n_frames // d.segment_len if stn else v.n_clips)
                    for v in self.test_videos]
        return [(self._lazy_feat(v), v.anno) for v in self.test_videos]

    def _train_items(self):
        """Train-split eval: abnormal videos use the frame mask GT
        (Train/spatio_transformer_shanghaitech.py:148-168), read once and
        kept: fit() evaluates the split every inter_epoch epochs.
        SHT/UBnormal only — the reference UCF scripts never evaluate the
        train split."""
        d = self.cfg.data
        if d.dataset == "UCF":
            raise ValueError("UCF has no train-split evaluation "
                             "(set eval_train_split=False)")
        items = []
        for r in self.train_records:
            anno = None
            if r.is_abnormal:
                anno = self._train_masks.get(r.key)
                if anno is None:
                    anno = self._train_masks[r.key] = np.load(
                        os.path.join(d.test_mask_dir, r.key + ".npy"))
            items.append(((lambda key=r.key: self._eval_feat(
                self.store.get(key))), anno))
        return items

    def evaluate(self, split: str = "test") -> float:
        """Frame AUC of the current weights on ``split`` ("test" or
        "train"), in eval mode."""
        cfg, d = self.cfg, self.cfg.data
        self.state.encoder.eval()
        self.eval_encoder.eval()
        self.state.head.eval()
        items = self._test_items() if split == "test" else self._train_items()
        t0 = time.perf_counter()
        if d.dataset == "UCF":
            evaluate = evaluate_ucf_stn if cfg.model.startswith("stn") \
                else evaluate_ucf_ltn
        else:
            evaluate = evaluate_stn if cfg.model.startswith("stn") \
                else evaluate_ltn
        auc = evaluate(self.scorer, items, d.segment_len)
        self.eval_seconds += time.perf_counter() - t0
        return auc

    # ---------------------------------------------------------------- train

    def train_epoch(self) -> Dict[str, float]:
        """One pass over the paired dataset.  Returns the last step's
        metrics, ``snippets_per_sec``, ``seconds`` (host wall time, batch
        building included) and ``batches``."""
        d = self.cfg.data
        batches = Prefetcher(
            BatchIterator(self.dataset, d.batch_size, drop_last=True),
            self.device, feature_dtype=resolve_dtype(d.transfer_dtype))
        snippets_per_batch = 2 * d.batch_size * d.part_num * d.part_len
        metrics = {}
        log_every = self.cfg.log_every_step
        n = 0
        t0 = time.perf_counter()
        for batch in batches:
            self.state, metrics = self.step_fn(self.state, *batch)
            n += 1
            if log_every and n % log_every == 0:
                # per-iteration loss lines like the reference
                # (spatio_transformer_shanghaitech.py:111-112); each waits
                # for the device, so off by default
                self.logger.info(
                    "[iter %d] %s", self.state.step,
                    {k: round(float(v), 4) for k, v in metrics.items()})
        # reading the metrics waits for the last step: inside the timing
        metrics = {k: float(v) for k, v in metrics.items()}
        seconds = time.perf_counter() - t0
        self.dataset.shuffle_keys()
        out = dict(metrics)
        if n:
            out["snippets_per_sec"] = n * snippets_per_batch / max(seconds,
                                                                   1e-9)
        return out | {"seconds": seconds, "batches": n}

    def _emit_metrics(self, record: Dict):
        """One JSON line per record in ``cfg.metrics_jsonl`` (off when
        empty)."""
        path = self.cfg.metrics_jsonl
        if not path:
            return
        with open(path, "a") as f:
            f.write(json.dumps({"ts": round(time.time(), 3), **record}) + "\n")

    # ------------------------------------------------------------ ckpt

    def params(self) -> Dict[str, Dict]:
        """The encoder's and head's state_dicts (live tensors)."""
        return {"encoder": self.state.encoder.state_dict(),
                "head": self.state.head.state_dict()}

    def save_state(self, path: str, asynchronous: bool = False):
        """Full resumable state: params, Adagrad accumulators, step and seed
        (the reference saves bare state_dicts and restarts its schedule on
        resume).  ``asynchronous``: return once the state is copied to host
        memory and write it in the background (ckpt/io.py)."""
        save_checkpoint(path, self.state, asynchronous=asynchronous)

    def restore_state(self, path: str):
        wait_for_saves()  # a pending autosave may still be writing ``path``
        self.state = load_checkpoint(path, self.state)

    def fit(self, epochs: Optional[int] = None,
            on_eval: Optional[Callable] = None,
            autosave_every: Optional[int] = None) -> TrainResult:
        """``on_eval(trainer, result, entry)`` is called after each
        evaluation.  ``autosave_every``: save the full state to
        ``<model_save_dir>/autosave`` every N epochs, asynchronously (restart
        with ``restore_state`` and continue exactly).  Every save has
        committed when ``fit`` returns."""
        cfg = self.cfg
        result = TrainResult()
        epochs = cfg.epochs if epochs is None else epochs
        for epoch in range(epochs):
            if autosave_every and epoch and epoch % autosave_every == 0:
                self.save_state(os.path.join(cfg.model_save_dir, "autosave"),
                                asynchronous=True)
            m = self.train_epoch()
            result.steps += m.pop("batches")
            self.logger.info("[epoch %d] %s", epoch,
                             {k: round(v, 4) for k, v in m.items()})
            self._emit_metrics({"kind": "train", "epoch": epoch,
                                "step": self.state.step, **m})
            if epoch % cfg.inter_epoch == 0 or epoch == epochs - 1:
                auc_test = self.evaluate("test") if self.test_videos else 0.0
                auc_train = (self.evaluate("train")
                             if cfg.eval_train_split else 0.0)
                entry = {"epoch": epoch, "auc_test": auc_test,
                         "auc_train": auc_train, **m}
                result.history.append(entry)
                self._emit_metrics({"kind": "eval", **entry})
                # the reference gates saving on the train-split AUC for SHT
                # (spatio_transformer_shanghaitech.py:177-191) and on test AUC
                # otherwise (spatio_transformer_UCF.py:139-149)
                gate = auc_train if cfg.eval_train_split else auc_test
                prev_best = (result.best_train_auc if cfg.eval_train_split
                             else result.best_test_auc)
                improved = gate > prev_best
                if auc_test > result.best_test_auc:
                    result.best_test_auc = auc_test
                    result.best_test_epoch = epoch
                if auc_train > result.best_train_auc:
                    result.best_train_auc = auc_train
                    result.best_train_epoch = epoch
                if improved:
                    # co-teaching regenerates pseudo labels from the BEST
                    # weights (spatio_transformer_MIL_CE.py:392-396); copies,
                    # since the next step updates the live tensors in place
                    self.best_params = {
                        name: {k: v.detach().clone() for k, v in sd.items()}
                        for name, sd in self.params().items()}
                if improved and gate > cfg.save_threshold:
                    path = os.path.join(
                        cfg.model_save_dir,
                        f"{cfg.data.dataset}_{cfg.model}_{gate:.4f}")
                    self.logger.info("saving model to %s", path)
                    save_checkpoint(path, self.params())
                self.logger.info(
                    "[epoch %d] test AUC %.4f (best %.4f @%d) "
                    "train AUC %.4f (best %.4f @%d)", epoch, auc_test,
                    result.best_test_auc, result.best_test_epoch, auc_train,
                    result.best_train_auc, result.best_train_epoch)
                if on_eval is not None:
                    on_eval(self, result, entry)
        wait_for_saves()  # commit any autosave in flight before returning
        return result


def train(cfg: TrainConfig, epochs: Optional[int] = None, logger=None,
          device="cuda") -> TrainResult:
    return Trainer(cfg, logger=logger, device=device).fit(epochs)
