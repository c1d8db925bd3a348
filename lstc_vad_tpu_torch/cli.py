"""CLI of the PyTorch package — the ``train`` and ``evaluate`` subcommands of
lstc_vad_tpu/cli/main.py:359-401, 492-632, 1109-1127 (SHT and UBnormal, STN
and LTN):

    python -m lstc_vad_tpu_torch train --preset sht_ltn --h5 feats.h5 \\
        --train-txt SH_Train_new.txt --test-txt SH_Test_NEW.txt \\
        --mask-dir masks/ [--epochs N] [--metrics-jsonl m.jsonl] \\
        [--resume state.pt] [--save-state state.pt] [--save-best best.pt] \\
        [--set optim.lr_encoder=3e-4 ...] [--device cuda|cpu]

    python -m lstc_vad_tpu_torch evaluate --preset sht_ltn \\
        --h5 feats.h5 --test-txt SH_Test_NEW.txt --mask-dir masks/ \\
        [--torch-ckpt --encoder-ckpt enc.ckpt --head-ckpt head.ckpt] \\
        [--set encoder.n_layers=2 ...] [--device cuda|cpu]

The flags are the JAX CLI's; a device mesh (``--mesh``, ``--multihost``) is
not offered yet (ROADMAP A18).  Everything runs on the card unless
``--device cpu`` is given.  ``train`` fits with the Trainer
(train/driver.py) and logs per-epoch losses and AUCs; ``evaluate`` builds the
model and scorer directly and prints the frame AUC as ``auc = <value>``.
Config fields are overridden with --set path=value, typed by the dataclass
field.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import typing

from .config import PRESETS, TrainConfig, preset, replace


def _valid_paths(cfg) -> list:
    out = []

    def walk(node, prefix):
        for f in dataclasses.fields(node):
            val = getattr(node, f.name)
            if dataclasses.is_dataclass(val):
                walk(val, f"{prefix}{f.name}.")
            else:
                out.append(f"{prefix}{f.name}")

    walk(cfg, "")
    return out


def _parse_typed(raw: str, t, path: str):
    import types

    origin = typing.get_origin(t)
    # Optional[...] — both typing.Union and PEP 604 `X | None` spellings
    if origin is typing.Union or origin is getattr(types, "UnionType", None):
        if raw == "None":
            return None
        inner = [a for a in typing.get_args(t) if a is not type(None)]
        return _parse_typed(raw, inner[0], path)
    if t is bool:
        low = raw.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise SystemExit(f"--set {path}: expected a bool, got {raw!r}")
    if t in (int, float):
        try:
            return t(raw)
        except ValueError:
            raise SystemExit(f"--set {path}: expected {t.__name__}, "
                             f"got {raw!r}") from None
    if t is str:
        return raw
    raise SystemExit(f"--set {path}: unsupported field type {t}")


def _coerce(cfg, path: str, raw: str):
    """Parse ``raw`` against the dataclass field's annotation; an unknown
    path fails at parse time with the list of valid ones."""
    node = cfg
    parts = path.split(".")
    try:
        for p in parts[:-1]:
            node = getattr(node, p)
        t = typing.get_type_hints(type(node))[parts[-1]]
    except (AttributeError, KeyError, TypeError):
        raise SystemExit(
            f"--set: unknown config path {path!r}.\nValid paths: "
            + ", ".join(_valid_paths(cfg))) from None
    return _parse_typed(raw, t, path)


def _apply_common(cfg: TrainConfig, args) -> TrainConfig:
    mapping = {"h5": "data.h5_path", "train_txt": "data.train_txt",
               "test_txt": "data.test_txt", "mask_dir": "data.test_mask_dir",
               "pseudo_labels": "data.pseudo_labels_path",
               "batch_size": "data.batch_size", "epochs": "epochs",
               "save_dir": "model_save_dir", "metrics_jsonl": "metrics_jsonl",
               "seed": "seed"}
    kw = {path: getattr(args, name) for name, path in mapping.items()
          if getattr(args, name, None) is not None}
    if getattr(args, "seed", None) is not None:
        kw["data.seed"] = args.seed  # the sampler's too, as the JAX CLI
    cfg = replace(cfg, **kw) if kw else cfg
    for item in args.set or []:
        path, _, raw = item.partition("=")
        cfg = replace(cfg, **{path: _coerce(cfg, path, raw)})
    return cfg


def _load_checkpoint(args, encoder, head):
    """--torch-ckpt with --encoder-ckpt/--head-ckpt: the reference's two
    state_dict files, loaded over the fresh weights; keys that match nothing
    and weights left fresh are reported, as the JAX CLI reports them."""
    if not args.torch_ckpt:
        if args.encoder_ckpt or args.head_ckpt:
            raise SystemExit("--encoder-ckpt/--head-ckpt are torch "
                             "state_dicts: add --torch-ckpt")
        print("[evaluate] no --torch-ckpt: scoring with fresh RANDOM-INIT "
              "weights (smoke-test mode)", file=sys.stderr)
        return
    if not (args.encoder_ckpt and args.head_ckpt):
        raise SystemExit("--torch-ckpt needs both --encoder-ckpt and "
                         "--head-ckpt (the reference saves two files)")
    from .ckpt.interop import load_reference_checkpoint

    enc_sd, head_sd = load_reference_checkpoint(args.encoder_ckpt,
                                                args.head_ckpt)
    for name, module, sd in (("encoder", encoder, enc_sd),
                             ("head", head, head_sd)):
        res = module.load_state_dict(sd, strict=False)
        if res.missing_keys or res.unexpected_keys:
            print(f"[ckpt] {name}: kept fresh {res.missing_keys}, skipped "
                  f"{res.unexpected_keys}", file=sys.stderr)


def cmd_evaluate(args):
    cfg = _apply_common(preset(args.preset), args)
    d = cfg.data
    if d.dataset == "UCF":
        raise SystemExit("the UCF eval scorers are not ported yet (ROADMAP "
                         "A14); use the JAX package's CLI")
    if d.ten_crop or d.pack_path:
        raise SystemExit("tenCrop stores and .lstcpack stores are not ported "
                         "yet (ROADMAP A6, A14)")
    # evaluation is f32 whatever the training knobs say, as in the JAX
    # package's Trainer._make_eval_encoder: the reference eval is plain f32
    cfg = replace(cfg, **{"encoder.compute_dtype": "float32",
                          "encoder.remat": False, "encoder.cast_sr": False})
    from .data import FeatureStore, load_test_videos
    from .evaluation.drivers import evaluate_ltn, evaluate_stn
    from .evaluation.scoring import ClipScorer, PartScorer
    from .models import build

    encoder, head = build(cfg, device=args.device, seed=cfg.seed)
    _load_checkpoint(args, encoder, head)
    store = FeatureStore(d.h5_path)
    try:
        videos = load_test_videos(d.dataset, d.test_txt, store,
                                  mask_dir=d.test_mask_dir)
        items = [(v.loader, v.anno) for v in videos]  # read per video
        if cfg.model.startswith("stn"):
            scorer = ClipScorer(encoder, head, d.n_patch, kind=cfg.head.kind)
            auc = evaluate_stn(scorer, items, d.segment_len)
        else:
            scorer = PartScorer(encoder, head, d.part_len, d.n_patch,
                                tail_rewindow=cfg.eval_tail_rewindow)
            auc = evaluate_ltn(scorer, items, d.segment_len)
    finally:
        store.close()
    print(f"auc = {auc}")
    return 0


def cmd_train(args):
    import logging

    from .ckpt import save_checkpoint
    from .train.driver import Trainer

    cfg = _apply_common(preset(args.preset), args)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    logger = logging.getLogger("lstc_vad_tpu_torch")
    trainer = Trainer(cfg, logger=logger, device=args.device)
    if args.resume:
        trainer.restore_state(args.resume)
        logger.info("resumed from %s at step %d", args.resume,
                    trainer.state.step)
    result = trainer.fit(epochs=args.epochs)
    if args.save_state:
        trainer.save_state(args.save_state)
        logger.info("saved full train state to %s", args.save_state)
    if args.save_best:
        # the reference keeps the best-AUC epoch's weights, not the last
        # (spatio_transformer_shanghaitech.py:177-191); the final ones when
        # no evaluation ran
        best = trainer.best_params or trainer.params()
        save_checkpoint(args.save_best, best)
        gate_auc, gate_ep = ((result.best_train_auc, result.best_train_epoch)
                             if cfg.eval_train_split else
                             (result.best_test_auc, result.best_test_epoch))
        logger.info("saved best-gate params to %s (gate AUC %.4f @%d)",
                    args.save_best, gate_auc, gate_ep)
    logger.info("best test AUC %.4f @%d, best train AUC %.4f @%d",
                result.best_test_auc, result.best_test_epoch,
                result.best_train_auc, result.best_train_epoch)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="lstc_vad_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="train STN or LTN (preset decides)")
    t.add_argument("--preset", required=True, choices=sorted(PRESETS))
    t.add_argument("--h5")
    t.add_argument("--train-txt", dest="train_txt")
    t.add_argument("--test-txt", dest="test_txt")
    t.add_argument("--mask-dir", dest="mask_dir")
    t.add_argument("--pseudo-labels", dest="pseudo_labels")
    t.add_argument("--batch-size", dest="batch_size", type=int)
    t.add_argument("--seed", type=int)
    t.add_argument("--epochs", type=int)
    t.add_argument("--save-dir", dest="save_dir")
    t.add_argument("--metrics-jsonl", dest="metrics_jsonl",
                   help="append structured per-epoch/eval metrics (one JSON "
                        "line each) to this file")
    t.add_argument("--resume", help="restore the full train state from this "
                                    "checkpoint file")
    t.add_argument("--save-state", dest="save_state",
                   help="save the full train state after fitting")
    t.add_argument("--save-best", dest="save_best",
                   help="save the best-AUC epoch's params, like the "
                        "reference's AUC-gated checkpoints")
    t.add_argument("--set", action="append", metavar="PATH=VALUE",
                   help="override any config field, e.g. "
                        "optim.lr_encoder=3e-4")
    t.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a card) or 'cpu'")
    t.set_defaults(fn=cmd_train)
    e = sub.add_parser("evaluate", help="frame-AUC evaluation")
    e.add_argument("--preset", required=True, choices=sorted(PRESETS))
    e.add_argument("--h5")
    e.add_argument("--test-txt", dest="test_txt")
    e.add_argument("--mask-dir", dest="mask_dir")
    e.add_argument("--seed", type=int, help="seed of the fresh weights")
    e.add_argument("--torch-ckpt", dest="torch_ckpt", action="store_true")
    e.add_argument("--encoder-ckpt", dest="encoder_ckpt")
    e.add_argument("--head-ckpt", dest="head_ckpt")
    e.add_argument("--set", action="append", metavar="PATH=VALUE",
                   help="override any config field, e.g. encoder.n_layers=2")
    e.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a card) or 'cpu'")
    e.set_defaults(fn=cmd_evaluate)
    args = p.parse_args(argv)
    return args.fn(args)
