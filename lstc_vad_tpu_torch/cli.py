"""CLI of the PyTorch package — the ``train``, ``gen-pseudo``, ``evaluate``
and ``coteach`` subcommands of lstc_vad_tpu/cli/main.py:359-675, 1109-1176,
1308-1331 (SHT, UBnormal and UCF; STN and LTN):

    python -m lstc_vad_tpu_torch train --preset sht_ltn --h5 feats.h5 \\
        --train-txt SH_Train_new.txt --test-txt SH_Test_NEW.txt \\
        --mask-dir masks/ [--epochs N] [--metrics-jsonl m.jsonl] \\
        [--resume state.pt] [--save-state state.pt] [--save-best best.pt] \\
        [--set optim.lr_encoder=3e-4 ...] [--device cuda|cpu]

    python -m lstc_vad_tpu_torch gen-pseudo --preset sht_stn --kind stn \\
        --h5 feats.h5 --train-txt SH_Train_new.txt --ckpt best.pt \\
        --out stn_pseudo.npy [--threshold 0.9]

    python -m lstc_vad_tpu_torch evaluate --preset ucf_ltn \\
        --h5 ucf.h5 --test-txt Test_Annotation.txt --mask-h5 gt.h5 \\
        [--ckpt best.pt | --torch-ckpt --encoder-ckpt e --head-ckpt h] \\
        [--per-class] [--dump-scores s.npz] [--bootstrap N]

    python -m lstc_vad_tpu_torch coteach --stn-preset sht_stn \\
        --ltn-preset sht_ltn --workdir work/ --h5 feats.h5 \\
        --train-txt ... --test-txt ... --mask-dir masks/ [--rounds 4]

The flags are the JAX CLI's.  Refused with the roadmap item that ports
them: ``--artifact`` (A17), ``--mesh`` / ``--multihost`` (A18) and
``--eval-crop`` (tenCrop, A14).  Everything runs on the card unless
``--device cpu`` is given.  ``--ckpt`` reads a ``ckpt/io.py`` file, the
parameters alone (``train --save-best``) or a full state (``--save-state``);
without a checkpoint, evaluate and gen-pseudo score random-init weights and
say so.  Config fields are overridden with --set path=value, typed by the
dataclass field.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
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
               "mask_h5": "data.test_mask_h5",
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


_UNPORTED = {"artifact": ("--artifact", "AOT artifacts are ROADMAP A17"),
             "mesh": ("--mesh", "a device mesh is ROADMAP A18"),
             "multihost": ("--multihost", "multi-process runs are ROADMAP "
                                          "A18"),
             "eval_crop": ("--eval-crop", "tenCrop evaluation is ROADMAP "
                                          "A14")}


def _refuse_unported(args):
    for name, (flag, why) in _UNPORTED.items():
        if getattr(args, name, None) is not None:
            raise SystemExit(f"{flag} is not ported yet: {why}")


def _eval_trainer(cfg: TrainConfig, args, cmd: str):
    """An eval-only Trainer holding the weights the checkpoint flags name:
    --ckpt (a ckpt/io.py file, loaded strictly), or --torch-ckpt with the
    reference's --encoder-ckpt/--head-ckpt state_dicts (keys that match
    nothing and weights left fresh are reported, as the JAX CLI reports
    them), or fresh random-init weights, said loudly."""
    from .train.driver import Trainer

    if args.torch_ckpt and not (args.encoder_ckpt and args.head_ckpt):
        raise SystemExit("--torch-ckpt needs both --encoder-ckpt and "
                         "--head-ckpt (the reference saves two files)")
    if not args.torch_ckpt and (args.encoder_ckpt or args.head_ckpt):
        raise SystemExit("--encoder-ckpt/--head-ckpt are torch state_dicts "
                         "(add --torch-ckpt); a --ckpt file holds both "
                         "modules")
    if args.torch_ckpt and args.ckpt:
        raise SystemExit("pass --ckpt or --torch-ckpt, not both")
    # evaluation is f32 whatever the training knobs say, as in the JAX
    # package's Trainer._make_eval_encoder: the reference eval is plain f32
    cfg = replace(cfg, **{"encoder.compute_dtype": "float32",
                          "encoder.remat": False, "encoder.cast_sr": False})
    trainer = Trainer(cfg, eval_only=True, device=args.device)
    state = trainer.state
    if args.ckpt:
        from .ckpt import load_checkpoint

        load_checkpoint(args.ckpt, state)
    elif args.torch_ckpt:
        from .ckpt.interop import load_reference_checkpoint

        enc_sd, head_sd = load_reference_checkpoint(args.encoder_ckpt,
                                                    args.head_ckpt)
        for name, module, sd in (("encoder", state.encoder, enc_sd),
                                 ("head", state.head, head_sd)):
            res = module.load_state_dict(sd, strict=False)
            if res.missing_keys or res.unexpected_keys:
                print(f"[ckpt] {name}: kept fresh {res.missing_keys}, "
                      f"skipped {res.unexpected_keys}", file=sys.stderr)
    else:
        print(f"[{cmd}] no --ckpt/--torch-ckpt: scoring with fresh "
              "RANDOM-INIT weights (smoke-test mode)", file=sys.stderr)
    return trainer


def cmd_evaluate(args):
    from .evaluation.scoring import (ucf_final_eval_scorer,
                                     ucf_final_eval_shapes)

    _refuse_unported(args)
    cfg = ucf_final_eval_shapes(_apply_common(preset(args.preset), args))
    d = cfg.data
    if d.ten_crop or d.pack_path:
        raise SystemExit("tenCrop stores and .lstcpack stores are not ported "
                         "yet (ROADMAP A14, A6)")
    if args.dump_scores and args.per_class:
        raise SystemExit("--dump-scores exports per-video eval scores; it "
                         "cannot be combined with --per-class")
    if args.bootstrap is not None:
        if args.bootstrap < 1:
            raise SystemExit(f"--bootstrap needs N >= 1, got {args.bootstrap}")
        if args.per_class:
            raise SystemExit("--bootstrap applies to the per-video eval; it "
                             "cannot be combined with --per-class")
    ucf_ltn = d.dataset == "UCF" and not cfg.model.startswith("stn")
    if args.per_class and not ucf_ltn:
        raise SystemExit("--per-class is the UCF per-anomaly-class "
                         "breakdown (LTN presets)")
    from .evaluation.drivers import (evaluate_ltn, evaluate_stn,
                                     evaluate_ucf_ltn, evaluate_ucf_per_class,
                                     evaluate_ucf_stn)

    trainer = _eval_trainer(cfg, args, "evaluate")
    try:
        if d.dataset == "UCF":
            items = [((lambda v=v: v.feat), v.anno,
                      v.n_frames // d.segment_len)
                     for v in trainer.test_videos]
        else:
            items = trainer._test_items()
        if ucf_ltn:
            scorer = ucf_final_eval_scorer(cfg, trainer.state.encoder,
                                           trainer.state.head)
        else:
            scorer = trainer.scorer
        if args.per_class:
            from .data.annotations import parse_ucf_test

            classes = [r.class_name for r in parse_ucf_test(d.test_txt)]
            far, mean_ap = evaluate_ucf_per_class(
                scorer, items, classes, d.segment_len,
                n_anomaly_classes=args.n_anomaly_classes)
            print(f"Normal FAR {far:.4f}, mean PR-AUC {mean_ap:.4f}")
            trainer._emit_metrics({"kind": "per_class_eval",
                                   "far": float(far),
                                   "mean_pr_auc": float(mean_ap),
                                   "dataset": d.dataset})
            return 0
        want = dict(return_scores=bool(args.dump_scores),
                    return_labels=bool(args.bootstrap))
        if d.dataset == "UCF":
            fn = evaluate_ucf_ltn if ucf_ltn else evaluate_ucf_stn
        else:
            fn = evaluate_stn if cfg.model.startswith("stn") else evaluate_ltn
        result = fn(scorer, items, d.segment_len, **want)
    finally:
        trainer.store.close()
    per_video = per_labels = None
    if args.bootstrap:
        auc, per_video, per_labels = result
    elif args.dump_scores:
        auc, per_video = result
    else:
        auc = result
    if args.dump_scores:
        import numpy as np

        np.savez(args.dump_scores,
                 **{v.key: s for v, s in zip(trainer.test_videos, per_video)})
        print(f"frame scores -> {args.dump_scores}")
    print(f"auc = {auc}")
    record = {"kind": "final_eval", "auc": float(auc), "dataset": d.dataset,
              "model": cfg.model}
    if args.bootstrap:
        from .evaluation.metrics import bootstrap_auc_ci

        lo, hi = bootstrap_auc_ci(per_video, per_labels,
                                  n_boot=args.bootstrap)
        print(f"95% CI [{lo:.4f}, {hi:.4f}] "
              f"({args.bootstrap} video-level bootstrap resamples)")
        record |= {"auc_ci_lo": lo, "auc_ci_hi": hi,
                   "n_bootstrap": args.bootstrap}
    trainer._emit_metrics(record)
    return 0


def cmd_gen_pseudo(args):
    _refuse_unported(args)
    cfg = _apply_common(preset(args.preset), args)
    d = cfg.data
    if args.threshold is None:
        args.threshold = 0.9 if args.kind == "stn" else 0.65
    if (args.kind == "stn") != cfg.model.startswith("stn"):
        raise SystemExit(
            f"--kind {args.kind} does not match the preset's model "
            f"{cfg.model!r} — pseudo labels are generated with the preset's "
            "encoder/head (pick the matching preset)")
    if not d.train_txt:
        raise SystemExit("gen-pseudo scores the train split: pass "
                         "--train-txt")
    from .pseudo import (generate_ltn_pseudo_labels,
                         generate_stn_pseudo_labels, pseudo_scorer,
                         save_pseudo_labels)

    trainer = _eval_trainer(cfg, args, "gen-pseudo")
    scorer = pseudo_scorer(cfg, trainer.state.encoder, trainer.state.head)
    try:
        if args.kind == "stn":
            pseudo = generate_stn_pseudo_labels(scorer, trainer.store,
                                                trainer.train_records,
                                                args.threshold)
        else:
            pseudo = generate_ltn_pseudo_labels(
                scorer, trainer.store, trainer.train_records, args.threshold,
                dataset=d.dataset, segment_len=d.segment_len)
    finally:
        trainer.store.close()
    save_pseudo_labels(args.out, pseudo)
    print(f"pseudo labels ({args.kind}, threshold {args.threshold}) "
          f"-> {args.out}")
    return 0


def _logger():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    return logging.getLogger("lstc_vad_tpu_torch")


def cmd_train(args):
    from .ckpt import save_checkpoint
    from .train.driver import Trainer

    _refuse_unported(args)
    cfg = _apply_common(preset(args.preset), args)
    logger = _logger()
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


def cmd_coteach(args):
    from .pseudo import CoTeachingDriver

    _refuse_unported(args)
    stn_cfg = _apply_common(preset(args.stn_preset), args)
    ltn_cfg = _apply_common(preset(args.ltn_preset), args)
    driver = CoTeachingDriver(stn_cfg, ltn_cfg, args.workdir,
                              stn_threshold=args.stn_threshold,
                              ltn_threshold=args.ltn_threshold,
                              logger=_logger(), device=args.device)
    driver.run(args.rounds, args.stn_epochs, args.ltn_epochs)
    return 0


def _add_data(p):
    p.add_argument("--h5")
    p.add_argument("--train-txt", dest="train_txt")
    p.add_argument("--test-txt", dest="test_txt")
    p.add_argument("--mask-dir", dest="mask_dir")
    p.add_argument("--mask-h5", dest="mask_h5",
                   help="UCF ground-truth frame labels (h5)")
    p.add_argument("--batch-size", dest="batch_size", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--set", action="append", metavar="PATH=VALUE",
                   help="override any config field, e.g. "
                        "optim.lr_encoder=3e-4")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a card) or 'cpu'")
    p.add_argument("--mesh", help="not ported yet (ROADMAP A18)")


def _add_common(p):
    p.add_argument("--preset", required=True, choices=sorted(PRESETS))
    _add_data(p)
    p.add_argument("--pseudo-labels", dest="pseudo_labels")
    p.add_argument("--epochs", type=int)
    p.add_argument("--save-dir", dest="save_dir")
    p.add_argument("--metrics-jsonl", dest="metrics_jsonl",
                   help="append structured per-epoch/eval metrics (one JSON "
                        "line each) to this file")


def _add_ckpt(p):
    p.add_argument("--ckpt", help="a checkpoint file of this package "
                                  "(train --save-best or --save-state)")
    p.add_argument("--torch-ckpt", dest="torch_ckpt", action="store_true",
                   help="--encoder-ckpt/--head-ckpt are the reference's "
                        "state_dicts")
    p.add_argument("--encoder-ckpt", dest="encoder_ckpt")
    p.add_argument("--head-ckpt", dest="head_ckpt")
    p.add_argument("--artifact", help="not ported yet (ROADMAP A17)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="lstc_vad_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train STN or LTN (preset decides)")
    _add_common(t)
    t.add_argument("--multihost", help="not ported yet (ROADMAP A18)")
    t.add_argument("--resume", help="restore the full train state from this "
                                    "checkpoint file")
    t.add_argument("--save-state", dest="save_state",
                   help="save the full train state after fitting")
    t.add_argument("--save-best", dest="save_best",
                   help="save the best-AUC epoch's params, like the "
                        "reference's AUC-gated checkpoints")
    t.set_defaults(fn=cmd_train)

    g = sub.add_parser("gen-pseudo", help="generate pseudo labels")
    _add_common(g)
    _add_ckpt(g)
    g.add_argument("--kind", choices=("stn", "ltn"), required=True)
    g.add_argument("--threshold", type=float, default=None,
                   help="default: 0.9 for stn, 0.65 for ltn (README.md:27,35)")
    g.add_argument("--out", required=True)
    g.set_defaults(fn=cmd_gen_pseudo)

    e = sub.add_parser("evaluate", help="frame-AUC evaluation")
    _add_common(e)
    _add_ckpt(e)
    e.add_argument("--dump-scores", dest="dump_scores",
                   help="write per-video frame scores to this .npz")
    e.add_argument("--per-class", dest="per_class", action="store_true",
                   help="UCF: per-anomaly-class AUC/PR-AUC/FAR table")
    e.add_argument("--n-anomaly-classes", dest="n_anomaly_classes", type=int,
                   default=13, help="anomaly class count for the mean PR-AUC "
                                    "(UCF-Crime: 13)")
    e.add_argument("--bootstrap", type=int, metavar="N",
                   help="report a 95%% CI from N video-level bootstrap "
                        "resamples alongside the point AUC")
    e.add_argument("--eval-crop", dest="eval_crop",
                   help="not ported yet (tenCrop, ROADMAP A14)")
    e.set_defaults(fn=cmd_evaluate)

    c = sub.add_parser("coteach", help="alternating co-teaching rounds")
    c.add_argument("--stn-preset", required=True, choices=sorted(PRESETS))
    c.add_argument("--ltn-preset", required=True, choices=sorted(PRESETS))
    c.add_argument("--workdir", required=True)
    c.add_argument("--rounds", type=int, default=4)
    c.add_argument("--stn-epochs", type=int, default=100)
    c.add_argument("--ltn-epochs", type=int, default=100)
    c.add_argument("--stn-threshold", type=float, default=0.9)
    c.add_argument("--ltn-threshold", type=float, default=0.65)
    _add_data(c)
    c.add_argument("--multihost", help="not ported yet (ROADMAP A18)")
    c.set_defaults(fn=cmd_coteach)

    args = p.parse_args(argv)
    return args.fn(args)
