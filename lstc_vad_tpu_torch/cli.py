"""CLI of the PyTorch package — the subcommands of
lstc_vad_tpu/cli/main.py:359-1302 (SHT, UBnormal and UCF;
STN and LTN; tenCrop stores; features from an HDF5 file or, with
``--set data.pack_path=feats.lstcpack``, from a pack):

    python -m lstc_vad_tpu_torch train --preset sht_ltn --h5 feats.h5 \\
        --train-txt SH_Train_new.txt --test-txt SH_Test_NEW.txt \\
        --mask-dir masks/ [--epochs N] [--metrics-jsonl m.jsonl] \\
        [--resume state.pt] [--save-state state.pt] [--save-best best.pt] \\
        [--set optim.lr_encoder=3e-4 ...] [--device cuda|cpu]

    python -m lstc_vad_tpu_torch gen-pseudo --preset sht_stn --kind stn \\
        --h5 feats.h5 --train-txt SH_Train_new.txt --ckpt best.pt \\
        --out stn_pseudo.npy [--threshold 0.9] [--artifact DIR]

    python -m lstc_vad_tpu_torch evaluate --preset ucf_ltn \\
        --h5 ucf.h5 --test-txt Test_Annotation.txt --mask-h5 gt.h5 \\
        [--ckpt best.pt | --torch-ckpt --encoder-ckpt e --head-ckpt h \\
         | --artifact DIR] [--per-class] [--dump-scores s.npz] \\
        [--bootstrap N] [--eval-crop 0-9|mean]

    python -m lstc_vad_tpu_torch coteach --stn-preset sht_stn \\
        --ltn-preset sht_ltn --workdir work/ --h5 feats.h5 \\
        --train-txt ... --test-txt ... --mask-dir masks/ [--rounds 4]

    python -m lstc_vad_tpu_torch export-aot --preset sht_ltn --ckpt best.pt \\
        --out artifact/ [--tails] [--l2] [--train-shapes]

    python -m lstc_vad_tpu_torch serve --preset sht_ltn \\
        [--ckpt best.pt | --artifact DIR | --backend SOCKET] \\
        [--max-streams 64] [--flush-every K] < requests.jsonl

    python -m lstc_vad_tpu_torch serve-backend --preset sht_ltn \\
        --socket /tmp/b.sock [--ckpt best.pt | --artifact DIR] \\
        [--max-batch 128] [--window-ms 2]

    python -m lstc_vad_tpu_torch pack --h5 feats.h5 --out feats.lstcpack
    python -m lstc_vad_tpu_torch validate-data --preset sht_ltn \\
        --set data.pack_path=feats.lstcpack --train-txt ... --test-txt ...
    python -m lstc_vad_tpu_torch export-torch --preset sht_ltn \\
        --ckpt best.pt --encoder-out enc.ckpt --head-out head.ckpt
    python -m lstc_vad_tpu_torch info
    python -m lstc_vad_tpu_torch profile --preset sht_ltn --mode eval \\
        --steps 5 --out prof/
    python -m lstc_vad_tpu_torch sweep --preset sht_ltn \\
        --grid optim.lr_encoder=1e-4,5e-5 --out sweep.jsonl [--rank-by test]
    python -m lstc_vad_tpu_torch benchmark

The flags are the JAX CLI's; every subcommand with the common flags takes
``--log-dir`` (train writes every config field there; evaluate and
gen-pseudo log there when given it).  ``pack`` needs h5py, so it runs on a
machine that has it; every other subcommand reads a pack without h5py.
``export-aot --platforms`` is refused, since this package's artifact is
device-portable.  Everything runs on the card unless ``--device cpu`` is
given; a ``serve --backend`` worker takes no ``--device``: it never touches
a device, nor imports torch; ``benchmark`` takes no option, as the JAX
one takes none, and measures the card (benchmark.py: one JSON line, exit 1
under an outage of the card).

Multi-device runs, one process per device: ``--mesh auto|DPxTP`` (train,
evaluate, gen-pseudo, coteach, sweep) lays the run out on a data x model
mesh over the processes torchrun launched (``auto`` factors their number;
one process on its own runs a 1x1 mesh); ``--multihost COORD:PORT
--num-processes N --process-id I`` (train, coteach) joins N processes
started by hand, or ``--multihost auto`` those of torchrun, and builds the
global mesh itself.  The card's processes join over NCCL, the CPU's over
gloo; each takes ``cuda:LOCAL_RANK``; rank 0 writes the files:

    torchrun --nproc-per-node 4 -m lstc_vad_tpu_torch train --mesh 2x2 ...
``--ckpt`` reads a ``ckpt/io.py`` file, the parameters alone
(``train --save-best``) or a full state (``--save-state``); without a
checkpoint, evaluate, gen-pseudo and serve score random-init weights and say
so.  Config fields are overridden with --set path=value, typed by the
dataclass field.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import typing

from .config import PRESETS, TrainConfig, preset, replace
from .utils.logging import get_logger, log_config


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


def _mesh_shape(spec: str, n_head: int, world: int):
    """--mesh 'auto' (the world's processes factored into data x model) or
    'DPxTP'; the mesh must cover the launched processes."""
    import re

    from .parallel.mesh import factor_devices

    if spec == "auto":
        return factor_devices(world, n_head)
    m = re.fullmatch(r"(\d+)x(\d+)", spec)
    if not m:
        raise SystemExit(
            f"--mesh must be 'auto' or 'DPxTP' (e.g. 2x4), got {spec!r}")
    dp, tp = int(m.group(1)), int(m.group(2))
    if tp > 1 and n_head % tp:
        raise SystemExit(f"--mesh model axis {tp} must divide the head "
                         f"count {n_head}")
    if dp * tp != world:
        raise SystemExit(
            f"--mesh {dp}x{tp} needs {dp * tp} processes, one per device; "
            f"this run has {world}: launch them with torchrun "
            f"(torchrun --nproc-per-node {dp * tp} -m lstc_vad_tpu_torch "
            "...) or join them with --multihost")
    return dp, tp


def _mesh_from_args(args, n_head: int, logger=None):
    """--mesh / --multihost: join the process group, move ``args.device``
    to this process's device (cuda:LOCAL_RANK), build the (data, model)
    mesh.  None when neither flag is given."""
    multihost = getattr(args, "multihost", None)
    spec = getattr(args, "mesh", None)
    if not multihost and not spec:
        return None
    import torch

    from .device import resolve_device
    from .parallel import distributed
    from .parallel.mesh import make_mesh

    device_type = resolve_device(args.device).type
    if multihost:
        if spec:
            raise SystemExit("--multihost builds the global mesh itself "
                             "(model axis auto-factored per host); drop "
                             "--mesh")
        if multihost == "auto":
            distributed.initialize_multihost(device=args.device)
        else:
            if args.num_processes is None or args.process_id is None:
                raise SystemExit("--multihost COORD:PORT needs "
                                 "--num-processes and --process-id")
            distributed.initialize_multihost(
                multihost, args.num_processes, args.process_id,
                device=args.device)
        args.device = str(distributed.local_device(args.device))
        mesh = distributed.make_global_mesh(n_head, device_type=device_type)
        if logger is not None:
            logger.info("multihost: process %d/%d, global mesh data=%d "
                        "model=%d", torch.distributed.get_rank(),
                        torch.distributed.get_world_size(), mesh.size(0),
                        mesh.size(1))
        return mesh
    dp, tp = _mesh_shape(spec, n_head, distributed.world_size())
    distributed.initialize_multihost(device=args.device, alone=True)
    args.device = str(distributed.local_device(args.device))
    mesh = make_mesh(dp, tp, device_type)
    if logger is not None:
        logger.info("mesh: data=%d model=%d", dp, tp)
    return mesh


def _refuse_mesh_with_artifact(args):
    if getattr(args, "mesh", None) and args.artifact:
        raise SystemExit("--mesh shards the live scorer; an AOT artifact is "
                         "a program of one device — drop one")


def _eval_knobs(cfg: TrainConfig) -> TrainConfig:
    """Evaluation is f32 whatever the training knobs say, as in the JAX
    package's Trainer._make_eval_encoder: the reference eval is plain f32."""
    from .models.encoder import eval_config

    return dataclasses.replace(cfg, encoder=eval_config(cfg.encoder))


def _check_ckpt_flags(args):
    if args.torch_ckpt and not (args.encoder_ckpt and args.head_ckpt):
        raise SystemExit("--torch-ckpt needs both --encoder-ckpt and "
                         "--head-ckpt (the reference saves two files)")
    if not args.torch_ckpt and (args.encoder_ckpt or args.head_ckpt):
        raise SystemExit("--encoder-ckpt/--head-ckpt are torch state_dicts "
                         "(add --torch-ckpt); a --ckpt file holds both "
                         "modules")
    if args.torch_ckpt and args.ckpt:
        raise SystemExit("pass --ckpt or --torch-ckpt, not both")


def _load_weights(state, args, cmd: str):
    """Load the weights the checkpoint flags name into ``state``: --ckpt (a
    ckpt/io.py file, loaded strictly), or --torch-ckpt with the reference's
    --encoder-ckpt/--head-ckpt state_dicts (keys that match nothing and
    weights left fresh are reported, as the JAX CLI reports them), or keep
    the fresh random-init weights, said loudly."""
    _check_ckpt_flags(args)
    if args.ckpt:
        from .ckpt import load_checkpoint

        load_checkpoint(args.ckpt, state)
    elif args.torch_ckpt:
        from .ckpt.interop import load_reference_checkpoint

        enc_sd, head_sd = load_reference_checkpoint(args.encoder_ckpt,
                                                    args.head_ckpt)
        if state.mesh is not None:
            from .parallel.mesh import local_state_dict

            enc_sd = local_state_dict(enc_sd, state.mesh)
            head_sd = local_state_dict(head_sd, state.mesh)
        for name, module, sd in (("encoder", state.encoder, enc_sd),
                                 ("head", state.head, head_sd)):
            res = module.load_state_dict(sd, strict=False)
            if res.missing_keys or res.unexpected_keys:
                print(f"[ckpt] {name}: kept fresh {res.missing_keys}, "
                      f"skipped {res.unexpected_keys}", file=sys.stderr)
    else:
        print(f"[{cmd}] no --ckpt/--torch-ckpt/--artifact: scoring with "
              "fresh RANDOM-INIT weights (smoke-test mode)", file=sys.stderr)


def _reject_ckpt_flags_with_artifact(args):
    if args.torch_ckpt or args.ckpt or args.encoder_ckpt or args.head_ckpt:
        raise SystemExit("--artifact already contains the params — drop "
                         "--ckpt/--torch-ckpt/--encoder-ckpt/--head-ckpt")


def _eval_trainer(cfg: TrainConfig, args, cmd: str, weights: bool = True):
    """An eval-only Trainer on ``--device`` (on ``--mesh``'s mesh when
    given) holding the weights the checkpoint flags name (``weights``; off
    when an artifact scores), with a log file in ``--log-dir`` when given
    one."""
    from .train.driver import Trainer

    _check_ckpt_flags(args)
    logger = get_logger(cmd, log_dir=args.log_dir) if args.log_dir else None
    mesh = _mesh_from_args(args, cfg.encoder.n_head, logger)
    trainer = Trainer(_eval_knobs(cfg), eval_only=True, device=args.device,
                      logger=logger, mesh=mesh)
    if weights:
        _load_weights(trainer.state, args, cmd)
    return trainer


def _eval_token_len(cfg) -> int:
    """Sequence length of one eval part: a single clip's patches for STN,
    part_len clips for LTN."""
    return (cfg.data.n_patch if cfg.model.startswith("stn")
            else cfg.data.part_len * cfg.data.n_patch)


def _load_eval_artifact(path: str, cfg, device):
    """Load an AOT scorer artifact and fail fast on head-kind / d_model /
    token-length mismatches, before any data is read."""
    from .export import load_scorer

    loaded = load_scorer(path, device=device)
    need_len = _eval_token_len(cfg)
    if loaded.meta["kind"] != cfg.head.kind:
        raise SystemExit(f"artifact head kind {loaded.meta['kind']!r} does "
                         f"not match the preset's {cfg.head.kind!r}")
    if loaded.meta["d_model"] != cfg.encoder.d_model:
        raise SystemExit(f"artifact d_model {loaded.meta['d_model']} != "
                         f"preset encoder.d_model {cfg.encoder.d_model}")
    if need_len not in loaded.token_lens:
        raise SystemExit(
            f"artifact has no program for {need_len}-token parts "
            f"(token_lens={loaded.token_lens}); re-export with the matching "
            "preset/--set shapes")
    return loaded


def _check_artifact_tails(loaded, cfg, cmd: str):
    """No-rewindow LTN paths score tails at their TRUE length: the artifact
    needs a program per possible tail length (export-aot --tails), checked
    before any store walk."""
    d = cfg.data
    if d.dataset == "UCF":
        # fixed max_clips bins: the one possible tail length is known
        tails = {(cfg.max_clips % d.part_len) * d.n_patch} - {0}
    else:
        tails = set(range(d.n_patch, _eval_token_len(cfg), d.n_patch))
    missing = sorted(tails - set(loaded.token_lens))
    if missing:
        msg = (f"artifact lacks programs for tail parts of {missing} tokens; "
               "re-export with --tails")
        if d.dataset == "UCF":
            # max_clips % part_len != 0: a tail part ALWAYS occurs
            raise SystemExit(msg)
        print(f"[{cmd}] warning: {msg} — videos whose clip count is not a "
              "part_len multiple will fail", file=sys.stderr)


def _wrap_artifact(scorer, loaded, expect_l2: bool):
    """Slot the artifact's programs into a scorer's inner VideoScorer
    (evaluation/scoring.py::ArtifactVideoScorer)."""
    if loaded.meta.get("l2_normalize", False) != expect_l2:
        raise SystemExit(
            f"this path needs l2_normalize={expect_l2} baked into the "
            "artifact (export-aot --l2 for the UCF final eval, without it "
            "otherwise)")
    from .evaluation.scoring import ArtifactVideoScorer

    scorer.scorer = ArtifactVideoScorer(loaded)
    return scorer


def _parse_eval_crop(cfg, raw):
    if not raw or raw == "mean":
        return cfg
    try:
        crop = int(raw)
    except ValueError:
        raise SystemExit(f"--eval-crop must be 0-9 or 'mean', got "
                         f"{raw!r}") from None
    if not 0 <= crop <= 9:
        raise SystemExit(f"--eval-crop index out of range 0-9: {crop}")
    return replace(cfg, **{"data.eval_crop": crop})


def cmd_evaluate(args):
    from .evaluation.scoring import (ucf_final_eval_scorer,
                                     ucf_final_eval_shapes)

    _refuse_mesh_with_artifact(args)
    cfg = ucf_final_eval_shapes(_apply_common(preset(args.preset), args))
    cfg = _parse_eval_crop(cfg, args.eval_crop)
    d = cfg.data
    stn = cfg.model.startswith("stn")
    if args.dump_scores and args.per_class:
        raise SystemExit("--dump-scores exports per-video eval scores; it "
                         "cannot be combined with --per-class")
    if args.bootstrap is not None:
        if args.bootstrap < 1:
            raise SystemExit(f"--bootstrap needs N >= 1, got {args.bootstrap}")
        if args.per_class:
            raise SystemExit("--bootstrap applies to the per-video eval; it "
                             "cannot be combined with --per-class")
    ucf_ltn = d.dataset == "UCF" and not stn
    if args.per_class and not ucf_ltn:
        raise SystemExit("--per-class is the UCF per-anomaly-class "
                         "breakdown (LTN presets)")
    if args.eval_crop == "mean":
        if not d.ten_crop:
            raise SystemExit("--eval-crop mean needs a tenCrop store "
                             "(--set data.ten_crop=true)")
        if d.dataset == "UCF":
            raise SystemExit(
                "tenCrop eval semantics exist for SHT/UBnormal only "
                "(utils/load_dataset.py:338-362,731-755; the reference's "
                "UCF_test_tenCrop at :494-509 is an identical copy of "
                "UCF_test with no crop axis)")
    loaded = None
    if args.artifact:
        _reject_ckpt_flags_with_artifact(args)
        loaded = _load_eval_artifact(args.artifact, cfg, args.device)
    from .evaluation.drivers import (evaluate_ltn, evaluate_multicrop_mean,
                                     evaluate_stn, evaluate_ucf_ltn,
                                     evaluate_ucf_per_class,
                                     evaluate_ucf_stn)
    from .parallel.multihost import is_writer

    trainer = _eval_trainer(cfg, args, "evaluate", weights=loaded is None)
    try:
        if ucf_ltn:
            # the UCF LTN final eval scores through its own scorer (L2 baked
            # in); every other path through the Trainer's (no L2)
            scorer = ucf_final_eval_scorer(cfg, trainer.state.encoder,
                                           trainer.state.head)
            if loaded is not None:
                _wrap_artifact(scorer, loaded, expect_l2=True)
        else:
            scorer = trainer.scorer
            if loaded is not None:
                if not stn and not cfg.eval_tail_rewindow:
                    _check_artifact_tails(loaded, cfg, "evaluate")
                _wrap_artifact(scorer, loaded, expect_l2=False)
        if d.dataset == "UCF":
            items = [(trainer._lazy_feat(v), v.anno,
                      v.n_frames // d.segment_len)
                     for v in trainer.test_videos]
        else:
            items = trainer._test_items()
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
        extra_record = {}
        if d.dataset == "UCF":
            fn = evaluate_ucf_ltn if ucf_ltn else evaluate_ucf_stn
        else:
            fn = evaluate_stn if stn else evaluate_ltn
        if args.eval_crop == "mean":
            # crop-major passes with per-crop lazy reads: each pass reads one
            # video at a time and keeps only its crop, so peak RSS stays near
            # one video (x10 reads) instead of every video's 10-crop array

            def items_for_crop(c):
                return [((lambda v=v, c=c: v.feat[:, c]), v.anno)
                        for v in trainer.test_videos]

            result = evaluate_multicrop_mean(fn, scorer, items_for_crop,
                                             d.segment_len, **want)
            extra_record = {"eval_crop": "mean"}
        else:
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
    if args.dump_scores and is_writer(trainer.mesh):
        import numpy as np

        np.savez(args.dump_scores,
                 **{v.key: s for v, s in zip(trainer.test_videos, per_video)})
        print(f"frame scores -> {args.dump_scores}")
    print(f"auc = {auc}")
    record = {"kind": "final_eval", "auc": float(auc), "dataset": d.dataset,
              "model": cfg.model, **extra_record}
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
    _refuse_mesh_with_artifact(args)
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
    if d.ten_crop and d.eval_crop is None:
        raise SystemExit("tenCrop pseudo generation needs "
                         "--set data.eval_crop=<0-9>")
    loaded = None
    if args.artifact:
        _reject_ckpt_flags_with_artifact(args)
        loaded = _load_eval_artifact(args.artifact, cfg, args.device)
    from .data.feature_store import CropView
    from .parallel.multihost import is_writer
    from .pseudo import (generate_ltn_pseudo_labels,
                         generate_stn_pseudo_labels, pseudo_scorer,
                         save_pseudo_labels)

    trainer = _eval_trainer(cfg, args, "gen-pseudo", weights=loaded is None)
    scorer = pseudo_scorer(cfg, trainer.state.encoder, trainer.state.head)
    if loaded is not None:
        if args.kind == "ltn":
            _check_artifact_tails(loaded, cfg, "gen-pseudo")
        _wrap_artifact(scorer, loaded, expect_l2=False)
    store = trainer.store
    if d.ten_crop:
        store = CropView(store, d.eval_crop)
    try:
        if args.kind == "stn":
            pseudo = generate_stn_pseudo_labels(scorer, store,
                                                trainer.train_records,
                                                args.threshold)
        else:
            pseudo = generate_ltn_pseudo_labels(
                scorer, store, trainer.train_records, args.threshold,
                dataset=d.dataset, segment_len=d.segment_len)
    finally:
        trainer.store.close()
    if is_writer(trainer.mesh):
        save_pseudo_labels(args.out, pseudo)
    print(f"pseudo labels ({args.kind}, threshold {args.threshold}) "
          f"-> {args.out}")
    return 0


def cmd_train(args):
    from .ckpt import save_checkpoint
    from .train.driver import Trainer

    cfg = _apply_common(preset(args.preset), args)
    logger = get_logger("train", log_dir=args.log_dir)
    log_config(logger, cfg)
    mesh = _mesh_from_args(args, cfg.encoder.n_head, logger)
    trainer = Trainer(cfg, logger=logger, device=args.device, mesh=mesh)
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
        save_checkpoint(args.save_best, best, mesh=mesh)
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

    stn_cfg = _apply_common(preset(args.stn_preset), args)
    ltn_cfg = _apply_common(preset(args.ltn_preset), args)
    logger = get_logger("coteach")
    mesh = _mesh_from_args(args, stn_cfg.encoder.n_head, logger)
    driver = CoTeachingDriver(stn_cfg, ltn_cfg, args.workdir,
                              stn_threshold=args.stn_threshold,
                              ltn_threshold=args.ltn_threshold,
                              logger=logger, device=args.device, mesh=mesh)
    driver.run(args.rounds, args.stn_epochs, args.ltn_epochs)
    return 0


def cmd_export_aot(args):
    """Export the eval scorer (torch.export programs + the weights once)
    into a self-contained deployment artifact (export.py)."""
    if args.platforms is not None:
        raise SystemExit(
            "--platforms lists the JAX artifact's lowering targets; this "
            "package's artifact is device-portable: it runs on the CPU or "
            "the card, whichever device exported it (load_scorer(device=))")
    from .ckpt import load_checkpoint
    from .evaluation.scoring import ucf_final_eval_shapes
    from .export import save_scorer_artifact
    from .train.state import create_train_state

    cfg = _apply_common(preset(args.preset), args)
    if not args.train_shapes:
        cfg = ucf_final_eval_shapes(cfg)
    # exported artifacts are EVAL programs: f32 compute, remat off
    cfg = _eval_knobs(cfg)
    stn = cfg.model.startswith("stn")
    token_len = _eval_token_len(cfg)
    tails = ()
    if args.tails:
        if stn:
            raise SystemExit("--tails is for LTN presets (STN scores single "
                             "clips — there are no shorter tail parts)")
        # the no-re-window eval paths score tail parts at their true length
        # (distinct programs: the relative-PE slices by sequence length)
        tails = tuple(range(cfg.data.n_patch, token_len, cfg.data.n_patch))
    state = create_train_state(cfg, device=args.device)
    load_checkpoint(args.ckpt, state)
    save_scorer_artifact(args.out, state.encoder, state.head, cfg.head.kind,
                         token_len, cfg.encoder.d_model, l2_normalize=args.l2,
                         extra_token_lens=tails,
                         extra_meta={"n_patch": cfg.data.n_patch,
                                     "part_len": (1 if stn
                                                  else cfg.data.part_len)})
    print(f"wrote AOT scorer artifact to {args.out}")
    return 0


def _live_serving_modules(args, cfg, tag: str):
    """(encoder, head) on ``--device`` in eval mode, holding the weights the
    checkpoint flags name — the f32 eval twin of the preset, as every other
    eval path builds it."""
    from .train.state import create_train_state

    state = create_train_state(_eval_knobs(cfg), device=args.device)
    _load_weights(state, args, tag)
    return state.encoder.eval(), state.head.eval()


def _baked_part_len(path: str):
    """The artifact's own part_len from meta.json (None when missing): the
    baked windowing wins over the preset's, which would recompute n_patch
    and truncate every pushed clip."""
    import json
    import os

    try:
        with open(os.path.join(path, "meta.json")) as f:
            return json.load(f).get("part_len")
    except (OSError, ValueError):
        return None  # missing/corrupt meta: the loader raises the real error


def cmd_serve(args):
    """Online scoring server over stdin/stdout: JSONL requests in, JSONL
    scores out (serving.serve_jsonl documents the protocol), backed by live
    weights, an AOT artifact, or — as a torch-free worker — a serve-backend
    process."""
    from .serving import StreamingScorer, serve_jsonl

    cfg = _apply_common(preset(args.preset), args)
    if args.max_streams < 1:
        raise SystemExit(f"--max-streams must be >= 1, got {args.max_streams}")
    # STN presets score single clips (part_len=1 + regressor); LTN scores
    # part_len-clip parts with the classifier's abnormal-class probability
    part_len = 1 if cfg.model.startswith("stn") else cfg.data.part_len
    if args.backend:
        # torch-FREE worker: protocol + stream buffers here, device calls
        # proxied to the serve-backend process (serving_mp.py)
        if args.artifact or args.torch_ckpt or args.ckpt \
                or args.encoder_ckpt or args.head_ckpt:
            raise SystemExit("--backend workers hold no params — they live "
                             "in the serve-backend process; drop "
                             "--ckpt/--torch-ckpt/--encoder-ckpt/"
                             "--head-ckpt/--artifact")
        if args.device is not None:
            raise SystemExit("--backend workers hold no device — the "
                             "serve-backend process owns it; drop --device")
        from .serving_mp import make_worker_scorer

        scorer = make_worker_scorer(args.backend, part_len, cfg.data.n_patch,
                                    cfg.encoder.d_model,
                                    max_streams=args.max_streams)
        n_push, n_scores = serve_jsonl(scorer, sys.stdin, sys.stdout,
                                       flush_every=args.flush_every)
        print(f"[serve] {n_push} clips in, {n_scores} scores out "
              f"(worker -> {args.backend})", file=sys.stderr)
        return 0
    args.device = args.device or "cuda"
    if args.artifact:
        _reject_ckpt_flags_with_artifact(args)
        baked = _baked_part_len(args.artifact)
        scorer = StreamingScorer.from_artifact(
            args.artifact, max_streams=args.max_streams,
            part_len=part_len if baked is None else None, device=args.device)
    else:
        encoder, head = _live_serving_modules(args, cfg, "serve")
        scorer = StreamingScorer(
            encoder, head, part_len, cfg.data.n_patch, cfg.encoder.d_model,
            max_streams=args.max_streams, head_kind=cfg.head.kind,
            transfer_dtype=cfg.data.eval_transfer_dtype)
    n_push, n_scores = serve_jsonl(scorer, sys.stdin, sys.stdout,
                                   flush_every=args.flush_every)
    print(f"[serve] {n_push} clips in, {n_scores} scores out",
          file=sys.stderr)
    return 0


def cmd_serve_backend(args):
    """Device-owner half of multi-process serving (serving_mp.py): ONE
    process on the card that coalesces token rows from N torch-free
    ``serve --backend`` workers into device calls.  Params flags mirror
    ``serve``.  Prints one JSON ready line to stdout once listening (a
    supervisor can block on it), serves until SIGINT/SIGTERM, then prints
    one JSON line with its device calls, rows, seconds inside the apply and
    kernel launches."""
    import json

    import numpy as np

    from .ops import cuda_attention
    from .serving import _fetch
    from .serving_mp import BatchingBackend

    cfg = _apply_common(preset(args.preset), args)
    if args.max_batch < 1:
        raise SystemExit(f"--max-batch must be >= 1, got {args.max_batch}")
    part_len = 1 if cfg.model.startswith("stn") else cfg.data.part_len
    if args.artifact:
        _reject_ckpt_flags_with_artifact(args)
        from .export import load_scorer

        loaded = load_scorer(args.artifact, device=args.device)
        if loaded.meta.get("l2_normalize", False):
            raise SystemExit(
                "artifact was exported with --l2 (UCF final-eval feature "
                "normalize); serving uses the plain part semantics — "
                "export without --l2")
        baked = loaded.meta.get("part_len")
        if baked is not None:
            part_len = int(baked)
        d_model = loaded.meta["d_model"]
        token_len = loaded.meta["token_len"]
        if token_len % part_len:
            raise SystemExit(f"artifact token_len {token_len} is not "
                             f"divisible by part_len {part_len}")
        n_patch = token_len // part_len
        apply_fn = loaded.score
    else:
        from .evaluation.scoring import VideoScorer

        encoder, head = _live_serving_modules(args, cfg, "serve-backend")
        apply_fn = VideoScorer(encoder, head,
                               cfg.head.kind).score_tokens_async
        d_model, n_patch = cfg.encoder.d_model, cfg.data.n_patch
    backend = BatchingBackend(apply_fn, d_model, max_batch=args.max_batch,
                              window_ms=args.window_ms)
    # one full-size call before listening: the kernel's library loads and
    # the first worker flush pays no set-up
    _fetch(apply_fn(np.zeros((args.max_batch, part_len * n_patch, d_model),
                             np.float32)))
    cuda_attention.reset_launches()

    def ready():
        print(json.dumps({"listening": args.socket, "d_model": d_model,
                          "max_batch": args.max_batch, "part_len": part_len,
                          "n_patch": n_patch}), flush=True)

    backend.serve_forever(args.socket, ready_fn=ready)
    print(json.dumps({"device_calls": backend.n_calls,
                      "rows": backend.n_rows,
                      "apply_s": backend.apply_seconds,
                      "kernel_launches": cuda_attention.launches}),
          flush=True)
    print(f"[serve-backend] {backend.n_calls} device calls, "
          f"{backend.n_rows} rows", file=sys.stderr)
    return 0


def cmd_pack(args):
    """Convert a reference h5 feature file into a ``.lstcpack`` (needs
    h5py: run it where the h5 lives; the card reads the pack without
    it)."""
    from .data.packed import pack_h5

    pack_h5(args.h5, args.out)
    print(f"packed {args.h5} -> {args.out}")
    return 0


def cmd_validate_data(args):
    """Walk every data artifact the config points at and report every
    inconsistency (data/validate.py); exit 1 when there is one."""
    from .data.validate import validate_data

    cfg = _apply_common(preset(args.preset), args)
    problems, stats = validate_data(cfg)
    print("stats: " + ", ".join(f"{k}={v}" for k, v in sorted(stats.items())))
    if problems:
        for problem in problems:
            print(f"PROBLEM: {problem}")
        print(f"{len(problems)} problem(s) found")
        return 1
    print("ok: all referenced data artifacts are consistent")
    return 0


def cmd_export_torch(args):
    """Write a checkpoint of this package (parameters or a full state) as
    the reference's two torch state_dict files, which its evaluation
    scripts load (ckpt/torch_export.py)."""
    from .ckpt import load_checkpoint
    from .ckpt.torch_export import save_torch_checkpoint
    from .train.state import create_train_state

    cfg = _apply_common(preset(args.preset), args)
    state = create_train_state(cfg, device=args.device)
    load_checkpoint(args.ckpt, state)
    save_torch_checkpoint(state.encoder, state.head, args.encoder_out,
                          args.head_out)
    print(f"wrote {args.encoder_out} and {args.head_out}")
    return 0


def cmd_benchmark(_args):
    """benchmark.py on the card: one JSON line; its exit code (0 after a
    measurement, 1 after an outage line)."""
    from .benchmark import main as bench_main

    return bench_main()


def cmd_info(args):
    """Versions, the devices and their memory, whether each native library
    is built, the presets and the ``--mesh auto`` factorization."""
    import os

    import torch

    from . import __version__
    from .device import resolve_device
    from .ops import _build
    from .parallel.mesh import factor_devices

    dev = resolve_device(args.device)
    print(f"lstc_vad_tpu_torch {__version__} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda} | device {dev}")
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        print(f"{n_cards} visible card(s):")
        for i in range(n_cards):
            free, total = torch.cuda.mem_get_info(i)
            print(f"  [{i}] {torch.cuda.get_device_name(i)}  "
                  f"{(total - free) / 1e9:.2f}/{total / 1e9:.2f} GB in use")
    else:
        print(f"host: {os.cpu_count()} cores")
    print(f"native libraries ({_build.BUILD_DIR}):")
    for name, source in _build.SOURCES.items():
        path = _build.library_path(name)
        state = f"built ({path.name})" if path.exists() else "not built"
        print(f"  {name} ({source}): {state}")
    dp, tp = factor_devices(max(n_cards, 1), 8)
    print(f"--mesh auto would build data={dp} x model={tp}")
    print(f"presets: {', '.join(sorted(PRESETS))}")
    return 0


def cmd_profile(args):
    """A torch.profiler trace of the train step or the eval forward at the
    preset's shapes on synthetic data, the first two calls (the kernel's
    library load and warm-up) outside the trace; prints one JSON line."""
    import json
    import os
    import time

    import numpy as np
    import torch

    from .evaluation.scoring import _scorer_apply
    from .ops import cuda_attention
    from .train.state import create_train_state
    from .utils.profiling import TRACE_FILE, device_busy_ms, trace

    cfg = _apply_common(preset(args.preset), args)
    if args.steps < 1:
        raise SystemExit(f"--steps must be >= 1, got {args.steps}")
    d, dd = cfg.encoder.d_model, cfg.data
    if args.mode == "eval":
        cfg = _eval_knobs(cfg)
    state = create_train_state(cfg, device=args.device)
    dev = next(state.encoder.parameters()).device
    rng = np.random.default_rng(0)

    def on_device(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    if args.mode == "train":
        from .train.steps import make_train_step

        step_fn = make_train_step(cfg)
        fshape = (dd.batch_size, dd.part_num * dd.part_len, dd.n_patch, d)
        norm, abnorm = on_device(fshape), on_device(fshape)
        labs = torch.from_numpy(rng.random(
            (dd.batch_size, dd.part_num * dd.part_len)).astype(
                np.float32)).to(dev)

        def one_step():
            # the step updates ``state`` in place and returns it
            return step_fn(state, norm, labs, abnorm, labs)[1]["loss"]
    else:
        x = on_device((args.eval_batch, _eval_token_len(cfg), d))
        state.encoder.eval()
        state.head.eval()

        def one_step():
            with torch.inference_mode():
                return _scorer_apply(state.encoder, state.head,
                                     cfg.head.kind, False, x)

    float(one_step().sum())  # the kernel's library loads here
    float(one_step().sum())  # warm
    cuda_attention.reset_launches()
    with trace(args.out):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            last = one_step()
        float(last.sum())  # drain inside the trace window
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(args.out, TRACE_FILE)
    busy = device_busy_ms(path) if dev.type == "cuda" else None
    print(f"trace written to {path} ({args.steps} {args.mode} steps; open "
          "it in Perfetto or chrome://tracing)")
    print(json.dumps({
        "mode": args.mode, "steps": args.steps, "device": str(dev),
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": None if busy is None else 1.0 - busy / wall_ms,
        "attention_launches": cuda_attention.launches}))
    return 0


def cmd_sweep(args):
    """Grid search over config fields: each --grid PATH=v1,v2,... axis is
    typed like --set; every combination trains a fresh model, and the
    ranked AUCs are printed and appended as JSON lines to --out."""
    import itertools
    import json

    from .parallel.multihost import is_writer
    from .train.driver import Trainer

    base = _apply_common(preset(args.preset), args)
    axes = []
    for item in args.grid or []:
        path, _, raw = item.partition("=")
        values = [v for v in raw.split(",") if v]
        if not values:
            raise SystemExit(f"--grid {path}: needs at least one value")
        if any(path == seen for seen, _ in axes):
            raise SystemExit(f"--grid {path}: duplicate axis (the later one "
                             "would silently shadow the earlier)")
        axes.append((path, [_coerce(base, path, v) for v in values]))
    if not axes:
        raise SystemExit("sweep needs at least one --grid PATH=v1,v2,...")
    mesh = _mesh_from_args(args, base.encoder.n_head)
    results = []
    combos = list(itertools.product(*(vals for _, vals in axes)))
    for i, combo in enumerate(combos):
        overrides = {path: val for (path, _), val in zip(axes, combo)}
        cfg = replace(base, **overrides)
        trainer = Trainer(cfg, device=args.device, mesh=mesh)
        r = trainer.fit(epochs=args.epochs)
        trainer.store.close()
        gate = r.best_train_auc if cfg.eval_train_split else r.best_test_auc
        rec = {"run": i, **overrides, "best_test_auc": r.best_test_auc,
               "best_test_epoch": r.best_test_epoch,
               "best_train_auc": r.best_train_auc, "gate_auc": gate}
        results.append(rec)
        print(f"[sweep {i + 1}/{len(combos)}] {overrides} -> "
              f"test {r.best_test_auc:.4f}")
        if args.out and is_writer(mesh):
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    # rank by the criterion the preset's model selection gates on (train
    # AUC for SHT presets, test AUC otherwise) unless told otherwise
    rank_key = "gate_auc" if args.rank_by == "gate" else "best_test_auc"
    results.sort(key=lambda r: -r[rank_key])
    print(f"rank  {'gate_auc':>8}  test_auc  overrides")
    for rank, rec in enumerate(results, 1):
        overrides = {k: v for k, v in rec.items()
                     if k not in ("run", "best_test_auc", "best_test_epoch",
                                  "best_train_auc", "gate_auc")}
        print(f"{rank:>4}  {rec['gate_auc']:8.4f}  "
              f"{rec['best_test_auc']:.4f}  {overrides}")
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


def _add_mesh(p, what: str):
    p.add_argument("--mesh", help=f"'auto' or 'DPxTP' (e.g. 2x4): {what} "
                                  "over a data x model mesh of the launched "
                                  "processes (torchrun, one per device)")


def _add_multihost(p):
    p.add_argument("--multihost", metavar="COORD",
                   help="multi-process run: coordinator 'host:port' (with "
                        "--num-processes/--process-id), or 'auto' for "
                        "torchrun's environment; builds the global mesh "
                        "over every process (model axis within a host)")
    p.add_argument("--num-processes", dest="num_processes", type=int)
    p.add_argument("--process-id", dest="process_id", type=int)


def _add_common(p):
    p.add_argument("--preset", required=True, choices=sorted(PRESETS))
    _add_data(p)
    p.add_argument("--pseudo-labels", dest="pseudo_labels")
    p.add_argument("--epochs", type=int)
    p.add_argument("--save-dir", dest="save_dir")
    p.add_argument("--log-dir", dest="log_dir",
                   help="write a log file here (train/evaluate/gen-pseudo; "
                        "other commands report on stderr/stdout only)")
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
    p.add_argument("--artifact",
                   help="AOT artifact directory (export-aot; --tails for "
                        "LTN): score through its programs, params and model "
                        "code not needed")


def main(argv=None):
    p = argparse.ArgumentParser(prog="lstc_vad_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train STN or LTN (preset decides)")
    _add_common(t)
    _add_mesh(t, "shard the train step")
    _add_multihost(t)
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
    _add_mesh(g, "shard scoring")
    _add_ckpt(g)
    g.add_argument("--kind", choices=("stn", "ltn"), required=True)
    g.add_argument("--threshold", type=float, default=None,
                   help="default: 0.9 for stn, 0.65 for ltn (README.md:27,35)")
    g.add_argument("--out", required=True)
    g.set_defaults(fn=cmd_gen_pseudo)

    e = sub.add_parser("evaluate", help="frame-AUC evaluation")
    _add_common(e)
    _add_mesh(e, "shard scoring")
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
                   help="tenCrop stores: crop index 0-9, or 'mean' for the "
                        "10-crop averaged eval")
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
    _add_mesh(c, "shard every round's step and scoring")
    _add_multihost(c)
    c.set_defaults(fn=cmd_coteach)

    x = sub.add_parser("export-aot",
                       help="export the eval scorer (torch.export programs "
                            "+ weights) into a self-contained deployment "
                            "artifact")
    _add_common(x)
    x.add_argument("--ckpt", required=True,
                   help="a checkpoint file of this package (params or a "
                        "full train state)")
    x.add_argument("--out", required=True, help="artifact directory")
    x.add_argument("--l2", action="store_true",
                   help="bake in the UCF eval-only L2 feature normalize "
                        "(Test/evaluation_UCF.py:77)")
    x.add_argument("--tails", action="store_true",
                   help="LTN: also bake programs for tail parts of 1.."
                        "part_len-1 clips (the no-re-window eval semantics)")
    x.add_argument("--train-shapes", dest="train_shapes",
                   action="store_true",
                   help="UCF LTN: export at the TRAINING part shapes "
                        "instead of the final-eval override (part_len=2) — "
                        "required for gen-pseudo --artifact on UCF")
    x.add_argument("--platforms",
                   help="refused: the artifact is device-portable")
    x.set_defaults(fn=cmd_export_aot)

    v = sub.add_parser("serve",
                       help="online scoring server: JSONL requests on stdin "
                            "(push/flush/end), JSONL scores on stdout")
    _add_common(v)
    _add_ckpt(v)
    v.set_defaults(device=None)  # a --backend worker takes none
    v.add_argument("--max-streams", dest="max_streams", type=int, default=64,
                   help="streams scored per device call")
    v.add_argument("--flush-every", dest="flush_every", type=int, default=0,
                   metavar="K",
                   help="also flush after every K pushes (default: only on "
                        "explicit {\"op\": \"flush\"} requests)")
    v.add_argument("--backend", metavar="SOCKET",
                   help="run as a torch-free protocol worker: buffer "
                        "streams here, proxy device calls to a "
                        "serve-backend unix socket")
    v.set_defaults(fn=cmd_serve)

    b = sub.add_parser("serve-backend",
                       help="multi-process serving device owner: batch "
                            "token rows from N 'serve --backend' workers "
                            "into device calls over a unix socket")
    _add_common(b)
    _add_ckpt(b)
    b.add_argument("--socket", required=True,
                   help="unix socket path to listen on")
    b.add_argument("--max-batch", dest="max_batch", type=int, default=128,
                   help="most rows of one coalesced device call (every "
                        "worker's --max-streams must be <= it)")
    b.add_argument("--window-ms", dest="window_ms", type=float, default=2.0,
                   help="coalescing window: how long to wait for more "
                        "workers' rows before dispatching a partial batch")
    b.set_defaults(fn=cmd_serve_backend)

    k = sub.add_parser("pack", help="convert a reference h5 feature file "
                                    "into a .lstcpack store (needs h5py)")
    k.add_argument("--h5", required=True)
    k.add_argument("--out", required=True)
    k.set_defaults(fn=cmd_pack)

    vd = sub.add_parser("validate-data",
                        help="check the h5 or pack, annotation txts, frame "
                             "masks and pseudo labels for consistency "
                             "(metadata only, reports every problem)")
    _add_common(vd)
    vd.set_defaults(fn=cmd_validate_data)

    et = sub.add_parser("export-torch",
                        help="write a checkpoint as the reference's two "
                             "torch state_dict files (encoder + head)")
    _add_common(et)
    et.add_argument("--ckpt", required=True,
                    help="a checkpoint file of this package (params or a "
                         "full train state)")
    et.add_argument("--encoder-out", dest="encoder_out", required=True)
    et.add_argument("--head-out", dest="head_out", required=True)
    et.set_defaults(fn=cmd_export_torch)

    i = sub.add_parser("info", help="print versions, devices and their "
                                    "memory, native libraries, presets and "
                                    "the auto-mesh factorization")
    i.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a card) or 'cpu'")
    i.set_defaults(fn=cmd_info)

    pr = sub.add_parser("profile",
                        help="write a torch.profiler trace of the train "
                             "step or the eval forward at preset shapes")
    _add_common(pr)
    pr.add_argument("--mode", choices=("train", "eval"), default="train")
    pr.add_argument("--steps", type=int, default=5)
    pr.add_argument("--eval-batch", dest="eval_batch", type=int, default=1024)
    pr.add_argument("--out", required=True, help="trace directory")
    pr.set_defaults(fn=cmd_profile)

    sw = sub.add_parser("sweep",
                        help="grid search: train every combination of "
                             "--grid PATH=v1,v2,... overrides, rank by AUC")
    _add_common(sw)
    _add_mesh(sw, "shard every run")
    sw.add_argument("--grid", action="append", metavar="PATH=V1,V2,...",
                    help="config axis to sweep (typed like --set); repeat "
                         "for a cartesian product")
    sw.add_argument("--out", help="append one JSON line per run")
    sw.add_argument("--rank-by", dest="rank_by", choices=("gate", "test"),
                    default="gate",
                    help="ranking criterion: 'gate' = the preset's model-"
                         "selection AUC (train split for SHT), 'test' = best "
                         "test AUC")
    sw.set_defaults(fn=cmd_sweep)

    bm = sub.add_parser("benchmark",
                        help="single-card throughput over the preset matrix "
                             "at full width: one JSON line (needs the card)")
    bm.set_defaults(fn=cmd_benchmark)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    finally:
        # leave a process group --mesh / --multihost joined (a serve
        # worker never imported torch, so nothing is imported here)
        dist = sys.modules.get("lstc_vad_tpu_torch.parallel.distributed")
        if dist is not None:
            dist.shutdown()
