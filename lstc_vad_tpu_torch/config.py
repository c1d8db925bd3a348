"""Typed configuration for the PyTorch package.

The package keeps its own copy of the JAX package's dataclass tree
(lstc_vad_tpu/config.py) so that it imports nothing from it: the same fields,
defaults, ``replace`` and the six presets.  One dataclass tree replaces the
~60 argparse flags duplicated across every reference script (e.g.
Train/spatio_transformer_shanghaitech.py:201-267,
Train/temporal_transformer_shanghaitech.py:257-323).  Only flags that affect
math / data semantics are kept; logging paths etc. live in the CLI layer.

``EncoderConfig.attn_impl`` takes this package's own values (ops/attention.py):
"auto" (the CUDA kernel on a CUDA tensor, the plain version on a CPU tensor)
and "plain" (the plain version on any device).

Presets at the bottom reproduce the reference defaults per dataset and model
(STN = spatio / short-temporal network, LTN = long-temporal network).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class EncoderConfig:
    """Transformer encoder trunk (reference: models/Encoder.py:4-74).

    ``cls_learned=False`` means the CLS token prepended to the sequence is the
    mean of the input tokens (Encoder.py:54); otherwise a learned parameter.
    """

    n_layers: int = 3
    n_head: int = 8
    d_k: int = 256
    d_v: int = 256
    d_model: int = 2048
    d_inner: int = 3027
    attn_dropout: float = 0.1      # MHA_attn_dropout
    fc_dropout: float = 0.1        # MHA_fc_dropout
    mha_layernorm: bool = False    # post-LN after the attention residual
    ffn_dropout: float = 0.1
    ffn_layernorm: bool = True     # post-LN after the FFN residual
    ffn_need: bool = True          # EncoderLayer FFN_need flag
    input_layernorm: bool = False  # LN on the raw inputs before CLS prepend
    cls_learned: bool = False
    position_encoding: bool = False       # learned absolute PE table
    max_position_tokens: int = 17
    position_dropout: float = 0.1
    relative_pe: bool = False      # 3-D Swin-video relative position bias
    relative_pe_2d: bool = False   # 2-D variant
    window_size: int = 4           # Ws (spatial) for the relative bias grid
    window_depth: int = 3          # Wd (clip index within a part); = part_len for LTN
    weight_init: bool = False      # xavier-uniform over all >=2-D params
    layer_norm_eps: float = 1e-6
    attn_impl: str = "auto"        # "auto" | "plain"
    # Train-time knobs (models/encoder.py); evaluation runs f32, no remat,
    # no SR whatever they say.
    compute_dtype: str = "float32" # "float32" | "bfloat16"
    cast_sr: bool = False          # stochastic rounding of bf16 casts
    remat: bool = False            # recompute each layer in the backward

    @property
    def rpe_num_tokens(self) -> int:
        """Window token count covered by the relative-bias index table."""
        if self.relative_pe:
            return self.window_depth * self.window_size * self.window_size
        if self.relative_pe_2d:
            return self.window_size * self.window_size
        return 0


@dataclass(frozen=True)
class HeadConfig:
    """Regressor (STN, sigmoid scalar) / Classifier (LTN, 2-way softmax).

    Reference: models/Regressor.py:4-21, models/Classifier.py:5-23.
    """

    kind: str = "regressor"  # "regressor" | "classifier"
    d_model: int = 2048
    hidden_dim: int = 512
    dropout: float = 0.6
    weight_init: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Dataset layout + sampler (reference: utils/load_dataset.py)."""

    dataset: str = "SHT"            # "SHT" | "UCF" | "UBnormal"
    h5_path: str = ""
    pack_path: str = ""             # .lstcpack (native mmap store); wins over h5
    train_txt: str = ""
    test_txt: str = ""
    test_mask_dir: str = ""         # SHT/UBnormal per-video .npy frame masks
    test_mask_h5: str = ""          # UCF ground-truth h5
    pseudo_labels_path: Optional[str] = None
    n_patch: int = 16
    d_model: int = 2048
    part_num: int = 16
    part_len: int = 7
    segment_len: int = 16           # frames per clip
    sample: str = "uniform"         # "uniform" | "random" jitter mode
    transfer_dtype: str = "float32" # "bfloat16" halves host->device batch
                                    # bytes (features only; labels stay f32)
    eval_transfer_dtype: str = "float32"  # eval/pseudo-gen wire dtype — its
                                    # OWN knob: transfer_dtype is a training
                                    # throughput lever and must never shift
                                    # eval scores/AUC silently (bf16 features
                                    # round at ~1e-2 relative)
    ten_crop: bool = False
    eval_crop: Optional[int] = None # which of the 10 crops to evaluate with
                                    # (tenCrop stores only; the reference has
                                    # NO committed tenCrop eval script, so the
                                    # crop must be chosen explicitly)
    eager: bool = True              # load all features to RAM up-front
    batch_size: int = 40
    num_workers: int = 2
    seed: int = 0


@dataclass(frozen=True)
class OptimConfig:
    """Adagrad, two LR groups, as in the reference
    (Train/spatio_transformer_shanghaitech.py:76-78)."""

    lr_encoder: float = 1e-4
    lr_head: float = 1e-2
    weight_decay: float = 1e-3
    clip_grad: bool = False
    clip_norm: float = 10.0
    # torch.optim.Adagrad defaults reproduced:
    adagrad_eps: float = 1e-10
    initial_accumulator: float = 0.0


@dataclass(frozen=True)
class LossConfig:
    lambda_1: float = 0.01          # sparsity weight inside the MIL loss
    lambda_mil: float = 1.0
    lambda_ce: float = 0.8
    lambda_bce: float = 1.0
    lambda_normal: float = 0.2      # co-teach BCE class weights
    lambda_abnormal: float = 2.0
    temporal_only: bool = False     # LTN: disable the CE term


@dataclass(frozen=True)
class TrainConfig:
    model: str = "stn"              # "stn" | "ltn"
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    epochs: int = 18201
    inter_epoch: int = 10           # eval cadence (epochs)
    log_every_step: int = 0         # per-iteration loss lines (0 = off;
                                    # forces a device sync per log)
    save_threshold: float = 0.9685
    seed: int = 0
    model_save_dir: str = "checkpoints"
    eval_train_split: bool = True   # reference also evals the train split on SHT
    eval_tail_rewindow: bool = True # LTN eval tail: re-window (standalone
                                    # scripts) vs feed short (MIL_CE rounds)
    max_clips: int = 32             # UCF eval bin count
    donate: bool = True
    metrics_jsonl: str = ""         # append one JSON line per train epoch /
                                    # eval to this file (machine-readable
                                    # observability; "" = off)
    dropout_rng: str = "rbg"        # kept for field parity with the JAX
                                    # package; no training path reads it yet


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for pjit: data parallel x model (tensor) parallel."""

    data: int = 1
    model: int = 1

    @property
    def axis_names(self) -> Tuple[str, str]:
        return ("data", "model")


def replace(cfg, **kw):
    """dataclasses.replace that also works on nested field paths 'a.b.c'."""
    direct = {k: v for k, v in kw.items() if "." not in k}
    nested: dict = {}
    for k, v in kw.items():
        if "." in k:
            outer, inner = k.split(".", 1)
            nested.setdefault(outer, {})[inner] = v
    for outer, inner_kw in nested.items():
        base = direct.get(outer, getattr(cfg, outer))
        direct[outer] = replace(base, **inner_kw)
    return dataclasses.replace(cfg, **direct)


# ---------------------------------------------------------------------------
# Presets reproducing the reference defaults.
# ---------------------------------------------------------------------------

def sht_stn() -> TrainConfig:
    """ShanghaiTech STN (Train/spatio_transformer_shanghaitech.py:201-267).
    README trains it with --encoder_weight_init --regressor_weight_init
    --FFN_layerNorm --FFN_dropout 0.3 (README.md:24; the README's
    --MHA_dropout flag does not exist in the script's argparse and is
    dropped)."""
    return TrainConfig(
        model="stn",
        encoder=EncoderConfig(d_inner=3027, ffn_layernorm=True, weight_init=True,
                              ffn_dropout=0.3, max_position_tokens=17),
        head=HeadConfig(kind="regressor", weight_init=True),
        data=DataConfig(dataset="SHT", n_patch=16, part_num=16, part_len=7),
        save_threshold=0.9685,
    )


def sht_ltn() -> TrainConfig:
    """ShanghaiTech LTN (Train/temporal_transformer_shanghaitech.py:257-323).
    README: --part_len 3 --MHA_layerNorm --FFN_layerNorm
    --relative_position_encoding (README.md:31)."""
    part_len = 3
    return TrainConfig(
        model="ltn",
        encoder=EncoderConfig(d_inner=4096, attn_dropout=0.2, fc_dropout=0.2,
                              mha_layernorm=True, ffn_layernorm=True,
                              relative_pe=True, window_size=4,
                              window_depth=part_len),
        head=HeadConfig(kind="classifier"),
        data=DataConfig(dataset="SHT", n_patch=16, part_num=16, part_len=part_len),
        save_threshold=0.9713,
    )


def ucf_stn() -> TrainConfig:
    """UCF-Crime STN (Train/spatio_transformer_UCF.py): 9 patches.  Unlike
    the SHT README recipe, no command overrides the script defaults, so
    FFN LayerNorm and xavier init stay OFF (store_true flags, :217-220)."""
    return TrainConfig(
        model="stn",
        encoder=EncoderConfig(d_inner=3027, ffn_layernorm=False),
        head=HeadConfig(kind="regressor"),
        data=DataConfig(dataset="UCF", n_patch=9, part_num=16, part_len=7,
                        eager=False),
        save_threshold=0.83,
        inter_epoch=5,
        # the reference UCF scripts never evaluate the train split and gate
        # saving on TEST AUC (Train/spatio_transformer_UCF.py:139-149)
        eval_train_split=False,
    )


def ucf_ltn() -> TrainConfig:
    """UCF-Crime LTN (Train/temporal_transformer_UCF.py): part_len 3 at train,
    9 patches; eval path uses part_len 2 + 32-bin compression + L2 norm
    (Test/evaluation_UCF.py:42-77)."""
    part_len = 3
    return TrainConfig(
        model="ltn",
        encoder=EncoderConfig(d_inner=4096, attn_dropout=0.2, fc_dropout=0.2,
                              mha_layernorm=True, ffn_layernorm=True,
                              relative_pe=True, window_size=4,
                              window_depth=part_len),
        head=HeadConfig(kind="classifier"),
        data=DataConfig(dataset="UCF", n_patch=9, part_num=16, part_len=part_len,
                        eager=False),
        save_threshold=0.825,
        inter_epoch=5,
        eval_train_split=False,
    )


def ubnormal_stn() -> TrainConfig:
    """UBnormal STN (Train/spatio_transformer_UBnormal.py).  Script defaults:
    FFN LayerNorm / xavier init OFF (store_true flags, :179-182)."""
    return TrainConfig(
        model="stn",
        encoder=EncoderConfig(d_inner=3027, ffn_layernorm=False),
        head=HeadConfig(kind="regressor"),
        data=DataConfig(dataset="UBnormal", n_patch=16, part_num=16, part_len=7),
        save_threshold=0.9685,
        eval_train_split=False,
    )


def ubnormal_ltn() -> TrainConfig:
    """UBnormal LTN (Train/temporal_transformer_UBnormal.py + README.md:55:
    d_model 1024, part_len 5)."""
    part_len = 5
    return TrainConfig(
        model="ltn",
        encoder=EncoderConfig(d_model=1024, d_inner=4096, attn_dropout=0.2,
                              fc_dropout=0.2, mha_layernorm=True,
                              ffn_layernorm=True, relative_pe=True,
                              window_size=4, window_depth=part_len),
        head=HeadConfig(kind="classifier", d_model=1024),
        data=DataConfig(dataset="UBnormal", n_patch=16, part_num=16,
                        part_len=part_len, d_model=1024),
        save_threshold=0.9713,
        # the reference's UBnormal train-split eval is inoperable (it parses
        # the label from the n_frames field and `gt` is never loaded), and
        # UBnormal ships masks for the test split only
        eval_train_split=False,
    )


PRESETS = {
    "sht_stn": sht_stn,
    "sht_ltn": sht_ltn,
    "ucf_stn": ucf_stn,
    "ucf_ltn": ucf_ltn,
    "ubnormal_stn": ubnormal_stn,
    "ubnormal_ltn": ubnormal_ltn,
}


def preset(name: str, **overrides) -> TrainConfig:
    cfg = PRESETS[name]()
    if overrides:
        cfg = replace(cfg, **overrides)
    return cfg
