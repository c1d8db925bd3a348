"""Weights from elsewhere into this package's state_dicts.

- ``state_dict_from_jax``: the JAX package's numpy param trees (flax layout)
  -> the encoder's and head's state_dicts.  This is the mapping of
  lstc_vad_tpu/ckpt/torch_export.py:38-119 (``export_encoder`` /
  ``export_head``), kept here as this package's own copy: flax Dense kernels
  are [in, out] and torch Linear weights [out, in], so kernels are
  transposed; the keys the reference registers whatever the flags are
  filled with identity LayerNorms and zero FFN weights, and the
  ``relative_position_index`` buffer is added, so ``load_state_dict(...,
  strict=True)`` succeeds.
- ``load_reference_checkpoint``: the reference's two ``.ckpt`` files
  (encoder, head) -> the same two state_dicts, with a DataParallel
  ``module.`` prefix stripped as the reference's loaders do
  (Train/pseudo_labels_generator_spatio.py:28-32).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import EncoderConfig
from ..models import rpe

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    # np.array copies: the leaves may be read-only views of device buffers
    return torch.from_numpy(np.array(x))


def encoder_state_dict_from_jax(enc_params: dict,
                                cfg: Optional[EncoderConfig] = None
                                ) -> StateDict:
    """Flax encoder subtree -> encoder state_dict.  With ``cfg``, the
    flag-independent keys are filled in too (see the module docstring)."""
    sd: StateDict = {}
    index = None
    if cfg is not None and (cfg.relative_pe or cfg.relative_pe_2d):
        index = (rpe.relative_position_index_3d(cfg.window_depth,
                                                cfg.window_size)
                 if cfg.relative_pe
                 else rpe.relative_position_index_2d(cfg.window_size))
        index = index.astype(np.int64)
    for name, sub in enc_params.items():
        if name == "input_layer_norm":
            sd["layer_norm.weight"] = _t(sub["scale"])
            sd["layer_norm.bias"] = _t(sub["bias"])
        elif name in ("cls_token", "position_enc"):
            sd[name] = _t(sub)
        elif name.startswith("layer_"):
            i = name[len("layer_"):]
            for mod, modp in sub.items():          # slf_attn | pos_ffn
                for pname, leaf in modp.items():
                    key = f"layer_stack.{i}.{mod}.{pname}"
                    if pname == "relative_position_bias_table":
                        sd[key] = _t(leaf)
                        if index is not None:
                            sd[f"layer_stack.{i}.{mod}."
                               "relative_position_index"] = _t(index)
                    elif pname == "layer_norm":
                        sd[key + ".weight"] = _t(leaf["scale"])
                        sd[key + ".bias"] = _t(leaf["bias"])
                    else:                          # w_qs/w_ks/w_vs/fc/w_1/w_2
                        sd[key + ".weight"] = _t(np.asarray(leaf["kernel"]).T)
                        if "bias" in leaf:
                            sd[key + ".bias"] = _t(leaf["bias"])
        else:
            raise ValueError(f"unknown encoder param {name!r}")
    if cfg is not None:
        _fill_unconditional(sd, cfg)
    return sd


def _fill_unconditional(sd: StateDict, cfg: EncoderConfig):
    """Identity LayerNorms and zero FFN weights for the modules the
    reference registers regardless of flags (unused under those flags)."""
    d, h = cfg.d_model, cfg.d_inner

    def fill(key: str, shape, value: float):
        sd.setdefault(key, torch.full(shape, value, dtype=torch.float32))

    fill("layer_norm.weight", (d,), 1.0)
    fill("layer_norm.bias", (d,), 0.0)
    for i in range(cfg.n_layers):
        p = f"layer_stack.{i}."
        for mod in ("slf_attn", "pos_ffn"):
            fill(p + mod + ".layer_norm.weight", (d,), 1.0)
            fill(p + mod + ".layer_norm.bias", (d,), 0.0)
        fill(p + "pos_ffn.w_1.weight", (h, d), 0.0)
        fill(p + "pos_ffn.w_1.bias", (h,), 0.0)
        fill(p + "pos_ffn.w_2.weight", (d, h), 0.0)
        fill(p + "pos_ffn.w_2.bias", (d,), 0.0)


def head_state_dict_from_jax(head_params: dict, kind: str) -> StateDict:
    """Flax head subtree -> Regressor/Classifier state_dict (Sequential
    indices 0/3/5 are the three Linears)."""
    if kind not in ("regressor", "classifier"):
        raise ValueError(f"unknown head kind {kind!r}")
    linear_to_seq = {"linear_0": "0", "linear_1": "3", "linear_2": "5"}
    sd: StateDict = {}
    for name, leaf in head_params["mlp"].items():
        seq = linear_to_seq[name]
        sd[f"{kind}.{seq}.weight"] = _t(np.asarray(leaf["kernel"]).T)
        sd[f"{kind}.{seq}.bias"] = _t(leaf["bias"])
    return sd


def state_dict_from_jax(enc_params: dict, head_params: dict,
                        cfg: EncoderConfig, kind: str
                        ) -> Tuple[StateDict, StateDict]:
    """(encoder state_dict, head state_dict) from the two flax subtrees."""
    return (encoder_state_dict_from_jax(enc_params, cfg),
            head_state_dict_from_jax(head_params, kind))


def _load(path: str) -> StateDict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def load_reference_checkpoint(enc_path: str, head_path: str
                              ) -> Tuple[StateDict, StateDict]:
    """The reference's encoder and head ``.ckpt`` files -> (encoder
    state_dict, head state_dict) on the CPU."""
    return _load(enc_path), _load(head_path)
