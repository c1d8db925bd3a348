"""This package's modules -> the reference's two torch state_dict files —
the counterpart of lstc_vad_tpu/ckpt/torch_export.py:38-137
(``save_torch_checkpoint``).

The reference's evaluation and pseudo-label scripts rebuild its Encoder and
head from two files (Test/evaluation_shanghaitech_ubnormal.py:35-62).  The
package's modules already register the reference's keys (models/encoder.py,
models/heads.py), every LayerNorm, the FFN and the ``relative_position_index``
buffer whatever the flags, so each file is the module's ``state_dict()``.
What a flag leaves unused is written as the JAX exporter writes it, since
the JAX package holds no parameter for it: identity LayerNorms
(``layer_norm`` at the top without ``input_layernorm``, each
``slf_attn.layer_norm`` without ``mha_layernorm``, each
``pos_ffn.layer_norm`` without ``ffn_layernorm``) and zero FFN weights
without ``ffn_need``.  So the files equal the JAX package's for the same
parameters, and load ``strict=True`` into the reference's modules and this
package's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

StateDict = Dict[str, torch.Tensor]


def _unused(cfg) -> Tuple[str, ...]:
    """Key prefixes of the modules ``cfg``'s flags leave unused."""
    prefixes = [] if cfg.input_layernorm else ["layer_norm."]
    for i in range(cfg.n_layers):
        p = f"layer_stack.{i}."
        if not cfg.mha_layernorm:
            prefixes.append(p + "slf_attn.layer_norm.")
        if not cfg.ffn_need:
            prefixes.append(p + "pos_ffn.")
        elif not cfg.ffn_layernorm:
            prefixes.append(p + "pos_ffn.layer_norm.")
    return tuple(prefixes)


def encoder_state_dict(encoder) -> StateDict:
    """The encoder's reference state_dict on the CPU, unused modules as the
    JAX exporter writes them."""
    unused = _unused(encoder.cfg)
    sd = {}
    for key, value in encoder.state_dict().items():
        value = value.detach().to("cpu", copy=True).contiguous()
        if key.startswith(unused):
            # a LayerNorm's weight is 1, every other unused value 0
            fill = 1.0 if ("." + key).endswith(".layer_norm.weight") else 0.0
            value = torch.full_like(value, fill)
        sd[key] = value
    return sd


def head_state_dict(head) -> StateDict:
    return {k: v.detach().to("cpu", copy=True).contiguous()
            for k, v in head.state_dict().items()}


def save_torch_checkpoint(encoder, head, encoder_path: str,
                          head_path: str) -> Tuple[StateDict, StateDict]:
    """Write the encoder's and head's reference state_dicts as the two
    ``.ckpt`` files; returns them."""
    enc_sd, head_sd = encoder_state_dict(encoder), head_state_dict(head)
    torch.save(enc_sd, encoder_path)
    torch.save(head_sd, head_path)
    return enc_sd, head_sd
