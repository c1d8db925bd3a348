"""Transformer encoder — the trunk shared by STN and LTN.

PyTorch counterpart of lstc_vad_tpu/models/encoder.py:75-291, with the
reference's module and parameter names (models/Encoder.py:4-74,
models/EncoderLayer.py:4-30, models/MultiHeadAttention.py:25-132,
models/FFN.py:4-22), so that the reference's state_dict — and the one
lstc_vad_tpu/ckpt/torch_export.py writes — loads with ``strict=True``:

- CLS token prepended to the sequence: mean of the input tokens by default
  (Encoder.py:54), learned parameter ``cls_token`` if ``cls_learned``.
- optional learned absolute position table ``position_enc`` + dropout.
- optional LayerNorm ``layer_norm`` on the raw inputs.
- N x [MHA -> optional FFN] blocks under ``layer_stack``; post-LN on each
  residual is optional.
- 3-D (or 2-D) Swin-video relative position bias added to the attention
  logits at non-CLS positions only, with the index table sliced by the
  actual sequence length (MultiHeadAttention.py:107-117).

As the reference does, every LayerNorm, the FFN (even when ``ffn_need`` is
off) and the int64 ``relative_position_index`` buffer are registered
whatever the flags; the flags gate only their use.

Dropout follows ``module.training``; evaluation calls ``.eval()``.  The
attention inner loop dispatches through ops.attention.sdpa (the CUDA kernel
on the card); the GEMMs are nn.Linear.  f32 only: bf16 compute, stochastic
rounding and remat are not ported yet (ROADMAP A19) and raise.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import EncoderConfig
from ..device import resolve_device
from ..ops.attention import sdpa
from . import initializers as init
from . import rpe


def check_supported(c: EncoderConfig):
    """Raise on the knobs this package does not implement yet, instead of
    ignoring them."""
    if c.compute_dtype != "float32":
        raise NotImplementedError(
            f"encoder.compute_dtype={c.compute_dtype!r}: only float32 is "
            "ported (bf16 compute is ROADMAP item A19)")
    if c.cast_sr:
        raise NotImplementedError("encoder.cast_sr is not ported yet "
                                  "(ROADMAP item A19)")
    if c.remat:
        raise NotImplementedError("encoder.remat is not ported yet "
                                  "(ROADMAP item A19)")


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        c = self.cfg = cfg
        kw = dict(bias=False, device=device)
        self.w_qs = nn.Linear(c.d_model, c.n_head * c.d_k, **kw)
        self.w_ks = nn.Linear(c.d_model, c.n_head * c.d_k, **kw)
        self.w_vs = nn.Linear(c.d_model, c.n_head * c.d_v, **kw)
        self.fc = nn.Linear(c.n_head * c.d_v, c.d_model, **kw)
        self.fc_dropout = nn.Dropout(c.fc_dropout)
        self.layer_norm = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps,
                                       device=device)
        self.relative_position_bias_table = None
        if c.relative_pe or c.relative_pe_2d:
            if c.relative_pe:
                index = rpe.relative_position_index_3d(c.window_depth,
                                                       c.window_size)
                size = rpe.table_size_3d(c.window_depth, c.window_size)
            else:
                index = rpe.relative_position_index_2d(c.window_size)
                size = rpe.table_size_2d(c.window_size)
            self.relative_position_bias_table = nn.Parameter(
                torch.empty(size, c.n_head, device=device))
            self.register_buffer("relative_position_index", torch.as_tensor(
                index.astype(np.int64), device=device))

    def reset_parameters(self, generator: torch.Generator):
        c = self.cfg
        for lin in (self.w_qs, self.w_ks, self.w_vs, self.fc):
            init.torch_linear_(lin, generator, c.weight_init)
        init.layer_norm_(self.layer_norm)
        if self.relative_position_bias_table is not None:
            if c.weight_init:
                init.xavier_uniform_(self.relative_position_bias_table,
                                     generator)
            else:
                init.trunc_normal_02_(self.relative_position_bias_table,
                                      generator)

    def relative_bias(self, length: int) -> Optional[torch.Tensor]:
        """Additive [H, length, length] bias; zero at the CLS row and column
        — equivalent to the reference's in-place add at attn[:, :, 1:, 1:]."""
        c = self.cfg
        if self.relative_position_bias_table is None or length <= 1:
            return None
        n_tok = length - 1
        index = self.relative_position_index
        if c.relative_pe:
            # index sliced by the actual token count (MultiHeadAttention.py:108)
            if n_tok > index.shape[0]:
                raise ValueError(
                    f"sequence of {n_tok} tokens exceeds the relative-PE window "
                    f"({index.shape[0]} = window_depth*window_size^2)")
            index = index[:n_tok, :n_tok]
        elif n_tok != index.shape[0]:
            # the 2-D path gathers the FULL window (MultiHeadAttention.py:114)
            raise ValueError(
                f"relative_pe_2d needs exactly window_size^2="
                f"{index.shape[0]} tokens, got {n_tok}")
        gathered = self.relative_position_bias_table[index.reshape(-1)]
        gathered = gathered.reshape(n_tok, n_tok, c.n_head).permute(2, 0, 1)
        return nn.functional.pad(gathered, (1, 0, 1, 0)).contiguous()

    def forward(self, x, mask=None, return_probs: bool = False,
                return_v: bool = False):
        """``return_probs``/``return_v`` mirror the reference's return_attn /
        return_attn_v plumbing: the attention map [B, H, L, L] and the V
        tensor [B, H, L, d_v] come back beside the output."""
        c = self.cfg
        b, length, _ = x.shape
        h, dk, dv = c.n_head, c.d_k, c.d_v
        residual = x
        # [B, H, L, D] views of the projections, no copies: the kernel reads
        # them strided and writes out as a view of a [B, L, H, D] buffer, so
        # the reshape below is a view too
        q = self.w_qs(x).view(b, length, h, dk).transpose(1, 2)
        k = self.w_ks(x).view(b, length, h, dk).transpose(1, 2)
        v = self.w_vs(x).view(b, length, h, dv).transpose(1, 2)
        dropout_p = c.attn_dropout if self.training else 0.0
        out = sdpa(q, k, v, temperature=math.sqrt(dk),
                   bias=self.relative_bias(length), mask=mask,
                   dropout_p=dropout_p, impl=c.attn_impl,
                   return_probs=return_probs or return_v)
        probs = None
        if return_probs or return_v:
            out, probs = out
        out = out.transpose(1, 2).reshape(b, length, h * dv)
        out = self.fc_dropout(self.fc(out)) + residual
        if c.mha_layernorm:
            out = self.layer_norm(out)
        if return_v:
            return out, probs, v
        if return_probs:
            return out, probs
        return out


class FeedForward(nn.Module):
    def __init__(self, cfg: EncoderConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        c = self.cfg = cfg
        self.w_1 = nn.Linear(c.d_model, c.d_inner, device=device)
        self.w_2 = nn.Linear(c.d_inner, c.d_model, device=device)
        self.dropout = nn.Dropout(c.ffn_dropout)
        self.layer_norm = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps,
                                       device=device)

    def reset_parameters(self, generator: torch.Generator):
        init.torch_linear_(self.w_1, generator, self.cfg.weight_init)
        init.torch_linear_(self.w_2, generator, self.cfg.weight_init)
        init.layer_norm_(self.layer_norm)

    def forward(self, x):
        residual = x
        x = self.w_2(torch.relu(self.w_1(x)))
        x = self.dropout(x) + residual
        if self.cfg.ffn_layernorm:
            x = self.layer_norm(x)
        return x


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.slf_attn = MultiHeadAttention(cfg, device=device)
        # registered even when ffn_need is off (EncoderLayer.py:15)
        self.pos_ffn = FeedForward(cfg, device=device)

    def forward(self, x, mask=None, return_probs: bool = False,
                return_v: bool = False):
        out = self.slf_attn(x, mask, return_probs=return_probs,
                            return_v=return_v)
        probs = v = None
        if return_v:
            out, probs, v = out
        elif return_probs:
            out, probs = out
        if self.cfg.ffn_need:
            out = self.pos_ffn(out)
        if return_v:
            return out, probs, v
        if return_probs:
            return out, probs
        return out


class Encoder(nn.Module):
    """x: [B, L, d_model] -> [B, L+1, d_model] (CLS at position 0).

    Build it on its device and draw its weights from a generator there:
    ``Encoder(cfg, device=dev).reset_parameters(torch.Generator(dev))``
    (models.build does both).  ``device`` defaults to the CUDA card, and
    every module of the package raises without one unless told the CPU."""

    def __init__(self, cfg: EncoderConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        check_supported(cfg)
        c = self.cfg = cfg
        self.layer_norm = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps,
                                       device=device)
        self.cls_token = self.position_enc = None
        if c.cls_learned:
            self.cls_token = nn.Parameter(
                torch.empty(1, 1, c.d_model, device=device))
        if c.position_encoding:
            self.position_enc = nn.Parameter(
                torch.empty(1, c.max_position_tokens, c.d_model,
                            device=device))
        self.position_dropout = nn.Dropout(c.position_dropout)
        self.layer_stack = nn.ModuleList(
            [EncoderLayer(c, device=device) for _ in range(c.n_layers)])

    def reset_parameters(self, generator: torch.Generator):
        c = self.cfg
        init.layer_norm_(self.layer_norm)
        for table in (self.cls_token, self.position_enc):
            if table is not None:
                if c.weight_init:
                    init.xavier_uniform_(table, generator)
                else:
                    init.randn_(table, generator)
        for layer in self.layer_stack:
            layer.slf_attn.reset_parameters(generator)
            layer.pos_ffn.reset_parameters(generator)
        return self

    def forward(self, x, mask=None, return_probs: bool = False,
                return_v: bool = False):
        """``return_probs`` -> (out, [per-layer attn maps]);
        ``return_v``     -> (out, [attn maps], [per-layer V tensors])."""
        c = self.cfg
        if c.input_layernorm:
            x = self.layer_norm(x)
        if self.cls_token is not None:
            cls = self.cls_token.expand(x.shape[0], 1, c.d_model)
        else:
            cls = x.mean(dim=1, keepdim=True)
        x = torch.cat([cls, x], dim=1)
        if self.position_enc is not None:
            x = self.position_dropout(x + self.position_enc[:, :x.shape[1]])
        probs_all, v_all = [], []
        for layer in self.layer_stack:
            x = layer(x, mask, return_probs=return_probs, return_v=return_v)
            if return_v:
                x, probs, v = x
                probs_all.append(probs)
                v_all.append(v)
            elif return_probs:
                x, probs = x
                probs_all.append(probs)
        if return_v:
            return x, probs_all, v_all
        if return_probs:
            return x, probs_all
        return x
