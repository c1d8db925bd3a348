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
of the tensors' type on the card); the f32 GEMMs (every Linear's product in
``dense`` and ``sharded_dense``) go through ops/cuda_linear.py's operator,
the 3xTF32 kernel of csrc/gemm.cu on the card and ``F.linear`` on the CPU.

The JAX package's train-time knobs, f32 and off by default:
- ``compute_dtype="bfloat16"``: the casts are explicit, as flax's are (no
  autocast, which would keep LayerNorm outputs and residuals in f32): x to
  bf16 at the attention's entry, bf16 Linear outputs from weights cast to
  bf16 on each call (the parameters stay f32), LayerNorm statistics in f32
  with the output cast back to bf16, the residual adds in bf16.  The
  encoder's output is bf16; the head upcasts it (models/heads.py).
- ``cast_sr``: on train passes of a bf16 encoder, every Linear takes
  stochastically rounded bf16 casts of its input, weight and bias
  (ops/sr.py) and keeps its output bf16; the activations between the
  Linears stay in their own type, the LayerNorms give f32.  Deterministic
  passes run the plain bf16 path bit for bit.  With f32 compute it raises
  ValueError, as the JAX package does.
- ``remat``: each layer runs under ``torch.utils.checkpoint``
  (``use_reentrant=False``) when a gradient is being taken, so its
  activations are recomputed in the backward.  Every dropout mask and SR
  noise draw comes from the default generators, which the checkpoint
  restores for the recompute, and on a mesh the recompute re-enters the
  step's batch layout (parallel/tp.py::remat_contexts): loss and gradients
  equal the plain path's bit for bit.  The diagnostic outputs
  (``return_probs``/``return_v``) bypass it.

The state_dict is the same whatever the knobs, so every checkpoint loads
into every configuration ``strict=True``.  Evaluation runs the f32 twin
(``eval_twin``), which shares the weights.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import EncoderConfig
from ..device import resolve_device
from ..ops.attention import sdpa
from ..ops.cuda_linear import linear
from ..ops.sr import sr_cast, sr_linear
from ..parallel import tp as tpc
from . import initializers as init
from . import rpe

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(c: EncoderConfig) -> torch.dtype:
    if c.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"encoder.compute_dtype={c.compute_dtype!r}; "
                         f"expected one of {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[c.compute_dtype]


def sr_active(c: EncoderConfig, training: bool) -> bool:
    """cast_sr applies to train passes of a bf16-compute encoder only
    (lstc_vad_tpu/models/encoder.py::_sr_active); deterministic passes keep
    the plain cast path bit for bit."""
    if not c.cast_sr or not training:
        return False
    if compute_dtype(c) != torch.bfloat16:
        raise ValueError("encoder.cast_sr requires "
                         f"compute_dtype='bfloat16', got {c.compute_dtype!r}")
    return True


def dense(lin: nn.Linear, x: torch.Tensor, dt: torch.dtype,
          sr: bool, tp: Optional[tpc.Axis] = None,
          row: bool = False) -> torch.Tensor:
    """``lin`` applied as the JAX package's Dense of compute type ``dt``:
    in f32 its product through ``linear`` (ops/cuda_linear.py); or x and
    the weight cast to bf16, the product rounded to bf16, then the bf16
    bias added (a second rounding, as flax adds the bias after the dot);
    or, on the SR arm, stochastically rounded casts.  ``tp``: ``lin`` is
    split over that model axis (``sharded_dense``)."""
    if tp is not None:
        return sharded_dense(lin, x, dt, sr, tp, row)
    if sr:
        return sr_linear(x, lin.weight, lin.bias)
    if dt == torch.float32:
        return linear(x, lin.weight, lin.bias)
    y = F.linear(x.to(dt), lin.weight.to(dt))
    return y if lin.bias is None else y + lin.bias.to(dt)


def _sr(t: torch.Tensor, tp: tpc.Axis, split: Optional[int],
        rows: bool) -> torch.Tensor:
    """``sr_cast(t)`` with the noise drawn at ``t``'s global shape
    (parallel/tp.py): ``split`` is the dim split over ``tp``, ``rows``
    whether its leading axis is this rank's batch rows.  A tensor that is
    not f32 draws none, as ``sr_cast`` draws none for it."""
    if t.dtype != torch.float32:
        return sr_cast(t)
    return sr_cast(t, tpc.draw_global(
        t.shape, lambda full: torch.randint(  # as ops/sr.py::sr_noise draws
            0, 1 << 16, full, dtype=torch.int32, device=t.device),
        cols=None if split is None else tp, col_dim=split or 0, rows=rows))


def sharded_dense(lin: nn.Linear, x: torch.Tensor, dt: torch.dtype,
                  sr: bool, tp: tpc.Axis, row: bool,
                  f32_linear=linear) -> torch.Tensor:
    """``dense`` of a Linear split over the model axis ``tp``
    (parallel/mesh.py's rules).  Column-parallel (``row`` False): x is
    replicated (the caller passed it through ``copy_to_model``) and the
    outputs, bias included, are this rank's.  Row-parallel: x holds this
    rank's inputs; the partial products are summed over the model axis and
    then the bias is added, once.  On bf16 each partial product is rounded
    to bf16 before the sum.  SR noise is drawn at the global shapes and
    sliced, in the unsharded order (x, weight, bias).  On a model axis of
    one rank a row-parallel Linear is whole: it runs as a column-parallel
    one, its bias inside the product, as the unsharded module runs.
    ``f32_linear`` computes the f32 product: the encoder's ``linear``, the
    heads' ``F.linear`` (their unsharded module's), so that a mesh of one
    rank gives each module's unsharded bits."""
    row = row and tp.size > 1
    w_dim = 1 if row else 0
    bias = lin.bias
    if sr:
        y = F.linear(_sr(x, tp, x.dim() - 1 if row else None, True),
                     _sr(lin.weight, tp, w_dim, False))
        if bias is not None and not row:
            y = y + _sr(bias, tp, 0, False)
    elif dt == torch.float32:
        y = f32_linear(x, lin.weight, None if row else bias)
    else:
        y = F.linear(x.to(dt), lin.weight.to(dt))
        if bias is not None and not row:
            y = y + bias.to(dt)
    if not row:
        return y
    y = tpc.reduce_from_model(y, tp)
    if bias is None:
        return y
    if sr:
        return y + _sr(bias, tp, None, False)
    return y + bias.to(y.dtype)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Statistics in f32, the output in ``dtype`` (the identity casts in
    f32)."""
    return ln(x.float()).to(dtype)


def eval_config(c: EncoderConfig) -> EncoderConfig:
    """``c`` with f32 compute, remat off and cast_sr off: what evaluation
    runs whatever the training knobs (lstc_vad_tpu/train/driver.py::
    _make_eval_encoder)."""
    return dataclasses.replace(c, compute_dtype="float32", remat=False,
                               cast_sr=False)


def _twin(module: nn.Module, cfg: EncoderConfig) -> nn.Module:
    twin = copy.copy(module)  # shares the parameter and buffer dicts
    twin._modules = type(module._modules)(
        (name, None if child is None else _twin(child, cfg))
        for name, child in module._modules.items())
    if "cfg" in vars(module):
        twin.cfg = cfg
    return twin


def eval_twin(encoder: "Encoder") -> "Encoder":
    """The f32, no-remat, no-SR twin of ``encoder``, holding the very same
    parameter and buffer tensors: a step's in-place update or a checkpoint
    load shows in both, and the twin allocates nothing.  ``encoder`` itself
    when it already has the evaluation knobs."""
    cfg = eval_config(encoder.cfg)
    if cfg == encoder.cfg:
        return encoder
    return _twin(encoder, cfg)


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
        self.tp = None  # the model axis, when laid out on a mesh
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
        table = self.relative_position_bias_table  # this rank's heads
        gathered = table[index.reshape(-1)]
        gathered = gathered.reshape(n_tok, n_tok, table.shape[1]).permute(
            2, 0, 1)
        return nn.functional.pad(gathered, (1, 0, 1, 0)).contiguous()

    def forward(self, x, mask=None, return_probs: bool = False,
                return_v: bool = False):
        """``return_probs``/``return_v`` mirror the reference's return_attn /
        return_attn_v plumbing: the attention map [B, H, L, L] and the V
        tensor [B, H, L, d_v] come back beside the output."""
        c = self.cfg
        tp = self.tp
        b, length, _ = x.shape
        dk, dv = c.d_k, c.d_v
        h = self.w_qs.weight.shape[0] // dk  # this rank's heads
        dt = compute_dtype(c)
        sr = sr_active(c, self.training)
        if not sr:
            # the SR arm keeps the activations between its casts as they are
            x = x.to(dt)
        residual = x
        xin = x if tp is None else tpc.copy_to_model(x, tp)
        # [B, H, L, D] views of the projections, no copies: the kernel reads
        # them strided and writes out as a view of a [B, L, H, D] buffer, so
        # the reshape below is a view too
        q = dense(self.w_qs, xin, dt, sr, tp).view(b, length, h, dk)
        k = dense(self.w_ks, xin, dt, sr, tp).view(b, length, h, dk)
        v = dense(self.w_vs, xin, dt, sr, tp).view(b, length, h, dv)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        dropout_p = c.attn_dropout if self.training else 0.0
        keep = None
        if dropout_p > 0.0 and tp is not None and tpc.sharded(tp):
            # drawn where plain_sdpa would draw it, at the global shape
            keep = tpc.dropout_noise((b, h, length, length), dropout_p,
                                     torch.float32, x.device, cols=tp,
                                     col_dim=1)
        out = sdpa(q, k, v, temperature=math.sqrt(dk),
                   bias=self.relative_bias(length), mask=mask,
                   dropout_p=dropout_p, impl=c.attn_impl,
                   return_probs=return_probs or return_v, dropout_mask=keep)
        probs = None
        if return_probs or return_v:
            out, probs = out
        out = out.transpose(1, 2).reshape(b, length, h * dv)
        out = tpc.dropout(self.fc_dropout,
                          dense(self.fc, out, dt, sr, tp, row=True)) \
            + residual
        if c.mha_layernorm:
            out = layer_norm(self.layer_norm, out,
                             torch.float32 if sr else dt)
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
        self.tp = None  # the model axis, when laid out on a mesh

    def reset_parameters(self, generator: torch.Generator):
        init.torch_linear_(self.w_1, generator, self.cfg.weight_init)
        init.torch_linear_(self.w_2, generator, self.cfg.weight_init)
        init.layer_norm_(self.layer_norm)

    def forward(self, x):
        c = self.cfg
        dt = compute_dtype(c)
        sr = sr_active(c, self.training)
        tp = self.tp
        residual = x
        if tp is not None:
            x = tpc.copy_to_model(x, tp)
        x = dense(self.w_2, torch.relu(dense(self.w_1, x, dt, sr, tp)), dt,
                  sr, tp, row=True)
        x = tpc.dropout(self.dropout, x) + residual
        if c.ffn_layernorm:
            x = layer_norm(self.layer_norm, x, torch.float32 if sr else dt)
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
        compute_dtype(cfg)
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
            # flax promotes a bf16 input with the f32 scale to f32
            x = layer_norm(self.layer_norm, x, torch.float32)
        if self.cls_token is not None:
            cls = self.cls_token.expand(x.shape[0], 1, c.d_model)
        else:
            cls = x.mean(dim=1, keepdim=True)
        x = torch.cat([cls, x], dim=1)
        if self.position_enc is not None:
            x = tpc.dropout(self.position_dropout,
                            x + self.position_enc[:, :x.shape[1]])
        probs_all, v_all = [], []
        # remat only where a gradient is taken: without one there is nothing
        # to recompute, and the math is the same either way
        remat = (c.remat and torch.is_grad_enabled()
                 and not (return_probs or return_v))
        for layer in self.layer_stack:
            if remat:
                x = checkpoint(layer, x, mask, use_reentrant=False,
                               context_fn=tpc.remat_contexts)
                continue
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
