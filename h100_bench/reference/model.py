"""The plain reference of the LTN: encoder, classifier, loss, backward and
Adagrad, in plain PyTorch on f32 (TF32 off), written from the original
LSTC code (models/Encoder.py, models/EncoderLayer.py,
models/MultiHeadAttention.py, models/FFN.py, models/Classifier.py,
Train/temporal_transformer_shanghaitech.py).  It imports nothing of the
program and takes only the benchmark's weights and inputs; the relative
position index it works out itself.

Every product goes through ``mm``: ``matmul`` is the f32 reference;
``tf32_matmul`` is the control, the same sums on inputs rounded to TF32 (10
mantissa bits, to nearest even), as the card's TF32 tensor cores take them.

Dropout (training only) draws each mask with ``F.dropout`` from the default
generators, re-seeded each step from (run seed, step) as the program's
train step seeds them (lstc_vad_tpu_torch/train/steps.py::step_rng), in the
order the forward meets them: per layer the attention probabilities, the
attention's output projection, the FFN's output; then the head's two.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` rounded to TF32's 10 mantissa bits, to nearest even."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & -8192).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b on TF32-rounded inputs, forward and backward alike."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(to_tf32(a), to_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g32, a32, b32 = to_tf32(g), to_tf32(a), to_tf32(b)
        grad_a = torch.matmul(g32, b32.transpose(-1, -2))
        if b.dim() == 2 and a.dim() > 2:  # x @ W: sum over the batch dims
            grad_b = torch.matmul(a32.reshape(-1, a.shape[-1]).t(),
                                  g32.reshape(-1, g.shape[-1]))
        else:
            grad_b = torch.matmul(a32.transpose(-1, -2), g32)
        return grad_a, grad_b


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _TF32MatMul.apply(a, b)


def f32_exact() -> None:
    """Products in f32 on the card, never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rpe_index_3d(window_depth: int, window_size: int) -> np.ndarray:
    """The 3-D relative position index over a (Wd, Ws, Ws) grid
    (models/MultiHeadAttention.py:55-74)."""
    grid = np.stack(np.meshgrid(np.arange(window_depth),
                                np.arange(window_size),
                                np.arange(window_size), indexing="ij"))
    flat = grid.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += window_depth - 1
    rel[:, :, 1] += window_size - 1
    rel[:, :, 2] += window_size - 1
    rel[:, :, 0] *= (2 * window_size - 1) ** 2
    rel[:, :, 1] *= 2 * window_size - 1
    return rel.sum(-1)


class LTN:
    """Functional encoder + classifier over a weight dict
    {"encoder.<key>", "head.<key>"}; ``p`` holds the configuration's
    numbers under their dotted names."""

    # the settings this reference implements; any other is refused
    IMPLEMENTS = {"encoder.cls_learned": False,
                  "encoder.position_encoding": False,
                  "encoder.input_layernorm": False,
                  "encoder.ffn_need": True, "encoder.relative_pe_2d": False,
                  "encoder.compute_dtype": "float32",
                  "head.kind": "classifier"}

    def __init__(self, p: Dict[str, object], device):
        other = {k: p[k] for k, v in self.IMPLEMENTS.items() if p[k] != v}
        if other:
            raise NotImplementedError(f"the reference LTN has no {other}")
        self.p = p
        self.index = None
        if p["encoder.relative_pe"]:
            self.index = torch.as_tensor(rpe_index_3d(
                p["encoder.window_depth"], p["encoder.window_size"]),
                dtype=torch.long, device=device)

    def _bias(self, table: torch.Tensor, length: int) -> torch.Tensor:
        """[H, L, L] additive bias, zero at the CLS row and column, the
        index sliced to the part's token count (MultiHeadAttention.py:108)."""
        n = length - 1
        idx = self.index[:n, :n].reshape(-1)
        b = table[idx].reshape(n, n, -1).permute(2, 0, 1)
        out = table.new_zeros((b.shape[0], length, length))
        out[:, 1:, 1:] = b
        return out

    def encoder(self, W, x: torch.Tensor, mm: MatMul = matmul,
                train: bool = False) -> torch.Tensor:
        p = self.p
        h, dk, dv = p["encoder.n_head"], p["encoder.d_k"], p["encoder.d_v"]
        eps = p["encoder.layer_norm_eps"]
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        b, length, d = x.shape
        for i in range(p["encoder.n_layers"]):
            a = f"encoder.layer_stack.{i}.slf_attn."
            residual = x
            q = mm(x, W[a + "w_qs.weight"].t()).view(b, length, h, dk)
            k = mm(x, W[a + "w_ks.weight"].t()).view(b, length, h, dk)
            v = mm(x, W[a + "w_vs.weight"].t()).view(b, length, h, dv)
            q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            s = mm(q / math.sqrt(dk), k.transpose(-1, -2))
            if self.index is not None:
                s = s + self._bias(W[a + "relative_position_bias_table"],
                                   length)
            probs = torch.softmax(s, dim=-1)
            if train and p["encoder.attn_dropout"] > 0:
                probs = F.dropout(probs, p["encoder.attn_dropout"], True)
            o = mm(probs, v).transpose(1, 2).reshape(b, length, h * dv)
            o = mm(o, W[a + "fc.weight"].t())
            if train:
                o = F.dropout(o, p["encoder.fc_dropout"], True)
            x = o + residual
            if p["encoder.mha_layernorm"]:
                x = F.layer_norm(x, (d,), W[a + "layer_norm.weight"],
                                 W[a + "layer_norm.bias"], eps)
            f = f"encoder.layer_stack.{i}.pos_ffn."
            residual = x
            y = torch.relu(mm(x, W[f + "w_1.weight"].t()) + W[f + "w_1.bias"])
            y = mm(y, W[f + "w_2.weight"].t()) + W[f + "w_2.bias"]
            if train:
                y = F.dropout(y, p["encoder.ffn_dropout"], True)
            x = y + residual
            if p["encoder.ffn_layernorm"]:
                x = F.layer_norm(x, (d,), W[f + "layer_norm.weight"],
                                 W[f + "layer_norm.bias"], eps)
        return x

    def head(self, W, x: torch.Tensor, mm: MatMul = matmul,
             train: bool = False) -> torch.Tensor:
        """Classifier probabilities [N, 2] (the Softmax inside the module,
        models/Classifier.py)."""
        drop = self.p["head.dropout"]
        c = "head.classifier."
        x = torch.relu(mm(x, W[c + "0.weight"].t()) + W[c + "0.bias"])
        if train:
            x = F.dropout(x, drop, True)
        x = mm(x, W[c + "3.weight"].t()) + W[c + "3.bias"]
        if train:
            x = F.dropout(x, drop, True)
        x = mm(x, W[c + "5.weight"].t()) + W[c + "5.bias"]
        return torch.softmax(x, dim=-1)

    @torch.no_grad()
    def scores(self, W, tokens: torch.Tensor, mm: MatMul = matmul
               ) -> torch.Tensor:
        """P(abnormal) of each part [N, T, d]."""
        x = tokens.float()
        return self.head(W, self.encoder(W, x, mm)[:, 0, :], mm)[:, 1]


def ltn_loss(probs: torch.Tensor, batch: int, part_num: int, part_len: int,
             abnorm_labels: torch.Tensor, p: Dict[str, object]
             ) -> torch.Tensor:
    """MIL ranking + soft cross-entropy on the classifier's probabilities
    (Train/temporal_transformer_shanghaitech.py:21-36, 99-112): the video
    score is the max over its parts; the sparsity term averages the flat
    score vector from index ``batch`` on, as the original slices it; the
    cross-entropy applies log_softmax to the probabilities again; normal
    parts target (1, 0), abnormal ones (1 - m, m), m the part's mean clip
    label."""
    pa = probs[:, 1]
    video = pa.reshape(-1, part_num).amax(-1)
    nor, abn = video[:batch], video[batch:]
    err = torch.relu(1.0 - abn[None, :] + nor[:, None]).sum() / (batch ** 2)
    mil = err + p["loss.lambda_1"] * pa.reshape(-1)[batch:].mean()
    m = abnorm_labels.reshape(batch, part_num, part_len).mean(-1)
    target = torch.cat([
        torch.stack([torch.ones_like(m), torch.zeros_like(m)], -1),
        torch.stack([1.0 - m, m], -1)]).reshape(-1, 2)
    ce = (-(target * torch.log_softmax(probs, dim=-1)).sum(-1)).mean()
    return p["loss.lambda_mil"] * mil + p["loss.lambda_ce"] * ce


def step_seed(seed: int, step: int) -> int:
    """The seed of a step's dropout draws, as the program derives it."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def adagrad(W: Dict[str, torch.Tensor], grads: Dict[str, Optional[torch.Tensor]],
            acc: Dict[str, torch.Tensor], p: Dict[str, object]) -> None:
    """One Adagrad update in place (torch.optim.Adagrad's arithmetic with
    lr_decay 0): g += wd·w; acc += g²; w -= lr · g / (sqrt(acc) + eps); the
    encoder's leaves at ``optim.lr_encoder``, the head's at
    ``optim.lr_head``.  A leaf without a gradient is left alone."""
    wd, eps = p["optim.weight_decay"], p["optim.adagrad_eps"]
    for name, g in grads.items():
        if g is None:
            continue
        w = W[name]
        lr = p["optim.lr_head"] if name.startswith("head.") \
            else p["optim.lr_encoder"]
        g = g + wd * w
        acc[name] = acc[name] + g * g
        W[name] = w - lr * g / (acc[name].sqrt() + eps)

