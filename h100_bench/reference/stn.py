"""The plain reference of the STN: the LTN's encoder layers with no bias, the
sigmoid Regressor and the STN MIL loss, in plain PyTorch on f32 (TF32 off),
written from the original LSTC code (models/Encoder.py,
models/EncoderLayer.py, models/Regressor.py,
Train/spatio_transformer_shanghaitech.py:21-32 and 89-109).  It imports
nothing of the program; the backward is autograd's and the update
``model.adagrad``.

A sequence is one clip: the mean of its ``n_patch`` patch features in
front of them as the CLS token (17 tokens at 16 patches), through
``LTN.encoder`` (which applies no relative bias and no attention LayerNorm
where the configuration has none), its CLS output through the Regressor.

Dropout (training only) draws each mask with ``F.dropout`` in the order
the program's forward meets them, as reference/model.py documents: per
layer the attention probabilities, the attention's output projection, the
FFN's output; then the Regressor's two.  The whole batch runs at once, as
the program draws it (152,320 tokens at the cell's shape), so each mask is
drawn at the program's shape.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from h100_bench.reference.model import LTN, MatMul, matmul


class STN(LTN):
    """Functional encoder + Regressor over a weight dict
    {"encoder.<key>", "head.<key>"}."""

    IMPLEMENTS = dict(LTN.IMPLEMENTS, **{"head.kind": "regressor"})

    def head(self, W, x: torch.Tensor, mm: MatMul = matmul,
             train: bool = False) -> torch.Tensor:
        """Regressor scores [N] (models/Regressor.py: Linear, ReLU,
        Dropout, Linear, Dropout, Linear, Sigmoid: the second Linear has no
        activation before its dropout)."""
        drop = self.p["head.dropout"]
        r = "head.regressor."
        x = torch.relu(mm(x, W[r + "0.weight"].t()) + W[r + "0.bias"])
        if train:
            x = F.dropout(x, drop, True)
        x = mm(x, W[r + "3.weight"].t()) + W[r + "3.bias"]
        if train:
            x = F.dropout(x, drop, True)
        x = mm(x, W[r + "5.weight"].t()) + W[r + "5.bias"]
        return torch.sigmoid(x)[:, 0]

    def forward(self, W, clips: torch.Tensor, mm: MatMul = matmul,
                train: bool = False) -> torch.Tensor:
        """Scores [N] of clips [N, n_patch, d]."""
        return self.head(W, self.encoder(W, clips.float(), mm, train)
                         [:, 0, :], mm, train)


def stn_loss(scores: torch.Tensor, batch: int, part_num: int, part_len: int,
             p: Dict[str, object]) -> torch.Tensor:
    """The STN's MIL loss on clip scores [2B · pn · pl], the B normal
    videos first (Train/spatio_transformer_shanghaitech.py:21-32): a
    video's score is the max over its ``part_num`` parts of the mean over a
    part's ``part_len`` clips; the hinge relu(1 - abnormal + normal) summed
    over every (normal, abnormal) pair and divided by B²; plus lambda_1
    times the mean score of the abnormal videos' clips."""
    per_video = scores.reshape(2 * batch, part_num, part_len)
    video = per_video.mean(-1).amax(-1)
    nor, abn = video[:batch], video[batch:]
    hinge = torch.relu(1.0 - abn[None, :] + nor[:, None]).sum() / batch ** 2
    sparsity = per_video[batch:].mean()
    return hinge + p["loss.lambda_1"] * sparsity
