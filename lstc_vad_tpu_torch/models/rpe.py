"""Relative position bias index tables (Swin-video style).

Reproduces the reference's buffer construction exactly
(models/MultiHeadAttention.py:55-74 for the 3-D variant over a
(window_depth, window_size, window_size) grid, :76-90 for the 2-D variant) —
computed once in numpy at module-construction time and registered as the
``relative_position_index`` buffer.  A copy of lstc_vad_tpu/models/rpe.py:
the tables are bit-equal to the JAX package's.

The bias is applied to attention logits at the non-CLS positions only
(attn[:, :, 1:, 1:] += bias; MultiHeadAttention.py:111), and the index table is
sliced [:L, :L] for sequences shorter than the full window
(indexed with len_q-1 at MultiHeadAttention.py:108), which selects the
top-left corner of the token grid — both reproduced in models/encoder.py.
"""

from __future__ import annotations

import numpy as np


def relative_position_index_3d(window_depth: int, window_size: int) -> np.ndarray:
    """[Wd*Ws*Ws, Wd*Ws*Ws] int32 indices into a bias table of size
    (2*Wd-1)*(2*Ws-1)^2."""
    d = np.arange(window_depth)
    h = np.arange(window_size)
    w = np.arange(window_size)
    grid = np.stack(np.meshgrid(d, h, w, indexing="ij"))      # [3, Wd, Ws, Ws]
    flat = grid.reshape(3, -1)                                 # [3, N]
    rel = flat[:, :, None] - flat[:, None, :]                  # [3, N, N]
    rel = rel.transpose(1, 2, 0).copy()                        # [N, N, 3]
    rel[:, :, 0] += window_depth - 1
    rel[:, :, 1] += window_size - 1
    rel[:, :, 2] += window_size - 1
    rel[:, :, 0] *= (2 * window_size - 1) * (2 * window_size - 1)
    rel[:, :, 1] *= 2 * window_size - 1
    return rel.sum(-1).astype(np.int32)


def relative_position_index_2d(window_size: int) -> np.ndarray:
    """[Ws*Ws, Ws*Ws] int32 indices into a bias table of size (2*Ws-1)^2."""
    h = np.arange(window_size)
    w = np.arange(window_size)
    grid = np.stack(np.meshgrid(h, w, indexing="ij"))
    flat = grid.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).copy()
    rel[:, :, 0] += window_size - 1
    rel[:, :, 1] += window_size - 1
    rel[:, :, 0] *= 2 * window_size - 1
    return rel.sum(-1).astype(np.int32)


def table_size_3d(window_depth: int, window_size: int) -> int:
    return (2 * window_depth - 1) * (2 * window_size - 1) * (2 * window_size - 1)


def table_size_2d(window_size: int) -> int:
    return (2 * window_size - 1) * (2 * window_size - 1)
