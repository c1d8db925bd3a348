"""The ``--mesh auto`` factorization — a copy of
lstc_vad_tpu/parallel/mesh.py:29-44 (plain arithmetic).  The mesh it would
build, data parallel x tensor parallel, is ROADMAP A18."""

from __future__ import annotations

from typing import Tuple


def factor_devices(n: int, n_head: int = 8,
                   max_model: int = 4) -> Tuple[int, int]:
    """Split n devices into (data, model).  The model axis divides the head
    count (heads shard evenly) and is the largest power of 2 <= max_model
    that still leaves data >= 2 whenever n >= 4; the rest goes to data:
    4 -> (2, 2), 8 -> (2, 4), 16 -> (4, 4), 32 -> (8, 4)."""
    model = 1
    m = 2
    while m <= max_model and n % m == 0 and n_head % m == 0:
        if n // m >= 2 or n <= 2:
            model = m
        m *= 2
    return n // model, model
