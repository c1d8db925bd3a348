"""Determinism: one seed fans out to every host generator and PyTorch's —
PyTorch counterpart of lstc_vad_tpu/utils/seeding.py.

The JAX package returns a PRNG key for its functional generators; here the
stateful default generators of torch (CPU and every CUDA device) are seeded
too, and a seeded ``torch.Generator`` is returned in the key's place for
code that draws from an explicit generator (model init, models.build).
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seeds(seed: int) -> torch.Generator:
    """Seed ``random``, ``PYTHONHASHSEED``, numpy's global generator and
    torch's default generators with ``seed``; return a CPU
    ``torch.Generator`` seeded with it."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
