"""Misc utilities — PyTorch counterpart of lstc_vad_tpu/utils/misc.py,
completing the reference's utils surface (utils/utils.py:12-23,118-131).

``resolve_dtype`` is the one lookup behind every wire-type knob
(``data.transfer_dtype`` for the training pipeline,
``data.eval_transfer_dtype`` for the scorers and the streaming server).
numpy has no bfloat16, and the JAX package reaches it through ml_dtypes,
which a machine with only PyTorch may lack: here the name resolves to a
torch dtype, and host buffers of that type are torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_dtype(name: str) -> torch.dtype:
    """The torch floating dtype a config string names ("float32",
    "bfloat16", "float16", ...); raises ValueError on anything else."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown floating dtype {name!r}; expected e.g. "
                         "'float32' or 'bfloat16'")
    return dtype


def random_perturb(v_len: int, num_segments: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Per-segment random index sampler (utils/utils.py:118-131): segment i
    picks a random index within [i*v_len/num_segments,
    (i+1)*v_len/num_segments]."""
    points = np.arange(num_segments) * v_len / num_segments
    out = np.empty(num_segments, dtype=int)
    for i in range(num_segments):
        lo = int(points[i])
        hi = int(points[i + 1]) if i < num_segments - 1 else v_len - 1
        out[i] = rng.integers(lo, hi + 1) if hi > lo else lo
    return out


def decode_and_patchify(frames, patch_per_height: int, patch_per_width: int):
    """JPEG-decode frames and split each into a grid of patches — how the
    reference's patch features were made offline (utils/utils.py:12-23).
    Needs cv2, imported here: nothing else in the package does."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("decode_and_patchify needs opencv-python") from e
    out = []
    for frame in frames:
        img = cv2.cvtColor(
            cv2.imdecode(np.frombuffer(frame, np.uint8), cv2.IMREAD_COLOR),
            cv2.COLOR_BGR2RGB)
        h = img.shape[0] // patch_per_height
        w = img.shape[1] // patch_per_width
        out.append([img[i * h:(i + 1) * h, j * w:(j + 1) * w]
                    for i in range(patch_per_height)
                    for j in range(patch_per_width)])
    return out
