"""Inputs from the seed: the split of a traffic mix, and the weights.

One general generator reads a mix's ``split`` parameters:

- ``videos``, ``normal``: the split's size; the first ``normal`` keys are
  normal videos, the rest abnormal;
- ``clips``: {"normal": [low, high], "abnormal": [low, high]}, the range
  of clips a video of each class has.  Every seed gets the same multiset
  of lengths, spread evenly over each range, in an order drawn from the
  seed, so that two seeds do the same work;
- ``features``: "normal" (standard normal) or "uniform" ([0, 1), as
  non-negative I3D features are); features are made on the card with a
  ``torch.Generator`` seeded from the seed, in a few large calls, and
  copied once to host memory, where the program takes them;
- ``extra_frames``: [low, high], frames past the last whole clip
  (``n_frames = 16 * clips + extra``); absent means none;
- each abnormal video has one anomalous interval of frames, drawn from the
  seed.

The weights are made the same way, on the card, keyed by the reference
implementation's state_dict names (models/Encoder.py, models/Classifier.py
of the original LSTC code), which the program's modules load.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

SEGMENT_LEN = 16
# purposes of the seed's streams
WEIGHTS, FEATURES, LAYOUT, LABELS = range(4)
CHUNK_FLOATS = 1 << 27  # 512 MB of f32 a call on the card


def stream_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose of the run's seed."""
    return int(np.random.SeedSequence([seed, purpose]).generate_state(
        1, np.uint64)[0] >> 1)


@dataclasses.dataclass
class Split:
    keys: List[str]
    feats: List[np.ndarray]     # [clips, n_patch, d] f32, views of one array
    annos: List[np.ndarray]     # per-frame 0/1, float64
    abnormal: List[bool]
    n_frames: List[int]

    @property
    def clips(self) -> List[int]:
        return [f.shape[0] for f in self.feats]


def clip_counts(split: dict, seed: int) -> List[int]:
    """The clips of each video of ``split``: the normal videos' lengths
    spread evenly over ``clips["normal"]``, the abnormal ones' over
    ``clips["abnormal"]``, each class in an order drawn from ``seed``."""
    rng = np.random.default_rng(stream_seed(seed, LAYOUT))
    out = []
    for kind, n in (("normal", split["normal"]),
                    ("abnormal", split["videos"] - split["normal"])):
        low, high = split["clips"][kind]
        counts = [low + (i * (high - low + 1)) // n for i in range(n)]
        out += [counts[i] for i in rng.permutation(n)]
    return out


def _fill(host: np.ndarray, kind: str, seed: int, device) -> None:
    """``host`` filled with draws made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, FEATURES))
    flat = torch.from_numpy(host).view(-1)
    for start in range(0, flat.numel(), CHUNK_FLOATS):
        n = min(CHUNK_FLOATS, flat.numel() - start)
        if kind == "normal":
            chunk = torch.randn(n, generator=gen, device=device)
        elif kind == "uniform":
            chunk = torch.rand(n, generator=gen, device=device)
        else:
            raise ValueError(f"unknown feature kind {kind!r}")
        flat[start:start + n].copy_(chunk)
        del chunk


def make_split(split: dict, seed: int, n_patch: int, d: int,
               device) -> Split:
    n_normal = split["normal"]
    counts = clip_counts(split, seed)
    host = np.empty((sum(counts), n_patch, d), np.float32)
    _fill(host, split["features"], seed, device)
    rng = np.random.default_rng(stream_seed(seed, LABELS))
    extra = split.get("extra_frames")
    feats, annos, frames, abnormal, keys = [], [], [], [], []
    offset = 0
    for i, c in enumerate(counts):
        feats.append(host[offset:offset + c])
        offset += c
        n_fr = c * SEGMENT_LEN + (int(rng.integers(extra[0], extra[1] + 1))
                                  if extra else 0)
        anno = np.zeros(n_fr)
        is_abn = i >= n_normal
        if is_abn:
            start = int(rng.integers(0, n_fr // 2))
            stop = int(rng.integers(start + SEGMENT_LEN, n_fr + 1))
            anno[start:stop] = 1.0
        keys.append(f"{'abnormal' if is_abn else 'normal'}_{i:04d}")
        annos.append(anno)
        frames.append(n_fr)
        abnormal.append(is_abn)
    return Split(keys, feats, annos, abnormal, frames)


# ---------------------------------------------------------------- weights

def weight_layout(p: Dict[str, object]) -> Dict[str, List[tuple]]:
    """{"encoder": [(key, shape, kind, fan_in)], "head": [...]} of an LTN
    encoder and classifier with the numbers ``p``.  Kinds: "linear" (U(±1 /
    sqrt(fan_in)), nn.Linear's default, for weight and bias), "ln_weight"
    (1 + U(±0.1)), "ln_bias" (U(±0.1)), "rpe" (0.02 · N(0, 1), the
    original's trunc_normal(std=.02) whose bounds lie at ±100σ)."""
    d, h = p["encoder.d_model"], p["encoder.n_head"]
    dk, dv, di = p["encoder.d_k"], p["encoder.d_v"], p["encoder.d_inner"]
    enc = [("layer_norm.weight", (d,), "ln_weight", 0),
           ("layer_norm.bias", (d,), "ln_bias", 0)]
    if p["encoder.relative_pe"]:
        wd, ws = p["encoder.window_depth"], p["encoder.window_size"]
        table = (2 * wd - 1) * (2 * ws - 1) * (2 * ws - 1)
    for i in range(p["encoder.n_layers"]):
        a = f"layer_stack.{i}.slf_attn."
        f = f"layer_stack.{i}.pos_ffn."
        enc += [(a + "w_qs.weight", (h * dk, d), "linear", d),
                (a + "w_ks.weight", (h * dk, d), "linear", d),
                (a + "w_vs.weight", (h * dv, d), "linear", d),
                (a + "fc.weight", (d, h * dv), "linear", h * dv),
                (a + "layer_norm.weight", (d,), "ln_weight", 0),
                (a + "layer_norm.bias", (d,), "ln_bias", 0)]
        if p["encoder.relative_pe"]:
            enc.append((a + "relative_position_bias_table", (table, h),
                        "rpe", 0))
        enc += [(f + "w_1.weight", (di, d), "linear", d),
                (f + "w_1.bias", (di,), "linear", d),
                (f + "w_2.weight", (d, di), "linear", di),
                (f + "w_2.bias", (d,), "linear", di),
                (f + "layer_norm.weight", (d,), "ln_weight", 0),
                (f + "layer_norm.bias", (d,), "ln_bias", 0)]
    hd, hid = p["head.d_model"], p["head.hidden_dim"]
    name = p["head.kind"]
    n_out = 2 if name == "classifier" else 1
    head = []
    for idx, (fan_in, fan_out) in zip((0, 3, 5), ((hd, hid), (hid, 32),
                                                  (32, n_out))):
        head += [(f"{name}.{idx}.weight", (fan_out, fan_in), "linear", fan_in),
                 (f"{name}.{idx}.bias", (fan_out,), "linear", fan_in)]
    return {"encoder": enc, "head": head}


def make_weights(p: Dict[str, object], seed: int, device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The weights of ``weight_layout(p)`` on ``device``: one uniform draw
    and one normal draw for all of them, sliced and scaled."""
    layout = weight_layout(p)
    entries = layout["encoder"] + layout["head"]
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, WEIGHTS))
    n_uniform = sum(math.prod(s) for _, s, k, _ in entries if k != "rpe")
    n_normal = sum(math.prod(s) for _, s, k, _ in entries if k == "rpe")
    uni = torch.rand(n_uniform, generator=gen, device=device).mul_(2).sub_(1)
    nor = torch.randn(max(n_normal, 1), generator=gen, device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {"encoder": {}, "head": {}}
    iu = inor = 0
    for part, items in layout.items():
        for key, shape, kind, fan_in in items:
            n = math.prod(shape)
            if kind == "rpe":
                t = nor[inor:inor + n].view(shape) * 0.02
                inor += n
            else:
                t = uni[iu:iu + n].view(shape)
                iu += n
                if kind == "linear":
                    t = t * (1.0 / math.sqrt(fan_in))
                elif kind == "ln_weight":
                    t = 1.0 + 0.1 * t
                else:
                    t = 0.1 * t
            out[part][key] = t.contiguous()
    return out


def flat(weights: Dict[str, Dict[str, torch.Tensor]]
         ) -> Dict[str, torch.Tensor]:
    """{"encoder.<key>" | "head.<key>": tensor}."""
    return {f"{part}.{k}": v for part, d in weights.items()
            for k, v in d.items()}


def unused(p: Dict[str, object]) -> List[str]:
    """Leaves the configuration leaves out of the forward (registered, as
    the original registers them, but never read)."""
    out = []
    if not p["encoder.input_layernorm"]:
        out += ["encoder.layer_norm.weight", "encoder.layer_norm.bias"]
    if not p["encoder.mha_layernorm"]:
        out += [f"encoder.layer_stack.{i}.slf_attn.layer_norm.{w}"
                for i in range(p["encoder.n_layers"])
                for w in ("weight", "bias")]
    return out

