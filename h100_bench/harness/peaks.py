"""The yardstick's arithmetic: the card's peaks, a model's FLOPs and an
attention call's least time.

Frozen copies, so that a change to the program cannot move them:

- ``flops_per_tokens``: lstc_vad_tpu_torch/benchmark.py::flops_per_tokens,
  reading the configuration's numbers from the benchmark's own file.
- the peaks and ``bound``: chip_smoke.py's ``HBM_BYTES_PER_S``,
  ``F32_FLOP_PER_S``, ``BF16_FLOP_PER_S`` and ``bound``.

Peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet, dense).  The f32
peak is the f32-accurate rate of 3xTF32, three TF32 tensor-core products
(495 TFLOP/s) for each f32 one: the non-tensor-core 67 TFLOP/s would be
passed by a path that moves its GEMMs onto 3xTF32, and the 989 TFLOP/s of
bf16 hides the headroom of an f32 path.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 495e12 / 3
BF16_FLOP_PER_S = 989e12
PEAK_FLOP_PER_S = {"float32": F32_FLOP_PER_S, "bfloat16": BF16_FLOP_PER_S}


def flops_per_tokens(p: dict, length: int) -> float:
    """Forward FLOPs of ONE ``length``-token sequence (CLS included) through
    the encoder and the head of the configuration numbers ``p`` (dotted
    names, as in a config file's ``program``): q, k, v and output
    projections, the two attention products, the FFN and the head's MLP, 2
    FLOPs a multiply-add; LayerNorm, softmax and bias terms left out."""
    d, h = p["encoder.d_model"], p["encoder.n_head"]
    dk, dv, di = p["encoder.d_k"], p["encoder.d_v"], p["encoder.d_inner"]
    L = length
    per_layer = (2 * L * d * h * (2 * dk + dv)
                 + 2 * h * L * L * (dk + dv)
                 + 2 * L * h * dv * d
                 + 2 * L * d * di * 2)
    hid = p["head.hidden_dim"]
    head = 2 * (d * hid + hid * 32 + 32 * 2)
    return float(p["encoder.n_layers"] * per_layer + head)


def bound(b: int, length: int, with_bias: bool, itemsize: int = 4,
          d_k: int = 256, d_v: int = 256, h: int = 8):
    """(least ms, "bytes" or "operations") of one attention call: q, k
    ([B, H, L, d_k]) and v read once, out ([B, H, L, d_v]) written once at
    ``itemsize`` bytes an element, the f32 bias [H, L, L] read once, over
    the memory rate; against the two products' 2·L²·(d_k + d_v) FLOP a
    (batch, head) pair over the tensor-core rate of the type."""
    n_bytes = (itemsize * b * h * length * (2 * d_k + 2 * d_v)
               + (4 * h * length * length if with_bias else 0))
    flops = 2 * b * h * length * length * (d_k + d_v)
    rate = F32_FLOP_PER_S if itemsize == 4 else BF16_FLOP_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
