"""Accuracy of the attention kernel against exact arithmetic, on the card.

    python3 scripts/torch_attention_accuracy.py [--scales 1 5 30] \
        [--lengths 10 49 81 129 257] [--d-v 256] [--stream]

For each sequence length and each factor by which q is scaled (the logits
grow with it: at 30 they reach about ±100, past expf's overflow at 88.7), it
draws q, k [4, 8, L, 256], v [4, 8, L, d_v] and a bias [8, L, L] from a
seeded generator and computes the attention three ways on the card: the
hand-written kernel the shape routes to (csrc/attention.cu up to L=128 at
d_v 256, csrc/attention_stream.cu past it or at another d_v, or at every
shape with ``--stream``; 3xTF32 on the tensor cores), the plain version
(ops/attention.py::plain_sdpa, cuBLAS f32 with TF32 off), and the same plain
version in float64 as the exact answer.  It prints one JSON line per case:
the largest absolute error of the kernel and of the plain f32 version
against float64, the largest excess of each over rtol 1e-4 / atol 1e-5, and
the largest difference between kernel and plain f32.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RTOL, ATOL = 1e-4, 1e-5


def measure(length: int, scale: float, seed: int = 0, d_v: int = 256,
            stream: bool = False) -> dict:
    import torch

    from lstc_vad_tpu_torch.ops import cuda_attention
    from lstc_vad_tpu_torch.ops.attention import plain_sdpa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed * 1000 + length)
    q, k = (torch.randn(4, 8, length, 256, device=dev, generator=g)
            for _ in range(2))
    v = torch.randn(4, 8, length, d_v, device=dev, generator=g)
    q = q * scale
    bias = torch.randn(8, length, length, device=dev, generator=g)
    exact = plain_sdpa(q.double(), k.double(), v.double(), 16.0,
                       bias=bias.double())
    kernel = (cuda_attention.stream_attention if stream
              else cuda_attention.attention)
    cuda_attention.reset_launches()
    out = {"kernel": kernel(q, k, v, bias, 16.0),
           "plain_f32": plain_sdpa(q, k, v, 16.0, bias=bias)}
    route, = (r for r, n in cuda_attention.by_route.items() if n)
    row = {"L": length, "d_v": d_v, "route": route, "q_scale": scale,
           "max_abs_logit": (torch.matmul(q.double() / 16.0,
                                          k.double().transpose(-1, -2))
                             + bias.double()).abs().max().item()}
    for name, x in out.items():
        err = (x.double() - exact).abs()
        row[f"{name}_max_abs_err"] = err.max().item()
        excess = err - (ATOL + RTOL * exact.abs())
        row[f"{name}_excess"] = excess.max().item()
    diff = out["kernel"] - out["plain_f32"]
    row["kernel_vs_plain_f32"] = diff.abs().max().item()
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scales", type=float, nargs="+", default=[1, 5, 30])
    p.add_argument("--lengths", type=int, nargs="+",
                   default=[10, 49, 81, 129, 257])
    p.add_argument("--d-v", type=int, default=256)
    p.add_argument("--stream", action="store_true",
                   help="the streaming kernel at every shape")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_attention_accuracy: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke

    card = chip_smoke.card_line()
    for length in args.lengths:
        for scale in args.scales:
            print(json.dumps({**measure(length, scale, d_v=args.d_v,
                                        stream=args.stream),
                              "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
