"""What holds the streaming attention kernels back: altered builds timed
on the card.

    python3 scripts/torch_stream_ablation.py [--reps 2] [--routes f32 bf16]

Builds lstc_vad_tpu_torch/csrc/attention_stream.cu (f32) and
csrc/attention_stream_bf16.cu (bf16) as they are and in altered copies (one
nvcc each, started together, into lstc_vad_tpu_torch/_build/ablation/), then
times each build through the package's wrapper (``stream_attention``) at
the streaming rows of chip_smoke.py's kernel phase: the main path's shape
forced (B=924, H=8, L=49, D=256), L=129 and 257 (B=256), L=1024 (B=64) and
config B's heads (B=924, H=4, d_k 512, d_v 384), all with bias and q, k, v
strided as the encoder passes them; builds in turns, ``--reps`` times.
The builds marked so compute wrong values on purpose (only times are
compared here; chip_smoke.py and the card tests check the kernels):

f32 (csrc/attention_stream.cu):
- ``as_is``: the kernel.
- ``no_mma`` (wrong values): the three tensor-core products of each 3xTF32
  step replaced by an ALU instruction on the same operands.
- ``k_cols_64``: K stages of 64 columns, not 128.
- ``three_stages``: the ring capped at 3 stages, not 6.
- ``two_blocks``: blocks of up to 8 warps sized so that two fit an SM,
  not one of up to 16.
- ``no_split`` (wrong values): operands passed to the tensor cores unsplit
  (the split's instructions gone, the three products kept).
- ``no_pv`` (wrong values): P·V's products skipped (its loads and splits
  kept).
- ``no_stage_sync`` (wrong values): no ``__syncthreads`` between stages
  (each thread still waits for its own copies).
- ``no_q_fill`` (wrong values): Q never loaded or split.
- ``no_s`` (wrong values): the Q·K^T loop of each K stage skipped (the
  stages still copied and waited for).
- ``no_pv_loop`` (wrong values): the P·V loop of each V stage skipped.
- ``no_exchange`` (wrong values): no barrier before the row group's warps
  add up their partial scores.
- ``no_store`` (wrong values): O never written.

bf16 (csrc/attention_stream_bf16.cu):
- ``as_is``: the kernel.
- ``keys_64``: past one key tile, tiles of 64 keys (one stage, two blocks
  an SM at d 256) where the kernel takes 32 (two stages, two blocks).
- ``one_block``: tiles of 64 keys in one block an SM with two stages.

It prints ptxas's registers and spills of each build, then one JSON line per
build and shape (the mean ms of 20 calls per repetition) and, for the
builds that compute the function, the largest error against plain_sdpa.

    python3 scripts/torch_stream_ablation.py --against-tiled [--reps 2]

times instead each streaming kernel as it is, forced through
``stream_attention``, against the tiled kernel of its type (the operator's
own route) at every model L up to 128 and the tile edges (B=256, and 924
at L=49; H=8, D=256, bias, strided), in turns: one JSON line per route and
L.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MMA3 = """  mma_tf32(p, a_small, b_big);
  mma_tf32(p, a_big, b_small);
  mma_tf32(p, a_big, b_big);"""
# route -> (source, entry, error-string function,
#           {build: (source substitutions, whether it computes the function)})
ABLATIONS = {
    "f32": ("attention_stream.cu", "lstc_attention_stream_fwd",
            "lstc_cuda_stream_error_string", {
                "as_is": ([], True),
                "no_mma": ([(MMA3, "\n".join(
                    f"  p[{i}] = __uint_as_float(a_big[{i}] ^ b_big[{i % 2}])"
                    f" + __uint_as_float(a_small[{i}] ^ b_small[{i % 2}]);"
                    for i in range(4)))], False),
                "k_cols_64": ([("constexpr int kKCols = 128;",
                                "constexpr int kKCols = 64;")], True),
                "three_stages": ([("kMinStages = 3, kMaxStages = 6;",
                                   "kMinStages = 3, kMaxStages = 3;")], True),
                "two_blocks": ([
                    ("constexpr int kMaxWarps = 16;",
                     "constexpr int kMaxWarps = 8;"),
                    ("constexpr int kMaxSmem = 232448;",
                     "constexpr int kMaxSmem = 114000;"),
                    ("__launch_bounds__(kMaxWarps * kWarp)",
                     "__launch_bounds__(kMaxWarps * kWarp, 2)")], True),
                "no_split": ([("""  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));""", """  big = __float_as_uint(x);
  small = big;""")], False),
                "no_pv": ([(
                    "                mma3(o[c][n], p_big[j], p_small[j], "
                    "b_big, b_small);",
                    "                o[c][n][0] += __uint_as_float("
                    "p_big[j][0] ^ b_big[0] ^ p_small[j][0] ^ b_small[1]);")],
                          False),
                "no_stage_sync": ([("""    cp_async_wait_older(S);
    __syncthreads();""", """    cp_async_wait_older(S);""")], False),
                "no_q_fill": ([(
                    "  fill_q(qsplit, 0, p.resident ? q_steps : k_steps);",
                    "")], False),
                "no_s": ([(
                    "        for (int kk = cg; kk < k_steps; kk += G) {",
                    "        for (int kk = cg; kk < k_steps * (L < 0); "
                    "kk += G) {")], False),
                "no_pv_loop": ([(
                    "            if (j < valid_nt) {\n              const "
                    "float* const vr",
                    "            if (j < valid_nt && L < 0) {\n              "
                    "const float* const vr")], False),
                "no_exchange": ([("""        __syncthreads();
        const float* const group""", """        const float* const group""")],
                                False),
                "no_store": ([(
                    "          if (c >= p.n_vc || row >= L || col >= p.dv) "
                    "continue;",
                    "          if (c >= p.n_vc || row >= L || col >= p.dv || "
                    "L > 0) continue;")], False),
            }),
    "bf16": ("attention_stream_bf16.cu", "lstc_attention_stream_bf16_fwd",
             "lstc_cuda_stream_bf16_error_string", {
                 "as_is": ([], True),
                 "keys_64": ([(
                     "const Layout layouts[] = {{32, 2, kPairSmem}, ",
                     "const Layout layouts[] = {")], True),
                 "one_block": ([(
                     "const Layout layouts[] = {{32, 2, kPairSmem}, ",
                     "const Layout layouts[] = {{64, 2, kMaxSmem}, ")],
                               True),
             }),
}
# (B, H, L, d_k, d_v)
SHAPES = [(924, 8, 49, 256, 256), (256, 8, 129, 256, 256),
          (256, 8, 257, 256, 256), (64, 8, 1024, 256, 256),
          (924, 4, 49, 512, 384)]


def build_all(out_dir: str, routes):
    """({(route, build): loaded library}, {(route, build): nvcc output})."""
    from lstc_vad_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for route in routes:
        source, _, _, builds = ABLATIONS[route]
        src = open(os.path.join(_build.CSRC_DIR, source)).read()
        for name, (subs, _) in builds.items():
            text = src
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"{route} {name}: the source no longer "
                                       f"holds {old.splitlines()[0]!r}")
                text = text.replace(old, new)
            cu = os.path.join(out_dir, f"{route}_{name}.cu")
            with open(cu, "w") as f:
                f.write(text)
            procs[route, name] = subprocess.Popen(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                 os.path.join(out_dir, f"{route}_{name}.so"), cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for key, proc in procs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{logs[key]}")
        libs[key] = ctypes.CDLL(os.path.join(out_dir, f"{key[0]}_{key[1]}.so"))
    return libs, logs


def use(route: str, lib):
    """Point the package's streaming launcher at one build of ``route``."""
    from lstc_vad_tpu_torch.ops import cuda_attention

    _, entry, errors, _ = ABLATIONS[route]
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 + [
        ctypes.c_uint, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, errors)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    cuda_attention._stream_kernel = lambda dtype: (fn, err)


def main(argv=None) -> int:
    import torch

    import chip_smoke
    from lstc_vad_tpu_torch.ops import _build, cuda_attention
    from lstc_vad_tpu_torch.ops.attention import plain_sdpa

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--routes", nargs="+", default=["f32", "bf16"],
                   choices=sorted(ABLATIONS))
    p.add_argument("--against-tiled", action="store_true",
                   help="time the streaming kernels against the tiled ones "
                        "at L <= 128 instead of the altered builds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_stream_ablation: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card)
    if args.against_tiled:
        return against_tiled(args.reps, card)
    libs, logs = build_all(os.path.join(_build.BUILD_DIR, "ablation"),
                           args.routes)
    for key, log in logs.items():
        for line in chip_smoke.ptxas_lines(log):
            print(f"  {key[0]} {key[1]}: {line}")
    dev = torch.device("cuda")
    original = cuda_attention._stream_kernel
    for route in args.routes:
        dtype = torch.float32 if route == "f32" else torch.bfloat16
        for b, h, length, d_k, d_v in SHAPES:
            g = torch.Generator(device=dev).manual_seed(length)
            q, k = (torch.randn(b, length, h, d_k, device=dev, generator=g)
                    .to(dtype).transpose(1, 2) for _ in range(2))
            v = torch.randn(b, length, h, d_v, device=dev,
                            generator=g).to(dtype).transpose(1, 2)
            bias = torch.randn(h, length, length, device=dev, generator=g)
            temp = float(d_k ** 0.5)
            ref = plain_sdpa(q, k, v, temp, bias=bias).float()
            times = {name: [] for name in ABLATIONS[route][3]}
            errs, refused = {}, {}
            for _ in range(args.reps):
                for name in times:
                    if name in refused:
                        continue
                    use(route, libs[route, name])
                    try:  # an altered build may find no geometry that fits
                        out = cuda_attention.stream_attention(q, k, v, bias,
                                                              temp)
                    except RuntimeError as e:
                        refused[name] = str(e)
                        continue
                    torch.cuda.synchronize()
                    if ABLATIONS[route][3][name][1]:
                        errs[name] = (out.float() - ref).abs().max().item()
                    times[name].append(chip_smoke.cuda_ms(
                        lambda: cuda_attention.stream_attention(
                            q, k, v, bias, temp)))
            cuda_attention._stream_kernel = original
            for name, ms in times.items():
                print(json.dumps({
                    "route": route, "build": name, "B": b, "H": h,
                    "L": length, "d_k": d_k, "d_v": d_v, "ms": ms,
                    "max_abs_err_vs_plain": errs.get(name),
                    "refused": refused.get(name), "card": card}), flush=True)
            del q, k, v, bias, ref
    return 0


def against_tiled(reps: int, card: str) -> int:
    """The streaming kernel of each route against the tiled one at every
    model L up to 128 (chip_smoke.LENGTHS)."""
    import torch

    import chip_smoke
    from lstc_vad_tpu_torch.ops import cuda_attention

    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for length in chip_smoke.LENGTHS:
            b = 924 if length == 49 else 256
            g = torch.Generator(device=dev).manual_seed(length)
            q, k, v = (torch.randn(b, length, 8, 256, device=dev, generator=g)
                       .to(dtype).transpose(1, 2) for _ in range(3))
            bias = torch.randn(8, length, length, device=dev, generator=g)
            fns = {"stream": cuda_attention.stream_attention,
                   "tiled": cuda_attention.attention}
            times = {name: [] for name in fns}
            for _ in range(reps):
                for name, fn in fns.items():
                    times[name].append(chip_smoke.cuda_ms(
                        lambda: fn(q, k, v, bias, 16.0)))
            print(json.dumps({"dtype": str(dtype).split(".")[-1], "B": b,
                              "H": 8, "L": length, "D": 256,
                              "stream_ms": times["stream"],
                              "tiled_ms": times["tiled"], "card": card}),
                  flush=True)
            del q, k, v, bias
    return 0


if __name__ == "__main__":
    sys.exit(main())
