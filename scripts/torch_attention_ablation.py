"""What holds the tiled f32 attention kernel back: altered builds and a copy
probe, timed on the card.

    python3 scripts/torch_attention_ablation.py [--reps 2]

Builds lstc_vad_tpu_torch/csrc/attention.cu (the tiled f32 kernel, which
every shape below routes to) as it is and in altered copies (one nvcc each,
started together, into lstc_vad_tpu_torch/_build/ablation/), then times each
build through the package's operator at the main path's shape (B=924, L=49)
and at L = 17, 49, 81 and 128 (B=256), H=8, D=256, with bias, q, k, v
strided as the encoder passes them; builds in turns, ``--reps`` times.  The
builds marked so compute wrong values on purpose (only times are compared
here; chip_smoke.py and the card tests check the kernel):

- ``as_is``: the kernel.
- ``copy_probe`` (wrong values): the same persistent blocks, rings, TMA
  boxes and barriers, with no arithmetic: each chunk is waited for and
  released, and each V box is stored to out's map by TMA.  It reads exactly
  q, k, v and writes out: the floor the layout allows.
- ``no_split`` (wrong values): the landed K and V chunks not split into
  their TF32 halves (the products read the split buffers as they are).
- ``no_products`` (wrong values): neither product issued.
- ``no_softmax`` (wrong values): S taken as P, with no mask, bias,
  exponential or division.
- ``one_tile_in_flight``, ``two_tiles_in_flight``: at 64-row tiles one
  consumer warpgroup takes every tile from one ring, the other two idle; or
  two consumer warpgroups, a ring each, in a block of 384 threads (the
  kernel has three; at 128-row tiles both consumer warpgroups take one tile
  in every build).

It prints ptxas's registers and spills of each build, then one JSON line per
build and shape (the mean ms of 20 calls per repetition, the bound and the
launch geometry) and, for the builds that compute the function, the largest
error against plain_sdpa.  Needs one CUDA card and nvcc.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_tiled_bf16_ablation import inputs, replace  # noqa: E402

PROBE = """    {  // copy probe: no arithmetic
      for (int x = 0; x < 2 * p.n_chunks; ++x, ++it) {
        const int s = it % S;
        const char* const st = ring + s * kStage;
        mbar_wait(full(rg, s), (it / S) & 1);
        if (x >= p.n_chunks && tid == 0) {
          tma_store(&to, smem_u32(st + wr * kOBox),
                    kCols * (x - p.n_chunks), 64 * wr, h0, b);
          bulk_commit();
          bulk_wait_read<0>();
        }
        wg_sync(wg);
        mbar_arrive(empty(rg, s));
      }
      continue;
    }
"""
S_ANCHOR = "    // S = (Q / temperature)·K^T over the chunks of D; sc[i] is row\n"
S_PRODUCTS = """        wgmma_tf32(acc[set], fs[set], at, 0);
        wgmma_tf32(acc[set], fb[set], at + (kBox >> 4), 1);
        wgmma_tf32(acc[set], fb[set], at, 1);"""
PV_PRODUCTS = """        wgmma_tf32(acc[set], ps[set], at, 0);
        wgmma_tf32(acc[set], pb[set], at + (kBox >> 4), 1);
        wgmma_tf32(acc[set], pb[set], at, 1);"""
SOFTMAX_START = "    // + bias, -inf where the key is past L or of another head; the row\n"
SOFTMAX_END = "    // O = P·V a 32-column chunk at a time, stored as each is done\n"


def cut_softmax(src: str) -> str:
    """S taken as P: the mask, bias, max, exponentials, sums and divisions
    cut out (the bias loads go with them)."""
    i, j = src.index(SOFTMAX_START), src.index(SOFTMAX_END)
    return src[:i] + src[j:]


def one_ring(src: str) -> str:
    """One tile in flight a block at 64-row tiles: one ring and one consumer
    warpgroup, the other two idle (the plan follows: up to 4 stages)."""
    src = replace("  static constexpr int RINGS = CW / NC;",
                  "  static constexpr int RINGS = NC == 1 ? 1 : CW / NC;")(src)
    return replace("  const int rg = NC == 1 ? wg : 0, wr = NC == 1 ? 0 : wg;\n",
                   "  const int rg = NC == 1 ? wg : 0, wr = NC == 1 ? 0 : wg;\n"
                   "  if (NC == 1 && wg > 0) return;\n")(src)


# build -> (source edits, whether it computes the function)
BUILDS = {
    "as_is": ([], True),
    "copy_probe": ([replace(S_ANCHOR, PROBE + S_ANCHOR)], False),
    "no_split": ([replace("      split_k<M, NK>(st + kBox, ks, split_tid);\n",
                          ""),
                  replace("      split_v<M, NK>(st, vs, split_tid);\n", "")],
                 False),
    "no_products": ([replace(S_PRODUCTS, "        (void)at;"),
                     replace(PV_PRODUCTS, "        (void)at;")], False),
    "no_softmax": ([cut_softmax], False),
    "one_tile_in_flight": ([one_ring], True),
    "two_tiles_in_flight": ([replace(
        "  static constexpr int CW = NC == 1 ? 3 : 2;",
        "  static constexpr int CW = 2;")], True),
}
SHAPES = [(924, 49), (256, 17), (256, 49), (256, 81), (256, 128)]


def build_all(out_dir: str, builds=BUILDS):
    """({build: loaded library}, {build: nvcc output}) of each of
    ``builds``."""
    from lstc_vad_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(_build.CSRC_DIR, "attention.cu")).read()
    procs = {}
    for name, (edits, _) in builds.items():
        text = src
        for edit in edits:
            text = edit(text)
        cu = os.path.join(out_dir, f"f32_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
             str(_build.CSRC_DIR), "-o",
             os.path.join(out_dir, f"f32_{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{logs[name]}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"f32_{name}.so"))
    return libs, logs


def use(lib, original):
    """Point the package's tiled f32 launcher at one build."""
    import torch

    from lstc_vad_tpu_torch.ops import cuda_attention

    fn = lib.lstc_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.lstc_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    cuda_attention._kernel = lambda dtype=torch.float32: (
        (fn, err) if dtype == torch.float32 else original(dtype))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_attention_ablation: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from lstc_vad_tpu_torch.ops import _build, cuda_attention
    from lstc_vad_tpu_torch.ops.attention import plain_sdpa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card)
    libs, logs = build_all(os.path.join(_build.BUILD_DIR, "ablation"))
    for name, log in logs.items():
        for line in chip_smoke.ptxas_lines(log):
            print(f"  {name}: {line}")
    dev = torch.device("cuda")
    original = cuda_attention._kernel
    for b, length in SHAPES:
        q, k, v, bias = inputs(b, length, torch.float32, dev)
        assert cuda_attention.route(q.dtype, length, 256, 256, True) == "f32"
        ref = plain_sdpa(q, k, v, 16.0, bias=bias)
        times = {name: [] for name in BUILDS}
        errs = {}
        for _ in range(args.reps):
            for name in BUILDS:
                use(libs[name], original)
                out = cuda_attention.attention(q, k, v, bias, 16.0)
                torch.cuda.synchronize()
                if BUILDS[name][1]:
                    errs[name] = (out - ref).abs().max().item()
                times[name].append(chip_smoke.cuda_ms(
                    lambda: cuda_attention.attention(q, k, v, bias, 16.0)))
        cuda_attention._kernel = original
        bound_ms, bound_by = chip_smoke.bound(b, length, True)
        plan = cuda_attention.f32_plan(length, 256)
        for name, ms in times.items():
            print(json.dumps({
                "build": name, "B": b, "H": 8, "L": length, "D": 256,
                "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "plan": plan, "max_abs_err_vs_plain": errs.get(name),
                "card": card}), flush=True)
        del q, k, v, bias, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
