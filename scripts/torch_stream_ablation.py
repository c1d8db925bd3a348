"""What holds the streaming attention kernels back: altered builds timed
on the card.

    python3 scripts/torch_stream_ablation.py [--reps 2] [--routes f32 bf16]
        [--shapes 0 3] [--routes bf16 bf16_pr15 --parent-csrc DIR]

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
- ``copy_probe`` (wrong values): the same blocks, rings, TMA boxes and
  barriers with no arithmetic: the producers do not split, the consumers
  wait for and release every ring item and store O unscaled.  The floor
  the layout allows.
- ``no_products`` (wrong values): no wgmma issued (S and O stay zero).
- ``no_s`` / ``no_pv`` (wrong values): Q·K^T's, or P·V's, wgmma only cut.
- ``no_softmax`` (wrong values): S split as P, with no mask, bias,
  exponential, sum or rescale of O.
- ``no_split`` (wrong values): the producers leave the ready slots as they
  are (no split of K and V, no transpose of V): what the split costs, and
  what a prologue kernel writing the halves to scratch (option b) would
  save inside this kernel.
- ``one_stage``: the rings at their least: 2 ready slots (4 where Q goes
  through them) and 1 landing zone.
- ``no_bias`` (wrong values): the bias never read.

bf16 (csrc/attention_stream_bf16.cu):
- ``as_is``: the kernel.
- ``no_bias``: the same build called without the bias (no bias stage).
- ``no_phase0`` (wrong values): the statistics phase cut (its second
  Q·K^T, K and bias traffic); phase 1 then runs on m = -inf, l = 0.
- ``no_softmax`` (wrong values): the statistics and P formed from S as it
  is (no bias, max, exponential, sum or reciprocal).
- ``no_products`` (wrong values): no wgmma issued.
- ``no_pingpong``: the consumer warpgroups' turns to issue wgmma cut.
- ``softmax_ieee``: expf and a division for every probability in place of
  ex2 with log2 e folded and one reciprocal of l a row.
- ``bias_rows``: the bias by a bulk copy a row at every L (TMA cut).
- ``no_l2_hint``: the bias's evict_last and Q's evict_first L2 policies
  replaced by evict_normal.
- ``one_stage``: every ring at one stage.

bf16_pr15 (the bf16 kernel as PR 15 left it, built from ``--parent-csrc``,
the csrc directory of a ``git archive`` of the parent commit, so that both
designs are timed in one call): ``as_is``, ``no_bias``, ``no_phase0``,
``no_softmax``, ``no_products`` as above, and its layouts ``keys_64``
(past one key tile, tiles of 64 keys, one stage, two blocks an SM at d
256, where it takes 32) and ``one_block`` (tiles of 64 keys in one block an
SM with two stages).

It prints ptxas's registers and spills of each build, then one JSON line per
build and shape (the mean ms of 20 calls per repetition) and, for the
builds that compute the function, the largest error against plain_sdpa
(without the bias for ``no_bias``).  ``--shapes`` picks rows of SHAPES by
index.

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
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

S_PRODUCT = """          wgmma_tf32(acc[set], fs[set], at, 0);
          wgmma_tf32(acc[set], fb[set], at + (kHalf >> 4), 1);
          wgmma_tf32(acc[set], fb[set], at, 1);
"""
PV_PRODUCT = """          wgmma_tf32(o[c], ps[j], vd, 1);
          wgmma_tf32(o[c], pb[j], vd + (kHalf >> 4), 1);
          wgmma_tf32(o[c], pb[j], vd, 1);
"""
PREPARE = """      prepare(kind, land, ready + slot * kSlot, n_boxes, p.inv_temp, pt);
"""
TILE = """      const int key0 = tile * kKeys;
"""
# the consumers wait for and release every ring item of the tile, with no
# arithmetic (O is stored unscaled)
PROBE = TILE + """      {  // copy probe
        const int n = (p.resident ? p.n_kc : 2 * p.n_kc) + nv;
        for (int x = it; x < it + n; ++x) {
          mbar_wait(ready_full(x % p.ready), (x / p.ready) & 1);
          mbar_arrive(ready_empty(x % p.ready));
        }
        it += n;
        continue;
      }
"""
SOFTMAX_START = "      float mx[2] = {-INFINITY, -INFINITY};\n"
SOFTMAX_END = "      // O += P·V, a V^T chunk of 128 columns a slot."


def cut_softmax(src: str) -> str:
    """S split as P: the mask, bias, max, exponentials and sums cut out; O
    scaled by 1 and l kept at 1."""
    i, j = src.index(SOFTMAX_START), src.index(SOFTMAX_END)
    return (src[:i] + "      const float alpha[2] = {1.f, 1.f};\n"
            "      l[0] = l[1] = 1.f;\n" + src[j:])


# the bf16 kernel's anchors
BF16_FOLD = ("  __device__ __forceinline__ void fold(const float (&s)[32], "
             "const Bias& bias) {")
BF16_PROBS = ("pa[kk][x] = pack_bf16(prob(s[i] + b.x, r), "
              "prob(s[i + 1] + b.y, r));")
BF16_PROBS_F32 = ("e[i] = prob(s[i] + b.x, (i >> 1) & 1);\n"
                  "      e[i + 1] = prob(s[i + 1] + b.y, (i >> 1) & 1);")
BF16_EXP = "return ex2(fmaf(x, kLog2e, -bl));"
BF16_PROB = "return exp_at(x, base[r], bl[r]) * rl[r];"
BF16_BIAS_MODE = ("  if (bias && L % 4 == 0 && reinterpret_cast<uintptr_t>(bias) "
                  "% 16 == 0) {")
BF16_BIAS_POLICY = ("__device__ __forceinline__ uint64_t bias_policy() "
                    "{ return l2_evict_last(); }")
BF16_Q_POLICY = ("__device__ __forceinline__ uint64_t q_policy() "
                 "{ return l2_evict_first(); }")
BF16_TURN_WAIT = "auto turn_wait = [&] { named_sync(kTurn + wg, 2 * kWG); };"
BF16_TURN_PASS = ("auto turn_pass = [&] { named_arrive(kTurn + 1 - wg, "
                  "2 * kWG); };")
BF16_STAGES = ("static const int kStages[4][3] = {{2, 2, 2}, {2, 2, 1}, "
               "{2, 1, 1}, {1, 1, 1}};")


def cut_wgmma(src: str) -> str:
    """Every wgmma of the kernel's source cut (S and O stay as set)."""
    out, n = re.subn(r"wgmma_(?:ss_mn|ss|rs)\([^;]*\);", ";", src)
    if not n:
        raise RuntimeError("the source no longer holds a wgmma call")
    return out


# the PR 15 bf16 kernel's anchors
P15_PHASES = "for (int phase = n_tiles > 1 ? 0 : 1; phase < 2; ++phase)"
P15_PHASES_1 = "for (int phase = 1; phase < 2; ++phase)"
P15_FIRST = "const int first_phase = n_tiles > 1 ? 0 : 1;"
P15_FIRST_1 = "const int first_phase = 1;"
P15_S = """            wgmma_ss(sc, desc(qa + (kk >> 2) * kBoxBytes + off, 16, 1024),
                     desc(ka + (kk >> 2) * kKVBox + off, 16, 1024),
                     c > 0 || kk > 0);
"""
P15_PV = """            wgmma_rs(o[nb], pa[kk],
                     desc(va + nb * kKVBox + kk * 2048, kKVBox, 1024));
"""
P15_LAYOUTS = "const Layout layouts[] = {{32, 2, kPairSmem}, "
P15_SOFTMAX_START = "        // + bias, -inf past L; each row's max over the tile\n"
P15_SOFTMAX_END = "        const uint32_t va = smem_u32(ring + s * p.stage_bytes"


def p15_cut_softmax(src: str) -> str:
    """S packed as P: the mask, bias, max, exponentials, sums and division
    cut out; phase 0 only releases its stage."""
    i, j = src.index(P15_SOFTMAX_START), src.index(P15_SOFTMAX_END)
    return (src[:i] + """        if (phase == 0) {
          mbar_arrive(empty(s));
          continue;
        }
        constexpr int kSteps = KEYS / 16;
        uint32_t pa[kSteps][4];
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
""" + src[j:])


# route -> (source, entry, error-string function,
#           {build: (source edits, whether it computes the function)});
# an edit is an (old, new) pair, replaced once, or a function of the text
ABLATIONS = {
    "f32": ("attention_stream.cu", "lstc_attention_stream_fwd",
            "lstc_cuda_stream_error_string", {
                "as_is": ([], True),
                "copy_probe": ([(PREPARE, ""), (TILE, PROBE)], False),
                "no_products": ([(S_PRODUCT, ""), (PV_PRODUCT, "")], False),
                "no_s": ([(S_PRODUCT, "")], False),
                "no_pv": ([(PV_PRODUCT, "")], False),
                "no_softmax": ([cut_softmax], False),
                "no_split": ([(PREPARE, "")], False),
                "one_stage": ([
                    ("  p.ready = min(p.resident ? 4 : kMaxReady,",
                     "  p.ready = min(min_ready,"),
                    ("  p.land = min(kMaxLand,", "  p.land = min(1,")], True),
                "no_bias": ([("bv[i] = bias && row < L && key < L",
                              "bv[i] = false && row < L && key < L")],
                            False),
            }),
    "bf16": ("attention_stream_bf16.cu", "lstc_attention_stream_bf16_fwd",
             "lstc_cuda_stream_bf16_error_string", {
                 "as_is": ([], True),
                 "no_bias": (None, True),
                 "no_phase0": ([("p.stats_phase = p.n_tiles > 1;",
                                 "p.stats_phase = 0;")], False),
                 "no_softmax": ([(BF16_FOLD, BF16_FOLD + "\n    return;"),
                                 (BF16_PROBS,
                                  "pa[kk][x] = pack_bf16(s[i], s[i + 1]);"),
                                 (BF16_PROBS_F32, "e[i] = s[i];\n"
                                  "      e[i + 1] = s[i + 1];")], False),
                 "no_products": ([cut_wgmma], False),
                 "no_pingpong": ([(BF16_TURN_WAIT,
                                   "auto turn_wait = [&] {};"),
                                  (BF16_TURN_PASS,
                                   "auto turn_pass = [&] {};")], True),
                 "softmax_ieee": ([(BF16_EXP, "return expf(x - base);"),
                                   (BF16_PROB, "return expf(x - base[r]) / "
                                    "l[r];")], True),
                 "bias_rows": ([(BF16_BIAS_MODE, BF16_BIAS_MODE.replace(
                     "if (bias &&", "if (false &&"))], True),
                 "no_l2_hint": ([(BF16_BIAS_POLICY, BF16_BIAS_POLICY.replace(
                     "l2_evict_last", "l2_evict_normal")),
                                 (BF16_Q_POLICY, BF16_Q_POLICY.replace(
                                     "l2_evict_first", "l2_evict_normal"))],
                                True),
                 "one_stage": ([(BF16_STAGES, "static const int kStages[4][3]"
                                 " = {{1, 1, 1}, {1, 1, 1}, {1, 1, 1}, "
                                 "{1, 1, 1}};")], True),
             }),
    # the bf16 kernel as PR 15 left it (PR 10's design), built from
    # --parent-csrc: what its time is made of, beside the rebuilt kernel's
    "bf16_pr15": ("attention_stream_bf16.cu",
                  "lstc_attention_stream_bf16_fwd",
                  "lstc_cuda_stream_bf16_error_string", {
                      "as_is": ([], True),
                      "no_phase0": ([(P15_PHASES, P15_PHASES_1),
                                     (P15_FIRST, P15_FIRST_1)], False),
                      "no_bias": (None, True),
                      "no_softmax": ([p15_cut_softmax], False),
                      "no_products": ([(P15_S, ""), (P15_PV, ";\n")],
                                      False),
                      "keys_64": ([(P15_LAYOUTS,
                                    "const Layout layouts[] = {")], True),
                      "one_block": ([(P15_LAYOUTS,
                                      "const Layout layouts[] = "
                                      "{{64, 2, kMaxSmem}, ")], True),
                  }),
}
# (B, H, L, d_k, d_v)
SHAPES = [(924, 8, 49, 256, 256), (256, 8, 129, 256, 256),
          (256, 8, 257, 256, 256), (64, 8, 1024, 256, 256),
          (924, 4, 49, 512, 384)]


def build_all(out_dir: str, routes, parent_csrc=None):
    """({(route, build): loaded library}, {(route, build): nvcc output}).
    The ``bf16_pr15`` route's sources (and their hopper.cuh) come from
    ``parent_csrc``, every other route's from the package."""
    from lstc_vad_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for route in routes:
        source, _, _, builds = ABLATIONS[route]
        csrc = str(_build.CSRC_DIR)
        if route == "bf16_pr15":
            if not parent_csrc:
                raise SystemExit("the bf16_pr15 route needs --parent-csrc")
            csrc = os.path.abspath(parent_csrc)
        src = open(os.path.join(csrc, source)).read()
        for name, (edits, _) in builds.items():
            if edits is None:  # the as_is build, called without the bias
                continue
            text = src
            for edit in edits:
                if callable(edit):
                    text = edit(text)
                    continue
                old, new = edit
                if text.count(old) != 1:
                    raise RuntimeError(f"{route} {name}: the source no longer "
                                       f"holds {old.splitlines()[0]!r}")
                text = text.replace(old, new)
            cu = os.path.join(out_dir, f"{route}_{name}.cu")
            with open(cu, "w") as f:
                f.write(text)
            procs[route, name] = subprocess.Popen(
                [_build.find_nvcc(), *_build.NVCC_FLAGS,
                 "-I", csrc, "-o",
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
    p.add_argument("--parent-csrc", default=None,
                   help="the csrc directory of the parent's checkout (a git "
                        "archive), for the bf16_pr15 route")
    p.add_argument("--shapes", nargs="+", type=int, default=None,
                   help="indices into SHAPES (default: all)")
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
                           args.routes, args.parent_csrc)
    for key, log in logs.items():
        for line in chip_smoke.ptxas_lines(log):
            print(f"  {key[0]} {key[1]}: {line}")
    dev = torch.device("cuda")
    original = cuda_attention._stream_kernel
    for route in args.routes:
        dtype = torch.float32 if route == "f32" else torch.bfloat16
        shapes = (SHAPES if args.shapes is None
                  else [SHAPES[i] for i in args.shapes])
        for b, h, length, d_k, d_v in shapes:
            g = torch.Generator(device=dev).manual_seed(length)
            q, k = (torch.randn(b, length, h, d_k, device=dev, generator=g)
                    .to(dtype).transpose(1, 2) for _ in range(2))
            v = torch.randn(b, length, h, d_v, device=dev,
                            generator=g).to(dtype).transpose(1, 2)
            bias = torch.randn(h, length, length, device=dev, generator=g)
            temp = float(d_k ** 0.5)
            ref = plain_sdpa(q, k, v, temp, bias=bias).float()
            ref_no_bias = plain_sdpa(q, k, v, temp).float()
            times = {name: [] for name in ABLATIONS[route][3]}
            errs, refused = {}, {}
            for _ in range(args.reps):
                for name in times:
                    if name in refused:
                        continue
                    edits, computes = ABLATIONS[route][3][name]
                    use(route, libs[route, "as_is" if edits is None
                                    else name])
                    b_in = None if edits is None else bias
                    try:  # an altered build may find no geometry that fits
                        out = cuda_attention.stream_attention(q, k, v, b_in,
                                                              temp)
                    except RuntimeError as e:
                        refused[name] = str(e)
                        continue
                    torch.cuda.synchronize()
                    if computes:
                        want = ref if b_in is not None else ref_no_bias
                        errs[name] = (out.float() - want).abs().max().item()
                    times[name].append(chip_smoke.cuda_ms(
                        lambda: cuda_attention.stream_attention(
                            q, k, v, b_in, temp)))
            cuda_attention._stream_kernel = original
            for name, ms in times.items():
                print(json.dumps({
                    "route": route, "build": name, "B": b, "H": h,
                    "L": length, "d_k": d_k, "d_v": d_v, "ms": ms,
                    "max_abs_err_vs_plain": errs.get(name),
                    "refused": refused.get(name), "card": card}), flush=True)
            del q, k, v, bias, ref, ref_no_bias
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
