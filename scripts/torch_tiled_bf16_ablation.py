"""What holds the tiled bf16 attention kernel back: altered builds, a copy
probe and the host's share, timed on the card.

    python3 scripts/torch_tiled_bf16_ablation.py [--reps 2]

Builds lstc_vad_tpu_torch/csrc/attention_bf16.cu as it is and in altered
copies (one nvcc each, started together, into
lstc_vad_tpu_torch/_build/ablation/), then times each build through the
package's operator at every L of chip_smoke.py's kernel phase (B=256) and at
the main path's shape (B=924, L=49), H=8, D=256, with bias, q, k, v strided
as the encoder passes them; builds in turns, ``--reps`` times.  The builds
marked so compute wrong values on purpose (only times are compared here;
chip_smoke.py and the card tests check the kernel):

- ``as_is``: the kernel.
- ``copy_probe`` (wrong values): the same persistent blocks, ring, TMA
  boxes and barriers, with no arithmetic: each tile's Q and K are waited
  for and released, and its V boxes are stored to out's map by TMA.  It
  reads exactly q, k, v and writes out: the floor the layout allows.
- ``no_products`` (wrong values): neither product issued (S and O zero).
- ``no_softmax`` (wrong values): S rounded to bf16 as P, with no mask,
  bias, exponential or division.
- ``no_store`` (wrong values): O never rounded, staged or stored.
- ``one_consumer``: one tile in flight a block at 64-row tiles (the second
  consumer warpgroup idle; the ring as it is: 2 stages at D = 256);
  ``one_consumer_1_stage``: the same with a ring of one stage.  (At
  128-row tiles both warpgroups take one tile in the kernel too, and the
  ring has one stage at D = 256.)

It prints ptxas's registers and spills of each build, then one JSON line per
build and shape (the mean ms of 20 calls per repetition, the bound and
the launch geometry) and, for the builds that compute the function, the
largest error against plain_sdpa.

    python3 scripts/torch_tiled_bf16_ablation.py --host [--lengths 17 33]

times instead, at each given L (B=256, H=8, D=256, bias, strided), each
tiled kernel (f32 and bf16 through the operator) and the bf16 streaming
kernel forced: the event time of back-to-back calls (as chip_smoke.py's
``cuda_ms`` takes it), the kernel's own device time under torch.profiler
(its CUDA time over its launches), and the host time of one call
(``perf_counter`` around 200 calls, no synchronise between them): where the
event time sits at the host time and above the device time, the row is
bound by each call's host overhead.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PROBE = """    {  // copy probe: no arithmetic
      mbar_wait(full_qk(s), ph);
      mbar_arrive(empty_qk(s));
      mbar_wait(full_v(s), ph);
      if (tid == 0) {
        for (int x = 0; x < DB; ++x)
          tma_store(&to, smem_u32(st + (2 * DB + x) * kBox + wg * kBoxBytes),
                    64 * x, NC == 1 ? 0 : 64 * wg, h0, b);
        bulk_commit();
        bulk_wait_read<0>();
      }
      wg_sync(wg);
      mbar_arrive(empty_v(s));
      continue;
    }
"""
S_PRODUCT = """          wgmma_ss(sc[kb], desc(qa + off, 16, 1024),
                   desc(ka + kb * kBoxBytes + off, 16, 1024), kk > 0);"""
PV_PRODUCT = """              wgmma_rs(o[j], pa[kk],
                       desc(va + (nb0 + j) * kBox + kk * 2048, kBox, 1024));"""
SOFTMAX_START = "    // + bias, the row softmax in f32, P rounded to bf16\n"
SOFTMAX_END = "    // P as bf16 pairs: the A fragment of 16-key step kk\n"


def replace(old: str, new: str):
    def edit(src: str) -> str:
        if src.count(old) != 1:
            raise RuntimeError(f"the source no longer holds "
                               f"{old.splitlines()[0]!r}")
        return src.replace(old, new)
    return edit


def cut_softmax(src: str) -> str:
    """S rounded to bf16 as P: the mask, bias, max, exponentials and sums
    cut out (the bias loads go with them); ``sum`` kept at 1."""
    i, j = src.index(SOFTMAX_START), src.index(SOFTMAX_END)
    return src[:i] + "    float sum[2] = {1.f, 1.f};\n" + src[j:]


def one_consumer(src: str) -> str:
    """One tile in flight a block at 64-row tiles: the second consumer
    warpgroup idle, the first taking every tile (the ring keeps its
    stages)."""
    src = replace("  constexpr int CG = 2 / NC;", "  constexpr int CG = 1;")(src)
    return replace("  const int group = wg / NC, wr = wg % NC;\n",
                   "  const int group = wg / NC, wr = wg % NC;\n"
                   "  if (group > 0) return;\n")(src)


# the ring cut to one stage (valid with one tile in flight)
one_stage = replace("  if (pl->nc == 1) pl->stages -= pl->stages % 2;",
                    "  pl->stages = 1;")
# build -> (source edits, whether it computes the function)
BUILDS = {
    "as_is": ([], True),
    "copy_probe": ([replace("    // this thread's rows r0 and r0 + 8 of the "
                            "tile", PROBE + "    // this thread's rows r0 "
                            "and r0 + 8 of the tile")], False),
    "no_products": ([replace(S_PRODUCT, "          (void)qa; (void)ka; "
                             "(void)off;"),
                     replace(PV_PRODUCT, "              (void)va;")], False),
    "no_softmax": ([cut_softmax], False),
    "no_store": ([replace("        if (nb0 + j < DB) store_block(o[j], nb0 + "
                          "j, b, h0);", "        if (nb0 + j < DB && L < 0) "
                          "store_block(o[j], nb0 + j, b, h0);")], False),
    "one_consumer": ([one_consumer], True),
    "one_consumer_1_stage": ([one_consumer, one_stage], True),
}
ENTRY, ERRORS = "lstc_attention_bf16_fwd", "lstc_cuda_bf16_error_string"


def altered(src: str, name: str) -> str:
    for edit in BUILDS[name][0]:
        src = edit(src)
    return src


def build_all(out_dir: str):
    """({build: loaded library}, {build: nvcc output})."""
    from lstc_vad_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(_build.CSRC_DIR, "attention_bf16.cu")).read()
    procs = {}
    for name in BUILDS:
        cu = os.path.join(out_dir, f"bf16_{name}.cu")
        with open(cu, "w") as f:
            f.write(altered(src, name))
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
             str(_build.CSRC_DIR), "-o",
             os.path.join(out_dir, f"bf16_{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{logs[name]}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"bf16_{name}.so"))
    return libs, logs


def use(lib, original):
    """Point the package's tiled bf16 launcher at one build."""
    import torch

    from lstc_vad_tpu_torch.ops import cuda_attention

    fn = getattr(lib, ENTRY)
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, ERRORS)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    cuda_attention._kernel = lambda dtype=torch.float32: (
        (fn, err) if dtype == torch.bfloat16 else original(dtype))


def inputs(b, length, dtype, dev, h=8, d=256):
    import torch

    g = torch.Generator(device=dev).manual_seed(length)
    q, k, v = (torch.randn(b, length, h, d, device=dev, generator=g)
               .to(dtype).transpose(1, 2) for _ in range(3))
    bias = torch.randn(h, length, length, device=dev, generator=g)
    return q, k, v, bias


def ablate(reps: int, card: str) -> int:
    import torch

    import chip_smoke
    from lstc_vad_tpu_torch.ops import _build, cuda_attention
    from lstc_vad_tpu_torch.ops.attention import plain_sdpa

    libs, logs = build_all(os.path.join(_build.BUILD_DIR, "ablation"))
    for name, log in logs.items():
        for line in chip_smoke.ptxas_lines(log):
            print(f"  {name}: {line}")
    dev = torch.device("cuda")
    original = cuda_attention._kernel
    shapes = [(256, n) for n in chip_smoke.LENGTHS] + [(924, 49)]
    for b, length in shapes:
        q, k, v, bias = inputs(b, length, torch.bfloat16, dev)
        ref = plain_sdpa(q, k, v, 16.0, bias=bias).float()
        times = {name: [] for name in BUILDS}
        errs = {}
        for _ in range(reps):
            for name in BUILDS:
                use(libs[name], original)
                out = cuda_attention.attention(q, k, v, bias, 16.0)
                torch.cuda.synchronize()
                if BUILDS[name][1]:
                    errs[name] = (out.float() - ref).abs().max().item()
                times[name].append(chip_smoke.cuda_ms(
                    lambda: cuda_attention.attention(q, k, v, bias, 16.0)))
        cuda_attention._kernel = original
        bound_ms, bound_by = chip_smoke.bound(b, length, True, 2)
        plan = cuda_attention.bf16_plan(length, 256)
        for name, ms in times.items():
            print(json.dumps({
                "build": name, "B": b, "H": 8, "L": length, "D": 256,
                "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "plan": plan, "max_abs_err_vs_plain": errs.get(name),
                "card": card}), flush=True)
        del q, k, v, bias, ref
    return 0


def host_share(lengths, card: str) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from lstc_vad_tpu_torch.ops import cuda_attention

    dev = torch.device("cuda")
    routes = {"f32": (torch.float32, cuda_attention.attention),
              "bf16": (torch.bfloat16, cuda_attention.attention),
              "bf16_stream": (torch.bfloat16,
                              cuda_attention.stream_attention)}
    for length in lengths:
        for name, (dtype, fn) in routes.items():
            q, k, v, bias = inputs(256, length, dtype, dev)

            def call():
                return fn(q, k, v, bias, 16.0)

            event_ms = chip_smoke.cuda_ms(call)
            n = 200
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            host_ms = (time.perf_counter() - t0) / n * 1e3
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            kernels = {e.key: (e.count, e.self_device_time_total / e.count)
                       for e in prof.key_averages()
                       if "attention" in e.key and "kernel" in e.key
                       and e.self_device_time_total > 0}
            print(json.dumps({
                "route": name, "B": 256, "H": 8, "L": length, "D": 256,
                "event_ms": event_ms, "host_ms_per_call": host_ms,
                "device_ms": {k: us / 1e3 for k, (_, us) in kernels.items()},
                "device_launches": {k: c for k, (c, _) in kernels.items()},
                "card": card}), flush=True)
            del q, k, v, bias
    return 0


def main(argv=None) -> int:
    import torch

    import chip_smoke

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--host", action="store_true",
                   help="device time against event and host time at short "
                        "L instead of the altered builds")
    p.add_argument("--lengths", type=int, nargs="+", default=[17, 33])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_tiled_bf16_ablation: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card)
    if args.host:
        return host_share(args.lengths, card)
    return ablate(args.reps, card)


if __name__ == "__main__":
    sys.exit(main())
