"""What holds the attention kernel back: altered builds timed on the card.

    python3 scripts/torch_attention_ablation.py [--reps 3]

Builds lstc_vad_tpu_torch/csrc/attention.cu (the tiled f32 kernel, which
every shape below routes to) as it is and in altered copies
(one nvcc each, started together, into lstc_vad_tpu_torch/_build/ablation/),
then times each build through the package's wrapper at the main path's shape
(B=924, H=8, L=49, D=256, bias, q/k/v strided as the encoder passes them)
and at L=17, 81 and 128 (B=256), in turns, ``--reps`` times.  The altered
builds are diagnostics, and the ones marked so compute wrong values on
purpose (only times are compared here; chip_smoke.py checks the kernel):

- ``as_is``: the kernel.
- ``no_mma`` (wrong values): the three tensor-core products of each 3xTF32
  step replaced by a few ALU instructions on the same operands.
- ``one_mma`` (wrong values): only big·big, the cost of single-pass TF32.
- ``no_split`` (wrong values): operands passed to the tensor cores unsplit.
- ``chained``: each 3xTF32 step accumulated on the tensor core into the
  running sum, not summed from zero and added in IEEE f32.
- ``three_stages``: a third shared-memory buffer in the copy pipeline.
- ``four_blocks``: the register cap at 4 blocks an SM up to L=64, not 6.
- ``uncapped``: no register cap (ptxas's own choice).

It prints ptxas's registers and spills of each build, one JSON line per
build and shape (the mean ms of 20 calls per
repetition; for the builds that compute the function, also the largest
error against float64 at L=49 with q scaled by 1 and by 30, from
scripts/torch_attention_accuracy.py), then the SASS opcode counts of the
L=49 instantiation of the kernel as it is (cuobjdump, where the toolkit has
it).  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MMA3 = """  mma(p, a_small, b_big);
  mma(p, a_big, b_small);
  mma(p, a_big, b_big);"""
# build name -> (source substitutions, whether it computes the function)
ABLATIONS = {
    "as_is": ([], True),
    "no_mma": ([(MMA3, "\n".join(
        f"  p[{i}] = __uint_as_float(a_big[{i}] ^ b_big[{i % 2}])"
        f" + __uint_as_float(a_small[{i}] ^ b_small[{i % 2}]);"
        for i in range(4)))], False),
    "one_mma": ([(MMA3, """  mma(p, a_big, b_big);
  p[0] += __uint_as_float(a_small[0] ^ b_small[0]);""")], False),
    "no_split": ([("""  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));""", """  big = __float_as_uint(x);
  small = big;""")], False),
    "chained": ([("""  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma(p, a_small, b_big);
  mma(p, a_big, b_small);
  mma(p, a_big, b_big);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];""", """  mma(d, a_small, b_big);
  mma(d, a_big, b_small);
  mma(d, a_big, b_big);""")], True),
    "three_stages": ([("constexpr int kStages = 2;",
                       "constexpr int kStages = 3;")], True),
    "four_blocks": ([("NT <= 6 ? 4 : NT <= 8 ? 6 : 2)",
                      "NT <= 6 ? 4 : NT <= 8 ? 4 : 2)")], True),
    "uncapped": ([("""__launch_bounds__(block_threads<NT>(),
                                  NT <= 6 ? 4 : NT <= 8 ? 6 : 2)""",
                   "__launch_bounds__(block_threads<NT>())")], True),
}
SHAPES = [(924, 49), (256, 17), (256, 81), (256, 128)]


def build_all(out_dir: str):
    """({build: loaded library}, {build: nvcc's output})."""
    from lstc_vad_tpu_torch.ops import _build

    src = open(os.path.join(_build.CSRC_DIR, "attention.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (subs, _) in ABLATIONS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old.splitlines()[0]!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{logs[name]}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
    return libs, logs


def use(lib):
    """Point the package's wrapper at one build."""
    from lstc_vad_tpu_torch.ops import cuda_attention

    fn = lib.lstc_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.lstc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lstc_cuda_error_string.restype = ctypes.c_char_p
    cuda_attention._kernel = lambda dtype=None: (
        fn, lib.lstc_cuda_error_string)


def sass_histogram(so_path: str, n_tiles: int):
    from lstc_vad_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        if f"ILi{n_tiles}E" in func.split("\n", 1)[0]:
            ops = collections.Counter(
                m.group(1).split(".")[0] for m in re.finditer(
                    r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                    func))
            return dict(ops.most_common())
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_attention_ablation: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    import torch_attention_accuracy
    from lstc_vad_tpu_torch.ops import _build, cuda_attention
    from lstc_vad_tpu_torch.ops.cuda_attention import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    out_dir = os.path.join(_build.BUILD_DIR, "ablation")
    libs, logs = build_all(out_dir)
    for name, log in logs.items():  # registers and spills per key-tile count
        print(json.dumps({"build": name,
                          "ptxas": list(chip_smoke.ptxas_lines(log))}))
    dev = torch.device("cuda")
    times = collections.defaultdict(list)
    inputs = {}
    for b, length in SHAPES:  # as the encoder passes them
        g = torch.Generator(device=dev).manual_seed(b * 1000 + length)
        q, k, v = (torch.randn(b, length, chip_smoke.H, chip_smoke.D,
                               device=dev, generator=g).transpose(1, 2)
                   for _ in range(3))
        bias = torch.randn(chip_smoke.H, length, length, device=dev,
                           generator=g)
        # every shape is one the tiled f32 kernel takes, the one altered
        assert cuda_attention.route(q.dtype, length, chip_smoke.D,
                                    chip_smoke.D, True) == "f32"
        inputs[(b, length)] = (q, k, v, bias)
    for _ in range(args.reps):
        for name, lib in libs.items():
            use(lib)
            for shape, (q, k, v, bias) in inputs.items():
                times[(name, *shape)].append(chip_smoke.cuda_ms(
                    lambda: attention(q, k, v, bias, 16.0)))
    errors = {}
    for name, lib in libs.items():
        if ABLATIONS[name][1]:
            use(lib)
            errors[name] = {scale: torch_attention_accuracy.measure(
                49, scale)["kernel_max_abs_err"] for scale in (1, 30)}
    for (name, b, length), ms in times.items():
        print(json.dumps({"build": name, "B": b, "L": length, "ms": ms,
                          "computes_the_function": ABLATIONS[name][1],
                          "err_vs_f64_L49_by_q_scale": errors.get(name),
                          "card": card}))
    print(json.dumps({"sass_opcodes_L49": sass_histogram(
        os.path.join(out_dir, "as_is.so"), 7), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
