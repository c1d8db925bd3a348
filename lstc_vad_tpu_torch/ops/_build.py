"""Build the package's native sources into shared libraries, at first use.

Each source under ``lstc_vad_tpu_torch/csrc`` is compiled into
``lstc_vad_tpu_torch/_build/lib<name>-<hash>.so`` and loaded with ctypes:
the CUDA kernels (``.cu``, one library per kernel source of the
attention and the Linear operators) by ``nvcc`` for ``sm_90a``, the host
C++ pack reader (``packstore.cpp``, data/packed.py) by ``g++``.  The hash
covers the source and the compiler flags (for a CUDA library every
``.cu`` / ``.cuh`` file of ``csrc``), so an edited source builds anew and a
stale library is never loaded.  The sources expose a plain C interface and include no PyTorch
header, which keeps a build to seconds.

Importing this module builds nothing and needs no compiler: the CPU tests
import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = {"attention": "attention.cu", "attention_bf16": "attention_bf16.cu",
           "attention_stream": "attention_stream.cu",
           "attention_stream_bf16": "attention_stream_bf16.cu",
           "gemm": "gemm.cu",
           "packstore": "packstore.cpp"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default prefix; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked at $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def _is_cuda(name: str) -> bool:
    return SOURCES[name].endswith(".cu")


def _digest(name: str) -> str:
    if _is_cuda(name):
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        files = [f for f in sorted(CSRC_DIR.iterdir())
                 if f.suffix in (".cu", ".cuh")]
    else:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        files = [CSRC_DIR / SOURCES[name]]
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _command(name: str, out: Path):
    src = str(CSRC_DIR / SOURCES[name])
    if _is_cuda(name):
        return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), src]
    return ["g++", *CXX_FLAGS, "-o", str(out), src]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source (all by default) whose library is missing,
    one compiler per source, all started together.  Returns {name: compiler
    output} for the sources it compiled (for a CUDA source ptxas reports
    registers and shared memory there).  Raises with the compiler's output
    if any build fails, or if a compiler is missing."""
    names = list(SOURCES) if names is None else list(names)
    jobs = []
    logs: Dict[str, str] = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = _command(name, tmp)
            try:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
            except OSError as e:
                raise RuntimeError(f"cannot run the compiler for {name} "
                                   f"({cmd[0]}): {e}") from e
            jobs.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in jobs:
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name} ({os.path.basename(proc.args[0])} "
                              f"exit {proc.returncode}):\n{logs[name]}")
            else:
                os.replace(tmp, out)  # atomic: a reader never sees half a .so
        if failed:
            raise RuntimeError("native build failed: " + "\n".join(failed))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
