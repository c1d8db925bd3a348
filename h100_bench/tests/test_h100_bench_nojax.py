"""No JAX: a fresh interpreter that imports run.py and every file of the
benchmark, then drives a tiny run of each cell through the port, holds no
module whose top-level name is JAX's, one of its libraries' or the JAX
package's.  Names are compared whole: the port's name begins with the JAX
package's.  The reference brings in nothing of the port."""

import json
import subprocess
import sys

from h100_bench.harness import spec
from h100_bench.harness.window import FORBIDDEN

FILES = sorted(p for p in spec.BENCH_DIR.rglob("*.py")
               if "tests" not in p.parts)


def _fresh(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(spec.ROOT),
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_names_are_compared_whole():
    from h100_bench.harness.window import forbidden_modules

    assert "lstc_vad_tpu" in FORBIDDEN
    assert "lstc_vad_tpu_torch" not in forbidden_modules()


def test_no_jax_after_import_and_tiny_runs():
    files = [str(p.relative_to(spec.ROOT)) for p in FILES]
    code = f"""
import importlib, json, runpy, sys, time
sys.path.insert(0, {str(spec.ROOT)!r})
sys.path.insert(0, {str(spec.BENCH_DIR / 'tests')!r})
from h100_bench.harness import spec
for f in {files!r}:
    if f == 'h100_bench/run.py':
        runpy.run_path(f, run_name='h100_bench_run')
    elif f.startswith('h100_bench/metrics/'):
        spec.metric_reader(f.split('/')[-1][:-3])
    else:
        importlib.import_module(f[:-3].replace('/', '.')
                                .removesuffix('.__init__'))
from conftest import CELLS, tiny_cell
from h100_bench.harness.window import run
import io
for w in CELLS:
    run(w, 3, 0.05, False, 'cpu', time.perf_counter(), tiny_cell(w),
        log=io.StringIO())
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    top = set(_fresh(code))
    assert "lstc_vad_tpu_torch" in top  # the port did run
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    refs = sorted(str(p.relative_to(spec.ROOT))
                  for p in (spec.BENCH_DIR / "reference").glob("*.py"))
    code = f"""
import json, sys
sys.path.insert(0, {str(spec.ROOT)!r})
import importlib
for f in {refs!r}:
    importlib.import_module(f[:-3].replace('/', '.'))
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    top = set(_fresh(code))
    assert "h100_bench" in top
    assert not top & {"lstc_vad_tpu_torch", *FORBIDDEN}
