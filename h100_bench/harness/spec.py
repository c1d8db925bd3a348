"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) resolves by name to:

- its configuration, the file that ``configs`` names for it;
- its traffic mix, ``h100_bench/traffic/<traffic>.json``, whose ``entry``
  names the program entry that drives it,
  ``h100_bench/entries/<entry>.py``;
- the limits of its output check, ``h100_bench/limits/<workload>.json``;
- its per-layer metrics, those of ``per_layer`` that list it, each read by
  ``h100_bench/metrics/<metric>.py``.

Adding a cell is adding such files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(MANIFEST)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, bench: dict = None) -> dict:
    """Everything a run of cell ``name`` reads: ``workload`` (its entry of
    ``workloads``), ``config`` (the configuration file's object),
    ``traffic``, ``limits``, ``end_to_end`` and ``per_layer`` (the metrics
    of the manifest that this cell reports)."""
    bench = bench or manifest()
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in {MANIFEST.name}; known: "
                       f"{sorted(workloads)}")
    w = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return {
        "workload": w,
        "config": load_json(ROOT / configs[w["config"]]["file"]),
        "traffic": load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(BENCH_DIR / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
    }


def entry(name: str):
    """The module ``h100_bench.entries.<name>``."""
    return importlib.import_module(f"h100_bench.entries.{name}")


def metric_reader(name: str):
    """The ``read`` function of ``h100_bench/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def files_of(name: str, bench: dict = None) -> List[Path]:
    """Every file that cell ``name`` resolves to (the manifest tests check
    that each exists)."""
    bench = bench or manifest()
    c = cell(name, bench)
    configs = {x["name"]: x for x in bench["configs"]}
    w = c["workload"]
    return ([ROOT / configs[w["config"]]["file"],
             BENCH_DIR / "traffic" / f"{w['traffic']}.json",
             BENCH_DIR / "entries" / f"{c['traffic']['entry']}.py",
             BENCH_DIR / "limits" / f"{name}.json"]
            + [BENCH_DIR / "metrics" / f"{m['name']}.py"
               for m in c["per_layer"]])

