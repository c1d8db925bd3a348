"""BENCHMARK.json keeps to its contract, and every cell resolves by name to
its config, traffic, entry, limits and metric files."""

import json
import re

import pytest

from h100_bench.harness import spec

BENCH = spec.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_KEYS = {"why", "layer", "source"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|inner|latent|state|proj|head|"
                   r"expan|d_model|d_k|d_v|experts_per")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[part]:
            extra = set(e) - KEYS[part] - {"workloads"}
            assert not extra and KEYS[part] <= set(e), (part, e["name"])
            assert NAME.match(e["name"])
            for k in TEXT_KEYS & set(e):
                assert _text(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"])
            if "better" in e:
                assert e["better"] in ("lower", "higher")
        names = [e["name"] for e in BENCH[part]]
        assert len(names) == len(set(names))
    assert len({e["name"] for e in BENCH["end_to_end"]}
               & {e["name"] for e in BENCH["per_layer"]}) == 0


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
        assert body["dtype"] in ("float32", "bfloat16")


def test_workloads():
    assert 1 <= len(CELLS) <= 24
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m.get("workloads", CELLS):
            assert w in CELLS
            assert "workloads" not in moved or w in moved["workloads"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    for path in spec.files_of(cell):
        assert path.is_file(), path
    c = spec.cell(cell)
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    # every rate the mix counts is an end-to-end metric of this cell
    assert set(c["traffic"]["end_to_end"]) <= names
    assert names - {"setup_s"} <= set(c["traffic"]["end_to_end"])
    for m in c["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    entry = spec.entry(c["traffic"]["entry"])
    assert hasattr(entry, "Cell")


@pytest.mark.parametrize("cell", CELLS)
def test_limits_are_set(cell):
    limits = spec.cell(cell)["limits"]
    assert limits["limits"]
    for name, value in limits["limits"].items():
        assert NAME.match(name) and value >= 0
