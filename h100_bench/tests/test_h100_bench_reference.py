"""The reference matches the port at a tiny size on the CPU, through each
cell's whole run (inputs, set-up, window, output check)."""

import io
import time

import numpy as np
import pytest
import torch

from conftest import CELLS, tiny_cell
from h100_bench.harness import data
from h100_bench.harness.cell import load_weights, program_config
from h100_bench.harness.window import run
from h100_bench.reference.model import LTN, matmul



@pytest.mark.parametrize("seed", [5, 2 ** 31 + 77])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(cell, seed):
    c = tiny_cell(cell)
    log = io.StringIO()
    line = run(cell, seed, 0.05, False, "cpu", time.perf_counter(), c,
               log=log)
    assert line["correct"], log.getvalue()
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    for k, v in line["checks"].items():
        assert v["value"] <= v["limit"] / 10, (k, v)
        assert f"check {k}:" in log.getvalue()
    names = {m["name"] for m in c["end_to_end"]}
    assert set(line["metrics"]) == names


def test_same_seed_same_inputs():
    c = tiny_cell("sht_ltn.eval")
    p = c["config"]["program"]
    a = data.make_split(c["traffic"]["split"], 9, 4, 16, "cpu")
    b = data.make_split(c["traffic"]["split"], 9, 4, 16, "cpu")
    for x, y in zip(a.feats + a.annos, b.feats + b.annos):
        np.testing.assert_array_equal(x, y)
    wa, wb = data.make_weights(p, 9, "cpu"), data.make_weights(p, 9, "cpu")
    for k, v in data.flat(wa).items():
        torch.testing.assert_close(v, data.flat(wb)[k], rtol=0, atol=0)
    # every seed gets the same work
    other = data.make_split(c["traffic"]["split"], 10, 4, 16, "cpu")
    assert sorted(other.clips) == sorted(a.clips)


def test_forward_matches_the_port():
    """The reference forward and the port's modules on the same weights,
    both in eval mode, at the tiny widths."""
    from lstc_vad_tpu_torch.models import build

    c = tiny_cell("sht_ltn.eval")
    p = c["config"]["program"]
    cfg = program_config(c["config"])
    weights = data.make_weights(p, 3, "cpu")
    encoder, head = build(cfg, "cpu", seed=0)
    load_weights(encoder, head, weights)
    x = torch.randn(5, 12, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = head(encoder(x)[:, 0, :])[:, 1]
    got = LTN(p, "cpu").scores(data.flat(weights), x, matmul)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_on_the_card(card, cell):
    line = run(cell, 5, 0.2, True, card, time.perf_counter(),
               tiny_cell(cell), log=io.StringIO())
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
    assert line["device"]["platform"] == "gpu"
