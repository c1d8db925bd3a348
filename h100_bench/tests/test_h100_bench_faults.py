"""The output check catches a broken timed path: a whole run of each cell
(the look for a card skipped, at a tiny size on the CPU) with each fault the
cell can have planted in the program reads ``correct`` false."""

import io
import time

import pytest

from conftest import CELLS, tiny_cell
from h100_bench.harness import spec
from h100_bench.harness.window import run
from h100_bench.tools.faults import FAULTS

CASES = [(w, f.__name__) for w in CELLS
         for f in FAULTS[spec.cell(w)["traffic"]["entry"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    from h100_bench.tools import faults

    c = tiny_cell(cell)
    with getattr(faults, fault)(c["traffic"]["entry"]):
        line = run(cell, 17, 0.05, False, "cpu", time.perf_counter(), c,
                   log=io.StringIO())
    assert line["correct"] is False, line["checks"]
