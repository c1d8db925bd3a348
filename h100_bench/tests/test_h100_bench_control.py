"""The control comes out not correct: the plain reference with its products
on TF32-rounded inputs (the precision below the configuration's f32), put
in the program's place, fails at least one of each cell's limits.  At a
tiny size on the CPU here; tools/readings.py reads it on the card at the
cells' own sizes, and the limits are set from those readings."""

import pytest

from conftest import CELLS, tiny_cell
from h100_bench.harness import spec
from h100_bench.reference.model import matmul, tf32_matmul



@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed):
    c = tiny_cell(cell)
    cell_ = spec.entry(c["traffic"]["entry"]).Cell(c, seed, "cpu")
    cell_.inputs()
    want = cell_.reference(matmul)
    numbers = cell_.compare(cell_.reference(tf32_matmul), want)
    limits = c["limits"]["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers
