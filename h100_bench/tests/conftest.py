"""Shared helpers of the benchmark's tests: the repo root on the path, and
tiny versions of the cells for runs on the CPU."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench.harness import spec  # noqa: E402

# the widths of a tiny LTN: every path of the full one, at a size the CPU
# runs in seconds
TINY = {"encoder.d_model": 16, "encoder.n_head": 2, "encoder.d_k": 8,
        "encoder.d_v": 8, "encoder.d_inner": 32, "encoder.n_layers": 2,
        "head.d_model": 16, "head.hidden_dim": 8, "data.n_patch": 4,
        "data.batch_size": 2}
TINY_SPLITS = {"ltn_eval": {"videos": 7, "normal": 4,
                            "clips": {"normal": [2, 9], "abnormal": [2, 6]}},
               "ltn_train": {"videos": 10, "normal": 6,
                             "clips": {"normal": [3, 12],
                                       "abnormal": [3, 8]}}}
CELLS = [w["name"] for w in spec.manifest()["workloads"]]


def tiny_cell(workload: str) -> dict:
    """The cell ``workload`` at tiny widths and a tiny split: the
    program's numbers and the file's are cut alike."""
    c = copy.deepcopy(spec.cell(workload))
    cfg = c["config"]
    cfg["overrides"] = dict(cfg.get("overrides", {}), **TINY)
    cfg["program"].update(TINY)
    c["traffic"]["split"].update(TINY_SPLITS[c["traffic"]["entry"]])
    return c


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
