"""The STN's entry, ``stn_train``, in the two tables of the shared tests that
are keyed by entry: its tiny split in tests/conftest.py's ``TINY_SPLITS``
and its faults in tools/faults.py's ``FAULTS`` (tools/faults_stn.py's
``register``).  The tests that run every cell at a tiny size (the tiny run,
the control, the faults, no JAX) then run ``sht_stn.train`` as they run the
LTN's cells.

pytest loads this file before tests/conftest.py and before any test module,
and imports tests/conftest.py afresh: ``pytest_plugin_registered`` adds the
row to that import.  The no-JAX test's fresh interpreter imports this file,
as every file of the benchmark, before it imports tests/conftest.py by the
name ``conftest``: the module is loaded here under that name with the row.
"""

import importlib.util
import sys
from pathlib import Path

from h100_bench.tools import faults_stn

TESTS_CONFTEST = Path(__file__).resolve().parent / "tests" / "conftest.py"

# clips of at least part_len (7) a video; 4 pairs of batch 2: two steps an
# epoch
TINY_SPLITS = {"stn_train": {"videos": 10, "normal": 6,
                             "clips": {"normal": [8, 20],
                                       "abnormal": [7, 14]}}}


def _is_tests_conftest(module) -> bool:
    path = getattr(module, "__file__", None)
    return path is not None and Path(path).resolve() == TESTS_CONFTEST


def _add_rows(conftest) -> None:
    for entry, split in TINY_SPLITS.items():
        conftest.TINY_SPLITS.setdefault(entry, split)


def pytest_plugin_registered(plugin):
    if _is_tests_conftest(plugin):
        _add_rows(plugin)


def _load_tests_conftest() -> None:
    """tests/conftest.py as the module ``conftest``, with the rows; another
    module of that name already loaded is left alone."""
    module = sys.modules.get("conftest")
    if module is None:
        spec = importlib.util.spec_from_file_location("conftest",
                                                      TESTS_CONFTEST)
        module = importlib.util.module_from_spec(spec)
        sys.modules["conftest"] = module
        spec.loader.exec_module(module)
    if _is_tests_conftest(module):
        _add_rows(module)


faults_stn.register()
_load_tests_conftest()
