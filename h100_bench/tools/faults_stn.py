"""Faults planted in the STN's timed path (entry ``stn_train``), to show that
its output check catches them, as tools/faults.py's do for the LTN:

- ``half_pairs``: the MIL loss over half the batch's pairs (the first half
  of the normal videos against the first half of the abnormal ones);
- ``state_unchanged``: tools/faults.py's, a step that takes the gradients
  and applies no update.

``register`` adds them to tools/faults.py: the entry's row of ``FAULTS``,
and ``half_pairs`` by name, where the shared tests and tools/readings.py
look faults up.  Their readings on the card, beside the program's and the
control's, in one process (tools/readings.py's command line, registered):

    python3 h100_bench/tools/faults_stn.py --workload sht_stn.train \\
        --seeds 101,102 --control-seeds 201 --faults half_pairs \\
        --fault-seeds 301 [--out readings.jsonl]
"""

import contextlib
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench.tools import faults, readings  # noqa: E402
from h100_bench.tools.faults import state_unchanged  # noqa: E402


@contextlib.contextmanager
def half_pairs(entry: str):
    from lstc_vad_tpu_torch.train import steps

    orig = steps.stn_mil_loss

    def half(snippet_scores, part_num, part_len, lambda_1):
        b = snippet_scores.shape[0] // 2
        h = max(b // 2, 1)
        return orig(torch.cat([snippet_scores[:h], snippet_scores[b:b + h]]),
                    part_num, part_len, lambda_1)

    with mock.patch.object(steps, "stn_mil_loss", half):
        yield


# the faults of the STN's entry
FAULTS = {"stn_train": (half_pairs, state_unchanged)}


def register() -> None:
    """The faults of this file in tools/faults.py, by entry and by name."""
    for entry, fs in FAULTS.items():
        faults.FAULTS.setdefault(entry, fs)
        for f in fs:
            setattr(faults, f.__name__, f)


def main(argv=None):
    """tools/readings.py's command line, the faults here registered."""
    register()
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
