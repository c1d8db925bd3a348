"""``eval.attn_ms_per_pass``: device ms a pass of the kernels the
attention operator's calls launched, matched to each call by launch
correlation (``trace.op_calls``) (layer: attention operator)."""

from h100_bench.harness import trace as tr
from h100_bench.harness.readers import ATTENTION_OP


def read(run):
    if run.win is None or not run.units:
        return None
    calls = tr.op_calls(run.events, ATTENTION_OP, run.win)
    device_s = sum(s for _, s in calls)
    if device_s <= 0:
        return None
    return 1e3 * device_s / run.units
