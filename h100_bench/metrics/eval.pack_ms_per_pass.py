"""``eval.pack_ms_per_pass``: host ms a pass inside the scorer's per-video
packing (``scorer.pack``: slices, part plan, chunk fill, the flushes it
makes) on the unit thread (layer: scorers)."""

from h100_bench.harness.spans import host_s, per_unit_ms


def read(run):
    return per_unit_ms(host_s(run.events, run.win, "scorer.pack"), run.units)
