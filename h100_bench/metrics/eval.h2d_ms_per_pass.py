"""``eval.h2d_ms_per_pass``: device ms of host-to-device copies per
evaluation pass (layer: scorers)."""

from h100_bench.harness.readers import h2d_ms


def read(run):
    return h2d_ms(run, run.units)
