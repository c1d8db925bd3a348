"""``train.h2d_ms_per_step``: device ms of host-to-device copies per train
step (layer: batch pipeline)."""

from h100_bench.harness.readers import h2d_ms


def read(run):
    return h2d_ms(run, run.counts.get("steps", 0))
