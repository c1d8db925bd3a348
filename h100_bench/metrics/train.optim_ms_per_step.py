"""``train.optim_ms_per_step``: device ms a step of what ``step.optim``
launched: gradient clipping and the Adagrad update (layer: encoder and
head)."""

from h100_bench.harness.spans import device_under_s, per_unit_ms


def read(run):
    return per_unit_ms(device_under_s(run.events, run.win, "step.optim"),
                       run.counts.get("steps", 0))
