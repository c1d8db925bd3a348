"""``train.sync_idle_ms_per_step``: device-idle ms a step while the unit
thread is inside ``train.sync``, the epoch's closing metrics read (layer:
Trainer)."""

from h100_bench.harness.spans import idle_under_s, per_unit_ms


def read(run):
    return per_unit_ms(idle_under_s(run.events, run.win, "train.sync"),
                       run.counts.get("steps", 0))
