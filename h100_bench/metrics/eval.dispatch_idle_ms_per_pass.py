"""``eval.dispatch_idle_ms_per_pass``: device-idle ms a pass while the unit
thread is inside ``scorer.dispatch`` (the cast, the copies and the forward
enqueued), at any depth (layer: scorers)."""

from h100_bench.harness.spans import idle_under_s, per_unit_ms


def read(run):
    return per_unit_ms(idle_under_s(run.events, run.win, "scorer.dispatch"),
                       run.units)
