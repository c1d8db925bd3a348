"""``eval.frames_ms_per_pass``: host ms a pass inside ``eval.frames``: part
scores expanded to frames, labels and the frame AUC (layer: eval
drivers)."""

from h100_bench.harness.spans import host_s, per_unit_ms


def read(run):
    return per_unit_ms(host_s(run.events, run.win, "eval.frames"), run.units)
