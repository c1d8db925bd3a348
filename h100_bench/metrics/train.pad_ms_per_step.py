"""``train.pad_ms_per_step``: device ms a step of what ``linear.pad``
launched: the GEMM's copies of an operand into a padded row stride (x into
``w_2`` in the forward, dY out of ``w_1`` in the backward, at d_inner 3027),
on whatever thread ran them (layer: GEMM operator)."""

from h100_bench.harness.spans import device_under_s, per_unit_ms


def read(run):
    return per_unit_ms(device_under_s(run.events, run.win, "linear.pad"),
                       run.counts.get("steps", 0))
