"""``train.attn_fwd_ms_per_step``: device ms a step of what
``attention.plain`` launched: the plain attention's forward, the path a
train step takes under attention dropout; its backward is autograd's and
not counted (layer: attention operator)."""

from h100_bench.harness.spans import device_under_s, per_unit_ms


def read(run):
    return per_unit_ms(
        device_under_s(run.events, run.win, "attention.plain"),
        run.counts.get("steps", 0))
