"""``eval.device_idle_pct``: the share of the traced window in which the device ran
no kernel, copy or memset (layer: device)."""

from h100_bench.harness.readers import device_idle_pct as read  # noqa: F401
