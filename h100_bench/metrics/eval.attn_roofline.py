"""``eval.attn_roofline``: the attention operator's least time over
the device time of the kernels it launched, summed over the window's
calls (layer: attention operator)."""

from h100_bench.harness.readers import attention_roofline_pct as read  # noqa: F401
