"""``eval.mfu``: the model FLOPs of the window's units over the traced window,
as a share of the chip's peak for the configuration's precision (layer:
encoder and head; a train step counts three forwards)."""

from h100_bench.harness.readers import mfu as read  # noqa: F401
