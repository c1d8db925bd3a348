"""``train.pad_roofline``: 100 · the least time of the window's padded
copies / the device time of what ``linear.pad`` launched.  The least time
is the program's ``pad_bytes`` count (each copy's rows read once and
written once, 2 · M · width · 4 bytes) over the frozen HBM rate; None
where the program counts no such bytes or the trace holds no such span
(layer: GEMM operator)."""

from h100_bench.harness.peaks import HBM_BYTES_PER_S
from h100_bench.harness.spans import device_under_s


def read(run):
    n_bytes = run.counts.get("pad_bytes", 0)
    device_s = device_under_s(run.events, run.win, "linear.pad")
    if not n_bytes or not device_s:
        return None
    return 100.0 * n_bytes / HBM_BYTES_PER_S / device_s
