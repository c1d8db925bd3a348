"""The arithmetic of the per-layer metric readers (``metrics/<name>.py``).
Each takes a ``window.Run`` and returns a number, or None when the run has
nothing to read (never 0 for a share of a peak or of a roofline)."""

from __future__ import annotations

from typing import Optional

from h100_bench.harness import trace as tr
from h100_bench.harness.peaks import bound

ATTENTION_OP = "lstc_vad::attention"


def device_idle_pct(run) -> Optional[float]:
    """100 · (1 - the device's busy time / the traced window)."""
    if run.win is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s(run.events, run.win) / run.window_s)


def mfu(run) -> Optional[float]:
    """100 · the model FLOPs of the window's units / the traced window /
    the chip's peak for the configuration's precision."""
    flops = run.counts.get("model_flops", 0.0)
    if not flops or run.win is None:
        return None
    return 100.0 * flops / run.window_s / run.peak_flop_per_s


def h2d_ms(run, n) -> Optional[float]:
    """Device ms of host-to-device copies in the window, per one of ``n``
    (passes, steps)."""
    if run.win is None or not n:
        return None
    return 1e3 * tr.h2d_s(run.events, run.win) / n


def _dims(call: dict):
    return call.get("args", {}).get("Input Dims")


def attention_roofline_pct(run) -> Optional[float]:
    """100 · the least time of the window's attention calls / the device
    time of what they launched, both summed over the calls.  The least
    time of a call is the frozen ``bound`` at its shapes (q [B, H, L, d_k],
    v [B, H, L, d_v], the bias [H, L, L] when given); its device time that
    of the kernels matched to it by launch correlation."""
    least = measured = 0.0
    for call, device_s in tr.op_calls(run.events, ATTENTION_OP, run.win):
        dims = _dims(call)
        if not dims or device_s <= 0:
            continue
        b, h, length, d_k = dims[0]
        d_v = dims[2][3]
        with_bias = len(dims) > 3 and bool(dims[3])
        ms, _ = bound(b, length, with_bias, 4, d_k, d_v, h)
        least += ms / 1e3
        measured += device_s
    if measured <= 0:
        return None
    return 100.0 * least / measured
