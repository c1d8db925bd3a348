"""The trace arithmetic and the per-layer readers on a hand-made trace."""

import json

import pytest

from h100_bench.harness import readers
from h100_bench.harness import trace as tr
from h100_bench.harness.peaks import bound
from h100_bench.harness.window import Run

ATT = "lstc_vad::attention"


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def _events():
    """A 1000 µs window: two attention calls whose kernels are matched by
    correlation (one of them launching two kernels), a GEMM, an HtoD copy
    overlapping a kernel, a memset, a kernel outside the window, and a
    kernel launched by another thread inside the first call's interval."""
    dims = [[4, 8, 49, 256], [4, 8, 49, 256], [4, 8, 49, 256], [8, 49, 49],
            []]
    return [
        _x(tr.WINDOW_SPAN, "user_annotation", 100, 1000),
        _x(ATT, "cpu_op", 150, 50, **{"Input Dims": dims}),
        _x("cuLaunchKernelEx", "cuda_driver", 160, 5, correlation=1),
        _x("cuLaunchKernelEx", "cuda_driver", 170, 5, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 180, 5, tid=2, correlation=9),
        _x("attn_a", "kernel", 200, 40, tid=7, correlation=1),
        _x("attn_b", "kernel", 240, 20, tid=7, correlation=2),
        _x("other", "kernel", 300, 100, tid=7, correlation=9),
        _x(ATT, "cpu_op", 500, 50, **{"Input Dims": dims}),
        _x("cudaLaunchKernel", "cuda_runtime", 510, 5, correlation=3),
        _x("attn_a", "kernel", 600, 30, tid=7, correlation=3),
        _x("aten::copy_", "cpu_op", 700, 200),
        _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 620, 100, tid=8),
        _x("Memset (Device)", "gpu_memset", 800, 10, tid=7),
        _x("late", "kernel", 1090, 100, tid=7),
        _x("outside", "kernel", 1200, 50, tid=7),
    ]


def test_union_and_busy():
    assert tr.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    events = _events()
    win = tr.window(events)
    assert win == (100, 1100)
    # [200, 260] + [300, 400] + [600, 720] + [800, 810] + [1090, 1100]
    assert tr.busy_s(events, win) == pytest.approx(300e-6)
    assert tr.h2d_s(events, win) == pytest.approx(100e-6)


def test_attention_calls_by_correlation():
    events = _events()
    calls = tr.op_calls(events, ATT, tr.window(events))
    assert [round(s * 1e6) for _, s in calls] == [60, 30]


def test_attention_calls_by_external_id():
    events = [_x(tr.WINDOW_SPAN, "user_annotation", 0, 100),
              _x(ATT, "cpu_op", 10, 10, **{"External id": 5}),
              _x("k", "kernel", 30, 7, tid=7, **{"External id": 5}),
              _x("k", "kernel", 40, 9, tid=7, **{"External id": 6})]
    calls = tr.op_calls(events, ATT, (0, 100))
    assert [round(s * 1e6) for _, s in calls] == [7]


def test_readers():
    events = _events()
    p = {"encoder.d_model": 2048}
    run = Run(events, tr.window(events),
              {"model_flops": 165e12 * 1e-3, "steps": 2}, 4, p, "float32")
    assert readers.device_idle_pct(run) == pytest.approx(70.0)
    # 165 GFLOP over 1 ms at 165 TFLOP/s
    assert readers.mfu(run) == pytest.approx(100.0)
    assert readers.h2d_ms(run, run.units) == pytest.approx(0.1 / 4)
    assert readers.h2d_ms(run, run.counts["steps"]) == pytest.approx(0.05)
    least, _ = bound(4, 49, True, 4, 256, 256, 8)
    assert readers.attention_roofline_pct(run) == pytest.approx(
        100 * 2 * least / 90e-3)


def test_readers_return_nothing_without_work():
    events = [_x(tr.WINDOW_SPAN, "user_annotation", 0, 100)]
    run = Run(events, (0, 100), {}, 1, {}, "float32")
    assert readers.attention_roofline_pct(run) is None
    assert readers.mfu(run) is None


def test_breakdown(tmp_path):
    events = _events()
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    loaded = tr.load(str(path))
    b = tr.breakdown(loaded, tr.window(loaded))
    names = dict(b["device_ops"])
    assert names["other"] == pytest.approx(100e-6)
    assert names["attn_a"] == pytest.approx(70e-6)
    assert "outside" not in names
    gaps = dict(b["idle_gaps"])
    # the gaps [720, 800] and [810, 1090] overlap aten::copy_ most
    assert gaps["aten::copy_"] == pytest.approx(360e-6)
    assert sum(gaps.values()) == pytest.approx(700e-6)
