"""The span arithmetic (harness/spans.py) and the readers of the program's
spans, on hand-made traces."""

import pytest

from h100_bench.harness import spans as sp
from h100_bench.harness import spec
from h100_bench.harness import trace as tr
from h100_bench.harness.window import Run

UNIT, OTHER = 1, 2  # the unit thread, a worker thread


def _x(name, cat, ts, dur, tid=UNIT, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def _span(name, ts, dur, tid=UNIT):
    return _x(name, "user_annotation", ts, dur, tid)


def _events():
    """A 1000 µs window of two units.  Unit 1 [100, 500]: ``outer`` spans
    [110, 400] holding ``inner`` [150, 200] and ``inner`` [300, 350]; a
    kernel runs [200, 300], launched inside the first ``inner``.  Unit 2
    [500, 1100]: ``inner`` [520, 560], then ``other`` [600, 800] whose idle
    time a kernel [650, 700] splits; an ``outer`` span on the worker thread
    [550, 900] launches a kernel [900, 950] and a copy [950, 1000]."""
    return [
        _span(tr.WINDOW_SPAN, 100, 1000),
        _span(tr.UNIT_SPAN, 100, 400),
        _span("outer", 110, 290),
        _span("inner", 150, 50),
        _x("cudaLaunchKernel", "cuda_runtime", 160, 5, correlation=1),
        _x("k1", "kernel", 200, 100, tid=7, correlation=1),
        _span("inner", 300, 50),
        _span(tr.UNIT_SPAN, 500, 600),
        _span("inner", 520, 40),
        _span("other", 600, 200),
        _x("cudaLaunchKernel", "cuda_runtime", 610, 5, correlation=2),
        _x("k2", "kernel", 650, 50, tid=7, correlation=2),
        _span("outer", 550, 350, tid=OTHER),
        _x("cudaLaunchKernel", "cuda_runtime", 560, 5, tid=OTHER,
           correlation=3),
        _x("cudaMemcpyAsync", "cuda_runtime", 570, 5, tid=OTHER,
           correlation=4),
        _x("k3", "kernel", 900, 50, tid=7, correlation=3),
        _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 950, 50, tid=8,
           correlation=4),
        _x("gpu range", "gpu_user_annotation", 100, 1000, tid=7),
    ]


WIN = (100, 1100)


def test_unit_thread_is_that_of_the_units():
    assert sp.unit_thread(_events(), WIN) == UNIT
    assert sp.unit_thread([_span(tr.WINDOW_SPAN, 0, 10)], (0, 10)) is None


def test_host_time_counts_the_unit_threads_outermost_spans():
    events = _events()
    # the worker's ``outer`` is not on the unit thread
    assert sp.host_s(events, WIN, "outer") == pytest.approx(290e-6)
    assert sp.host_s(events, WIN, "inner") == pytest.approx(140e-6)
    nested = events + [_span("inner", 160, 20)]  # inside [150, 200]
    assert sp.host_s(nested, WIN, "inner") == pytest.approx(140e-6)


def test_idle_under_a_span_at_any_depth():
    events = _events()
    # busy [200, 300], [650, 700], [900, 1000]
    assert sp.idle_intervals(events, WIN) == [(100, 200), (300, 650),
                                              (700, 900), (1000, 1100)]
    # outer [110, 400]: idle [110, 200] + [300, 400]
    assert sp.idle_under_s(events, WIN, "outer") == pytest.approx(190e-6)
    # inner [150, 200] + [300, 350] + [520, 560]: all idle
    assert sp.idle_under_s(events, WIN, "inner") == pytest.approx(140e-6)
    # other [600, 800] less the kernel [650, 700]
    assert sp.idle_under_s(events, WIN, "other") == pytest.approx(150e-6)


def test_device_time_by_correlation_on_the_spans_thread():
    events = _events()
    # unit thread ``outer``: k1; worker ``outer``: k3 and the copy
    assert sp.device_under_s(events, WIN, "outer") == pytest.approx(200e-6)
    assert sp.device_under_s(events, WIN, "inner") == pytest.approx(100e-6)
    assert sp.device_under_s(events, WIN, "other") == pytest.approx(50e-6)
    # a launch on another thread inside the span's interval is not its own
    assert sp.device_under_s(events, WIN, tr.UNIT_SPAN) == pytest.approx(
        150e-6)


def test_idle_split_by_the_innermost_span():
    events = _events()
    by = sp.idle_by_innermost(events, WIN)
    # unit: [100, 110], [400, 500], [500, 520], [560, 600], [800, 900],
    # [1000, 1100]; outer: [110, 150], [350, 400]; inner: [150, 200],
    # [300, 350], [520, 560]; other: [600, 650], [700, 800]
    assert by == pytest.approx({tr.UNIT_SPAN: 370e-6, "outer": 90e-6,
                                "inner": 140e-6, "other": 150e-6})
    assert sum(by.values()) == pytest.approx(
        sum(b - a for a, b in sp.idle_intervals(events, WIN)) / 1e6)
    # only the spans named (and the benchmark's own)
    assert sp.idle_by_innermost(events, WIN, names={"outer"}) == \
        pytest.approx({tr.UNIT_SPAN: 560e-6, "outer": 190e-6})
    # the same split of some of the idle intervals alone
    assert sp.idle_by_innermost(events, WIN, [(300, 650)]) == pytest.approx(
        {"inner": 90e-6, "outer": 50e-6, tr.UNIT_SPAN: 160e-6,
         "other": 50e-6})


def test_nothing_to_read_without_spans():
    events = [_span(tr.WINDOW_SPAN, 0, 100), _span(tr.UNIT_SPAN, 0, 100),
              _x("k", "kernel", 10, 10, tid=7, correlation=1)]
    for f in (sp.host_s, sp.idle_under_s, sp.device_under_s):
        assert f(events, (0, 100), "scorer.pack") is None
        assert f(events, None, "scorer.pack") is None
    assert sp.per_unit_ms(None, 3) is None
    assert sp.per_unit_ms(0.5, 0) is None
    assert sp.per_unit_ms(0.5, 4) == pytest.approx(125.0)


NEW = {"eval.pack_ms_per_pass": ("scorer.pack", "host"),
       "eval.pack_idle_ms_per_pass": ("scorer.pack", "idle"),
       "eval.dispatch_idle_ms_per_pass": ("scorer.dispatch", "idle"),
       "eval.frames_ms_per_pass": ("eval.frames", "host"),
       "train.sync_idle_ms_per_step": ("train.sync", "idle"),
       "train.optim_ms_per_step": ("step.optim", "device")}


@pytest.mark.parametrize("metric", sorted(NEW))
def test_readers_of_one_span(metric):
    name, rule = NEW[metric]
    renamed = [dict(e, name=name) if e["name"] == "inner" else e
               for e in _events()]
    run = Run(renamed, WIN, {"steps": 2}, 2, {}, "float32")
    want = {"host": 140e-6, "idle": 140e-6, "device": 100e-6}[rule]
    read = spec.metric_reader(metric)
    assert read(run) == pytest.approx(1e3 * want / 2)
    # a program without the span (the parent commit): nothing to read
    assert read(Run(_events(), WIN, {"steps": 2}, 2, {}, "float32")) is None


def test_batch_wait_reads_start_and_wait():
    read = spec.metric_reader("train.batch_wait_ms_per_step")
    events = _events()
    run = Run(events, WIN, {"steps": 2}, 2, {}, "float32")
    assert read(run) is None
    start = events + [_span("batch.start", 505, 10)]
    assert read(Run(start, WIN, {"steps": 2}, 2, {}, "float32")) == \
        pytest.approx(1e3 * 10e-6 / 2)
    both = start + [_span("batch.wait", 520, 30), _span("batch.wait", 900, 5)]
    assert read(Run(both, WIN, {"steps": 2}, 2, {}, "float32")) == \
        pytest.approx(1e3 * 45e-6 / 2)
