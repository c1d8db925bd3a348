"""The STN's cell, ``sht_stn.train`` (entry ``stn_train``, reference
reference/stn.py, faults tools/faults_stn.py), at a tiny size on the CPU:
its rows in the shared tables keyed by entry (h100_bench/conftest.py), so
that the shared tests run it as the LTN's cells; the unit's counts; and its
three readers (``train.pad_ms_per_step``, ``train.pad_roofline``,
``train.attn_fwd_ms_per_step``) on a hand-made trace."""

import pytest

import conftest
from conftest import CELLS, tiny_cell
from h100_bench.harness import spec
from h100_bench.harness import trace as tr
from h100_bench.harness.peaks import HBM_BYTES_PER_S
from h100_bench.harness.window import Run
from h100_bench.tools import faults

CELL = "sht_stn.train"


def test_the_shared_tables_have_the_stn_rows():
    """The shared tests find the STN's tiny split and its faults, the
    faults by name too (tools/readings.py looks them up so)."""
    assert CELL in CELLS
    assert "stn_train" in conftest.TINY_SPLITS
    names = [f.__name__ for f in faults.FAULTS["stn_train"]]
    assert names == ["half_pairs", "state_unchanged"]
    assert all(getattr(faults, n) is f for n, f in
               zip(names, faults.FAULTS["stn_train"]))
    # the LTN's rows as they were
    assert [f.__name__ for f in faults.FAULTS["ltn_train"]] == [
        "half_batch", "state_unchanged"]


def test_unit_counts_clips_flops_and_pad_bytes():
    from h100_bench.harness.peaks import flops_per_tokens

    c = tiny_cell(CELL)
    cell = spec.entry("stn_train").Cell(c, 3, "cpu")
    cell.inputs()
    cell.build()
    counts = cell.unit()
    cell.release()
    p = c["config"]["program"]
    clips = 2 * p["data.batch_size"] * p["data.part_num"] * p["data.part_len"]
    assert counts["steps"] == 2
    assert counts["snippets"] == 2 * clips
    assert counts["model_flops"] == 2 * 3 * clips * flops_per_tokens(
        p, p["data.n_patch"] + 1)
    assert counts["pad_bytes"] == 0  # F.linear on the CPU pads nothing


# ------------------------------------------------------------ the readers

def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def _events():
    """A 1000 µs window of two steps: on the unit thread (1) a forward
    ``linear.pad`` [150, 170] launching a copy [200, 240] and two
    ``attention.plain`` spans, [300, 320] launching a kernel [330, 350] and
    [600, 620] launching two [630, 640], [640, 660]; on the autograd thread
    (3) a backward ``linear.pad`` [700, 720] launching a copy [750, 810];
    a kernel launched on the unit thread outside any span [400, 500]."""
    return [
        _x(tr.WINDOW_SPAN, "user_annotation", 100, 1000),
        _x(tr.UNIT_SPAN, "user_annotation", 100, 500),
        _x("linear.pad", "user_annotation", 150, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 160, 5, correlation=1),
        _x("copy", "kernel", 200, 40, tid=7, correlation=1),
        _x("attention.plain", "user_annotation", 300, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 305, 5, correlation=2),
        _x("softmax", "kernel", 330, 20, tid=7, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 380, 5, correlation=3),
        _x("gemm", "kernel", 400, 100, tid=7, correlation=3),
        _x(tr.UNIT_SPAN, "user_annotation", 600, 500),
        _x("attention.plain", "user_annotation", 600, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 605, 5, correlation=4),
        _x("cudaLaunchKernel", "cuda_runtime", 610, 5, correlation=5),
        _x("bmm", "kernel", 630, 10, tid=7, correlation=4),
        _x("softmax", "kernel", 640, 20, tid=7, correlation=5),
        _x("linear.pad", "user_annotation", 700, 20, tid=3),
        _x("cudaLaunchKernel", "cuda_runtime", 705, 5, tid=3,
           correlation=6),
        _x("copy", "kernel", 750, 60, tid=7, correlation=6),
    ]


WIN = (100, 1100)


def _run(events, **counts):
    return Run(events, WIN, dict({"steps": 2}, **counts), 2, {}, "float32")


def test_pad_ms_per_step_counts_both_threads():
    read = spec.metric_reader("train.pad_ms_per_step")
    # the forward's copy 40 µs and the backward's 60 µs, over two steps
    assert read(_run(_events())) == pytest.approx(1e3 * 100e-6 / 2)


def test_attn_fwd_ms_per_step():
    read = spec.metric_reader("train.attn_fwd_ms_per_step")
    assert read(_run(_events())) == pytest.approx(1e3 * 50e-6 / 2)


def test_pad_roofline_is_the_counted_bytes_over_the_copies_time():
    read = spec.metric_reader("train.pad_roofline")
    n_bytes = 0.5 * HBM_BYTES_PER_S * 100e-6  # half the rate for 100 µs
    assert read(_run(_events(), pad_bytes=n_bytes)) == pytest.approx(50.0)
    # no counter (a program without it) or no bytes: nothing to read
    assert read(_run(_events())) is None
    assert read(_run(_events(), pad_bytes=0)) is None


@pytest.mark.parametrize("metric", ["train.pad_ms_per_step",
                                    "train.pad_roofline",
                                    "train.attn_fwd_ms_per_step"])
def test_nothing_to_read_without_the_spans(metric):
    """A program without the spans (the parent commit, or an aligned cell
    that never pads) reads None, never 0."""
    events = [e for e in _events() if e["name"] not in ("linear.pad",
                                                        "attention.plain")]
    read = spec.metric_reader(metric)
    assert read(_run(events, pad_bytes=1e6)) is None
    assert read(Run(events, None, {"steps": 2}, 2, {}, "float32")) is None
