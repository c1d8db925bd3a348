"""The frozen copies under h100_bench equal what they were copied from, at
the cells' shapes: the FLOP count, the attention bound and its peaks, the
trace union, the reference's relative position index, the training
batches' draws, and the program configuration each config file states."""

import json
import sys

import numpy as np
import pytest

from conftest import CELLS
from h100_bench.harness import data, peaks, spec
from h100_bench.harness import trace as tr
from h100_bench.harness.cell import program_config
from h100_bench.reference import sampling
from h100_bench.reference.model import rpe_index_3d


def _chip_smoke():
    sys.path.insert(0, str(spec.ROOT))
    import chip_smoke

    return chip_smoke


def _program_cfg(cell):
    c = spec.cell(cell)
    return c, program_config(c["config"])


@pytest.mark.parametrize("cell", CELLS)
def test_config_file_is_the_program_config(cell):
    _program_cfg(cell)  # raises on any number that differs


@pytest.mark.parametrize("cell", CELLS)
def test_flops_per_tokens(cell):
    from lstc_vad_tpu_torch.benchmark import flops_per_tokens

    c, cfg = _program_cfg(cell)
    p = c["config"]["program"]
    for length in (p["data.part_len"] * p["data.n_patch"] + 1, 17, 81):
        assert peaks.flops_per_tokens(p, length) == flops_per_tokens(
            cfg, length)


@pytest.mark.parametrize("b,length,bias,itemsize,dk,dv,h", [
    (2048, 49, True, 4, 256, 256, 8), (1055, 49, True, 4, 256, 256, 8),
    (1280, 49, True, 4, 256, 256, 8), (256, 81, False, 2, 128, 128, 4),
    (64, 1024, True, 2, 256, 384, 8)])
def test_bound_and_peaks(b, length, bias, itemsize, dk, dv, h):
    cs = _chip_smoke()
    assert peaks.bound(b, length, bias, itemsize, dk, dv, h) == cs.bound(
        b, length, bias, itemsize, dk, dv, h)
    assert (peaks.HBM_BYTES_PER_S, peaks.F32_FLOP_PER_S,
            peaks.BF16_FLOP_PER_S) == (cs.HBM_BYTES_PER_S, cs.F32_FLOP_PER_S,
                                       cs.BF16_FLOP_PER_S)


def test_busy_union_equals_the_program_profiling(tmp_path):
    from lstc_vad_tpu_torch.utils.profiling import device_busy_ms

    rng = np.random.default_rng(0)
    events = [{"ph": "X", "name": "k", "cat": cat, "ts": float(ts),
               "dur": float(d), "pid": 0, "tid": 7}
              for cat, ts, d in zip(
                  rng.choice(["kernel", "gpu_memcpy", "gpu_memset",
                              "cpu_op"], 300),
                  rng.integers(0, 10_000, 300), rng.integers(1, 400, 300))]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    loaded = tr.load(str(path))
    assert tr.busy_s(loaded, (-1.0, 1e9)) * 1e3 == pytest.approx(
        device_busy_ms(str(path)), rel=1e-12)


@pytest.mark.parametrize("depth,size", [(3, 4), (2, 4), (5, 4)])
def test_rpe_index(depth, size):
    from lstc_vad_tpu_torch.models import rpe

    np.testing.assert_array_equal(
        rpe_index_3d(depth, size), rpe.relative_position_index_3d(depth,
                                                                  size))


@pytest.mark.parametrize("seed", [0, 4_000_000_017])
def test_training_batches(seed):
    """The reference's draws of pairs and windows equal the program's
    dataset's, epoch after epoch."""
    from lstc_vad_tpu_torch.data.annotations import TrainRecord
    from lstc_vad_tpu_torch.data.datasets import PairedTrainDataset

    clips = data.clip_counts({"videos": 23, "normal": 15,
                              "clips": {"normal": [18, 86],
                                        "abnormal": [10, 40]}}, seed)
    keys = [f"v{i}" for i in range(23)]
    abnormal = [i >= 15 for i in range(23)]

    class Store:
        def get(self, key):
            i = keys.index(key)
            # each clip holds its index plus 1000 x its video's
            return (np.arange(clips[i], dtype=np.float32)[:, None, None]
                    + 1000 * i) * np.ones((1, 2, 1), np.float32)

        def n_clips(self, key):
            return clips[keys.index(key)]

    ds = PairedTrainDataset([TrainRecord(k, a) for k, a in
                             zip(keys, abnormal)], Store(), part_num=16,
                            part_len=3, n_patch=1, sample="uniform",
                            seed=seed)
    normal = [i for i in range(23) if not abnormal[i]]
    abn = [i for i in range(23) if abnormal[i]]
    epochs = sampling.epochs([clips[i] for i in normal],
                             [clips[i] for i in abn], 4, 16, 3, seed)
    for _ in range(3):
        batches = next(epochs)
        assert len(batches) == len(ds) // 4
        for b, pairs in enumerate(batches):
            for j, ((nv, ni), (av, ai)) in enumerate(pairs):
                nf, _, af, _ = ds[b * 4 + j]
                np.testing.assert_array_equal(nf[:, 0, 0],
                                              ni + 1000 * normal[nv])
                np.testing.assert_array_equal(af[:, 0, 0],
                                              ai + 1000 * abn[av])
        ds.shuffle_keys()
