"""The bf16 streaming kernel's launch geometry and work queue, on the CPU.

tests/bf16_stream_plan.py writes out what
lstc_vad_tpu_torch/csrc/attention_stream_bf16.cu computes: its plan (shared
memory, threads, rows a work item, ring stages, Q resident, query tiles a
block, ping-pong) and the walk of its persistent blocks over the work items.
Here it is held to a table and to the rules the kernel needs: a block's
shared memory within 227 KB, 384 threads (one producer and two consumer
warpgroups), and a queue that hands every (b, h, 64-row query tile) to
exactly one block once.  On the card
tests/test_torch_cuda_kernel.py::test_stream_plan_fits_the_block holds the
C plan equal to this mirror.
"""

import pytest
import torch

from lstc_vad_tpu_torch.ops import cuda_attention

from bf16_stream_plan import (KEYS_OUT, ROWS, SMEM_LIMIT, bf16_stream_plan,
                              work_items)

# (L, d_k, d_v, bias) -> the plan's values in KEYS_OUT order: the rows of
# the kernel phase (D = 256 past 128, config B's widths, the main shape
# forced), no bias, and the widths where Q no longer fits resident
PLANS = {
    (129, 256, 256, True): (231568, 384, 128, 2, 1, 64, 2, 2, 1, 1, 1),
    (1024, 256, 256, True): (231568, 384, 128, 2, 1, 64, 2, 2, 1, 1, 1),
    (1024, 256, 256, False): (196752, 384, 128, 2, 1, 64, 2, 2, 0, 1, 1),
    (49, 256, 256, True): (231568, 384, 128, 2, 1, 64, 2, 2, 1, 1, 1),
    (49, 512, 384, True): (214160, 384, 64, 1, 1, 64, 1, 1, 1, 1, 0),
    (8, 8, 8, True): (118928, 384, 128, 2, 1, 64, 2, 2, 2, 1, 1),
    (129, 64, 257, True): (174224, 384, 64, 2, 1, 64, 1, 2, 2, 1, 0),
    (129, 512, 1024, True): (214160, 384, 64, 1, 1, 64, 1, 1, 1, 1, 0),
    (129, 1024, 8, True): (230544, 384, 64, 1, 0, 64, 1, 1, 1, 1, 0),
    (129, 2048, 64, True): (230544, 384, 64, 1, 0, 64, 1, 1, 1, 1, 0),
}
# the card tests' width pairs (tests/test_torch_cuda_kernel.py)
WIDTHS = ((8, 8), (24, 48), (48, 24), (256, 256), (384, 512), (1024, 8),
          (512, 1024), (64, 257), (512, 384), (2048, 64))
QUEUE_LENGTHS = (1, 64, 65, 129, 1024)


def test_plan_keys_are_the_launchers():
    assert KEYS_OUT == cuda_attention.STREAM_PLAN_KEYS[torch.bfloat16]


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_plan_table(shape):
    plan = bf16_stream_plan(*shape)
    assert tuple(plan[k] for k in KEYS_OUT) == PLANS[shape]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("widths", WIDTHS,
                         ids=[f"dk{a}_dv{b}" for a, b in WIDTHS])
@pytest.mark.parametrize("length", [1, 64, 65, 129, 1024])
def test_plan_fits_the_block(length, widths, with_bias):
    """Within a block's 227 KB; three warpgroups; two 64-row tiles in
    ping-pong where every warpgroup holds all of d_v (<= 256), one tile
    with O's columns split past that; Q resident up to d_k 512, streamed
    at 2048; every ring at one or two stages; no pass or chunk more than
    the widths need."""
    d_k, d_v = widths
    p = bf16_stream_plan(length, d_k, d_v, with_bias)
    assert 0 < p["smem_bytes"] <= SMEM_LIMIT
    assert p["threads"] == 384 and p["persistent"] == 1
    assert p["rows"] == ROWS * p["row_tiles"]
    assert p["pingpong"] == (p["row_tiles"] == 2) == (p["split"] == 0)
    if p["split"] == 0:
        assert d_v <= 256 and p["nb"] * 64 >= d_v
    else:
        assert p["n_passes"] * p["v_boxes"] * 64 >= d_v
        assert (p["n_passes"] - 1) * p["v_boxes"] * 64 < d_v
    if d_k <= 512:
        assert p["q_resident"] == 1
    if d_k >= 2048:
        assert p["q_resident"] == 0
    assert p["chunk_boxes"] * p["n_chunks"] * 64 >= d_k
    assert (p["n_chunks"] - 1) * p["chunk_boxes"] * 64 < d_k
    assert p["stages"] in (1, 2) and p["v_stages"] in (1, 2)
    assert p["bias_stages"] in ((1, 2) if with_bias else (0,))
    assert p["n_tiles"] * 64 >= length > (p["n_tiles"] - 1) * 64


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("widths", [(256, 256), (512, 384)],
                         ids=["d256", "config_b"])
@pytest.mark.parametrize("length", QUEUE_LENGTHS)
def test_queue_covers_every_tile_once(length, widths, sms):
    """Every (b, h, 64-row query tile) below L goes to exactly one block
    once, at fewer tiles than blocks and more; a tile past L (the second
    of an item at an odd tile count) rides along in its item and is never
    a tile of its own; the blocks' item counts differ by at most one."""
    batch, heads = 3, 4 if widths == (512, 384) else 8
    plan = bf16_stream_plan(length, *widths, True)
    blocks = work_items(batch, heads, length, plan, sms)
    seen = [(b, h, q0) for walk in blocks for b, h, tiles in walk
            for q0 in tiles if q0 < length]
    want = [(b, h, 64 * t) for b in range(batch) for h in range(heads)
            for t in range(-(-length // 64))]
    assert sorted(seen) == sorted(want) and len(set(seen)) == len(seen)
    for walk in blocks:
        for _, _, tiles in walk:
            assert tiles[0] < length  # an item's first tile is live
    counts = [len(walk) for walk in blocks]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1
    assert len(blocks) == min(sms, sum(counts))


def test_odd_tile_count_leaves_one_warpgroup_without_rows():
    """L = 129: three 64-row tiles a pair, two items: the second item's
    second tile lies past L, so one consumer warpgroup has no row to
    store there."""
    plan = bf16_stream_plan(129, 256, 256, True)
    walk = work_items(1, 1, 129, plan, 132)
    assert [tiles for _, _, tiles in (w[0] for w in walk)] == [(0, 64),
                                                              (128, 192)]


def test_queue_past_65535_items():
    """B·H = 22,000 pairs at L = 129 (the card test's 66,000 tiles): 44,000
    items over 132 persistent blocks, 333 or 334 a block."""
    plan = bf16_stream_plan(129, 8, 8, True)
    n_qt = -(-129 // plan["rows"])
    n_items = 2750 * 8 * n_qt
    assert n_items == 44000
    per_block = [len(range(b, n_items, 132)) for b in range(132)]
    assert set(per_block) == {333, 334} and sum(per_block) == n_items


def test_plan_refuses_empty_shapes():
    for shape in ((0, 8, 8), (8, 0, 8), (8, 8, 0)):
        with pytest.raises(ValueError):
            bf16_stream_plan(*shape, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width,offset", [(13, 1), (7, 3), (48, 1), (64, 0)])
def test_padded_copy_is_tma_ready(width, offset, dtype):
    """The bf16 streaming kernel reads q, k and v through TMA alone; the
    wrapper hands it a view off the 16-byte grid as a padded copy: the same
    shape and values, a 16-byte-aligned base, and batch, head and row
    strides of whole 16 bytes (any width)."""
    buf = torch.randn(2 * 3 * 5 * width + offset).to(dtype)
    t = buf[offset:].view(2, 3, 5, width)
    ready = cuda_attention._tma_ready(t)
    assert ready == (offset == 0 and width * t.element_size() % 16 == 0)
    padded = cuda_attention._padded(t)
    assert padded.shape == t.shape and torch.equal(padded, t)
    assert cuda_attention._tma_ready(padded)
    assert padded.stride(-1) == 1
