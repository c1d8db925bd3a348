"""The tiled f32 attention kernel's launch geometry
(lstc_vad_tpu_torch/csrc/attention.cu::plan), written out in Python: the
CPU tests hold it to a table, and on the card
tests/test_torch_cuda_kernel.py::test_f32_plan_fits_the_block holds the C
plan (ops/cuda_attention.py::f32_plan) equal to it.

64-row tiles of 64/R heads of R rows (the least of 16, 32, 64 that holds
L), three in flight a block of four warpgroups, each consumer warpgroup
with a ring, a split buffer and a staging box of its own; or 128 rows of
one head over both consumer warpgroups of a block of three, from one ring
with two split buffers and two staging boxes a warpgroup.  The products
take 8·ceil(L/8) keys with one head a tile, else all 64.  A ring stage
holds a 32-column chunk of the tile's Q and K boxes (a V box takes half of
one) and its full and empty barriers; a split buffer a chunk's big and
small halves.  As many stages as fit, up to 4.  The chunk is a constant,
so D does not move the geometry.
"""

SMEM_LIMIT, MAX_STAGES = 232448, 4
ROW_BYTES = 128          # a box row: 32 f32 columns
O_BOX = 64 * ROW_BYTES   # a staging box


def f32_plan(length: int, d: int) -> dict:
    if not (1 <= length <= 128 and 32 <= d <= 256 and d % 32 == 0):
        raise ValueError(f"the tiled f32 kernel does not take L={length} "
                         f"d={d}")
    rows = next(r for r in (16, 32, 64, 128) if length <= r)
    nc = 2 if rows == 128 else 1
    heads = max(1, 64 // rows)
    consumers = 3 if nc == 1 else 2
    rings, splits, staging = consumers // nc, nc, nc
    box = 64 * nc * ROW_BYTES
    stage = 2 * box + 2 * 8
    fixed = rings * splits * 2 * box + consumers * staging * O_BOX
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // (rings * stage))
    return {"smem_bytes": rings * stages * stage + fixed,
            "threads": 128 * (consumers + 1), "rows": 64 * nc,
            "heads": heads, "head_rows": rows,
            "keys": 8 * -(-length // 8) if heads == 1 else 64,
            "rings": rings, "stages": stages}
