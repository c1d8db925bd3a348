"""The bf16 streaming attention kernel's launch geometry and work queue
(lstc_vad_tpu_torch/csrc/attention_stream_bf16.cu::plan and the item walk
of its producer and consumers), written out in Python: the CPU tests hold
it to a table and to the rules below, and on the card
tests/test_torch_cuda_kernel.py::test_stream_plan_fits_the_block holds the
C plan (ops/cuda_attention.py::stream_plan) equal to it.

Key tiles of 64.  Where d_v <= 256 and Q of two 64-row query tiles fits
resident beside one stage of each ring, a work item is 128 query rows, one
tile a consumer warpgroup (ping-pong); else 64 rows, O's columns split over
both warpgroups (NB = min(3, ceil(min(blocks, 6) / 2)) 64-column blocks
each, passes of 2·NB blocks), Q resident or streamed in chunks of d_k
beside K, and two P slots of 8 KB.  The K, V and bias rings take 2, 2, 2
stages, else 2, 2, 1, else 2, 1, 1, else 1, 1, 1, the first that fits; a
bias stage holds its item's rows at 272 bytes a row (17 chunks of 16, what
a bulk copy of a row takes; TMA fills the first 256 bytes of each).
Blocks are persistent: grid = min(items, SMs), block i walks items i,
i + grid, ...; item = pair · n_qt + query block, pair = b · H + h.
"""

SMEM_LIMIT = 232448
BOX = 64 * 128           # 64 rows x 64 bf16 columns
BIAS_PITCH = 17 * 16     # a bias row copied whole
BARS = 18 * 8
KEYS, ROWS = 64, 64
STAGES = ((2, 2, 2), (2, 2, 1), (2, 1, 1), (1, 1, 1))
KEYS_OUT = ("smem_bytes", "threads", "rows", "stages", "q_resident", "keys",
            "row_tiles", "v_stages", "bias_stages", "persistent", "pingpong")


def _fits(q, k, v, bias, slots):
    for ks, vs, bs in STAGES:
        smem = q + ks * k + vs * v + bs * bias + slots + BARS
        if smem <= SMEM_LIMIT:
            return smem, ks, vs, bs
    return None


def bf16_stream_plan(length: int, d_k: int, d_v: int, with_bias: bool
                     ) -> dict:
    """The geometry ``lstc_attention_stream_bf16_plan`` writes, plus the
    layout's own numbers (``split``, ``nb``, ``chunk_boxes``, ``n_chunks``,
    ``v_boxes``, ``n_passes``, ``n_tiles``)."""
    if length < 1 or d_k < 1 or d_v < 1:
        raise ValueError(f"no geometry at L={length} d_k={d_k} d_v={d_v}")
    kb, vb = -(-d_k // 64), -(-d_v // 64)

    def bias_bytes(rows):
        return rows * BIAS_PITCH if with_bias else 0

    layout = None
    if vb <= 4:
        fit = _fits(2 * kb * BOX, kb * BOX, vb * BOX,
                    bias_bytes(2 * ROWS), 0)
        if fit:
            layout = dict(split=0, nb=vb, v_boxes=vb, n_passes=1,
                          chunk_boxes=kb, n_chunks=1, fit=fit)
    if layout is None:
        nb = min(3, (min(vb, 6) + 1) // 2)
        v, bias = 2 * nb * BOX, bias_bytes(ROWS)
        common = dict(split=1, nb=nb, v_boxes=2 * nb,
                      n_passes=-(-vb // (2 * nb)))
        fit = _fits(kb * BOX, kb * BOX, v, bias, 2 * BOX)
        if fit:
            layout = dict(common, chunk_boxes=kb, n_chunks=1, fit=fit)
        else:
            for cb in range(kb, 0, -1):
                fit = _fits(0, 2 * cb * BOX, v, bias, 2 * BOX)
                if fit:
                    layout = dict(common, chunk_boxes=cb,
                                  n_chunks=-(-kb // cb), fit=fit)
                    break
    if layout is None:
        raise ValueError(f"no geometry at L={length} d_k={d_k} d_v={d_v}")
    smem, ks, vs, bs = layout.pop("fit")
    split = layout["split"]
    out = dict(zip(KEYS_OUT, (
        smem, 384, ROWS if split else 2 * ROWS, ks,
        int(layout["n_chunks"] == 1), KEYS, 1 if split else 2, vs,
        bs if with_bias else 0, 1, int(not split))))
    out.update(layout, n_tiles=-(-length // KEYS))
    return out


def work_items(batch: int, heads: int, length: int, plan: dict, sms: int):
    """[block] -> the work items it walks, each as (b, h, first query row
    of each 64-row tile it holds); grid = min(items, sms)."""
    rows = plan["rows"]
    n_qt = -(-length // rows)
    n_items = batch * heads * n_qt
    grid = min(n_items, sms)
    blocks = []
    for block in range(grid):
        walk = []
        for item in range(block, n_items, grid):
            pair, q0 = divmod(item, n_qt)
            b, h = divmod(pair, heads)
            walk.append((b, h, tuple(q0 * rows + ROWS * w
                                     for w in range(rows // ROWS))))
        blocks.append(walk)
    return blocks
