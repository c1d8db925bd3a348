"""The CUDA attention kernel against its plain version, on the card.

These tests need an NVIDIA card with nvcc; without one they skip.  The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py

Tolerance rtol 1e-4 / atol 1e-5: the kernel's products are 3xTF32 on the
tensor cores (each operand split into two TF32 halves, about 2^-22 of
relative error per product) and cuBLAS's are f32 FMA summed in another
order.  At logits near ±100 no f32 sum meets that tolerance against exact
arithmetic; there the kernel is held to float64 (test_kernel_large_logits).
"""

import numpy as np
import pytest
import torch

from lstc_vad_tpu_torch.ops import cuda_attention
from lstc_vad_tpu_torch.ops.attention import plain_sdpa

from bf16_stream_plan import KEYS_OUT as BF16_STREAM_KEYS
from bf16_stream_plan import bf16_stream_plan
from f32_tiled_plan import f32_plan as f32_plan_mirror

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-4, 1e-5
# every model L (STN, UCF, SHT, UBnormal) and both sides of each tile edge
LENGTHS = (1, 8, 10, 15, 16, 17, 19, 28, 31, 33, 49, 63, 64, 65, 81, 96, 127,
           128)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, seed, b, h, length, d, with_bias, strided=False):
    """q, k, v [B, H, L, D] (views of [B, L, H, D] buffers when
    ``strided``, as the encoder passes them) and bias [H, L, L] or None."""
    g = torch.Generator(device=card).manual_seed(seed)
    if strided:
        q, k, v = (torch.randn(b, length, h, d, device=card,
                               generator=g).transpose(1, 2)
                   for _ in range(3))
    else:
        q, k, v = (torch.randn(b, h, length, d, device=card, generator=g)
                   for _ in range(3))
    bias = (torch.randn(h, length, length, device=card, generator=g)
            if with_bias else None)
    return q, k, v, bias


def _check_against_plain(q, k, v, bias, temp):
    before = cuda_attention.launches
    out = cuda_attention.attention(q, k, v, bias, temp)
    torch.cuda.synchronize()
    assert cuda_attention.launches == before + 1
    assert torch.isfinite(out).all()
    ref = plain_sdpa(q, k, v, temp, bias=bias)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    return out


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("length", LENGTHS)
def test_kernel_matches_plain(card, length, with_bias):
    q, k, v, bias = _inputs(card, length, 5, 8, length, 256, with_bias)
    _check_against_plain(q, k, v, bias, 16.0)


@pytest.mark.parametrize("length", [17, 49, 128])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_kernel_narrow_heads(card, d, length):
    q, k, v, bias = _inputs(card, d + length, 3, 2, length, d, True)
    _check_against_plain(q, k, v, bias, float(np.sqrt(d)))


@pytest.mark.parametrize("length,pairs", [(10, 9), (16, 1), (28, 3),
                                          (31, 7)])
def test_kernel_partial_last_block(card, length, pairs):
    """At L <= 32 a tile packs 4 or 2 heads of a batch row; a pair count
    that is not a multiple of the heads a tile (here H = 1, so every tile
    has heads past H, zero-filled) must write no row it does not own."""
    assert pairs % cuda_attention.f32_plan(length, 64)["heads"]
    q, k, v, bias = _inputs(card, pairs, pairs, 1, length, 64, True)
    _check_against_plain(q, k, v, bias, 8.0)


@pytest.mark.parametrize("length", [10, 17, 49, 81, 128])
def test_kernel_reads_and_writes_the_encoders_layout(card, length):
    """Strided views of [B, L, H, D] buffers in; out is a view of a
    [B, L, H, D] buffer, so the encoder's reshape of it is a view."""
    q, k, v, bias = _inputs(card, 100 + length, 6, 8, length, 256, True,
                            strided=True)
    assert not q.is_contiguous()
    out = _check_against_plain(q, k, v, bias, 16.0)
    assert out.transpose(1, 2).is_contiguous()
    assert out.transpose(1, 2).reshape(6, length, 8 * 256)._base is not None


@pytest.mark.parametrize("length", [10, 49, 81, 128])
def test_kernel_large_logits(card, length):
    """q scaled by 30 puts the logits near ±100, past expf's overflow at
    88.7: only the row-max subtraction keeps the softmax finite.  At such
    logits the plain f32 version itself misses rtol 1e-4 / atol 1e-5
    against exact arithmetic (its f32 sums err by up to 1e-4 on the output,
    scripts/torch_attention_accuracy.py), so here both are held to the plain
    version run in float64, and the kernel must come out no farther from it
    than the plain f32 version does."""
    q, k, v, bias = _inputs(card, 200 + length, 4, 8, length, 256, True)
    q = q * 30
    assert torch.matmul(q / 16.0, k.transpose(-1, -2)).abs().max() > 89
    out = cuda_attention.attention(q, k, v, bias, 16.0)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    exact = plain_sdpa(q.double(), k.double(), v.double(), 16.0,
                       bias=bias.double())
    plain = plain_sdpa(q, k, v, 16.0, bias=bias)
    kernel_err = (out.double() - exact).abs().max().item()
    plain_err = (plain.double() - exact).abs().max().item()
    assert kernel_err <= plain_err, (kernel_err, plain_err)


def test_kernel_raises_instead_of_falling_back(card):
    before = cuda_attention.launches
    q = torch.zeros(1, 1, 49, 256, device=card)
    with pytest.raises(TypeError):
        cuda_attention.attention(q.half(), q.half(), q.half(), None, 16.0)
    with pytest.raises(ValueError, match="innermost stride"):
        qt = torch.zeros(1, 1, 256, 49, device=card).transpose(-1, -2)
        cuda_attention.attention(qt, qt, qt, None, 16.0)
    assert cuda_attention.launches == before


def test_f32_plan_fits_the_block(card):
    """The tiled f32 kernel's launch geometry, read from its C source, at
    every L and D it takes: equal to the written-out plan
    (tests/f32_tiled_plan.py) and inside a block's 227 KB; the shapes it
    does not take are refused."""
    for length in range(1, 129):
        for d in range(32, 257, 32):
            plan = cuda_attention.f32_plan(length, d)
            assert plan == f32_plan_mirror(length, d), (length, d, plan)
            assert plan["smem_bytes"] <= 232448, plan
    for length, d in ((0, 64), (129, 64), (49, 16), (49, 288), (49, 48)):
        with pytest.raises(ValueError):
            cuda_attention.f32_plan(length, d)


@pytest.mark.parametrize("d", [32, 96, 256])
@pytest.mark.parametrize("length", [1, 16, 17, 32, 33, 64, 65, 96, 127,
                                    128])
def test_f32_kernel_tile_edges(card, length, d):
    """Both sides of every tile edge (4, 2 and 1 heads a 64-row tile, one
    head over 128 rows) and of the key counts the products take, at one,
    three and eight 32-column chunks of D, with the bias, strided."""
    q, k, v, bias = _inputs(card, 5000 + length + d, 3, 8, length, d, True,
                            strided=True)
    _check_against_plain(q, k, v, bias, float(np.sqrt(d)))


@pytest.mark.parametrize("length", [1, 10, 16, 17, 28, 32])
@pytest.mark.parametrize("h", [1, 3, 5])
def test_f32_kernel_packs_heads_when_h_is_not_a_multiple(card, h, length):
    """H = 1, 3 or 5 where a tile packs 4 or 2 heads: every batch row ends
    in a partial tile whose missing heads are zero-filled (a box of more
    heads than the tensor has, at H = 1) and never stored; the scores
    between packed heads are masked."""
    heads = cuda_attention.f32_plan(length, 256)["heads"]
    assert heads > 1 and h % heads
    q, k, v, bias = _inputs(card, 5500 + 10 * h + length, 7, h, length, 256,
                            True, strided=True)
    _check_against_plain(q, k, v, bias, 16.0)


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("length,b,h", [(17, 400, 3), (49, 170, 5),
                                        (81, 50, 7)])
def test_f32_kernel_persistent_loop(card, length, b, h):
    """More tiles than the blocks' rings take at once (one block an SM), and
    a tile count that is not a multiple of them, so every ring walks
    several tiles and the last walk is partial."""
    plan = cuda_attention.f32_plan(length, 64)
    tiles, rings = b * -(-h // plan["heads"]), plan["rings"] * _sms()
    assert tiles > 2 * rings and tiles % rings
    q, k, v, bias = _inputs(card, 5700 + length, b, h, length, 64, True,
                            strided=True)
    _check_against_plain(q, k, v, bias, 8.0)


@pytest.mark.parametrize("length", [10, 49, 81, 128])
def test_f32_kernel_writes_only_its_view(card, length):
    """out a view of heads 2-4 and columns 0-95 of an encoder-layout
    [B, L, 8, 128] buffer filled with a guard value (q, k, v such views
    too): the kernel's TMA stores write the view and leave every other
    head, column and row of the buffer as it was."""
    import ctypes

    b, h, d, guard = 4, 3, 96, 7.0
    g = torch.Generator(device=card).manual_seed(5900 + length)

    def view(buf):
        return buf[:, :, 2:2 + h, :d].transpose(1, 2)

    q, k, v = (view(torch.randn(b, length, 8, 128, device=card, generator=g))
               for _ in range(3))
    bias = torch.randn(h, length, length, device=card, generator=g)
    buf = torch.full((b, length, 8, 128), guard, device=card)
    out = view(buf)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in cuda_attention._strides(t)))
    temp = float(np.sqrt(d))
    cuda_attention._launch_tiled(q, k, v, bias, temp, out, strides, "f32")
    torch.cuda.synchronize()
    ref = plain_sdpa(q, k, v, temp, bias=bias)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    untouched = torch.ones_like(buf, dtype=torch.bool)
    untouched[:, :, 2:2 + h, :d] = False
    assert (buf[untouched] == guard).all()


def test_f32_kernel_grid_past_65535_tiles(card):
    """B·H = 65,600 one-head tiles at L = 49: the persistent loop walks
    past the 65,535 a grid's y or z dimension would take."""
    q, k, v, bias = _inputs(card, 6100, 8200, 8, 49, 32, True, strided=True)
    assert 8200 * 8 > 65535
    _check_against_plain(q, k, v, bias, float(np.sqrt(32)))


@pytest.mark.parametrize("length", [40, 100])
@pytest.mark.parametrize("position", range(8))
def test_f32_kernel_key_order(card, position, length):
    """V zero but for the keys at one position of every 8-key group, at a
    64-row tile (L = 40) and a 128-row one (L = 100), each ending in a part
    of a group: the kernel reads P's k-slots in the key order
    0,2,4,6,1,3,5,7 and V^T in the same order, so a wrong permutation takes
    another key's probability at once."""
    q, k, v, bias = _inputs(card, 6200 + 10 * length + position, 2, 3,
                            length, 32, True)
    keep = (torch.arange(length, device=card) % 8 == position).float()
    v = (v * keep[:, None]).contiguous()
    _check_against_plain(q, k, v, bias, float(np.sqrt(32)))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("length", [17, 49, 81])
def test_kernel_backward_gives_the_plain_gradients(card, length, with_bias):
    """attention(...).sum().backward() through the kernel's autograd
    Function gives every input a gradient, equal to autograd through
    plain_sdpa: q, k, v as the encoder's strided views of leaves that
    require grad, and a bias that requires grad (the gathered RPE table)."""
    g = torch.Generator(device=card).manual_seed(300 + length)
    b, h, d = 6, 8, 256

    def leaves():
        gen = torch.Generator(device=card).manual_seed(300 + length)
        bufs = [torch.randn(b, length, h, d, device=card, generator=gen)
                .requires_grad_() for _ in range(3)]
        bias = (torch.randn(h, length, length, device=card, generator=gen)
                .requires_grad_() if with_bias else None)
        return bufs, bias

    w = torch.randn(b, h, length, d, device=card, generator=g)
    bufs, bias = leaves()
    before = cuda_attention.launches
    out = cuda_attention.attention(*(x.transpose(1, 2) for x in bufs), bias,
                                   16.0)
    assert out.grad_fn is not None
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert cuda_attention.launches == before + 1  # the backward launches none
    ref_bufs, ref_bias = leaves()
    ref = plain_sdpa(*(x.transpose(1, 2) for x in ref_bufs), 16.0,
                     bias=ref_bias)
    (ref * w).sum().backward()
    pairs = list(zip(bufs, ref_bufs))
    if with_bias:
        pairs.append((bias, ref_bias))
    for x, r in pairs:
        assert x.grad is not None
        np.testing.assert_allclose(x.grad.cpu().numpy(),
                                   r.grad.cpu().numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_sdpa_auto_with_grad_takes_the_kernel_and_keeps_the_graph(card):
    from lstc_vad_tpu_torch.ops.attention import sdpa

    q, k, v, bias = _inputs(card, 7, 4, 8, 49, 256, True, strided=True)
    q.requires_grad_()
    before = cuda_attention.launches
    out = sdpa(q, k, v, 16.0, bias=bias)
    assert cuda_attention.launches == before + 1
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


def _full_width(card, preset_name, **overrides):
    """The preset's encoder and head at full width from seed 0, once with
    the kernel and once with plain attention, holding the same weights."""
    from lstc_vad_tpu_torch.config import preset, replace
    from lstc_vad_tpu_torch.models import build

    cfg = preset(preset_name, **overrides)
    kernel = build(cfg, device=card, seed=0)
    plain = build(replace(cfg, **{"encoder.attn_impl": "plain"}),
                  device=card, seed=0)
    for a, b in zip(kernel, plain):
        b.load_state_dict(a.state_dict())
    return cfg, kernel, plain


def test_ucf_scorer_pass_takes_the_kernel(card):
    """The UCF LTN final eval (part_len 2, 32 bins, L2-normalized, L=19)
    through UCFBinnedScorer: every encoder call launches the kernel once a
    layer, and the part scores match the plain path within 5e-5."""
    from lstc_vad_tpu_torch.evaluation.scoring import UCFBinnedScorer

    cfg, kernel, plain = _full_width(card, "ucf_ltn", **{
        "encoder.window_depth": 2, "data.part_len": 2})
    rng = np.random.default_rng(0)
    items = [(rng.random((n, 9, 2048), dtype=np.float32), n)
             for n in (1, 20, 33, 250)]
    before = cuda_attention.launches
    scorer = UCFBinnedScorer(*kernel, 2, 9)
    got = scorer.score_videos(items)
    assert cuda_attention.launches - before == \
        cfg.encoder.n_layers * scorer.scorer.n_calls > 0
    want = UCFBinnedScorer(*plain, 2, 9).score_videos(items)
    for (s, parts, _), (ws, wparts, _) in zip(got, want):
        assert parts == wparts
        np.testing.assert_allclose(s, ws, rtol=0, atol=5e-5)


def test_pseudo_label_pass_takes_the_kernel(card):
    """LTN pseudo labels at full sht_ltn width without tail re-window
    (L=49 and the short tails' 17 and 33): raw scores within 5e-5 of the
    plain path."""
    from lstc_vad_tpu_torch.data.annotations import TrainRecord
    from lstc_vad_tpu_torch.data.synthetic import SyntheticStore
    from lstc_vad_tpu_torch.evaluation.scoring import PartScorer
    from lstc_vad_tpu_torch.pseudo import generate_ltn_pseudo_labels

    cfg, kernel, plain = _full_width(card, "sht_ltn")
    rng = np.random.default_rng(1)
    store = SyntheticStore({f"v{n}": rng.standard_normal(
        (n, 16, 2048), dtype=np.float32) for n in (2, 13, 40, 71)})
    records = [TrainRecord(k, i % 2 == 1) for i, k in enumerate(store.feats)]
    before = cuda_attention.launches
    scorer = PartScorer(*kernel, 3, 16, tail_rewindow=False)
    got = generate_ltn_pseudo_labels(scorer, store, records, -1.0)
    assert cuda_attention.launches - before == \
        cfg.encoder.n_layers * scorer.scorer.n_calls > 0
    want = generate_ltn_pseudo_labels(
        PartScorer(*plain, 3, 16, tail_rewindow=False), store, records, -1.0)
    for key, labels in want.items():
        assert got[key].shape == (store.n_clips(key[:-4]),)
        np.testing.assert_allclose(got[key], labels, rtol=0, atol=5e-5)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_op_passes_opcheck_on_the_card(card, with_bias, grad):
    """The registered lstc_vad::attention on CUDA tensors: schema, fake
    implementation (shapes and strides of the kernel's output), autograd
    registration, and tracing with dynamic shapes."""
    q, k, v, bias = _inputs(card, 400 + 2 * with_bias + grad, 3, 8, 49, 256,
                            with_bias, strided=True)
    for t in (q, k, v) + ((bias,) if with_bias else ()):
        t.requires_grad_(grad)
    result = torch.library.opcheck(torch.ops.lstc_vad.attention.default,
                                   (q, k, v, bias, 16.0))
    assert set(result.values()) == {"SUCCESS"}, result


def _small_ltn(card, **overrides):
    """A small sht_ltn (d_k 32, the kernel's narrowest head) on ``card``."""
    from lstc_vad_tpu_torch.config import preset
    from lstc_vad_tpu_torch.models import build

    cfg = preset("sht_ltn", **{
        "encoder.d_model": 64, "encoder.d_inner": 96, "encoder.n_head": 2,
        "encoder.d_k": 32, "encoder.d_v": 32, "encoder.n_layers": 2,
        "head.d_model": 64, "head.hidden_dim": 16, "data.n_patch": 16,
        "data.d_model": 64, **overrides})
    return cfg, build(cfg, device=card, seed=0)


@pytest.mark.parametrize("export_on", ["cuda", "cpu"])
def test_exported_program_launches_the_kernel_on_the_card(card, tmp_path,
                                                          export_on):
    """An artifact exported on the card, or on the CPU, loads on the card
    and its programs launch the kernel once a layer per call, with the live
    kernel path's scores."""
    from lstc_vad_tpu_torch.evaluation.scoring import _scorer_apply
    from lstc_vad_tpu_torch.export import load_scorer, save_scorer_artifact

    cfg, (enc, head) = _small_ltn(card)
    if export_on == "cpu":
        from lstc_vad_tpu_torch.models import build

        cpu_enc, cpu_head = build(cfg, device="cpu", seed=0)
        cpu_enc.load_state_dict({k: t.cpu() for k, t in
                                 enc.state_dict().items()})
        cpu_head.load_state_dict({k: t.cpu() for k, t in
                                  head.state_dict().items()})
        exporter = (cpu_enc, cpu_head)
    else:
        exporter = (enc, head)
    path = str(tmp_path / "artifact")
    save_scorer_artifact(path, *exporter, "classifier", 48, 64,
                         extra_token_lens=(16, 32))
    loaded = load_scorer(path, device=card)
    rng = np.random.default_rng(0)
    for length in (16, 32, 48):
        x = rng.standard_normal((5, length, 64)).astype(np.float32)
        before = cuda_attention.launches
        got = loaded.score(x)
        assert cuda_attention.launches - before == cfg.encoder.n_layers
        with torch.inference_mode():
            want = _scorer_apply(enc, head, "classifier", False,
                                 torch.from_numpy(x).to(card)).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    assert loaded.score(x[:1]).shape == (1,)


def test_fit_from_a_pack_equals_fit_from_memory(card, tmp_path):
    """One fit(1) step of a small sht_ltn from a .lstcpack (batches through
    get_batch and the native gather) and from the same features in memory
    (per item), at the preset's dropouts from the same seed: the same
    batches and dropout masks, so the same loss; the train-split evaluation
    after the step launches the kernel once a layer per encoder call.  The
    updated parameters agree to rtol 1e-5 (the RPE table's gradient is
    summed with atomics, in no fixed order), and so do the AUCs, to 1e-4."""
    from lstc_vad_tpu_torch.config import preset, replace
    from lstc_vad_tpu_torch.data.annotations import TrainRecord
    from lstc_vad_tpu_torch.data.packed import write_pack
    from lstc_vad_tpu_torch.data.synthetic import (SyntheticStore,
                                                   write_train_files)
    from lstc_vad_tpu_torch.train.driver import Trainer

    rng = np.random.default_rng(2)
    feats, records, masks = {}, [], {}
    for i in range(10):
        key, abnormal, n = f"v{i:02d}", i >= 6, int(rng.integers(12, 30))
        feats[key] = rng.standard_normal((n, 16, 64), dtype=np.float32)
        records.append(TrainRecord(key, abnormal))
        if abnormal:
            masks[key] = (np.arange(n * 16) < n * 8).astype(np.float64)
    train_txt, mask_dir = write_train_files(str(tmp_path), records, masks)
    pack = str(tmp_path / "feats.lstcpack")
    write_pack(pack, feats.items())
    cfg = preset("sht_ltn", **{
        "encoder.d_model": 64, "encoder.d_inner": 96, "encoder.n_head": 2,
        "encoder.d_k": 32, "encoder.d_v": 32, "encoder.n_layers": 2,
        "head.d_model": 64, "head.hidden_dim": 16, "data.n_patch": 16,
        "data.d_model": 64, "data.train_txt": train_txt,
        "data.test_mask_dir": mask_dir, "data.batch_size": 4,
        "model_save_dir": str(tmp_path / "ckpt")})
    runs = {}
    for name, kw in (("pack", {"data.pack_path": pack}), ("memory", {})):
        store = None if kw else SyntheticStore(feats)
        trainer = Trainer(replace(cfg, **kw), store=store, test_videos=[],
                          device=card)
        before = cuda_attention.launches
        result = trainer.fit(1)
        runs[name] = (trainer, result, cuda_attention.launches - before)
    (tp, rp, lp), (tm, rm, lm) = runs["pack"], runs["memory"]
    assert tp.store.native and rp.steps == rm.steps == 1
    assert rp.history[0]["loss"] == pytest.approx(rm.history[0]["loss"],
                                                  rel=1e-6)
    assert abs(rp.history[0]["auc_train"] - rm.history[0]["auc_train"]) \
        <= 1e-4
    assert lp == lm == cfg.encoder.n_layers * tp.scorer.scorer.n_calls > 0
    for (name, a), b in zip(tp.state.encoder.state_dict().items(),
                            tm.state.encoder.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=name)



# ----------------------------------------------------------- the bf16 route
#
# bf16 q, k, v go to csrc/attention_bf16.cu.  Its products are exact and
# summed in f32, as plain_sdpa's, but in another order; so a probability
# that lies near a bf16 rounding edge may round the other way in one of the
# two, which moves the output by up to 2^-7 (a bf16 ulp, relative, of the
# probabilities summed) times the largest |v|, and the output's own
# rounding by a bf16 ulp, under rtol 1e-2.  What holds the kernel's
# accuracy is the second check: against attention in float64 on the same
# bf16 inputs it errs no more than plain_sdpa does (x1.05).
BF16_RTOL = 1e-2


def _bf16_inputs(card, seed, b, h, length, d, with_bias, strided=False):
    q, k, v, bias = _inputs(card, seed, b, h, length, d, with_bias, strided)
    return q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16), \
        bias


def _exact(q, k, v, bias, temp):
    from lstc_vad_tpu_torch.ops.attention import scalar_in

    s = torch.matmul((q / scalar_in(temp, q.dtype)).double(),
                     k.double().transpose(-1, -2))
    if bias is not None:
        s = s + bias.double()
    return torch.matmul(torch.softmax(s, dim=-1), v.double())


def _check_bf16(q, k, v, bias, temp):
    before = (cuda_attention.launches, cuda_attention.launches_bf16)
    out = cuda_attention.attention(q, k, v, bias, temp)
    torch.cuda.synchronize()
    assert (cuda_attention.launches, cuda_attention.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    ref = plain_sdpa(q, k, v, temp, bias=bias)
    atol = 2 ** -7 * v.float().abs().max().item()
    err = (out.float() - ref.float()).abs()
    assert (err <= BF16_RTOL * ref.float().abs() + atol).all(), \
        err.max().item()
    exact = _exact(q, k, v, bias, temp)
    kernel_err = (out.double() - exact).abs().max().item()
    plain_err = (ref.double() - exact).abs().max().item()
    assert kernel_err <= 1.05 * plain_err + 1e-6, (kernel_err, plain_err)
    return out


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("length", LENGTHS)
def test_bf16_kernel_matches_plain(card, length, with_bias):
    q, k, v, bias = _bf16_inputs(card, length, 5, 8, length, 256, with_bias)
    _check_bf16(q, k, v, bias, 16.0)


@pytest.mark.parametrize("length", [17, 49, 128])
@pytest.mark.parametrize("d", [32, 96, 256])
def test_bf16_kernel_narrow_heads(card, d, length):
    """d=96: √96 is not a bf16 number; the kernel scales by the temperature
    rounded to bf16, as plain_sdpa (and JAX's weak scalar) does."""
    q, k, v, bias = _bf16_inputs(card, d + length, 3, 2, length, d, True)
    _check_bf16(q, k, v, bias, float(np.sqrt(d)))


@pytest.mark.parametrize("length,pairs", [(10, 9), (28, 3)])
def test_bf16_kernel_partial_last_block(card, length, pairs):
    """``pairs`` heads a batch row where a tile packs several heads: the
    row's last tile is partial, its missing heads zero-filled by TMA and
    never stored."""
    assert pairs % cuda_attention.bf16_plan(length, 64)["heads"]
    q, k, v, bias = _bf16_inputs(card, pairs, 2, pairs, length, 64, True)
    _check_bf16(q, k, v, bias, 8.0)


@pytest.mark.parametrize("length", [10, 17, 49, 81, 128])
def test_bf16_kernel_reads_and_writes_the_encoders_layout(card, length):
    q, k, v, bias = _bf16_inputs(card, 100 + length, 6, 8, length, 256, True,
                                 strided=True)
    assert not q.is_contiguous()
    out = _check_bf16(q, k, v, bias, 16.0)
    assert out.transpose(1, 2).is_contiguous()


def test_bf16_kernel_streams_misaligned_strides(card):
    """Rows 72 bytes apart do not fit the tiled kernel's 16-byte copies: the
    call goes to the streaming kernel; a bf16 bias is still refused."""
    q = torch.zeros(2, 2, 9, 36, device=card,
                    dtype=torch.bfloat16)[..., :32]  # rows 72 bytes apart
    before = cuda_attention.by_route["bf16_stream"]
    _check_bf16(q, q, q, None, 4.0)
    assert cuda_attention.by_route["bf16_stream"] == before + 1
    before = cuda_attention.launches
    ok = torch.zeros(2, 2, 9, 32, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 bias"):
        cuda_attention.attention(ok, ok, ok, torch.zeros(
            2, 9, 9, device=card, dtype=torch.bfloat16), 4.0)
    assert cuda_attention.launches == before


def test_bf16_plan_fits_the_block(card):
    """The tiled bf16 kernel's launch geometry at every L and D it takes:
    64-row tiles of 64/R heads of R = 16, 32 or 64 rows (the least that
    holds L), or 128 rows of one head over both consumer warpgroups of a
    block; as many ring stages, up to 4 (an even number at 64-row tiles,
    two of which are in flight), as a block's 227 KB hold beside two 8 KB
    O boxes a consumer warpgroup and 32 bytes of barriers a stage."""
    for length in range(1, 129):
        for d in range(32, 257, 32):
            plan = cuda_attention.bf16_plan(length, d)
            rows = plan["head_rows"]
            assert rows in (16, 32, 64, 128) and rows >= length, plan
            assert rows == 16 or rows // 2 < length, plan
            assert plan["rows"] == (128 if rows == 128 else 64), plan
            assert plan["heads"] == max(1, 64 // rows), plan
            assert plan["threads"] == 384, plan
            stage = 3 * -(-d // 64) * plan["rows"] * 128 + 32
            fixed = 2 * 2 * 8192
            assert plan["smem_bytes"] == plan["stages"] * stage + fixed
            assert plan["smem_bytes"] <= 232448, plan
            assert 1 <= plan["stages"] <= 4, plan
            step = 2 if plan["rows"] == 64 else 1  # two tiles in flight
            assert plan["stages"] % step == 0, plan
            assert plan["stages"] == 4 or \
                fixed + (plan["stages"] + step) * stage > 232448, plan
    for length, d in ((0, 64), (129, 64), (49, 16), (49, 288), (49, 48)):
        with pytest.raises(ValueError):
            cuda_attention.bf16_plan(length, d)


@pytest.mark.parametrize("d", [32, 96, 256])
@pytest.mark.parametrize("length", [1, 16, 17, 32, 33, 64, 65, 96, 127,
                                    128])
def test_bf16_kernel_tile_edges(card, length, d):
    """Both sides of every tile edge (4, 2 and 1 heads a 64-row tile, one
    head over 128 rows) at a width of one half box (32), one and a half
    (96: √96 is not a power of two, so q is scaled in shared memory) and
    four boxes (256: S is scaled in f32), with the bias, strided."""
    q, k, v, bias = _bf16_inputs(card, 3000 + length + d, 3, 8, length, d,
                                 True, strided=True)
    _check_bf16(q, k, v, bias, float(np.sqrt(d)))


@pytest.mark.parametrize("length", [1, 10, 16, 17, 28, 32])
@pytest.mark.parametrize("h", [1, 3, 5])
def test_bf16_kernel_packs_heads_when_h_is_not_a_multiple(card, h, length):
    """H = 1, 3 or 5 where a tile packs 4 or 2 heads: every batch row ends
    in a partial tile whose missing heads are zero-filled (a box of more
    heads than the tensor has, at H = 1) and never stored; the scores
    between packed heads are masked."""
    heads = cuda_attention.bf16_plan(length, 256)["heads"]
    assert heads > 1 and h % heads
    q, k, v, bias = _bf16_inputs(card, 3500 + 10 * h + length, 7, h, length,
                                 256, True, strided=True)
    _check_bf16(q, k, v, bias, 16.0)


@pytest.mark.parametrize("length,b,h", [(17, 100, 5), (49, 150, 3),
                                        (81, 50, 7)])
def test_bf16_kernel_persistent_loop(card, length, b, h):
    """More tiles than persistent blocks (one an SM), so every block walks
    several, with a partial last tile of each batch row where heads are
    packed."""
    heads = cuda_attention.bf16_plan(length, 64)["heads"]
    assert b * -(-h // heads) > 2 * _sms()
    q, k, v, bias = _bf16_inputs(card, 3700 + length, b, h, length, 64,
                                 True, strided=True)
    _check_bf16(q, k, v, bias, 8.0)


@pytest.mark.parametrize("length", [10, 49, 81, 128])
def test_bf16_kernel_writes_only_its_view(card, length):
    """out a view of heads 2-4 and columns 0-95 of an encoder-layout
    [B, L, 8, 128] buffer filled with a guard value (q, k, v such views
    too): the kernel's TMA stores write the view and leave every other
    head, column and row of the buffer as it was."""
    import ctypes

    b, h, d, guard = 4, 3, 96, 7.0
    g = torch.Generator(device=card).manual_seed(3900 + length)

    def view(buf):
        return buf[:, :, 2:2 + h, :d].transpose(1, 2)

    q, k, v = (view(torch.randn(b, length, 8, 128, device=card,
                                generator=g).to(torch.bfloat16))
               for _ in range(3))
    bias = torch.randn(h, length, length, device=card, generator=g)
    buf = torch.full((b, length, 8, 128), guard, device=card,
                     dtype=torch.bfloat16)
    out = view(buf)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in cuda_attention._strides(t)))
    temp = float(np.sqrt(d))
    cuda_attention._launch_tiled(q, k, v, bias, temp, out, strides, "bf16")
    torch.cuda.synchronize()
    ref = plain_sdpa(q, k, v, temp, bias=bias)
    atol = 2 ** -7 * v.float().abs().max().item()
    err = (out.float() - ref.float()).abs()
    assert (err <= BF16_RTOL * ref.float().abs() + atol).all()
    untouched = torch.ones_like(buf, dtype=torch.bool)
    untouched[:, :, 2:2 + h, :d] = False
    assert (buf[untouched] == guard).all()


@pytest.mark.parametrize("length", [10, 49, 81, 128])
def test_bf16_kernel_large_logits(card, length):
    """q scaled by 30 puts the logits near ±100, past expf's overflow: only
    the row-max subtraction keeps the softmax finite; no farther from
    attention in float64 than plain_sdpa (x1.05)."""
    q, k, v, bias = _bf16_inputs(card, 4100 + length, 4, 8, length, 256,
                                 True, strided=True)
    q = (q.float() * 30).to(torch.bfloat16)
    assert torch.matmul(q.float() / 16.0,
                        k.float().transpose(-1, -2)).abs().max() > 89
    _check_bf16(q, k, v, bias, 16.0)


def test_bf16_kernel_grid_past_65535_tiles(card):
    """B·H = 65,600 one-head tiles at L = 49: the persistent loop walks
    past the 65,535 a grid's y or z dimension would take."""
    q, k, v, bias = _bf16_inputs(card, 4300, 8200, 8, 49, 32, True,
                                 strided=True)
    assert 8200 * 8 > 65535
    _check_bf16(q, k, v, bias, float(np.sqrt(32)))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("length", [17, 49, 81])
def test_bf16_kernel_backward_gives_the_plain_gradients(card, length,
                                                        with_bias):
    """The registered autograd of the bf16 route is autograd through
    plain_sdpa on the saved bf16 inputs: the same gradients, bit for bit."""
    b, h, d = 6, 8, 256

    def leaves():
        gen = torch.Generator(device=card).manual_seed(400 + length)
        bufs = [torch.randn(b, length, h, d, device=card, generator=gen)
                .to(torch.bfloat16).requires_grad_() for _ in range(3)]
        bias = (torch.randn(h, length, length, device=card, generator=gen)
                .requires_grad_() if with_bias else None)
        return bufs, bias

    w = torch.randn(b, h, length, d, device=card).to(torch.bfloat16)
    bufs, bias = leaves()
    out = cuda_attention.attention(*(x.transpose(1, 2) for x in bufs), bias,
                                   16.0)
    (out * w).float().sum().backward()
    ref_bufs, ref_bias = leaves()
    ref = plain_sdpa(*(x.transpose(1, 2) for x in ref_bufs), 16.0,
                     bias=ref_bias)
    (ref * w).float().sum().backward()
    pairs = list(zip(bufs, ref_bufs))
    if with_bias:
        pairs.append((bias, ref_bias))
    for x, r in pairs:
        assert x.grad is not None and x.grad.dtype == x.dtype
        assert torch.equal(x.grad, r.grad)


def test_remat_step_launches_the_kernel_twice_per_layer(card):
    """With attention dropout 0 and remat, each layer's forward runs twice
    in a step (the recompute), the kernel of the compute type each time;
    the loss and gradients equal the step without remat bit for bit."""
    from lstc_vad_tpu_torch.config import replace
    from lstc_vad_tpu_torch.train import create_train_state, make_train_step

    cfg, _ = _small_ltn(card, **{"encoder.attn_dropout": 0.0,
                                 "encoder.compute_dtype": "bfloat16",
                                 "data.part_num": 2, "data.batch_size": 2})
    d = cfg.data
    rng = np.random.default_rng(0)
    shape = (2, d.part_num * d.part_len, d.n_patch, cfg.encoder.d_model)
    batch = (rng.standard_normal(shape).astype(np.float32),
             np.zeros((2, d.part_num * d.part_len), np.float32),
             rng.standard_normal(shape).astype(np.float32),
             rng.random((2, d.part_num * d.part_len)).astype(np.float32))
    runs = []
    for remat in (False, True):
        c = replace(cfg, **{"encoder.remat": remat})
        state = create_train_state(c, device=card, seed=0)
        cuda_attention.reset_launches()
        metrics = make_train_step(c).grads(state, *batch)
        torch.cuda.synchronize()
        assert cuda_attention.launches == cuda_attention.launches_bf16 == \
            cfg.encoder.n_layers * (2 if remat else 1)
        runs.append((metrics["loss"], [p.grad for p in
                                       state.encoder.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert (a is None) == (b is None)
        if a is not None:
            # the RPE table's gradient is summed with atomics
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)



# ------------------------------------------------- the streaming kernel
#
# csrc/attention_stream.cu (f32) and csrc/attention_stream_bf16.cu (bf16)
# take every shape the tiled kernels do not: L > 128, d_k != d_v, widths
# that are not 32k up to 256, strides that do not fit 16-byte copies.  They
# are held to the same bars as the tiled kernel of their type: f32 at rtol
# 1e-4 / atol 1e-5 against plain_sdpa (and no farther from float64 than
# plain_sdpa at large logits), bf16 as _check_bf16 says.

# both sides of one and two key tiles (32 keys f32, 64 bf16), the models'
# L, and long parts
STREAM_LENGTHS = (1, 2, 17, 31, 33, 49, 63, 65, 127, 128, 129, 144, 192,
                  257, 512, 1024)
# (d_k, d_v): equal and unequal, narrow, not a multiple of 32, past 256 and
# across the split of O over warps (f32: 128 columns a warp; bf16: 256 a
# warpgroup, two past that, passes past 512), d_k 512 with config B's d_v
# at the shared-memory limit, and d_k 2048, where Q no longer fits whole
STREAM_WIDTHS = ((8, 8), (24, 48), (48, 24), (256, 256), (384, 512),
                 (1024, 8), (512, 1024), (64, 257), (512, 384), (2048, 64))


def _stream_inputs(card, seed, b, h, length, d_k, d_v, dtype, with_bias,
                   layout="contiguous"):
    """q, k [B, H, L, d_k], v [B, H, L, d_v] of ``dtype``: contiguous, as
    the encoder's views of [B, L, H, d] buffers (``strided``), views whose
    base lies one element past a 16-byte boundary (``unaligned``), or
    contiguous but for one such tensor (``unaligned_q``, ``_k``, ``_v``)."""
    g = torch.Generator(device=card).manual_seed(seed)

    def make(d, name):
        if layout == "strided":
            x = torch.randn(b, length, h, d, device=card, generator=g)
            return x.to(dtype).transpose(1, 2)
        x = torch.randn(b * h * length * d + 1, device=card, generator=g)
        x = x.to(dtype)
        start = int(layout in ("unaligned", f"unaligned_{name}"))
        return x[start:start + b * h * length * d].view(b, h, length, d)

    q, k, v = make(d_k, "q"), make(d_k, "k"), make(d_v, "v")
    bias = (torch.randn(h, length, length, device=card, generator=g)
            if with_bias else None)
    return q, k, v, bias


def _check_stream(q, k, v, bias, temp, forced=False):
    """One call that must take the streaming kernel of q's type (through
    its own launcher when ``forced``, else through the operator), held
    against plain_sdpa as the route's tiled kernel is."""
    name = "f32_stream" if q.dtype == torch.float32 else "bf16_stream"
    before = (cuda_attention.launches, cuda_attention.launches_stream,
              cuda_attention.by_route[name])
    fn = (cuda_attention.stream_attention if forced
          else cuda_attention.attention)
    if q.dtype == torch.bfloat16:
        return _check_bf16_with(fn, q, k, v, bias, temp, name, before)
    out = fn(q, k, v, bias, temp)
    torch.cuda.synchronize()
    _assert_stream_launch(name, before)
    assert out.shape == (*q.shape[:3], v.shape[-1])
    assert out.transpose(1, 2).is_contiguous()
    assert torch.isfinite(out).all()
    ref = plain_sdpa(q, k, v, temp, bias=bias)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    return out


def _assert_stream_launch(name, before):
    assert (cuda_attention.launches, cuda_attention.launches_stream,
            cuda_attention.by_route[name]) == tuple(x + 1 for x in before)


def _check_bf16_with(fn, q, k, v, bias, temp, name, before):
    out = fn(q, k, v, bias, temp)
    torch.cuda.synchronize()
    _assert_stream_launch(name, before)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert out.shape == (*q.shape[:3], v.shape[-1])
    ref = plain_sdpa(q, k, v, temp, bias=bias)
    atol = 2 ** -7 * v.float().abs().max().item()
    err = (out.float() - ref.float()).abs()
    assert (err <= BF16_RTOL * ref.float().abs() + atol).all(), \
        err.max().item()
    exact = _exact(q, k, v, bias, temp)
    kernel_err = (out.double() - exact).abs().max().item()
    plain_err = (ref.double() - exact).abs().max().item()
    assert kernel_err <= 1.05 * plain_err + 1e-6, (kernel_err, plain_err)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("widths", STREAM_WIDTHS,
                         ids=[f"dk{a}_dv{b}" for a, b in STREAM_WIDTHS])
@pytest.mark.parametrize("length", STREAM_LENGTHS)
def test_stream_kernel_grid(card, length, widths, dtype):
    """Every L of the grid at every width pair, both routes; with a bias
    at even L and widths, without at the others; strided as the encoder
    passes them where both widths are even."""
    d_k, d_v = widths
    with_bias = (length + d_k + d_v) % 2 == 0
    layout = "strided" if length % 2 else "contiguous"
    q, k, v, bias = _stream_inputs(card, length * 7 + d_k + d_v, 2, 3, length,
                                   d_k, d_v, getattr(torch, dtype),
                                   with_bias, layout)
    temp = float(np.sqrt(d_k))
    tiled = cuda_attention.route(q.dtype, length, d_k, d_v, True)
    _check_stream(q, k, v, bias, temp, forced=not tiled.endswith("_stream"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["strided", "unaligned", "unaligned_q",
                                    "unaligned_k", "unaligned_v"])
@pytest.mark.parametrize("length,d_k,d_v", [(49, 256, 256), (129, 256, 256),
                                            (33, 13, 7), (257, 20, 36),
                                            (129, 96, 160)])
def test_stream_kernel_views(card, length, d_k, d_v, layout, dtype):
    """Strided views and bases off the 16-byte grid (and widths that 16
    bytes do not divide), of all three tensors or of one: such a tensor is
    copied 4 bytes at a time (f32) or element by element by the producer
    warp instead of by TMA (bf16), with the same result."""
    q, k, v, bias = _stream_inputs(card, length + d_k, 3, 4, length, d_k, d_v,
                                   getattr(torch, dtype), True, layout)
    aligned = all(cuda_attention._aligned(t) for t in (q, k, v))
    width = 16 // q.element_size()  # elements in 16 bytes
    assert aligned == (layout == "strided" and d_k % width == 0
                       and d_v % width == 0)
    if layout.startswith("unaligned_"):
        for name, t in zip("qkv", (q, k, v)):
            if name != layout[-1]:
                assert cuda_attention._aligned(t) == (t.shape[-1] % width == 0)
            else:
                assert not cuda_attention._aligned(t)
    name = cuda_attention.route(q.dtype, length, d_k, d_v, aligned)
    _check_stream(q, k, v, bias, float(np.sqrt(d_k)),
                  forced=not name.endswith("_stream"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [1, 10, 17, 49, 64, 65, 81, 128])
def test_stream_kernel_where_the_tiled_kernel_runs(card, length, dtype):
    """Forced through its launcher at the tiled kernels' shapes (D = 256,
    bias, the encoder's views): the plain version's result, and the tiled
    kernel's within the route's tolerance."""
    q, k, v, bias = _stream_inputs(card, 500 + length, 5, 8, length, 256,
                                   256, getattr(torch, dtype), True,
                                   "strided")
    assert cuda_attention.route(q.dtype, length, 256, 256, True) == \
        ("f32" if dtype == "float32" else "bf16")
    streamed = _check_stream(q, k, v, bias, 16.0, forced=True)
    before = cuda_attention.launches_stream
    tiled = cuda_attention.attention(q, k, v, bias, 16.0)
    assert cuda_attention.launches_stream == before
    if dtype == "float32":
        np.testing.assert_allclose(streamed.cpu().numpy(),
                                   tiled.cpu().numpy(), rtol=RTOL, atol=ATOL)
    else:
        atol = 2 ** -7 * v.float().abs().max().item()
        err = (streamed.float() - tiled.float()).abs()
        assert (err <= BF16_RTOL * tiled.float().abs() + atol).all()


@pytest.mark.parametrize("growing", [False, True])
@pytest.mark.parametrize("length", [129, 257, 1024])
def test_stream_kernel_large_logits(card, length, growing):
    """Logits near ±100 (q scaled by 30): the kernel no farther from
    attention in float64 than the plain f32 version (see
    test_kernel_large_logits).  ``growing``: a bias that rises along the
    keys as well (0 to 60), so that the row max grows at every key tile and
    the online softmax rescales O each time."""
    q, k, v, bias = _stream_inputs(card, 700 + length, 2, 8, length, 256,
                                   128, torch.float32, True)
    q = q * 30
    if growing:
        bias = bias + torch.linspace(0, 60, length, device=card)
    out = cuda_attention.attention(q, k, v, bias, 16.0)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    exact = plain_sdpa(q.double(), k.double(), v.double(), 16.0,
                       bias=bias.double())
    plain = plain_sdpa(q, k, v, 16.0, bias=bias)
    kernel_err = (out.double() - exact).abs().max().item()
    plain_err = (plain.double() - exact).abs().max().item()
    assert kernel_err <= plain_err, (kernel_err, plain_err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length,d_k,d_v", [(129, 256, 256), (49, 16, 24),
                                            (257, 48, 80)])
def test_stream_kernel_backward_gives_the_plain_gradients(card, length, d_k,
                                                          d_v, dtype):
    """Through the operator at L = 129 and at d_v != d_k: the forward
    launches the streaming kernel, and the registered autograd (through
    plain_sdpa) gives the plain gradients bit for bit."""
    dt = getattr(torch, dtype)
    b, h = 4, 3

    def leaves():
        gen = torch.Generator(device=card).manual_seed(length + d_v)
        bufs = [torch.randn(b, length, h, d, device=card, generator=gen)
                .to(dt).requires_grad_() for d in (d_k, d_k, d_v)]
        bias = torch.randn(h, length, length, device=card,
                           generator=gen).requires_grad_()
        return bufs, bias

    w = torch.randn(b, h, length, d_v, device=card).to(dt)
    bufs, bias = leaves()
    before = cuda_attention.launches_stream
    out = cuda_attention.attention(*(x.transpose(1, 2) for x in bufs), bias,
                                   float(np.sqrt(d_k)))
    assert cuda_attention.launches_stream == before + 1
    (out * w).float().sum().backward()
    ref_bufs, ref_bias = leaves()
    ref = plain_sdpa(*(x.transpose(1, 2) for x in ref_bufs),
                     float(np.sqrt(d_k)), bias=ref_bias)
    (ref * w).float().sum().backward()
    for x, r in list(zip(bufs, ref_bufs)) + [(bias, ref_bias)]:
        assert x.grad is not None and torch.equal(x.grad, r.grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [65, 129, 257, 1024])
def test_stream_kernel_late_growing_max(card, length, dtype):
    """Scores that grow along the keys (a bias rising from 0 to 12, and the
    largest logit of each row in its last keys): every key tile raises the
    running max, so every tile rescales O and the sum; within the route's
    bars of plain_sdpa."""
    q, k, v, bias = _stream_inputs(card, 900 + length, 2, 4, length, 64, 96,
                                   getattr(torch, dtype), True, "strided")
    bias = bias + torch.linspace(0, 12, length, device=card)
    _check_stream(q, k, v, bias, 8.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("widths", STREAM_WIDTHS,
                         ids=[f"dk{a}_dv{b}" for a, b in STREAM_WIDTHS])
def test_stream_plan_fits_the_block(card, widths, dtype):
    """The launch geometry the streaming kernels compute: within a block's
    227 KB of shared memory and 1024 threads, whole warps, and Q held
    resident for the whole of d_k up to 512 (streamed in chunks only past
    what shared memory holds)."""
    d_k, d_v = widths
    for length in (1, 129, 1024):
        plan = cuda_attention.stream_plan(getattr(torch, dtype), length, d_k,
                                          d_v, True)
        assert 0 < plan["smem_bytes"] <= 232448, plan
        assert plan["threads"] % 32 == 0 and plan["threads"] <= 1024, plan
        assert plan["rows"] % 16 == 0 and plan["stages"] >= 1, plan
        if d_k <= 512:
            assert plan["q_resident"] == 1, plan
        if d_k >= 2048:
            assert plan["q_resident"] == 0, plan
        if dtype == "bfloat16":
            mirror = bf16_stream_plan(length, d_k, d_v, True)
            assert plan == {k: mirror[k] for k in BF16_STREAM_KEYS}, plan


@pytest.mark.parametrize("position", range(8))
def test_stream_kernel_f32_key_order(card, position):
    """V zero but for the keys at one position of every 8-key group (L =
    40: a whole tile and a part): the f32 kernel reads P's k-slots in the
    key order 0,2,4,6,1,3,5,7 and V^T in the same order, so a wrong
    permutation takes another key's probability at once."""
    q, k, v, bias = _stream_inputs(card, 60 + position, 2, 3, 40, 16, 24,
                                   torch.float32, True)
    keep = (torch.arange(40, device=card) % 8 == position).float()
    v = (v * keep[:, None]).contiguous()
    _check_stream(q, k, v, bias, 4.0)


# the f32 kernel's key tile
F32_STREAM_KEYS = 32


@pytest.mark.parametrize("length", [F32_STREAM_KEYS - 1, F32_STREAM_KEYS,
                                    F32_STREAM_KEYS + 1,
                                    2 * F32_STREAM_KEYS + 1])
def test_stream_kernel_f32_key_tile_edges(card, length):
    """Key counts at the f32 kernel's tile edges (one key short of a tile,
    a tile, one past, two tiles and one): the keys past L of the last tile
    score -inf and their V^T columns are zero."""
    q, k, v, bias = _stream_inputs(card, 80 + length, 3, 4, length, 256, 128,
                                   torch.float32, True, "strided")
    _check_stream(q, k, v, bias, 16.0)


@pytest.mark.parametrize("length", [1, 40, 129])
def test_stream_kernel_f32_steps_in_the_zero_fill(card, length):
    """d_k = d_v = 8: one 8-column step of a 128-column chunk holds data,
    the other fifteen lie in the zero fill of Q, K and V (TMA fills columns
    past d with 0) and add nothing."""
    q, k, v, bias = _stream_inputs(card, 90 + length, 2, 3, length, 8, 8,
                                   torch.float32, True)
    tiled = cuda_attention.route(q.dtype, length, 8, 8, True)
    _check_stream(q, k, v, bias, float(np.sqrt(8)),
                  forced=not tiled.endswith("_stream"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_kernel_grid_past_65535_blocks(card, dtype):
    """B·H = 22,000 pairs of 3 query tiles each at L = 129: 66,000 blocks,
    past the 65,535 a grid's y or z dimension would take."""
    q, k, v, bias = _stream_inputs(card, 11, 2750, 8, 129, 8, 8,
                                   getattr(torch, dtype), True, "strided")
    _check_stream(q, k, v, bias, float(np.sqrt(8)))


# --------------------------------- the bf16 streaming kernel's own edges
#
# csrc/attention_stream_bf16.cu: persistent blocks over work items of two
# 64-row query tiles (one a consumer warpgroup, in ping-pong) where d_v <=
# 256, one tile with O's columns split past that; the bias by TMA where L·4
# bytes is a multiple of 16, by a bulk copy a row elsewhere.  Each case is
# held to the bf16 bars (_check_bf16_with).


@pytest.mark.parametrize("length", [1, 65, 129, 320, 449])
def test_stream_bf16_odd_tile_count(card, length):
    """1, 3, 5, 7 and 8 64-row tiles: at an odd count the last item's
    second consumer warpgroup holds rows past L only, computes on the zero
    fill and stores nothing, and both warpgroups still take every turn."""
    q, k, v, bias = _stream_inputs(card, 30 + length, 3, 5, length, 256,
                                   256, torch.bfloat16, True, "strided")
    _check_stream(q, k, v, bias, 16.0, forced=length <= 128)


@pytest.mark.parametrize("widths", [(256, 256), (48, 24)],
                         ids=["d256", "dk48_dv24"])
@pytest.mark.parametrize("length", [63, 127, 191, 193, 255, 257, 511, 513])
def test_stream_bf16_key_tile_edges(card, length, widths):
    """L = 64k - 1 and 64k + 1: the last key tile one key short of full or
    one key long, masked past L, in both phases."""
    d_k, d_v = widths
    q, k, v, bias = _stream_inputs(card, 40 + length, 2, 3, length, d_k, d_v,
                                   torch.bfloat16, True, "strided")
    _check_stream(q, k, v, bias, float(np.sqrt(d_k)), forced=length <= 128)


@pytest.mark.parametrize("heads", [3, 4])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("length", [129, 130, 131, 132, 257])
def test_stream_bf16_bias_rows_off_the_grid(card, length, offset, heads):
    """Bias rows whose L·4 bytes are not a multiple of 16 (L = 129, 130,
    131, 257) come by a bulk copy a row, each row's first key at its own
    place in its 16-byte chunk; so does a bias whose base lies ``offset``
    floats past a 16-byte boundary even where L = 132 would take TMA; at
    3 and 4 heads."""
    h = heads
    q, k, v, _ = _stream_inputs(card, 50 + length, 2, h, length, 256, 256,
                                torch.bfloat16, False, "strided")
    g = torch.Generator(device=card).manual_seed(length + offset)
    buf = torch.randn(h * length * length + 4, device=card, generator=g)
    bias = buf[offset:offset + h * length * length].view(h, length, length)
    assert bias.is_contiguous()
    _check_stream(q, k, v, bias, 16.0)


@pytest.mark.parametrize("widths", [(512, 384), (384, 512), (64, 257),
                                    (512, 1024)],
                         ids=["config_b", "dk384_dv512", "dk64_dv257",
                              "dk512_dv1024"])
@pytest.mark.parametrize("length", [1, 49, 64, 65, 129, 257])
def test_stream_bf16_column_split(card, length, widths):
    """d_v past 256: one 64-row tile a work item, O's columns split over
    both consumer warpgroups, S and P computed once by warpgroup 0 and P
    handed to warpgroup 1 through shared memory (in passes of 384 columns
    at d_v 512 and 1024); config B's heads among them."""
    d_k, d_v = widths
    plan = cuda_attention.stream_plan(torch.bfloat16, length, d_k, d_v, True)
    assert plan["row_tiles"] == 1 and plan["pingpong"] == 0
    q, k, v, bias = _stream_inputs(card, 60 + length + d_v, 4, 4, length, d_k,
                                   d_v, torch.bfloat16, True, "strided")
    _check_stream(q, k, v, bias, float(np.sqrt(d_k)))


@pytest.mark.parametrize("pairs,length", [(1, 129), (2, 65), (1, 1),
                                          (35000, 129)])
def test_stream_bf16_persistent_loop(card, pairs, length):
    """Fewer work items than SMs (2, 2 and 1 items: most blocks of a
    full grid would have none, so the grid is cut to the items) and more
    than 65,535 (70,000 items over one block an SM)."""
    q, k, v, bias = _stream_inputs(card, 70 + length, pairs, 1, length, 8, 8,
                                   torch.bfloat16, True, "strided")
    _check_stream(q, k, v, bias, float(np.sqrt(8)), forced=length <= 128)


@pytest.mark.parametrize("length", [129, 257, 1024])
def test_stream_bf16_late_growing_max_across_phases(card, length):
    """At D = 256 (two query tiles a block, the bias by TMA at 1024 and by
    rows at 129 and 257): a bias rising by 4 at every key tile, so the
    running max of phase 0 grows at each tile and phase 1's probabilities
    all come from the final max and sum."""
    q, k, v, bias = _stream_inputs(card, 80 + length, 2, 4, length, 256, 256,
                                   torch.bfloat16, True, "strided")
    bias = bias + 4.0 * (torch.arange(length, device=card) // 64)
    _check_stream(q, k, v, bias.contiguous(), 16.0)


def test_routes_on_the_card_follow_the_shape(card):
    """The tiled kernels keep their shapes (the main path's, L <= 128, D =
    32k up to 256, aligned); every other shape launches the streaming
    kernel, counted once in its route."""
    cases = [((49, 256, 256), "strided", "f32"),
             ((128, 32, 32), "contiguous", "f32"),
             ((129, 256, 256), "strided", "f32_stream"),
             ((49, 256, 128), "strided", "f32_stream"),
             ((49, 288, 288), "contiguous", "f32_stream"),
             ((49, 256, 256), "unaligned", "f32_stream")]
    for dtype in (torch.float32, torch.bfloat16):
        for (length, d_k, d_v), layout, want in cases:
            if dtype == torch.bfloat16:
                want = want.replace("f32", "bf16")
            q, k, v, bias = _stream_inputs(card, length, 2, 8, length, d_k,
                                           d_v, dtype, True, layout)
            cuda_attention.reset_launches()
            cuda_attention.attention(q, k, v, bias, 16.0)
            assert cuda_attention.by_route == {
                r: int(r == want) for r in cuda_attention.ROUTES}, want
            assert cuda_attention.launches == 1
            assert cuda_attention.launches_stream == int(
                want.endswith("_stream"))
            assert cuda_attention.launches_bf16 == int(
                dtype == torch.bfloat16)


def test_long_part_encoder_takes_the_streaming_kernel(card):
    """A small sht_ltn at part_len 8 (L = 129) and one with d_v != d_k
    score parts on the card through the streaming kernel, once a layer a
    call, within 5e-5 of the plain path."""
    from lstc_vad_tpu_torch.config import replace
    from lstc_vad_tpu_torch.evaluation.scoring import _scorer_apply
    from lstc_vad_tpu_torch.models import build

    for overrides in ({"data.part_len": 8, "encoder.window_depth": 8},
                      {"encoder.d_k": 24, "encoder.d_v": 40}):
        cfg, (enc, head) = _small_ltn(card, **overrides)
        plain_enc, plain_head = build(
            replace(cfg, **{"encoder.attn_impl": "plain"}), device=card,
            seed=0)
        plain_enc.load_state_dict(enc.state_dict())
        plain_head.load_state_dict(head.state_dict())
        n_tok = cfg.data.part_len * cfg.data.n_patch
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (6, n_tok, 64)).astype(np.float32)).to(card)
        cuda_attention.reset_launches()
        with torch.inference_mode():
            got = _scorer_apply(enc, head, "classifier", False, x)
            assert cuda_attention.launches_stream == \
                cuda_attention.launches == cfg.encoder.n_layers
            want = _scorer_apply(plain_enc, plain_head, "classifier", False,
                                 x)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=5e-5)
