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
    """At L <= 32 a block holds 4 or 2 (b, h) pairs; a pair count that
    leaves the last block part empty must write no row it does not own."""
    assert pairs % cuda_attention.tile(length).pairs
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


@pytest.mark.parametrize("length", [10, 49, 81])
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
    q = torch.zeros(1, 1, 129, 256, device=card)
    with pytest.raises(ValueError, match="L up to 128"):
        cuda_attention.attention(q, q, q, None, 16.0)
    q = torch.zeros(1, 1, 49, 256, device=card)
    with pytest.raises(TypeError):
        cuda_attention.attention(q.half(), q.half(), q.half(), None, 16.0)
    with pytest.raises(ValueError, match="innermost stride"):
        qt = torch.zeros(1, 1, 256, 49, device=card).transpose(-1, -2)
        cuda_attention.attention(qt, qt, qt, None, 16.0)
    assert cuda_attention.launches == before


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
