"""The f32 Linear operator ``lstc_vad::linear`` (ops/cuda_linear.py) on the
CPU, where it is ``F.linear`` itself.

On a CPU tensor the operator runs ``F.linear``, and its registered autograd
reruns autograd of ``F.linear`` on the saved inputs, so its outputs and
every gradient are ``F.linear``'s bit for bit: the port's CPU numbers, and
so its parity with the JAX package, do not move.  On the card the same
operator launches csrc/gemm.cu where ``route`` says so
(tests/test_torch_cuda_linear.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lstc_vad_tpu.config import EncoderConfig as JaxEncoderConfig
from lstc_vad_tpu.models import Encoder as JaxEncoder
from lstc_vad_tpu_torch.ckpt.interop import encoder_state_dict_from_jax
from lstc_vad_tpu_torch.config import PRESETS, EncoderConfig, preset
from lstc_vad_tpu_torch.models import Encoder, build
from lstc_vad_tpu_torch.ops import cuda_linear

# (x's shape, how it is laid out): 2-D and 3-D, contiguous, a transposed
# view, a slice off a wider buffer, and a view on an odd storage offset
LAYOUTS = {
    "2d": ((37, 24), "contiguous"),
    "3d": ((3, 49, 24), "contiguous"),
    "3d_transposed": ((3, 49, 24), "transposed"),
    "3d_sliced": ((3, 49, 24), "sliced"),
    "2d_offset": ((37, 24), "offset"),
}


def _x(shape, layout, seed=0):
    rng = np.random.default_rng(seed)
    if layout == "transposed":
        buf = rng.standard_normal((shape[0], shape[2], shape[1]))
        return torch.from_numpy(buf.astype(np.float32)).transpose(1, 2)
    if layout == "sliced":
        buf = rng.standard_normal(shape[:-1] + (shape[-1] + 5,))
        return torch.from_numpy(buf.astype(np.float32))[..., 2:2 + shape[-1]]
    if layout == "offset":
        buf = rng.standard_normal(int(np.prod(shape)) + 1).astype(np.float32)
        return torch.from_numpy(buf)[1:].view(shape)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _weights(n, k, with_bias, seed=1):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((n, k)) / k ** 0.5)
                         .astype(np.float32))
    b = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
         if with_bias else None)
    return w, b


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cpu_operator_is_f_linear_bit_for_bit(layout, with_bias):
    shape, how = LAYOUTS[layout]
    x = _x(shape, how)
    w, b = _weights(40, shape[-1], with_bias)
    got = cuda_linear.linear(x, w, b)
    want = F.linear(x, w, b)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cpu_gradients_are_f_linear_bit_for_bit(layout, with_bias):
    """x, weight and bias gradients through the operator against autograd
    of F.linear, for the same upstream gradient; and with x alone, or the
    parameters alone, requiring one."""
    shape, how = LAYOUTS[layout]
    w0, b0 = _weights(40, shape[-1], with_bias)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        shape[:-1] + (40,)).astype(np.float32))
    for need_x, need_params in ((True, True), (True, False), (False, True)):
        grads = []
        for fn in (cuda_linear.linear, F.linear):
            x = _x(shape, how).requires_grad_(need_x)
            w = w0.clone().requires_grad_(need_params)
            b = None if b0 is None else b0.clone().requires_grad_(need_params)
            fn(x, w, b).backward(g)
            grads.append([t.grad for t in (x, w, b) if t is not None])
        for got, want in zip(*grads):
            assert (got is None) == (want is None)
            if got is not None:
                assert torch.equal(got, want)


def _encoder_linears(cfg):
    """(name, out, in) of every Linear of one encoder layer."""
    c = cfg.encoder
    return [("w_qs", c.n_head * c.d_k, c.d_model),
            ("w_ks", c.n_head * c.d_k, c.d_model),
            ("w_vs", c.n_head * c.d_v, c.d_model),
            ("fc", c.d_model, c.n_head * c.d_v),
            ("w_1", c.d_inner, c.d_model),
            ("w_2", c.d_model, c.d_inner)]


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_route_at_every_presets_widths(name):
    """Every f32 Linear of every preset is one the kernel takes, for the
    forward and for the input gradient (the same widths swapped), d_inner
    3027 (the STN and UCF presets, rows not whole 16 bytes) too; bf16 is
    refused at every one of them, and so is an empty width."""
    cfg = preset(name)
    for lin, n, k in _encoder_linears(cfg):
        assert cuda_linear.check_kernel(torch.float32, n, k) is None, lin
        assert cuda_linear.check_kernel(torch.float32, k, n) is None, lin
        with pytest.raises(TypeError):
            cuda_linear.check_kernel(torch.bfloat16, n, k)
        with pytest.raises(TypeError):
            cuda_linear.check_kernel(torch.bfloat16, k, n)
    cuda_linear.check_kernel(torch.float32, 2048, 3027)
    cuda_linear.check_kernel(torch.float32, 3027, 2048)
    for n, k in ((2048, 0), (0, 2048)):
        with pytest.raises(ValueError):
            cuda_linear.check_kernel(torch.float32, n, k)


def test_fake_gives_the_shape_on_meta():
    x = torch.empty(3, 49, 24, device="meta")
    w = torch.empty(40, 24, device="meta")
    b = torch.empty(40, device="meta")
    for bias in (None, b):
        y = cuda_linear.linear(x, w, bias)
        assert y.device.type == "meta" and y.shape == (3, 49, 40)
        assert y.dtype == torch.float32
    assert cuda_linear.linear(x[0], w).shape == (49, 40)
    with pytest.raises(ValueError):
        cuda_linear.linear(x, torch.empty(40, 23, device="meta"))


@pytest.mark.parametrize("case", ["linear", "linear_bias", "input_grad",
                                  "weight_grad"])
def test_operators_pass_opcheck_on_the_cpu(case):
    """lstc_vad::linear (its autograd included), the input gradient's
    lstc_vad::linear_input_grad and the weight gradient's
    lstc_vad::linear_weight_grad: schema, fake implementation, tracing with
    dynamic shapes."""
    x = _x((3, 17, 24), "contiguous").requires_grad_()
    w, b = _weights(40, 24, case == "linear_bias")
    w.requires_grad_()
    if b is not None:
        b.requires_grad_()
    if case == "input_grad":
        op, args = torch.ops.lstc_vad.linear_input_grad.default, (
            _x((3, 17, 40), "contiguous"), w.detach())
    elif case == "weight_grad":
        op, args = torch.ops.lstc_vad.linear_weight_grad.default, (
            _x((3, 17, 40), "contiguous"), x.detach())
    else:
        op, args = torch.ops.lstc_vad.linear.default, (x, w, b)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_weight_grad_fake_gives_n_by_k_on_meta():
    """The weight gradient's fake: [N, K] for dY [..., N] and x [..., K],
    whatever the leading dimensions."""
    op = torch.ops.lstc_vad.linear_weight_grad
    for lead in ((3, 49), (147,), ()):
        g = torch.empty(*lead, 40, device="meta")
        x = torch.empty(*lead, 24, device="meta")
        dw = op(g, x)
        assert dw.device.type == "meta" and dw.shape == (40, 24)
        assert dw.dtype == torch.float32


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cpu_weight_grad_op_is_the_matmul(layout):
    """On the CPU the weight gradient's operator is dYᵀ·X by torch.matmul
    over the rows, bit for bit, at every layout of x."""
    shape, how = LAYOUTS[layout]
    x = _x(shape, how)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        shape[:-1] + (40,)).astype(np.float32))
    got = torch.ops.lstc_vad.linear_weight_grad(g, x)
    want = torch.matmul(g.reshape(-1, 40).t(), x.reshape(-1, shape[-1]))
    assert torch.equal(got, want)


def test_tma_rows_reads_padded_views_in_place():
    """``_tma_view`` pads a ragged width once (counted, 2 · M · width · 4
    bytes), and ``_tma_rows`` then reads that padded view in place, as it
    reads any ragged matrix whose rows lie a multiple of 4 elements apart
    on a 16-byte grid; an aligned width it takes as ``_rows`` does,
    contiguous (a copy of any other layout, uncounted)."""
    cuda_linear.reset_launches()
    g = torch.randn(3, 5, 7)
    padded = cuda_linear._tma_view(g)
    assert cuda_linear.pad_copies == 1
    assert cuda_linear.pad_bytes == 2 * g.numel() * 4
    assert padded.shape == g.shape and torch.equal(padded, g)
    rows, ld = cuda_linear._tma_rows(padded)
    assert ld == 8 and rows.data_ptr() == padded.data_ptr()
    assert torch.equal(rows, g.reshape(-1, 7))
    assert cuda_linear.pad_copies == 1  # read in place, no second copy
    rows, ld = cuda_linear._tma_rows(g)  # ragged: padded
    assert ld == 8 and cuda_linear.pad_copies == 2
    buf = torch.randn(15, 12)
    sliced = buf[:, 4:11]  # ragged rows 12 apart, 16 bytes in
    rows, ld = cuda_linear._tma_rows(sliced)
    assert ld == 12 and rows.data_ptr() == sliced.data_ptr()
    assert torch.equal(rows, sliced)
    sliced = buf[:, 4:8]  # aligned rows 12 apart: a contiguous copy
    rows, ld = cuda_linear._tma_rows(sliced)
    assert ld == 4 and rows.is_contiguous() and torch.equal(rows, sliced)
    transposed = torch.randn(8, 15).t()
    rows, ld = cuda_linear._tma_rows(transposed)
    assert ld == 8 and rows.is_contiguous()
    assert torch.equal(rows, transposed)
    assert cuda_linear.pad_copies == 2
    cuda_linear.reset_launches()
    assert cuda_linear.pad_copies == cuda_linear.pad_bytes == 0


def _counting(monkeypatch):
    """Counts the operator's calls (its implementation, whichever device)."""
    calls = []
    forward = cuda_linear._forward

    def counted(x, weight, bias):
        calls.append((tuple(weight.shape), bias is not None))
        return forward(x, weight, bias)

    monkeypatch.setattr(cuda_linear, "_forward", counted)
    return calls


def test_encoder_parity_with_jax_runs_through_the_operator(monkeypatch):
    """The JAX parity of tests/test_torch_encoder.py, with every Linear of
    the f32 encoder counted through the operator (6 a layer, biases on the
    FFN's), while a bf16-compute encoder's Linears never enter it."""
    calls = _counting(monkeypatch)
    jcfg = JaxEncoderConfig(attn_impl="xla", d_model=64, d_inner=96,
                            n_head=4, d_k=16, d_v=16, n_layers=2,
                            mha_layernorm=True, ffn_layernorm=True,
                            relative_pe=True, window_size=4, window_depth=3)
    x = np.random.default_rng(7).standard_normal((3, 48, 64),
                                                 dtype=np.float32)
    model = JaxEncoder(jcfg)
    params = jax.tree.map(np.asarray,
                          model.init(jax.random.PRNGKey(0), x))["params"]
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JaxEncoderConfig)}
    port = Encoder(EncoderConfig(**fields), device="cpu")
    port.load_state_dict(encoder_state_dict_from_jax(params, jcfg),
                         strict=True)
    ref = np.asarray(model.apply({"params": params}, x, deterministic=True))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    assert len(calls) == 6 * jcfg.n_layers
    assert sum(bias for _, bias in calls) == 2 * jcfg.n_layers

    calls.clear()
    bf16 = Encoder(dataclasses.replace(EncoderConfig(**fields),
                                       compute_dtype="bfloat16"),
                   device="cpu")
    bf16.load_state_dict(port.state_dict())
    with torch.no_grad():
        bf16.eval()(torch.from_numpy(x))
    assert calls == []


def _small_ltn():
    """A small LTN configuration, dropout off, and a batch for it."""
    cfg = preset("sht_ltn", **{
        "encoder.d_model": 32, "encoder.d_inner": 48, "encoder.n_head": 2,
        "encoder.d_k": 16, "encoder.d_v": 16, "encoder.n_layers": 2,
        "encoder.attn_dropout": 0.0, "encoder.fc_dropout": 0.0,
        "encoder.ffn_dropout": 0.0, "head.d_model": 32, "data.n_patch": 4,
        "data.d_model": 32, "data.part_len": 3})
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 12, 32)).astype(np.float32))
    return cfg, x


def test_train_step_gradients_run_through_the_operator(monkeypatch):
    """A small LTN's loss backward: every Linear's forward goes through the
    operator, and the parameters' gradients equal those of the same encoder
    with its Linears on F.linear, bit for bit."""
    cfg, x = _small_ltn()
    grads = []
    for through_op in (True, False):
        calls = _counting(monkeypatch)
        if not through_op:
            monkeypatch.setattr("lstc_vad_tpu_torch.models.encoder.linear",
                                F.linear)
        encoder, head = build(cfg, device="cpu", seed=0)
        encoder.train()
        torch.manual_seed(0)  # the same dropout masks, if any
        head(encoder(x)[:, 0]).sum().backward()
        assert len(calls) == (6 * cfg.encoder.n_layers if through_op else 0)
        grads.append({k: p.grad for k, p in encoder.named_parameters()
                      if p.grad is not None})
        monkeypatch.undo()
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_a_model_axis_of_one_rank_keeps_each_modules_product(monkeypatch):
    """On a model axis of one rank (``sharded_dense``) the encoder's
    Linears go through the operator and the heads' stay on F.linear, as
    each module runs off the mesh: the same calls, the same output and the
    same gradients, bit for bit."""
    from lstc_vad_tpu_torch.parallel import mesh, tp

    cfg, x = _small_ltn()
    runs = []
    for one_rank in (False, True):
        calls = _counting(monkeypatch)
        encoder, head = build(cfg, device="cpu", seed=0)
        if one_rank:
            for module in (encoder, head):
                for m in mesh._tp_modules(module):
                    m.tp = tp.Axis(None, 0, 1)
        encoder.train()
        out = head(encoder(x)[:, 0])
        out.sum().backward()
        grads = {k: p.grad for k, p in [*encoder.named_parameters(),
                                         *head.named_parameters()]
                 if p.grad is not None}
        runs.append((len(calls), out.detach(), grads))
        monkeypatch.undo()
    assert runs[0][0] == runs[1][0] == 6 * cfg.encoder.n_layers
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[0][2].keys() == runs[1][2].keys()
    for k, g in runs[0][2].items():
        assert torch.equal(g, runs[1][2][k]), k


def test_cuda_counters_are_plain_integers():
    cuda_linear.launches_wgrad = 5
    cuda_linear.reset_launches()
    assert cuda_linear.launches == cuda_linear.launches_dgrad == 0
    assert cuda_linear.launches_wgrad == 0
    assert type(cuda_linear.launches) is int
    assert type(cuda_linear.launches_dgrad) is int
    assert type(cuda_linear.launches_wgrad) is int
    x = torch.ones(2, 4, requires_grad=True)
    w = torch.ones(3, 4, requires_grad=True)
    cuda_linear.linear(x, w).sum().backward()
    torch.ops.lstc_vad.linear_weight_grad(torch.ones(2, 3), x.detach())
    # CPU calls launch nothing
    assert cuda_linear.launches == cuda_linear.launches_dgrad == 0
    assert cuda_linear.launches_wgrad == 0
