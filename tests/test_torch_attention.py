"""The PyTorch package's attention against the JAX package's.

``plain_sdpa`` (lstc_vad_tpu_torch/ops/attention.py) is held against
``_xla_sdpa`` and against the Pallas kernel run in interpret mode, at every
sequence length the models use, with the JAX test's tolerance
(tests/test_pallas_attention.py:26-27).  On the CPU the kernel's wrapper
runs the plain version; the kernel itself is checked on the card by
tests/test_torch_cuda_kernel.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from lstc_vad_tpu.ops.attention import _xla_sdpa
from lstc_vad_tpu.ops.pallas_attention import pallas_sdpa
from lstc_vad_tpu_torch.ops import cuda_attention
from lstc_vad_tpu_torch.ops.attention import plain_sdpa, sdpa

RTOL, ATOL = 2e-5, 2e-6
LENGTHS = (10, 17, 19, 28, 49, 81)  # STN 9/16 patches, UCF eval/train, SHT, UBnormal


def _inputs(seed, b, h, length, d, with_bias):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, length, d)).astype(np.float32)
               for _ in range(3))
    bias = (rng.standard_normal((h, length, length)).astype(np.float32)
            if with_bias else None)
    return q, k, v, bias


def _port(q, k, v, bias, temp, fn=plain_sdpa):
    t = torch.from_numpy
    return fn(t(q), t(k), t(v), temp,
              bias=None if bias is None else t(bias)).numpy()


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("length", LENGTHS)
def test_plain_matches_jax_and_pallas(length, with_bias):
    q, k, v, bias = _inputs(length, 3, 2, length, 32, with_bias)
    temp = float(np.sqrt(32))
    ours = _port(q, k, v, bias, temp)
    ref = np.asarray(_xla_sdpa(q, k, v, bias, None, temp, 0.0, None))
    pallas = np.asarray(pallas_sdpa(q, k, v, temp, bias=bias, interpret=True))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, rtol=RTOL, atol=ATOL)


def test_plain_matches_jax_at_model_head_width():
    """D = d_k = 256, the presets' head width, at the SHT LTN length."""
    q, k, v, bias = _inputs(1, 2, 2, 49, 256, True)
    temp = 16.0
    ref = np.asarray(_xla_sdpa(q, k, v, bias, None, temp, 0.0, None))
    np.testing.assert_allclose(_port(q, k, v, bias, temp), ref,
                               rtol=RTOL, atol=ATOL)


def test_mask_and_probs_match_jax():
    q, k, v, _ = _inputs(2, 2, 2, 9, 16, False)
    mask = np.ones((2, 1, 9, 9), np.float32)
    mask[:, :, :, -2:] = 0
    out, probs = sdpa(*(torch.from_numpy(a) for a in (q, k, v)), 4.0,
                      mask=torch.from_numpy(mask), return_probs=True)
    ref_out, ref_probs = _xla_sdpa(q, k, v, None, mask, 4.0, 0.0, None,
                                   return_probs=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_every_impl_on_cpu_is_the_plain_version(impl):
    q, k, v, bias = _inputs(3, 2, 2, 17, 32, True)
    t = torch.from_numpy
    before = cuda_attention.launches
    out = sdpa(t(q), t(k), t(v), 4.0, bias=t(bias), impl=impl)
    np.testing.assert_array_equal(out.numpy(), _port(q, k, v, bias, 4.0))
    assert cuda_attention.launches == before == 0


@pytest.mark.parametrize("impl", ["pallas", "cuda", "Auto"])
def test_unknown_impl_raises(impl):
    """The JAX package's values and near-misses are not this package's."""
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="unknown attention impl"):
        sdpa(q, q, q, temperature=2.0, impl=impl)


def test_dropout_changes_output_only_when_active():
    q, k, v, _ = _inputs(4, 2, 2, 9, 16, False)
    t = torch.from_numpy
    det = sdpa(t(q), t(k), t(v), 4.0)
    torch.manual_seed(0)
    dropped = sdpa(t(q), t(k), t(v), 4.0, dropout_p=0.5)
    assert not torch.allclose(det, dropped)


def test_kernel_shared_memory_limit():
    """K and V of one (b, h) pair live in shared memory: D=256 fits up to
    L=110, and the wrapper refuses a shape past the 227 KB a block may use
    before it reaches the card."""
    assert cuda_attention.smem_bytes(81, 256) <= cuda_attention.SMEM_LIMIT
    assert cuda_attention.smem_bytes(110, 256) <= cuda_attention.SMEM_LIMIT
    assert cuda_attention.smem_bytes(111, 256) > cuda_attention.SMEM_LIMIT
    q = torch.zeros(1, 1, 111, 256)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_attention._check(q, q, q, None, 16.0)


@pytest.mark.parametrize("bad", ["dtype", "d", "bias", "contiguous"])
def test_kernel_checks_reject_what_the_kernel_does_not_take(bad):
    q = torch.zeros(2, 2, 9, 32)
    bias = torch.zeros(2, 9, 9)
    if bad == "dtype":
        q = q.double()
    elif bad == "d":
        q = torch.zeros(2, 2, 9, 24)
    elif bad == "bias":
        bias = torch.zeros(1, 9, 9)
    else:
        q = torch.zeros(2, 2, 32, 9).transpose(-1, -2)
    with pytest.raises((TypeError, ValueError)):
        cuda_attention._check(q, q, q, bias, 4.0)
