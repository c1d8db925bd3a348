"""The CUDA attention kernel against its plain version, on the card.

These tests need an NVIDIA card with nvcc; without one they skip.  The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py

Tolerance rtol 1e-4 / atol 1e-5: cuBLAS sums the plain version's products in
another order than the kernel's FMA chains and warp shuffles.
"""

import numpy as np
import pytest
import torch

from lstc_vad_tpu_torch.ops import cuda_attention
from lstc_vad_tpu_torch.ops.attention import plain_sdpa

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("length", [1, 10, 17, 19, 28, 49, 81, 110])
def test_kernel_matches_plain(card, length, with_bias):
    g = torch.Generator(device=card).manual_seed(length)
    q, k, v = (torch.randn(5, 8, length, 256, device=card, generator=g)
               for _ in range(3))
    bias = (torch.randn(8, length, length, device=card, generator=g)
            if with_bias else None)
    before = cuda_attention.launches
    out = cuda_attention.attention(q, k, v, bias, 16.0)
    torch.cuda.synchronize()
    assert cuda_attention.launches == before + 1
    ref = plain_sdpa(q, k, v, 16.0, bias=bias)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_kernel_narrow_heads(card, d):
    g = torch.Generator(device=card).manual_seed(d)
    q, k, v = (torch.randn(3, 2, 49, d, device=card, generator=g)
               for _ in range(3))
    out = cuda_attention.attention(q, k, v, None, float(np.sqrt(d)))
    ref = plain_sdpa(q, k, v, float(np.sqrt(d)))
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


def test_kernel_raises_instead_of_falling_back(card):
    q = torch.zeros(1, 1, 111, 256, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_attention.attention(q, q, q, None, 16.0)
    with pytest.raises(TypeError):
        cuda_attention.attention(q.half(), q.half(), q.half(), None, 16.0)
