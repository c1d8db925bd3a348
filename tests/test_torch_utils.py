"""``utils/seeding.py`` and ``utils/misc.py`` of the PyTorch package against
the JAX package's (lstc_vad_tpu/utils/seeding.py, utils/misc.py).

``set_seeds`` seeds the same host generators as JAX's (so ``random`` and
numpy draw the same numbers after either) and torch's default generators,
and returns a seeded ``torch.Generator`` where JAX returns a key.
``random_perturb`` draws bit-equal indices from the same numpy generator.
``resolve_dtype`` maps a wire-type name to a torch dtype.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

from lstc_vad_tpu.utils import misc as jax_misc
from lstc_vad_tpu.utils.seeding import set_seeds as jax_set_seeds
from lstc_vad_tpu_torch.utils import misc
from lstc_vad_tpu_torch.utils.seeding import set_seeds


@pytest.mark.parametrize("seed", [0, 7])
def test_set_seeds_seeds_what_jax_seeds_and_torch(seed):
    jax_set_seeds(seed)
    want = (random.random(), np.random.rand(3).tolist(),
            os.environ["PYTHONHASHSEED"])
    gen = set_seeds(seed)
    assert (random.random(), np.random.rand(3).tolist(),
            os.environ["PYTHONHASHSEED"]) == want
    a = torch.rand(4)
    torch.manual_seed(seed)
    assert torch.equal(a, torch.rand(4))
    assert isinstance(gen, torch.Generator)
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=torch.Generator()
                                  .manual_seed(seed)))


@pytest.mark.parametrize("v_len,segments", [(100, 32), (7, 3), (5, 5),
                                            (33, 1)])
def test_random_perturb_is_bit_equal_to_jax(v_len, segments):
    got = misc.random_perturb(v_len, segments, np.random.default_rng(3))
    want = jax_misc.random_perturb(v_len, segments, np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)


def test_resolve_dtype():
    assert misc.resolve_dtype("float32") is torch.float32
    assert misc.resolve_dtype("bfloat16") is torch.bfloat16
    for bad in ("int8", "nope", "Tensor"):
        with pytest.raises(ValueError, match="floating dtype"):
            misc.resolve_dtype(bad)


def test_decode_and_patchify_needs_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="opencv"):
        misc.decode_and_patchify([b""], 2, 2)


def test_decode_and_patchify_matches_jax():
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(0).integers(0, 255, (24, 36, 3), np.uint8)
    frames = [cv2.imencode(".jpg", img)[1].tobytes()] * 2
    got = misc.decode_and_patchify(frames, 2, 3)
    want = jax_misc.decode_and_patchify(frames, 2, 3)
    assert len(got) == 2 and len(got[0]) == 6
    for a, b in zip(got, want):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)
