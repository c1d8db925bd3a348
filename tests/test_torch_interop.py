"""Weights from the JAX package into the PyTorch package.

``state_dict_from_jax`` must give the keys and values of the JAX package's
own exporter (lstc_vad_tpu/ckpt/torch_export.py), bit for bit, and a
``.ckpt`` pair written by ``save_torch_checkpoint`` must load through
``load_reference_checkpoint`` — with or without a DataParallel ``module.``
prefix — and score as the JAX model does.
"""

import jax
import numpy as np
import pytest
import torch

from lstc_vad_tpu.ckpt.torch_export import (export_encoder, export_head,
                                            save_torch_checkpoint)
from lstc_vad_tpu.config import EncoderConfig as JaxEncoderConfig
from lstc_vad_tpu.models import Encoder as JaxEncoder
from lstc_vad_tpu.models import make_head as jax_make_head
from lstc_vad_tpu_torch.ckpt.interop import (load_reference_checkpoint,
                                             state_dict_from_jax)
from lstc_vad_tpu_torch.models import Encoder, make_head

from test_torch_encoder import CONFIGS, SMALL, port_config


def _jax_params(jcfg, n_tok, kind="classifier"):
    x = np.zeros((1, n_tok, jcfg.d_model), np.float32)
    enc = jax.tree.map(np.asarray, JaxEncoder(jcfg).init(
        jax.random.PRNGKey(0), x))["params"]
    head = jax.tree.map(np.asarray, jax_make_head(kind, jcfg.d_model, 32).init(
        jax.random.PRNGKey(1), x[:, 0]))["params"]
    return enc, head


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_bit_equal_to_jax_exporter(name):
    kw, n_tok = CONFIGS[name]
    jcfg = JaxEncoderConfig(attn_impl="xla", **{**SMALL, **kw})
    kind = "regressor" if "stn" in name else "classifier"
    enc, head = _jax_params(jcfg, n_tok, kind)
    ours_enc, ours_head = state_dict_from_jax(enc, head, jcfg, kind)
    for ours, ref in ((ours_enc, export_encoder(enc, jcfg)),
                      (ours_head, export_head(head, kind))):
        assert sorted(ours) == sorted(ref)
        for key, val in ref.items():
            assert ours[key].numpy().dtype == np.asarray(val).dtype, key
            np.testing.assert_array_equal(ours[key].numpy(), val,
                                          err_msg=key)
    # and the result loads strictly into the port's modules
    Encoder(port_config(jcfg), device="cpu").load_state_dict(ours_enc,
                                                             strict=True)
    make_head(kind, jcfg.d_model, 32, device="cpu").load_state_dict(
        ours_head, strict=True)


@pytest.mark.parametrize("prefix", ["", "module."])
def test_reference_ckpt_pair_loads_and_scores_the_same(tmp_path, prefix):
    kw, n_tok = CONFIGS["ltn_full_window_L49"]
    jcfg = JaxEncoderConfig(attn_impl="xla", **SMALL, **kw)
    enc, head = _jax_params(jcfg, n_tok)
    enc_path, head_path = str(tmp_path / "enc.ckpt"), str(tmp_path /
                                                          "head.ckpt")
    save_torch_checkpoint({"encoder": enc, "head": head}, enc_path,
                          head_path, "classifier", encoder_cfg=jcfg)
    if prefix:  # a DataParallel-wrapped save
        for path in (enc_path, head_path):
            sd = torch.load(path, weights_only=True)
            torch.save({prefix + k: v for k, v in sd.items()}, path)
    enc_sd, head_sd = load_reference_checkpoint(enc_path, head_path)
    assert not any(k.startswith("module.") for k in enc_sd)
    port_enc = Encoder(port_config(jcfg), device="cpu")
    port_enc.load_state_dict(enc_sd, strict=True)
    port_head = make_head("classifier", 64, 32, device="cpu")
    port_head.load_state_dict(head_sd, strict=True)

    x = np.random.default_rng(3).standard_normal((4, n_tok, 64),
                                                 dtype=np.float32)
    h = JaxEncoder(jcfg).apply({"params": enc}, x, deterministic=True)
    ref = jax_make_head("classifier", 64, 32).apply(
        {"params": head}, h[:, 0], deterministic=True)
    with torch.no_grad():
        ours = port_head.eval()(port_enc.eval()(torch.from_numpy(x))[:, 0])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)
