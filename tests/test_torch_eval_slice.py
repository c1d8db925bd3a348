"""The PyTorch package's evaluation slice against the JAX package's, end to
end on a ShanghaiTech-shaped synthetic set (tests/fixtures.py): test-split
loading, part chunking, the batched scorer, frame expansion and the AUC.

The two stacks score the same features with the same weights (JAX init,
mapped by ckpt/interop.py).  Per-video frame scores must agree within atol
1e-5 and the AUC within 1e-4: the small residual comes from another f32
summation order, which can swap near-tied parts.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from fixtures import make_sht_like
from lstc_vad_tpu.ckpt.torch_export import save_torch_checkpoint
from lstc_vad_tpu.config import preset as jax_preset
from lstc_vad_tpu.data.datasets import load_test_videos as jax_load_videos
from lstc_vad_tpu.data.feature_store import FeatureStore as JaxFeatureStore
from lstc_vad_tpu.evaluation import drivers as jax_drivers
from lstc_vad_tpu.evaluation import scoring as jax_scoring
from lstc_vad_tpu.models import Encoder as JaxEncoder
from lstc_vad_tpu.models import make_head as jax_make_head
from lstc_vad_tpu_torch import cli
from lstc_vad_tpu_torch.ckpt.interop import state_dict_from_jax
from lstc_vad_tpu_torch.data import FeatureStore, load_test_videos
from lstc_vad_tpu_torch.evaluation import drivers
from lstc_vad_tpu_torch.evaluation.scoring import ClipScorer, PartScorer
from lstc_vad_tpu_torch.models import Encoder, make_head
from lstc_vad_tpu_torch.ops import cuda_attention

from test_torch_encoder import port_config

# an sht-shaped small model: 16 patches, 3-clip parts (49 tokens), 3-D RPE
SMALL = {"encoder.d_model": 32, "encoder.d_inner": 48, "encoder.n_head": 2,
         "encoder.d_k": 16, "encoder.d_v": 16, "encoder.n_layers": 2,
         "head.d_model": 32, "head.hidden_dim": 16, "data.n_patch": 16,
         "data.d_model": 32}
SET_FLAGS = [a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]


@pytest.fixture(scope="module")
def sht(tmp_path_factory):
    return make_sht_like(str(tmp_path_factory.mktemp("sht")), n_patch=16,
                         d_model=32)


def _jax_side(preset_name, h5, test_txt, mask_dir, tail_rewindow=True):
    """JAX weights, scorer and per-video frame scores for the preset."""
    cfg = jax_preset(preset_name, **SMALL)
    d = cfg.data
    enc = JaxEncoder(cfg.encoder)
    head = jax_make_head(cfg.head.kind, cfg.head.d_model, cfg.head.hidden_dim)
    n_tok = d.n_patch * (1 if cfg.model == "stn" else d.part_len)
    x = np.zeros((1, n_tok, d.d_model), np.float32)
    params = {"encoder": enc.init(jax.random.PRNGKey(0), x)["params"],
              "head": head.init(jax.random.PRNGKey(1), x[:, 0])["params"]}
    params = jax.tree.map(np.asarray, params)
    store = JaxFeatureStore(h5)
    videos = jax_load_videos("SHT", test_txt, store, mask_dir=mask_dir)
    items = [(v.feat, v.anno) for v in videos]
    if cfg.model == "stn":
        scorer = jax_scoring.ClipScorer(enc, head, d.n_patch)
        auc, scores = jax_drivers.evaluate_stn(params, scorer, items,
                                               return_scores=True)
    else:
        scorer = jax_scoring.PartScorer(enc, head, d.part_len, d.n_patch,
                                        tail_rewindow=tail_rewindow)
        auc, scores = jax_drivers.evaluate_ltn(params, scorer, items,
                                               return_scores=True)
    store.close()
    return cfg, params, auc, scores


def _port_models(cfg, params):
    enc_sd, head_sd = state_dict_from_jax(params["encoder"], params["head"],
                                          cfg.encoder, cfg.head.kind)
    enc = Encoder(port_config(cfg.encoder), device="cpu")
    enc.load_state_dict(enc_sd, strict=True)
    head = make_head(cfg.head.kind, cfg.head.d_model, cfg.head.hidden_dim,
                     device="cpu")
    head.load_state_dict(head_sd, strict=True)
    return enc, head


def _assert_same(ours, ref):
    auc, scores = ours
    ref_auc, ref_scores = ref
    assert len(scores) == len(ref_scores)
    for a, b in zip(scores, ref_scores):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert abs(auc - ref_auc) <= 1e-4


@pytest.mark.parametrize("tail_rewindow", [True, False])
def test_ltn_slice_matches_jax(sht, tail_rewindow):
    h5, _, test_txt, mask_dir = sht
    cfg, params, ref_auc, ref_scores = _jax_side("sht_ltn", h5, test_txt,
                                                 mask_dir, tail_rewindow)
    enc, head = _port_models(cfg, params)
    store = FeatureStore(h5)
    videos = load_test_videos("SHT", test_txt, store, mask_dir=mask_dir)
    scorer = PartScorer(enc, head, cfg.data.part_len, cfg.data.n_patch,
                        tail_rewindow=tail_rewindow)
    before = cuda_attention.launches
    ours = drivers.evaluate_ltn(scorer, [((lambda v=v: v.feat), v.anno)
                                         for v in videos],
                                return_scores=True)
    store.close()
    _assert_same(ours, (ref_auc, ref_scores))
    # on the CPU the wrapper runs the plain version and launches nothing
    assert cuda_attention.launches == before == 0
    assert scorer.scorer.n_calls >= 1


def test_stn_slice_matches_jax(sht):
    h5, _, test_txt, mask_dir = sht
    cfg, params, ref_auc, ref_scores = _jax_side("sht_stn", h5, test_txt,
                                                 mask_dir)
    enc, head = _port_models(cfg, params)
    store = FeatureStore(h5)
    videos = load_test_videos("SHT", test_txt, store, mask_dir=mask_dir)
    ours = drivers.evaluate_stn(ClipScorer(enc, head, cfg.data.n_patch),
                                [(v.feat, v.anno) for v in videos],
                                return_scores=True)
    store.close()
    _assert_same(ours, (ref_auc, ref_scores))


def _run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    line = [ln for ln in out.getvalue().splitlines()
            if ln.startswith("auc = ")]
    return float(line[-1].split("=")[1])


@pytest.mark.parametrize("preset_name", ["sht_ltn", "sht_stn"])
def test_cli_evaluate_matches_jax(sht, tmp_path, preset_name):
    h5, _, test_txt, mask_dir = sht
    cfg, params, ref_auc, _ = _jax_side(preset_name, h5, test_txt, mask_dir)
    enc_path, head_path = str(tmp_path / "e.ckpt"), str(tmp_path / "h.ckpt")
    save_torch_checkpoint(params, enc_path, head_path, cfg.head.kind,
                          encoder_cfg=cfg.encoder)
    auc = _run_cli(["evaluate", "--preset", preset_name, "--h5", h5,
                    "--test-txt", test_txt, "--mask-dir", mask_dir,
                    "--torch-ckpt", "--encoder-ckpt", enc_path,
                    "--head-ckpt", head_path, "--device", "cpu",
                    *SET_FLAGS])
    assert abs(auc - ref_auc) <= 1e-4


@pytest.mark.parametrize("preset_name", ["sht_ltn", "sht_stn"])
def test_cli_evaluate_from_a_pack_matches_jax(sht, tmp_path, preset_name):
    """``evaluate --set data.pack_path=...`` over a pack made from the h5:
    the JAX AUC within 1e-4, and the port's own ``--h5`` AUC exactly."""
    from lstc_vad_tpu_torch.data.packed import pack_h5

    h5, _, test_txt, mask_dir = sht
    cfg, params, ref_auc, _ = _jax_side(preset_name, h5, test_txt, mask_dir)
    enc_path, head_path = str(tmp_path / "e.ckpt"), str(tmp_path / "h.ckpt")
    save_torch_checkpoint(params, enc_path, head_path, cfg.head.kind,
                          encoder_cfg=cfg.encoder)
    pack = str(tmp_path / "feats.lstcpack")
    pack_h5(h5, pack)
    common = ["evaluate", "--preset", preset_name, "--test-txt", test_txt,
              "--mask-dir", mask_dir, "--torch-ckpt", "--encoder-ckpt",
              enc_path, "--head-ckpt", head_path, "--device", "cpu",
              *SET_FLAGS]
    auc = _run_cli([*common, "--set", f"data.pack_path={pack}"])
    assert abs(auc - ref_auc) <= 1e-4
    assert auc == _run_cli([*common, "--h5", h5])


def test_entry_points_need_a_card_unless_told_cpu(sht):
    """Without a card, the default device fails loudly instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    h5, _, test_txt, mask_dir = sht
    from lstc_vad_tpu_torch.config import preset
    from lstc_vad_tpu_torch.models import Encoder, build, make_head

    cfg = preset("sht_ltn", **SMALL)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Encoder(cfg.encoder)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_head(cfg.head.kind, cfg.head.d_model)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["evaluate", "--preset", "sht_ltn", "--h5", h5,
                  "--test-txt", test_txt, "--mask-dir", mask_dir,
                  *SET_FLAGS])


def test_cli_rejects_unported_paths(sht):
    with pytest.raises(SystemExit, match="A18"):
        cli.main(["evaluate", "--preset", "sht_ltn", "--device", "cpu",
                  "--mesh", "2x1"])
    with pytest.raises(SystemExit, match="unknown config path"):
        cli.main(["evaluate", "--preset", "sht_ltn", "--device", "cpu",
                  "--set", "encoder.nope=1"])
