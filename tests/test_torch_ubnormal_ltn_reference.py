"""The port's UBnormal LTN evaluation path (``PartScorer`` + ``evaluate_ltn``)
against the benchmark's plain reference (``h100_bench/reference``), on the
CPU, at a small UBnormal-shaped configuration: the ``ubnormal_ltn``
config file's numbers with the widths cut, d_model != n_head * d_k, parts of
5 clips x 16 patches + CLS = 81 tokens under the 5 x 4 x 4 relative bias,
the tail re-window on, and videos shorter than a part."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench.harness import data  # noqa: E402
from h100_bench.harness.cell import load_weights, program_config  # noqa: E402
from h100_bench.reference.evaluation import ltn_eval, roc_auc  # noqa: E402
from h100_bench.reference.model import LTN, matmul, rpe_index_3d  # noqa: E402

CONFIG = ROOT / "h100_bench" / "configs" / "ubnormal_ltn.json"
# widths cut; part_len, window_depth, n_patch and the window kept
SMALL = {"encoder.d_model": 16, "encoder.n_head": 2, "encoder.d_k": 16,
         "encoder.d_v": 16, "encoder.d_inner": 32, "head.d_model": 16,
         "head.hidden_dim": 8, "data.d_model": 16}
# clips a video: 2 and 3 are shorter than a part (re-windowed by Python
# slice semantics), 5 is one part, the rest end in a re-windowed tail
CLIPS = (2, 3, 5, 7, 11, 13, 16, 9)
SEGMENT_LEN = 16


def _config():
    config = json.loads(CONFIG.read_text())
    config["overrides"] = dict(SMALL)
    config["program"].update(SMALL)
    return config


def _split(seed, d):
    rng = np.random.default_rng(seed)
    feats, annos = [], []
    for i, c in enumerate(CLIPS):
        feats.append(rng.standard_normal((c, 16, d)).astype(np.float32))
        anno = np.zeros(c * SEGMENT_LEN)
        if i % 2:
            start = int(rng.integers(0, len(anno) // 2))
            anno[start:start + SEGMENT_LEN * 2] = 1.0
        annos.append(anno)
    return feats, annos


def test_config_is_the_ubnormal_shape():
    p = _config()["program"]
    assert p["data.part_len"] == p["encoder.window_depth"] == 5
    assert p["data.n_patch"] == p["encoder.window_size"] ** 2
    assert p["encoder.d_model"] != p["encoder.n_head"] * p["encoder.d_k"]
    LTN(p, "cpu")  # the reference implements every setting of the file


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_eval_pass_matches_the_reference(seed):
    from lstc_vad_tpu_torch.evaluation.drivers import evaluate_ltn
    from lstc_vad_tpu_torch.evaluation.scoring import PartScorer
    from lstc_vad_tpu_torch.models import build

    config = _config()
    p = config["program"]
    cfg = program_config(config)
    weights = data.make_weights(p, seed, "cpu")
    encoder, head = build(cfg, "cpu", seed=0)
    load_weights(encoder, head, weights)
    scorer = PartScorer(encoder, head, p["data.part_len"], p["data.n_patch"],
                        tail_rewindow=True)
    feats, annos = _split(seed % 2 ** 32, p["encoder.d_model"])
    auc, frames, labels = evaluate_ltn(scorer, list(zip(feats, annos)),
                                       SEGMENT_LEN, return_labels=True)

    _, w_frames, w_labels = ltn_eval(
        LTN(p, "cpu"), data.flat(weights), feats, annos, p["data.part_len"],
        p["data.n_patch"], "cpu", matmul, True, SEGMENT_LEN)
    assert len(frames) == len(w_frames) == len(CLIPS)
    for g, w, lab, w_lab in zip(frames, w_frames, labels, w_labels):
        assert g.shape == w.shape
        np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(lab, w_lab)
    want = roc_auc(np.concatenate(frames), np.concatenate(w_labels))
    assert abs(auc - want) <= 1e-9


def test_relative_position_index_matches_the_reference():
    from lstc_vad_tpu_torch.models.rpe import (relative_position_index_3d,
                                               table_size_3d)

    got = relative_position_index_3d(5, 4)
    np.testing.assert_array_equal(got, rpe_index_3d(5, 4))
    assert got.shape == (80, 80)
    assert table_size_3d(5, 4) == 9 * 7 * 7 == got.max() + 1


def test_port_builds_the_full_width_preset_on_the_meta_device():
    """The unreduced preset's module shapes: q, k, v 1024 -> 2048, the
    output projection 2048 -> 1024, a 441-row bias table of 8 heads."""
    from lstc_vad_tpu_torch.models import build

    cfg = program_config(json.loads(CONFIG.read_text()))
    with torch.device("meta"):
        encoder, head = build(cfg, "cpu", seed=0)
    sd = {**{f"encoder.{k}": v.shape for k, v in encoder.state_dict().items()},
          **{f"head.{k}": v.shape for k, v in head.state_dict().items()}}
    a = "encoder.layer_stack.0.slf_attn."
    assert sd[a + "w_qs.weight"] == (2048, 1024)
    assert sd[a + "fc.weight"] == (1024, 2048)
    assert sd[a + "relative_position_bias_table"] == (441, 8)
    assert sd["head.classifier.0.weight"] == (512, 1024)
