"""AOT artifacts of the PyTorch package (lstc_vad_tpu_torch/export.py) and
the attention kernel as the registered operator ``lstc_vad::attention``.

- The operator passes ``torch.library.opcheck`` on CPU tensors (strided
  q/k/v as the encoder passes them, with and without bias, with grads).
- save -> load -> score reproduces the live apply (rtol 1e-6, atol 1e-7,
  the bar of tests/test_export_aot.py:48; rtol 1e-5 / atol 1e-6 with
  ``--l2`` and a regressor head), at every baked token length and at batch
  1, and rejects a token length or width that was not baked.  The programs
  hold no weights, hold the operator as one node, and move to another
  device (``meta`` here) and run there.
- A fresh interpreter loads and scores an artifact without importing the
  model code, the config, or jax.
- The port's artifact agrees with the JAX package's ``LoadedScorer``
  (``platforms=("cpu",)``) on the same params within 1e-5.
- ``evaluate --artifact`` gives the checkpoint eval's AUC and frame scores
  (the ROADMAP A17 check) and ``gen-pseudo --artifact`` its labels;
  ``StreamingScorer.from_artifact`` the live scorer's scores.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fixtures import make_sht_like
from lstc_vad_tpu.config import EncoderConfig
from lstc_vad_tpu.export import load_scorer as jax_load_scorer
from lstc_vad_tpu.export import save_scorer_artifact as jax_save_artifact
from lstc_vad_tpu.models import Encoder as JaxEncoder
from lstc_vad_tpu.models import make_head as jax_make_head
from lstc_vad_tpu_torch import cli
from lstc_vad_tpu_torch.ckpt import save_checkpoint
from lstc_vad_tpu_torch.config import preset
from lstc_vad_tpu_torch.data import load_pseudo_labels
from lstc_vad_tpu_torch.evaluation.scoring import _scorer_apply
from lstc_vad_tpu_torch.export import (_PARAMS, _program_file, load_scorer,
                                       save_scorer_artifact)
from lstc_vad_tpu_torch.ops import cuda_attention
from lstc_vad_tpu_torch.ops.attention import plain_sdpa
from lstc_vad_tpu_torch.serving import StreamingScorer
from lstc_vad_tpu_torch.train.state import create_train_state

from test_torch_serving import port_modules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = EncoderConfig(d_model=16, d_inner=24, n_head=2, d_k=8, d_v=8,
                     n_layers=2, relative_pe=True, window_size=2,
                     window_depth=3, ffn_layernorm=True, attn_impl="xla")
D, TOKEN_LEN = 16, 3 * 4  # part_len=3, n_patch=4


# -- the registered operator ----------------------------------------------

@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("strided", [False, True])
def test_op_passes_opcheck_on_cpu(strided, with_bias, grad):
    rng = np.random.default_rng(int(strided) * 4 + int(with_bias) * 2
                                + int(grad))
    shape = (3, 17, 2, 32) if strided else (3, 2, 17, 32)
    bufs = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .requires_grad_(grad) for _ in range(3)]
    q, k, v = ((x.transpose(1, 2) for x in bufs) if strided else bufs)
    bias = (torch.from_numpy(rng.standard_normal((2, 17, 17),
                                                 dtype=np.float32))
            .requires_grad_(grad) if with_bias else None)
    result = torch.library.opcheck(torch.ops.lstc_vad.attention.default,
                                   (q, k, v, bias, 4.0))
    assert set(result.values()) == {"SUCCESS"}, result
    out = cuda_attention.attention(q, k, v, bias, 4.0)
    # the kernel's layout: a [B, H, L, D] view of a [B, L, H, D] buffer
    assert out.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(out, plain_sdpa(q, k, v, 4.0, bias=bias))
    assert cuda_attention.launches == 0


def test_op_raises_on_a_device_without_the_kernel():
    q = torch.zeros(1, 1, 4, 32, device="meta")
    # meta tensors take the fake implementation: shapes and strides only
    out = cuda_attention.attention(q, q, q, None, 2.0)
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_attention._launch(q, q, q, None, 2.0)


# -- artifacts ------------------------------------------------------------

def _jax_model(kind="classifier"):
    enc = JaxEncoder(JCFG)
    head = jax_make_head(kind, D, 8)
    x = np.zeros((2, TOKEN_LEN, D), np.float32)
    params = jax.tree.map(np.asarray, {
        "encoder": enc.init(jax.random.PRNGKey(0), x)["params"],
        "head": head.init(jax.random.PRNGKey(1), x[:, 0])["params"]})
    return enc, head, params


@pytest.fixture(scope="module")
def model():
    """(JAX encoder, JAX head, params, port encoder, port head)."""
    enc, head, params = _jax_model()
    return (enc, head, params, *port_modules(JCFG, params))


@pytest.fixture(scope="module")
def artifact(model, tmp_path_factory):
    """A classifier artifact at the full-part length and both tails."""
    path = str(tmp_path_factory.mktemp("aot") / "artifact")
    save_scorer_artifact(path, *model[3:], "classifier", TOKEN_LEN, D,
                         extra_token_lens=(4, 8),
                         extra_meta={"n_patch": 4, "part_len": 3})
    return path


def live(enc, head, x, kind="classifier", l2=False):
    with torch.inference_mode():
        return _scorer_apply(enc, head, kind, l2,
                             torch.from_numpy(x)).numpy()


def test_artifact_round_trip_matches_live_apply(model, artifact, rng):
    loaded = load_scorer(artifact, device="cpu")
    assert loaded.token_lens == [4, 8, TOKEN_LEN]
    for length in loaded.token_lens:
        for batch in (1, 3, 8):
            x = rng.standard_normal((batch, length, D)).astype(np.float32)
            np.testing.assert_allclose(loaded.score(x), live(*model[3:], x),
                                       rtol=1e-6, atol=1e-7)
    assert loaded.n_calls == 9
    assert loaded.score(np.zeros((0, TOKEN_LEN, D), np.float32)).shape == (0,)


def test_artifact_l2_and_regressor(rng, tmp_path):
    _, _, params = _jax_model("regressor")
    enc, head = port_modules(JCFG, params, kind="regressor")
    path = str(tmp_path / "artifact")
    save_scorer_artifact(path, enc, head, "regressor", TOKEN_LEN, D,
                         l2_normalize=True)
    loaded = load_scorer(path, device="cpu")
    x = rng.standard_normal((4, TOKEN_LEN, D)).astype(np.float32)
    np.testing.assert_allclose(loaded.score(x),
                               live(enc, head, x, "regressor", l2=True),
                               rtol=1e-5, atol=1e-6)
    assert loaded.meta["l2_normalize"] and loaded.meta["kind"] == "regressor"


@pytest.mark.parametrize("shape", [(2, TOKEN_LEN + 1, D), (2, TOKEN_LEN, 8),
                                   (2, 5, D)])
def test_artifact_rejects_wrong_token_shape(artifact, shape):
    loaded = load_scorer(artifact, device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        loaded.score(np.zeros(shape, np.float32))


def test_programs_hold_no_weights_and_the_op(artifact):
    """The weights are stored once beside the programs; each program holds
    the attention operator as an opaque node per layer."""
    params = torch.load(os.path.join(artifact, _PARAMS), weights_only=True)
    assert any(k.startswith("encoder.") for k in params)
    assert any(k.startswith("head.") for k in params)
    for length in (4, 8, TOKEN_LEN):
        program = torch.export.load(os.path.join(artifact,
                                                 _program_file(length)))
        assert not program.state_dict and not program.constants
        assert program.example_inputs is None  # they hold the weights
        ops = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
        assert ops.count(torch.ops.lstc_vad.attention.default) == \
            JCFG.n_layers
    with open(os.path.join(artifact, "meta.json")) as f:
        meta = json.load(f)
    assert {k: meta[k] for k in ("token_len", "token_lens", "d_model",
                                 "kind", "l2_normalize", "n_patch",
                                 "part_len")} == {
        "token_len": TOKEN_LEN, "token_lens": [4, 8, TOKEN_LEN],
        "d_model": D, "kind": "classifier", "l2_normalize": False,
        "n_patch": 4, "part_len": 3}


def test_cpu_exported_program_moves_to_another_device(artifact):
    """load_scorer moves the programs to the asked device, the device the
    graph bakes into the input's dtype cast included: here the meta device,
    where every op but the kernel's fake runs shapes only."""
    loaded = load_scorer(artifact, device="cpu")
    from torch.export.passes import move_to_device_pass

    program = torch.export.load(os.path.join(artifact,
                                             _program_file(TOKEN_LEN)))
    devices = {str(n.kwargs["device"]) for n in program.graph.nodes
               if "device" in n.kwargs}
    assert devices == {"cpu"}
    moved = move_to_device_pass(program, "meta")
    assert {str(n.kwargs["device"]) for n in moved.graph.nodes
            if "device" in n.kwargs} == {"meta"}
    params = {k: v.to("meta") for k, v in loaded._params.items()}
    out = moved.module()(params, torch.zeros(5, TOKEN_LEN, D,
                                             device="meta"))
    assert out.shape == (5,) and out.device.type == "meta"


def test_fresh_interpreter_loads_without_model_code(artifact, rng):
    x = rng.standard_normal((3, TOKEN_LEN, D)).astype(np.float32)
    npy = os.path.join(os.path.dirname(artifact), "x.npy")
    np.save(npy, x)
    code = ("import json, sys, numpy as np\n"
            "from lstc_vad_tpu_torch.export import load_scorer\n"
            f"s = load_scorer({artifact!r}, device='cpu')\n"
            f"scores = s.score(np.load({npy!r}))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'lstc_vad_tpu') or m.startswith("
            "('lstc_vad_tpu_torch.models', 'lstc_vad_tpu_torch.config'))]\n"
            "print(json.dumps({'scores': scores.tolist(), 'bad': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.splitlines()[-1])
    assert report["bad"] == []
    np.testing.assert_allclose(report["scores"],
                               load_scorer(artifact, device="cpu").score(x),
                               rtol=0, atol=0)


def test_port_artifact_equals_jax_artifact(model, artifact, rng, tmp_path):
    jenc, jhead, params = model[:3]
    path = str(tmp_path / "jax_artifact")
    jax_save_artifact(path, jenc, jhead, "classifier", params, TOKEN_LEN, D,
                      platforms=("cpu",), extra_token_lens=(4, 8))
    theirs = jax_load_scorer(path)
    ours = load_scorer(artifact, device="cpu")
    assert ours.token_lens == theirs.token_lens
    for length in ours.token_lens:
        x = rng.standard_normal((5, length, D)).astype(np.float32)
        np.testing.assert_allclose(ours.score(x), theirs.score(x), rtol=0,
                                   atol=1e-5)


def test_streaming_from_artifact_matches_live(model, artifact, rng):
    enc, head = model[3:]
    scorer = StreamingScorer(enc, head, 3, 4, D, max_streams=4)
    aot = StreamingScorer.from_artifact(artifact, max_streams=4,
                                        device="cpu")
    assert (aot.part_len, aot.n_patch, aot.d_model) == (3, 4, D)
    assert not aot.pad_batches
    video = rng.standard_normal((8, 4, D)).astype(np.float32)  # tail 2
    for s in (scorer, aot):
        for clip in video:
            s.push("cam0", clip)
    np.testing.assert_allclose([x for _, x in aot.flush()],
                               [x for _, x in scorer.flush()], atol=1e-6)
    np.testing.assert_allclose(aot.end_stream("cam0"),
                               scorer.end_stream("cam0"), atol=1e-6)


def test_from_artifact_rejects_l2_and_part_len_mismatch(model, artifact,
                                                        tmp_path):
    with pytest.raises(ValueError, match="exported with part_len=3"):
        StreamingScorer.from_artifact(artifact, part_len=2, device="cpu")
    s = StreamingScorer.from_artifact(artifact, part_len=3, device="cpu")
    assert (s.part_len, s.n_patch) == (3, 4)
    path = str(tmp_path / "l2")
    save_scorer_artifact(path, *model[3:], "classifier", TOKEN_LEN, D,
                         l2_normalize=True,
                         extra_meta={"n_patch": 4, "part_len": 3})
    with pytest.raises(ValueError, match="exported with --l2"):
        StreamingScorer.from_artifact(path, device="cpu")


# -- the CLI: evaluate / gen-pseudo / serve through an artifact ------------

SMALL = {"encoder.d_model": 32, "encoder.d_inner": 48, "encoder.n_head": 2,
         "encoder.d_k": 16, "encoder.d_v": 16, "encoder.n_layers": 2,
         "head.d_model": 32, "head.hidden_dim": 16, "data.n_patch": 16,
         "data.d_model": 32}
SET_FLAGS = [a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]


def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main([*argv, "--device", "cpu"]) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def sht_artifact(tmp_path_factory):
    """A make_sht_like set, a checkpoint of seeded sht_ltn weights and the
    artifact export-aot --tails writes from it."""
    root = tmp_path_factory.mktemp("sht_aot")
    h5, train_txt, test_txt, mask_dir = make_sht_like(str(root), n_patch=16,
                                                      d_model=32)
    state = create_train_state(preset("sht_ltn", **SMALL), device="cpu",
                               seed=4)
    ckpt = str(root / "best.pt")
    save_checkpoint(ckpt, {"encoder": state.encoder.state_dict(),
                           "head": state.head.state_dict()})
    art = str(root / "artifact")
    data = ["--preset", "sht_ltn", "--h5", h5, "--train-txt", train_txt,
            "--test-txt", test_txt, "--mask-dir", mask_dir, *SET_FLAGS]
    assert "wrote AOT" in _cli("export-aot", *data, "--ckpt", ckpt, "--out",
                               art, "--tails")
    return data, ckpt, art, root


def test_export_aot_bakes_the_tails(sht_artifact):
    loaded = load_scorer(sht_artifact[2], device="cpu")
    assert loaded.token_lens == [16, 32, 48]
    assert (loaded.meta["part_len"], loaded.meta["n_patch"]) == (3, 16)


def test_evaluate_through_the_artifact_equals_the_checkpoint(sht_artifact):
    data, ckpt, art, root = sht_artifact
    scores = {}
    for name, flags in (("ckpt", ["--ckpt", ckpt]),
                        ("artifact", ["--artifact", art])):
        path = str(root / f"{name}.npz")
        out = _cli("evaluate", *data, *flags, "--dump-scores", path)
        auc = float(out.splitlines()[-1].split("=")[1])
        scores[name] = (auc, np.load(path))
    (auc, want), (got_auc, got) = scores["ckpt"], scores["artifact"]
    assert got_auc == pytest.approx(auc, abs=1e-6)
    for key in want.files:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)


def test_gen_pseudo_through_the_artifact_equals_the_checkpoint(sht_artifact):
    data, ckpt, art, root = sht_artifact
    labels = {}
    for name, flags in (("ckpt", ["--ckpt", ckpt]),
                        ("artifact", ["--artifact", art])):
        out = str(root / f"{name}_pseudo.npy")
        _cli("gen-pseudo", *data, *flags, "--kind", "ltn", "--threshold",
             "-1", "--out", out)
        labels[name] = load_pseudo_labels(out)
    assert labels["ckpt"].keys() == labels["artifact"].keys()
    for key, want in labels["ckpt"].items():
        np.testing.assert_allclose(labels["artifact"][key], want, rtol=0,
                                   atol=1e-6)


def test_serve_through_the_artifact_equals_live(sht_artifact, monkeypatch):
    data, ckpt, art, _ = sht_artifact
    rng = np.random.default_rng(5)
    lines = [json.dumps({"op": "push", "stream": f"s{i % 2}",
                         "feat": rng.standard_normal((16, 32))
                         .astype(np.float32).tolist()}) for i in range(9)]
    lines.append(json.dumps({"op": "end_all"}))
    replies = {}
    for name, flags in (("ckpt", ["--ckpt", ckpt]),
                        ("artifact", ["--artifact", art])):
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines)
                                                      + "\n"))
        out = _cli("serve", *data, *flags, "--flush-every", "4")
        replies[name] = [json.loads(x) for x in out.splitlines()]
    assert len(replies["ckpt"]) == len(replies["artifact"]) > 3
    for g, w in zip(replies["artifact"], replies["ckpt"]):
        assert g.keys() == w.keys()
        for k in w:
            if k == "score":
                assert g[k] == pytest.approx(w[k], abs=1e-6)
            elif k == "scores":
                np.testing.assert_allclose(g[k], w[k], atol=1e-6)
            else:
                assert g[k] == w[k]
