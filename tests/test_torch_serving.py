"""The PyTorch package's streaming scorer and JSONL server
(lstc_vad_tpu_torch/serving.py) against the JAX package's
(lstc_vad_tpu/serving.py) on the same weights: JAX params mapped by
ckpt/interop.py, loaded strictly, dropout off.  Scores agree within 1e-5,
the bar of tests/test_serving.py:46; the JSONL replies agree line for line
(scores within 1e-5, every other field equal).  The error paths of
tests/test_serving.py run on the port's scorer.
"""

import base64
import io
import json

import jax
import numpy as np
import pytest

from lstc_vad_tpu.config import EncoderConfig
from lstc_vad_tpu.models import Encoder as JaxEncoder
from lstc_vad_tpu.models import make_head as jax_make_head
from lstc_vad_tpu.serving import StreamingScorer as JaxStreamingScorer
from lstc_vad_tpu.serving import serve_jsonl as jax_serve_jsonl
from lstc_vad_tpu_torch import config as pc
from lstc_vad_tpu_torch.ckpt.interop import state_dict_from_jax
from lstc_vad_tpu_torch.evaluation.scoring import PartScorer, VideoScorer
from lstc_vad_tpu_torch.models import Encoder, make_head
from lstc_vad_tpu_torch.serving import StreamingScorer, serve_jsonl

ATOL = 1e-5
PART_LEN, N_PATCH, D = 3, 4, 16
SMALL = dict(d_model=D, d_inner=24, n_head=2, d_k=8, d_v=8, n_layers=1,
             relative_pe=True, window_size=4, window_depth=3,
             mha_layernorm=True, ffn_layernorm=True)


def port_modules(jcfg, params, kind="classifier", hidden=8):
    """The port's encoder and head on the CPU holding the JAX ``params``."""
    cfg = pc.EncoderConfig(**{**jcfg.__dict__, "attn_impl": "auto"})
    enc = Encoder(cfg, device="cpu")
    head = make_head(kind, cfg.d_model, hidden, device="cpu")
    enc_sd, head_sd = state_dict_from_jax(params["encoder"], params["head"],
                                          cfg, kind)
    enc.load_state_dict(enc_sd, strict=True)
    head.load_state_dict(head_sd, strict=True)
    return enc.eval(), head.eval()


@pytest.fixture(scope="module")
def model():
    """(JAX encoder, JAX head, params, port encoder, port head)."""
    jcfg = EncoderConfig(attn_impl="xla", **SMALL)
    jenc = JaxEncoder(jcfg)
    jhead = jax_make_head("classifier", D, 8)
    params = jax.tree.map(np.asarray, {
        "encoder": jenc.init(jax.random.PRNGKey(0),
                             np.zeros((1, 12, D), np.float32))["params"],
        "head": jhead.init(jax.random.PRNGKey(1),
                           np.zeros((1, D), np.float32))["params"]})
    return (jenc, jhead, params, *port_modules(jcfg, params))


def pair(model, max_streams=4):
    """(port scorer, JAX scorer) on the same weights."""
    jenc, jhead, params, enc, head = model
    return (StreamingScorer(enc, head, PART_LEN, N_PATCH, D,
                            max_streams=max_streams),
            JaxStreamingScorer(jenc, jhead, params, PART_LEN, N_PATCH, D,
                               max_streams=max_streams))


def push_both(scorers, sid, clips):
    for s in scorers:
        for clip in clips:
            s.push(sid, clip)


def test_flush_scores_equal_jax_and_offline(model, rng):
    ours, ref = pair(model)
    video = rng.standard_normal((9, N_PATCH, D)).astype(np.float32)
    got, want = [], []
    for clip in video:
        push_both((ours, ref), "cam0", [clip])
        got += [s for _, s in ours.flush()]
        want += [s for _, s in ref.flush()]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=ATOL)
    offline, _ = PartScorer(*model[3:], PART_LEN, N_PATCH).score_video(video)
    np.testing.assert_allclose(got, offline, atol=ATOL)
    assert ours.streams() == []  # drained streams are dropped


def test_many_streams_one_call(model, rng):
    ours, ref = pair(model, max_streams=8)
    for i in range(5):
        push_both((ours, ref), f"cam{i}", rng.standard_normal(
            (PART_LEN, N_PATCH, D)).astype(np.float32))
    got, want = dict(ours.flush()), dict(ref.flush())
    assert got.keys() == want.keys() and len(got) == 5
    for sid in got:
        assert got[sid] == pytest.approx(want[sid], abs=ATOL)
    # one padded call of max_streams rows (pad_batches is on for live)
    assert (ours.n_calls, ours.n_padded) == (1, 3)


def test_end_streams_equal_jax_with_several_buffered_parts(model, rng):
    """7 clips buffered, never flushed: 2 full parts + a 1-clip tail, the
    tail at its true length (PartScorer without tail re-window)."""
    ours, ref = pair(model)
    video = rng.standard_normal((7, N_PATCH, D)).astype(np.float32)
    push_both((ours, ref), "cam0", video)
    got, want = ours.end_stream("cam0"), ref.end_stream("cam0")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=ATOL)
    offline, _ = PartScorer(*model[3:], PART_LEN, N_PATCH,
                            tail_rewindow=False).score_video(video)
    np.testing.assert_allclose(got, offline, atol=ATOL)
    assert ours.end_stream("cam0") == []


def test_flushed_then_ended_tail_equals_jax(model, rng):
    ours, ref = pair(model)
    video = rng.standard_normal((5, N_PATCH, D)).astype(np.float32)
    push_both((ours, ref), "cam0", video)
    np.testing.assert_allclose([s for _, s in ours.flush()],
                               [s for _, s in ref.flush()], atol=ATOL)
    np.testing.assert_allclose(ours.end_stream("cam0"),
                               ref.end_stream("cam0"), atol=ATOL)


def test_end_streams_batched_calls(model, rng):
    """Ending many streams costs one call per max_streams group of full
    parts + one per distinct tail length, as in the JAX package."""
    ours, ref = pair(model, max_streams=16)
    calls = []
    inner = ours._apply
    ours._apply = lambda t: (calls.append(t.shape), inner(t))[1]
    lengths = {"a": 7, "b": 7, "c": 8, "d": 5, "e": 3, "f": 4}
    for sid, n in lengths.items():
        push_both((ours, ref), sid, rng.standard_normal(
            (n, N_PATCH, D)).astype(np.float32))
    got = ours.end_streams(list(lengths))
    want = ref.end_streams(list(lengths))
    assert len(calls) == 3, calls
    assert calls[0] == (16, PART_LEN * N_PATCH, D)
    assert sorted(c[1] for c in calls[1:]) == [N_PATCH, 2 * N_PATCH]
    for sid in lengths:
        np.testing.assert_allclose(got[sid], want[sid], atol=ATOL)


def test_live_apply_is_the_offline_eval_apply(model):
    """The served scorer runs the VideoScorer the offline scorers use; a
    narrower wire type is ROADMAP A19."""
    enc, head = model[3:]
    ours = StreamingScorer(enc, head, PART_LEN, N_PATCH, D)
    assert isinstance(ours.scorer, VideoScorer)
    assert ours._apply == ours.scorer.score_tokens_async
    with pytest.raises(NotImplementedError, match="A19"):
        StreamingScorer(enc, head, PART_LEN, N_PATCH, D,
                        transfer_dtype="bfloat16")


def test_push_shape_validation_leaks_no_buffer(model):
    ours, _ = pair(model)
    for i in range(5):
        with pytest.raises(ValueError, match="clip shape"):
            ours.push(f"bad{i}", np.zeros((2, D), np.float32))
    assert ours.streams() == []


def _replies(fn, scorer, script, flush_every=0):
    lines = [s if isinstance(s, str) else json.dumps(s) for s in script]
    out = io.StringIO()
    counts = fn(scorer, io.StringIO("\n".join(lines) + "\n"), out,
                flush_every=flush_every)
    return [json.loads(ln) for ln in out.getvalue().splitlines()], counts


def assert_replies_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (g, w)
        for k in w:
            if k == "score":
                assert g[k] == pytest.approx(w[k], abs=ATOL)
            elif k == "scores":
                np.testing.assert_allclose(g[k], w[k], atol=ATOL)
            else:
                assert g[k] == w[k], (k, g, w)


@pytest.mark.parametrize("flush_every", [0, 3])
def test_serve_jsonl_replies_equal_jax_line_for_line(model, rng, flush_every):
    """One request script: list and base64 feats over three streams, flush,
    end, malformed lines, end_all and the EOF end."""
    clips = rng.standard_normal((14, N_PATCH, D)).astype(np.float32)

    def feat(i):
        if i % 2:
            return base64.b64encode(clips[i].astype("<f4").tobytes()).decode()
        return clips[i].tolist()

    script = [{"op": "push", "stream": f"s{i % 3}", "feat": feat(i)}
              for i in range(7)]
    script += [{"op": "flush"}, "not json",
               {"op": "push", "stream": "s0", "feat": [[1.0]]},
               {"op": "push", "stream": "s0", "feat": "AAAA"},
               {"op": "nope"}, {"op": "end", "stream": "s1"}]
    script += [{"op": "push", "stream": f"s{i % 2}", "feat": feat(i)}
               for i in range(7, 12)]
    script += [{"op": "end_all"}, {"op": "end_all"}]
    script += [{"op": "push", "stream": "late", "feat": feat(i)}
               for i in (12, 13)]
    ours, ref = pair(model)
    got, got_counts = _replies(serve_jsonl, ours, script, flush_every)
    want, want_counts = _replies(jax_serve_jsonl, ref, script, flush_every)
    assert got_counts == want_counts
    assert_replies_match(got, want)
    assert sum("error" in r for r in got) == 4
    assert got[-1] == {"ended_streams": 1}  # EOF ended the late stream


def test_flush_restores_buffers_on_device_error(model, rng):
    """A device error mid-flush must not lose buffered clips: the popped
    parts are re-prepended so a retry rescores the same state."""
    ours, ref = pair(model, max_streams=1)  # 2 ready streams -> 2 groups
    for sid in ("a", "b"):
        push_both((ours, ref), sid, rng.standard_normal(
            (4, N_PATCH, D)).astype(np.float32))
    good, calls = ours._apply, []

    def bad_apply(t):
        calls.append(t.shape)
        raise RuntimeError("card fell over")

    ours._apply = bad_apply
    with pytest.raises(RuntimeError, match="card fell over"):
        ours.flush()
    assert calls
    assert {s: len(b) for s, b in ours._buffers.items()} == {"a": 4, "b": 4}
    ours._apply = good
    got, want = dict(ours.flush()), dict(ref.flush())
    for sid in want:
        assert got[sid] == pytest.approx(want[sid], abs=ATOL)
    ours._apply = bad_apply  # end_streams restores too
    with pytest.raises(RuntimeError):
        ours.end_streams(["a", "b"])
    assert {s: len(b) for s, b in ours._buffers.items()} == {"a": 1, "b": 1}
    ours._apply = good
    got, want = ours.end_streams(["a", "b"]), ref.end_streams(["a", "b"])
    for sid in want:
        np.testing.assert_allclose(got[sid], want[sid], atol=ATOL)


def test_serve_jsonl_flush_drains_backlog(model, rng):
    clips = rng.standard_normal((7, N_PATCH, D)).astype(np.float32)
    script = [{"op": "push", "stream": "cam", "feat": c.tolist()}
              for c in clips] + [{"op": "flush"}]
    replies, (n_push, n_scores) = _replies(serve_jsonl, pair(model)[0],
                                           script)
    assert n_push == 7 and {"flushed": 2} in replies
    (end,) = [r for r in replies if r.get("ended")]
    assert len(end["scores"]) == 1 and n_scores == 3


def test_serve_jsonl_flush_every_drops_drained_streams(model, rng):
    clips = rng.standard_normal((6, N_PATCH, D)).astype(np.float32)
    script = [{"op": "push", "stream": f"s{i % 2}", "feat": clips[i].tolist()}
              for i in range(6)] + [{"op": "end_all"}]
    replies, (n_push, n_scores) = _replies(serve_jsonl, pair(model)[0],
                                           script, flush_every=3)
    assert n_push == 6 and {"flushed": 2} in replies
    assert not [r for r in replies if r.get("ended")]
    assert replies[-1] == {"ended_streams": 0} and n_scores == 2


def test_end_all_emits_terminator(model):
    replies, _ = _replies(serve_jsonl, pair(model)[0], [{"op": "end_all"}])
    assert replies == [{"ended_streams": 0}]


def test_eof_end_failure_reported_not_raised(model, rng):
    ours, _ = pair(model)

    def failing_end(sids):
        raise ValueError("no program for token_len 4")

    ours.end_streams = failing_end
    clip = rng.standard_normal((N_PATCH, D)).astype(np.float32)
    replies, counts = _replies(serve_jsonl, ours, [
        {"op": "push", "stream": "cam0", "feat": clip.tolist()}])
    assert counts == (1, 0)
    assert any("no program for token_len" in r.get("error", "")
               for r in replies)
