"""Multi-process serving (lstc_vad_tpu_torch/serving_mp.py): the batching
backend, its torch-free workers, and the wire format shared with the JAX
package (lstc_vad_tpu/serving_mp.py).

The cases of tests/test_serving_mp.py run on the port's backend with a
deterministic stand-in apply; the live apply through a backend gives the
single-process scorer's scores; the JAX package's own numpy-only worker
(``make_worker_scorer``) talking to the port's backend gets the JAX
``StreamingScorer``'s scores within 1e-5 (tests/test_serving.py:46); and the
CLI runs ``serve-backend --device cpu`` with two ``serve --backend`` worker
processes, one of which shows that a worker imports no torch.
"""

import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from lstc_vad_tpu.serving import StreamingScorer as JaxStreamingScorer
from lstc_vad_tpu.serving_mp import make_worker_scorer as jax_worker_scorer
from lstc_vad_tpu_torch.config import preset
from lstc_vad_tpu_torch.evaluation.scoring import VideoScorer
from lstc_vad_tpu_torch.serving import StreamingScorer, serve_jsonl
from lstc_vad_tpu_torch.serving_mp import (BatchingBackend, RemoteApply,
                                           make_worker_scorer)
from lstc_vad_tpu_torch.train.state import create_train_state

from test_torch_serving import model  # noqa: F401  (fixture)
from test_torch_serving import D as MODEL_D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 8
TIMEOUT = 120


def _fake_apply(tokens):
    """Deterministic per-row stand-in for the eval apply."""
    return np.asarray(tokens, np.float32).sum(axis=(1, 2))


@pytest.fixture
def sock():
    """A short socket path: unix socket paths are limited to 108 bytes."""
    root = tempfile.mkdtemp(prefix="lv")
    yield os.path.join(root, "b.sock")
    for name in os.listdir(root):
        os.unlink(os.path.join(root, name))
    os.rmdir(root)


def _started(apply_fn, d_model=D, **kw):
    b = BatchingBackend(apply_fn, d_model, **kw)
    b._dispatcher = threading.Thread(target=b._dispatch_loop, daemon=True)
    b._dispatcher.start()
    return b


def test_submit_roundtrip_and_counters():
    b = _started(_fake_apply, max_batch=8, window_ms=0.0)
    try:
        rows = np.arange(2 * 3 * D, dtype=np.float32).reshape(2, 3, D)
        np.testing.assert_allclose(b.submit(3, rows), rows.sum(axis=(1, 2)),
                                   rtol=1e-6)
        assert b.n_calls == 1 and b.n_rows == 2
    finally:
        b.shutdown()


def test_concurrent_submits_coalesce_and_route_correctly():
    seen = []

    def spy(tokens):
        seen.append(tokens.shape[0])
        return _fake_apply(tokens)

    b = _started(spy, max_batch=64, window_ms=50.0)
    results, barrier = {}, threading.Barrier(6)

    def worker(i):
        rows = np.full((2, 4, D), float(i + 1), np.float32)
        barrier.wait()
        results[i] = b.submit(4, rows)

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        for i in range(6):
            np.testing.assert_allclose(results[i], (i + 1) * 4 * D,
                                       rtol=1e-6)
        # six 2-row requests in one 50 ms window: fewer calls than requests,
        # each carrying only the coalesced rows (no padding to max_batch)
        assert b.n_calls < 6 and b.n_rows == 12 == sum(seen)
    finally:
        b.shutdown()


def test_dispatcher_fifo_across_token_lengths():
    """The dispatcher serves the token length holding the OLDEST request."""
    b = BatchingBackend(_fake_apply, D, max_batch=8, window_ms=0.0)
    done = []

    def sub(length):
        done.append(b.submit(length, np.zeros((1, length, D), np.float32)))

    t_old = threading.Thread(target=sub, args=(5,))
    t_new = threading.Thread(target=sub, args=(3,))
    t_old.start()
    time.sleep(0.05)
    t_new.start()
    time.sleep(0.05)
    try:
        for want in (5, 3):
            tok, taken = b._take_round()
            assert tok == want
            for p in taken:
                p.scores = np.zeros(len(p.rows), np.float32)
                p.event.set()
        t_old.join(timeout=10)
        t_new.join(timeout=10)
        assert len(done) == 2
    finally:
        b.shutdown()


def test_submit_validates_shape_and_size():
    b = _started(_fake_apply, max_batch=4, window_ms=0.0)
    try:
        with pytest.raises(ValueError, match="max_batch"):
            b.submit(3, np.zeros((5, 3, D), np.float32))
        with pytest.raises(ValueError, match="shape"):
            b.submit(3, np.zeros((2, 3, D + 1), np.float32))
    finally:
        b.shutdown()


def test_apply_error_fails_request_not_backend():
    calls = {"n": 0}

    def flaky(tokens):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("card fell over")
        return _fake_apply(tokens)

    b = _started(flaky, max_batch=8, window_ms=0.0)
    try:
        with pytest.raises(RuntimeError, match="card fell over"):
            b.submit(2, np.ones((1, 2, D), np.float32))
        np.testing.assert_allclose(b.submit(2, np.ones((1, 2, D),
                                                       np.float32)),
                                   2 * D, rtol=1e-6)
    finally:
        b.shutdown()


def test_socket_ping_and_dmodel_check(sock):
    b = BatchingBackend(_fake_apply, D, max_batch=8, window_ms=0.0)
    b.start(sock)
    try:
        client = RemoteApply(sock, D)
        assert client.max_batch == 8
        tokens = np.arange(3 * 2 * D, dtype=np.float32).reshape(3, 2, D)
        np.testing.assert_allclose(client(tokens), tokens.sum(axis=(1, 2)),
                                   rtol=1e-6)
        client.close()
        with pytest.raises(ValueError, match="d_model"):
            RemoteApply(sock, D + 1)
    finally:
        b.shutdown()


def test_concurrent_stress_routing_integrity(sock):
    """4 socket clients fire 40 requests each of random row counts and
    token lengths: every reply is the apply of THAT request's rows."""
    b = BatchingBackend(_fake_apply, D, max_batch=16, window_ms=1.0)
    b.start(sock)
    errors, sent = [], []

    def client(cid):
        rng = np.random.default_rng(cid)
        try:
            c = RemoteApply(sock, D)
            total = 0
            for i in range(40):
                n = int(rng.integers(1, 6))
                rows = rng.standard_normal(
                    (n, int(rng.choice([2, 3, 5])), D)).astype(np.float32)
                if not np.allclose(c(rows), rows.sum(axis=(1, 2)),
                                   rtol=1e-5, atol=1e-5):
                    errors.append((cid, i))
                    return
                total += n
            sent.append(total)
            c.close()
        except Exception as e:  # surfaced through errors
            errors.append((cid, repr(e)))

    try:
        threads = [threading.Thread(target=client, args=(cid,))
                   for cid in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        assert not errors, errors[:2]
        assert len(sent) == 4 and b.n_rows == sum(sent)
        assert b.n_calls <= 4 * 40
    finally:
        b.shutdown()


def test_remote_apply_survives_backend_restart(sock):
    b1 = BatchingBackend(_fake_apply, D, max_batch=8, window_ms=0.0)
    b1.start(sock)
    client = RemoteApply(sock, D)
    tokens = np.ones((2, 3, D), np.float32)
    np.testing.assert_allclose(client(tokens), 3 * D, rtol=1e-6)
    b1.shutdown()
    b2 = BatchingBackend(_fake_apply, D, max_batch=8, window_ms=0.0)
    b2.start(sock)
    try:
        np.testing.assert_allclose(client(tokens), 3 * D, rtol=1e-6)
    finally:
        b2.shutdown()
        client.close()


def test_worker_flush_ships_only_real_rows(sock):
    seen = []

    def spy(tokens):
        seen.append(tokens.shape)
        return _fake_apply(tokens)

    b = BatchingBackend(spy, D, max_batch=8, window_ms=0.0)
    b.start(sock)
    try:
        s = make_worker_scorer(sock, part_len=2, n_patch=3, d_model=D,
                               max_streams=6)
        assert not s.pad_batches
        for sid in ("a", "b"):
            for _ in range(2):
                s.push(sid, np.ones((3, D), np.float32))
        assert len(s.flush()) == 2
        assert b.n_rows == 2 and seen == [(2, 6, D)]
    finally:
        b.shutdown()


def test_worker_scorer_matches_single_process(model, sock):  # noqa: F811
    """A port worker through a backend whose apply is the live eval apply
    gives the single-process scorer's flush and end_streams scores."""
    enc, head = model[3:]
    b = BatchingBackend(VideoScorer(enc, head, "classifier")
                        .score_tokens_async, MODEL_D, max_batch=8,
                        window_ms=0.0)
    b.start(sock)
    try:
        local = StreamingScorer(enc, head, 3, 4, MODEL_D, max_streams=4)
        remote = make_worker_scorer(sock, 3, 4, MODEL_D, max_streams=4)
        rng = np.random.default_rng(0)
        for _ in range(7):
            for sid in ("a", "b", "c"):
                clip = rng.standard_normal((4, MODEL_D)).astype(np.float32)
                local.push(sid, clip)
                remote.push(sid, clip)
        lf, rf = dict(local.flush()), dict(remote.flush())
        assert lf.keys() == rf.keys()
        for sid in lf:
            assert rf[sid] == pytest.approx(lf[sid], abs=1e-6)
        le = local.end_streams(local.streams())
        re_ = remote.end_streams(remote.streams())
        for sid in le:
            np.testing.assert_allclose(re_[sid], le[sid], atol=1e-6)
        assert b.n_calls == remote.n_calls
    finally:
        b.shutdown()


def test_jax_worker_gets_jax_scores_from_the_port_backend(model, sock):  # noqa: F811,E501
    """The JAX package's numpy-only worker, unchanged, against the port's
    backend: the same wire format, and the JAX StreamingScorer's scores
    within 1e-5 — over the JSONL protocol, flush and end_all."""
    jenc, jhead, params, enc, head = model
    b = BatchingBackend(VideoScorer(enc, head, "classifier")
                        .score_tokens_async, MODEL_D, max_batch=8,
                        window_ms=1.0)
    b.start(sock)
    try:
        from lstc_vad_tpu.serving import serve_jsonl as jax_serve_jsonl

        rng = np.random.default_rng(3)
        lines = [json.dumps({"op": "push", "stream": f"s{i % 3}",
                             "feat": rng.standard_normal((4, MODEL_D))
                             .astype(np.float32).tolist()})
                 for i in range(14)]
        lines += [json.dumps({"op": "flush"}), json.dumps({"op": "end_all"})]
        outs = []
        for scorer in (jax_worker_scorer(sock, 3, 4, MODEL_D, max_streams=4),
                       JaxStreamingScorer(jenc, jhead, params, 3, 4, MODEL_D,
                                          max_streams=4)):
            out = io.StringIO()
            counts = jax_serve_jsonl(scorer, io.StringIO("\n".join(lines)
                                                         + "\n"), out)
            outs.append((counts, [json.loads(x)
                                  for x in out.getvalue().splitlines()]))
        (got_counts, got), (want_counts, want) = outs
        assert got_counts == want_counts == (14, 6)
        assert len(got) == len(want) and b.n_calls > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            if "score" in w:
                assert g["score"] == pytest.approx(w["score"], abs=1e-5)
            elif "scores" in w:
                np.testing.assert_allclose(g["scores"], w["scores"],
                                           atol=1e-5)
            else:
                assert g == w
    finally:
        b.shutdown()


def test_worker_jsonl_protocol_through_backend(sock):
    b = BatchingBackend(_fake_apply, D, max_batch=8, window_ms=0.0)
    b.start(sock)
    try:
        scorer = make_worker_scorer(sock, part_len=3, n_patch=4, d_model=D,
                                    max_streams=4)
        clips = np.random.default_rng(1).standard_normal((3, 4, D))
        lines = [json.dumps({"op": "push", "stream": "s0",
                             "feat": c.tolist()}) for c in clips]
        lines += [json.dumps({"op": "flush"}), json.dumps({"op": "end_all"})]
        out = io.StringIO()
        counts = serve_jsonl(scorer, io.StringIO("\n".join(lines) + "\n"),
                             out)
        replies = [json.loads(ln) for ln in out.getvalue().splitlines()]
        assert counts == (3, 1)
        assert replies[0]["score"] == pytest.approx(
            float(clips.astype(np.float32).sum()), rel=1e-5)
        assert replies[1:] == [{"flushed": 1}, {"ended_streams": 0}]
    finally:
        b.shutdown()


SMALL = {"encoder.d_model": 8, "encoder.d_inner": 16, "encoder.n_head": 2,
         "encoder.d_k": 4, "encoder.d_v": 4, "encoder.n_layers": 1,
         "head.d_model": 8, "head.hidden_dim": 8, "data.n_patch": 4,
         "data.d_model": 8, "data.part_len": 3, "encoder.window_depth": 3}
SET_FLAGS = [a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]
# a worker run in-process: it serves its stdin, then shows that the whole
# worker path (CLI, protocol, socket client) imported no torch
NO_TORCH_WORKER = """
import sys
from lstc_vad_tpu_torch.cli import main
rc = main(sys.argv[1:])
assert "torch" not in sys.modules, "the worker imported torch"
sys.exit(rc)
"""


def test_cli_backend_and_two_workers(sock):
    """serve-backend --device cpu and two serve --backend worker processes:
    each worker's scores equal an in-process live scorer on the same seeded
    weights, neither worker imports torch, and SIGTERM shuts the backend
    down with its call and row counts."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    common = ["--preset", "sht_ltn", *SET_FLAGS]
    backend = subprocess.Popen(
        [sys.executable, "-m", "lstc_vad_tpu_torch", "serve-backend",
         *common, "--socket", sock, "--max-batch", "8", "--window-ms", "5",
         "--device", "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(backend.stdout.readline())
        assert ready == {"listening": sock, "d_model": 8, "max_batch": 8,
                         "part_len": 3, "n_patch": 4}
        rng = np.random.default_rng(2)
        clips = {sid: rng.standard_normal((4, 4, 8)).astype(np.float32)
                 for sid in ("w0", "w1")}
        procs = {}
        for i, (sid, c) in enumerate(clips.items()):
            lines = [json.dumps({"op": "push", "stream": sid,
                                 "feat": clip.tolist()}) for clip in c]
            lines.append(json.dumps({"op": "flush"}))
            head = ([sys.executable, "-c", NO_TORCH_WORKER] if i == 0 else
                    [sys.executable, "-m", "lstc_vad_tpu_torch"])
            procs[sid] = subprocess.Popen(
                [*head, "serve", *common, "--backend", sock,
                 "--max-streams", "4"], cwd=ROOT, env=env,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            procs[sid].stdin.write("\n".join(lines) + "\n")
            procs[sid].stdin.close()
        replies = {}
        for sid, proc in procs.items():
            assert proc.wait(timeout=TIMEOUT) == 0, proc.stderr.read()
            replies[sid] = [json.loads(x) for x in proc.stdout.read()
                            .splitlines()]
        cfg = preset("sht_ltn", **SMALL)
        state = create_train_state(cfg, device="cpu")
        local = StreamingScorer(state.encoder, state.head, 3, 4, 8)
        for sid, c in clips.items():
            for clip in c:
                local.push(sid, clip)
        flushed = dict(local.flush())
        ended = local.end_streams(local.streams())
        for sid, got in replies.items():
            assert got[0]["stream"] == sid and got[1] == {"flushed": 1}
            assert got[0]["score"] == pytest.approx(flushed[sid], abs=1e-6)
            assert got[2]["stream"] == sid and got[2]["ended"]
            np.testing.assert_allclose(got[2]["scores"], ended[sid],
                                       atol=1e-6)
        backend.send_signal(signal.SIGTERM)
        out, err = backend.communicate(timeout=TIMEOUT)
        summary = json.loads(out.splitlines()[-1])
        assert summary["device_calls"] >= 2 and summary["rows"] == 4
        assert summary["kernel_launches"] == 0  # the CPU path has no kernel
        assert "device calls" in err
    finally:
        if backend.poll() is None:
            backend.kill()
            backend.wait(timeout=TIMEOUT)
