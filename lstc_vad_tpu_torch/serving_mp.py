"""Multi-process serving: N torch-free protocol workers behind ONE batching
backend process that owns the card — PyTorch counterpart of
lstc_vad_tpu/serving_mp.py, speaking its wire format byte for byte.

The single-process JSONL server (serving.serve_jsonl) interleaves protocol
work (JSON parse, base64 decode, buffer management) with device work on one
Python thread; under many client pipes the protocol side starves the device.
This module splits them:

    client JSONL ──> worker 0 (parse + stream buffers, no torch) ──┐
    client JSONL ──> worker 1                                      ├─ unix
    ...                                                            │  socket
                   backend (the ONE process on the card) <─────────┘
                   coalesces same-length rows from all workers into one
                   device call per round

- Workers run the unchanged serve_jsonl protocol and StreamingScorer
  buffering; their device apply is a ``RemoteApply`` that ships the token
  batch over the socket.  This module imports numpy and the standard library
  only, so a worker never imports torch and never creates a CUDA context.
  The JAX package's numpy-only workers (lstc_vad_tpu/serving_mp.py::
  make_worker_scorer) run unchanged against this backend.
- The backend accepts length-prefixed binary requests from every worker
  connection, groups rows of equal token length that arrive within a short
  coalescing window, scores them in one device call and splits the replies.
  Eager PyTorch compiles nothing per batch size, so unlike the JAX backend
  it sends only the coalesced rows, never a padded max_batch batch.

Wire format (both directions): ``>I`` header length, JSON header, ``>I``
payload length, raw little-endian f32 payload.
  request  {"n": rows, "tok": L}          + rows*L*d_model f32
  reply    {"n": rows}                    + rows f32 scores
  error    {"error": "..."}              (empty payload)
  ping     {"op": "ping"} -> {"ok": true, "d_model": d, "max_batch": n}

CLI: ``serve-backend --socket PATH ...`` (params flags like ``serve``), then
any number of ``serve --backend PATH --preset ...`` workers.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .serving import StreamingScorer, _fetch

_HDR = struct.Struct(">I")


def _send_msg(sock: socket.socket, header: dict, payload: bytes = b"") -> None:
    head = json.dumps(header).encode()
    sock.sendall(_HDR.pack(len(head)) + head
                 + _HDR.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            # EOF with nothing buffered = a clean close on a message
            # boundary (the first read of the next header); partial bytes
            # mean the peer died mid-message.
            raise ConnectionError("peer closed mid-message"
                                  if buf else "peer closed")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock: socket.socket):
    hlen = _HDR.unpack(_recv_exact(sock, 4))[0]
    header = json.loads(_recv_exact(sock, hlen))
    plen = _HDR.unpack(_recv_exact(sock, 4))[0]
    return header, _recv_exact(sock, plen)


class _Pending:
    __slots__ = ("rows", "event", "scores", "error", "seq")

    def __init__(self, rows: np.ndarray, seq: int = 0):
        self.rows = rows
        self.event = threading.Event()
        self.scores: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        self.seq = seq  # arrival order, for starvation-free scheduling


class BatchingBackend:
    """Owns the device apply; coalesces same-token-length rows from many
    worker connections into one device call.

    ``apply_fn(tokens[n, L, d] f32) -> scores[n]`` (or a zero-arg resolve()
    of them) is the live eval apply (evaluation/scoring.py::VideoScorer
    ``score_tokens_async``) or an AOT artifact's ``LoadedScorer.score``.
    ``max_batch`` is the most rows of one call; each request must carry
    n <= max_batch rows (a worker's max_streams is its request size, so
    keep worker max_streams <= backend max_batch).  ``window_ms`` is how
    long the dispatcher waits after the first pending request for more rows
    to merge — skipped when a full batch is already waiting."""

    def __init__(self, apply_fn, d_model: int, max_batch: int = 128,
                 window_ms: float = 2.0):
        self._apply = apply_fn
        self.d_model = d_model
        self.max_batch = max_batch
        self._window_s = window_ms / 1e3
        self._cond = threading.Condition()
        self._pending: Dict[int, List[_Pending]] = {}
        self._stop = False
        self._dispatcher: Optional[threading.Thread] = None
        self._server_sock: Optional[socket.socket] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._seq = 0
        self.n_calls = 0          # device calls made
        self.n_rows = 0           # rows scored
        self.apply_seconds = 0.0  # host wall time inside the apply

    # ---------------------------------------------------------- scoring core

    def submit(self, tok_len: int, rows: np.ndarray) -> np.ndarray:
        """Queue [n, tok_len, d] rows, block until their scores return."""
        if rows.ndim != 3 or rows.shape[1] != tok_len \
                or rows.shape[2] != self.d_model:
            raise ValueError(f"rows shape {rows.shape} != "
                             f"(n, {tok_len}, {self.d_model})")
        if rows.shape[0] > self.max_batch:
            raise ValueError(f"request of {rows.shape[0]} rows exceeds "
                             f"max_batch={self.max_batch} — lower the "
                             "worker's max_streams or raise the backend's "
                             "--max-batch")
        with self._cond:
            if self._stop:
                raise RuntimeError("backend is shut down")
            self._seq += 1
            p = _Pending(np.ascontiguousarray(rows, dtype=np.float32),
                         seq=self._seq)
            self._pending.setdefault(tok_len, []).append(p)
            self._cond.notify_all()
        p.event.wait()
        if p.error is not None:
            raise RuntimeError(p.error)
        return p.scores

    def _take_round(self):
        """One coalescing round: serve the token length holding the OLDEST
        pending request (FIFO across lengths — a sustained majority length
        can never starve a minority one, e.g. tail flushes behind full-part
        traffic), take entries while they fit in max_batch (entries are
        atomic — a reply maps 1:1 to a request)."""
        with self._cond:
            while not self._pending and not self._stop:
                self._cond.wait()
            if not self._pending:
                return None, []
            tok_len = min(self._pending,
                          key=lambda L: self._pending[L][0].seq)
            queue = self._pending[tok_len]
            if sum(len(p.rows) for p in queue) < self.max_batch \
                    and self._window_s > 0 and not self._stop:
                # brief window for other workers' rows to land
                self._cond.wait(self._window_s)
                queue = self._pending.get(tok_len, [])
            taken, total = [], 0
            while queue and total + len(queue[0].rows) <= self.max_batch:
                p = queue.pop(0)
                taken.append(p)
                total += len(p.rows)
            if not queue:
                self._pending.pop(tok_len, None)
        return tok_len, taken

    def _dispatch_loop(self):
        while True:
            tok_len, taken = self._take_round()
            if tok_len is None:
                if self._stop:
                    return
                continue
            if not taken:
                continue
            try:
                at = sum(len(p.rows) for p in taken)
                tokens = np.empty((at, tok_len, self.d_model), np.float32)
                offs, at = [], 0
                for p in taken:
                    tokens[at:at + len(p.rows)] = p.rows
                    offs.append((at, at + len(p.rows)))
                    at += len(p.rows)
                t0 = time.perf_counter()
                scores = np.asarray(_fetch(self._apply(tokens)),
                                    dtype=np.float32)
                self.apply_seconds += time.perf_counter() - t0
                self.n_calls += 1
                self.n_rows += at
                for p, (beg, end) in zip(taken, offs):
                    p.scores = scores[beg:end]
            except Exception as e:  # device error: fail THESE requests only
                for p in taken:
                    p.error = f"{type(e).__name__}: {e}"
            finally:
                for p in taken:
                    p.event.set()

    # ------------------------------------------------------------ socket srv

    def _handle_conn(self, conn: socket.socket):
        with self._conns_lock:
            self._conns.add(conn)
        try:
            while True:
                try:
                    header, payload = _recv_msg(conn)
                except (ConnectionError, OSError):
                    return  # worker went away; its streams died with it
                try:
                    if header.get("op") == "ping":
                        _send_msg(conn, {"ok": True,
                                         "d_model": self.d_model,
                                         "max_batch": self.max_batch})
                        continue
                    n, tok_len = int(header["n"]), int(header["tok"])
                    expect = n * tok_len * self.d_model * 4
                    if len(payload) != expect:
                        raise ValueError(f"payload is {len(payload)} bytes, "
                                         f"expected {expect}")
                    rows = np.frombuffer(payload, "<f4").reshape(
                        n, tok_len, self.d_model)
                    scores = self.submit(tok_len, rows)
                    _send_msg(conn, {"n": n},
                              scores.astype("<f4").tobytes())
                except Exception as e:
                    # a bad request fails that request, not the connection
                    _send_msg(conn, {"error": f"{type(e).__name__}: {e}"})
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def start(self, sock_path: str) -> None:
        """Bind the unix socket and start dispatcher + accept threads
        (non-blocking; use serve_forever() to block)."""
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        self._server_sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server_sock.bind(sock_path)
        self._server_sock.listen(64)
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._dispatcher.start()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._server_sock.accept()
            except OSError:
                return  # socket closed by shutdown
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()

    def serve_forever(self, sock_path: str, ready_fn=None) -> None:
        # SIGTERM (what `timeout` and process supervisors send) must run
        # the same orderly shutdown as Ctrl-C: close worker connections,
        # join the dispatcher, report the device-call summary.  Installing
        # a handler only works from the main thread; elsewhere the caller
        # owns signal routing.
        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM,
                          lambda *_: self._request_stop())
        self.start(sock_path)
        if ready_fn is not None:
            ready_fn()
        try:
            while not self._stop:
                time.sleep(0.2)
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def _request_stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()

    def shutdown(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._server_sock is not None:
            try:
                self._server_sock.close()
            except OSError:
                pass
        # close live worker connections too: a zombie handler answering
        # "backend is shut down" forever would defeat worker reconnects
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=5)


class RemoteApply:
    """StreamingScorer device-apply proxy: ships the token batch to a
    BatchingBackend socket and returns its scores.  numpy + stdlib only —
    the worker process never imports torch."""

    def __init__(self, sock_path: str, d_model: int,
                 connect_timeout_s: float = 10.0):
        self.d_model = d_model
        self.sock_path = sock_path
        self._connect_timeout_s = connect_timeout_s
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._connect()

    def _connect(self):
        deadline = time.monotonic() + self._connect_timeout_s
        while True:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                self._sock.connect(self.sock_path)
                break
            except (FileNotFoundError, ConnectionRefusedError, OSError):
                self._sock.close()
                self._sock = None
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)  # backend still starting / restarting
        _send_msg(self._sock, {"op": "ping"})
        header, _ = _recv_msg(self._sock)
        if header.get("d_model") not in (None, self.d_model):
            raise ValueError(f"backend serves d_model={header['d_model']}, "
                             f"worker expects {self.d_model}")
        self.max_batch = header.get("max_batch")

    def __call__(self, tokens) -> np.ndarray:
        tokens = np.ascontiguousarray(tokens, dtype="<f4")
        n, tok_len, _ = tokens.shape
        with self._lock:
            try:
                _send_msg(self._sock, {"n": n, "tok": tok_len},
                          tokens.tobytes())
                header, payload = _recv_msg(self._sock)
            except (ConnectionError, OSError):
                # the backend restarted: reconnect once and retry THIS
                # request — a long-lived worker must survive a backend
                # bounce without dropping its buffered streams (the scorer
                # restores buffers if this raises anyway)
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                self._connect()
                _send_msg(self._sock, {"n": n, "tok": tok_len},
                          tokens.tobytes())
                header, payload = _recv_msg(self._sock)
        if "error" in header:
            raise RuntimeError(f"backend: {header['error']}")
        return np.frombuffer(payload, "<f4").copy()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def make_worker_scorer(sock_path: str, part_len: int, n_patch: int,
                       d_model: int, max_streams: int = 16
                       ) -> StreamingScorer:
    """A StreamingScorer whose device apply is a RemoteApply — the object a
    torch-free worker runs serve_jsonl with.  Worker ``max_streams`` is its
    request size toward the backend: keep it <= the backend's max_batch.
    Only the real rows go on the wire (the scorer's ``pad_batches`` is
    off)."""
    return StreamingScorer.with_apply(RemoteApply(sock_path, d_model),
                                      part_len, n_patch, d_model,
                                      max_streams, head_kind="remote")
