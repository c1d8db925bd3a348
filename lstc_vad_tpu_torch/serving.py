"""Online / streaming inference for deployment — PyTorch counterpart of
lstc_vad_tpu/serving.py.

The reference only has offline batch evaluation; a production anomaly
detector consumes video streams clip by clip.  ``StreamingScorer`` serves S
concurrent streams, batching every ready stream into one device call:

- each stream pushes one clip's features [n_patch, d] per video timestep;
- when a stream has accumulated ``part_len`` clips, its part is scored on
  the next flush; streams are batched into [max_streams, part_len*n_patch,
  d] calls;
- emitted scores follow the offline part semantics exactly (LTN classifier
  abnormal-class probability per part), so online and offline scores for
  the same video are the same (tests/test_torch_serving.py).

The live apply is ``evaluation/scoring.py::VideoScorer``, the eval apply the
offline scorers use, on pinned host buffers; an AOT artifact
(``from_artifact``) or a multi-process worker (serving_mp.py) brings its own.
For the STN (per-clip scoring) use ``part_len=1`` with a regressor head.

This module imports numpy and the standard library only: the live scorer
and the artifact loader import torch when they are built, so a
multi-process worker (serving_mp.py) never imports it.
"""

from __future__ import annotations

import base64
import json
from typing import Dict, List, Optional, Tuple

import numpy as np


def _fetch(scores) -> np.ndarray:
    """An apply returns scores, or a zero-arg resolve() that waits for them
    (the live scorer's copies run while the host fills the next group)."""
    return np.asarray(scores() if callable(scores) else scores)


class StreamingScorer:
    """``encoder`` / ``head``: the modules to score with, on their device.
    ``transfer_dtype`` other than float32 is ROADMAP A19 and raises.

    ``n_calls`` counts the device calls made and ``n_padded`` the padding
    rows they carried."""

    def __init__(self, encoder, head, part_len: int, n_patch: int,
                 d_model: int, max_streams: int = 64,
                 head_kind: str = "classifier",
                 transfer_dtype: str = "float32"):
        if transfer_dtype != "float32":
            raise NotImplementedError(
                f"transfer_dtype={transfer_dtype!r}: stream buffers and "
                "flush batches are float32; a narrower wire type is ROADMAP "
                "A19")
        from .evaluation.scoring import VideoScorer

        self._init(part_len, n_patch, d_model, max_streams, head_kind)
        self.scorer = VideoScorer(encoder, head, head_kind)
        self._apply = self.scorer.score_tokens_async
        self._new_batch = self.scorer.host_buffer
        # every flush call of the live scorer has one shape, max_streams
        # rows (the JAX package's one compiled program; here it keeps the
        # call shape fixed); applies that pad for themselves (artifacts,
        # serving_mp.RemoteApply) set this False and get only the real rows
        self.pad_batches = True

    def _init(self, part_len, n_patch, d_model, max_streams, head_kind):
        self.part_len = int(part_len)
        self.n_patch = int(n_patch)
        self.d_model = int(d_model)
        self.max_streams = int(max_streams)
        self.head_kind = head_kind
        self.scorer = None
        self._new_batch = lambda shape: np.empty(shape, np.float32)
        self.pad_batches = False
        self._buffers: Dict[str, List[np.ndarray]] = {}
        self.n_calls = 0
        self.n_padded = 0

    @classmethod
    def with_apply(cls, apply, part_len: int, n_patch: int, d_model: int,
                   max_streams: int = 64, head_kind: str = "remote"):
        """A scorer whose device work is ``apply(tokens [n, L, d] f32) ->
        scores [n]`` (or a resolve() of them), given only the real rows."""
        self = cls.__new__(cls)
        self._init(part_len, n_patch, d_model, max_streams, head_kind)
        self._apply = apply
        return self

    @classmethod
    def from_artifact(cls, path: str, max_streams: int = 64,
                      part_len: Optional[int] = None, device="cuda"):
        """Serve straight from an AOT artifact (CLI ``export-aot``): the
        serving process needs no model code and no config.  The artifact
        must bake the flush token length (part_len*n_patch); if streams may
        end on partial parts, each tail length too (``export-aot --tails``).
        It runs on ``device`` whichever device exported it."""
        from .export import load_scorer

        loaded = load_scorer(path, device=device)
        meta = loaded.meta
        if meta.get("l2_normalize", False):
            # online scores must equal the offline part semantics WITHOUT
            # the UCF final-eval L2 quirk
            raise ValueError(
                "artifact was exported with --l2 (UCF final-eval feature "
                "normalize); streaming serves the plain part semantics — "
                "export without --l2")
        meta_pl = meta.get("part_len")
        if part_len is not None and meta_pl is not None \
                and int(part_len) != int(meta_pl):
            # the baked token_len is part_len*n_patch: a different part_len
            # would recompute n_patch and truncate every pushed clip
            raise ValueError(
                f"artifact was exported with part_len={meta_pl}; the "
                f"part_len={part_len} override would re-window its baked "
                f"programs — drop the override or re-export")
        part_len = meta_pl if meta_pl is not None else part_len
        if part_len is None:
            raise ValueError("artifact meta has no part_len — pass part_len=")
        token_len = meta["token_len"]
        if token_len % part_len:
            raise ValueError(f"token_len {token_len} is not divisible by "
                             f"part_len {part_len}")
        self = cls.with_apply(loaded.score, part_len,
                              token_len // int(part_len), meta["d_model"],
                              max_streams, meta["kind"])
        self.loaded = loaded
        return self

    def push(self, stream_id: str, clip_feat: np.ndarray) -> None:
        """Append one clip's features [n_patch, d] to a stream's buffer."""
        # validate BEFORE touching _buffers: a rejected push must not leak
        # an empty buffer entry per bad stream id in a long-running server
        clip = np.ascontiguousarray(clip_feat[:self.n_patch, :],
                                    dtype=np.float32)
        if clip.shape != (self.n_patch, self.d_model):
            raise ValueError(f"clip shape {clip.shape} != "
                             f"({self.n_patch}, {self.d_model})")
        self._buffers.setdefault(stream_id, []).append(clip)

    def _dispatch(self, parts: List[np.ndarray], tok_len: int):
        """One device call over ``parts`` (each [tok_len, d]), padded to
        max_streams rows when ``pad_batches``; returns what the apply
        returns, without waiting for it."""
        n_rows = self.max_streams if self.pad_batches else len(parts)
        tokens = self._new_batch((n_rows, tok_len, self.d_model))
        for i, part in enumerate(parts):
            tokens[i] = part
        tokens[len(parts):] = 0.0
        self.n_calls += 1
        self.n_padded += n_rows - len(parts)
        return self._apply(tokens)

    def end_stream(self, stream_id: str) -> List[float]:
        """Finish one stream; see end_streams."""
        return self.end_streams([stream_id])[stream_id]

    def end_streams(self, stream_ids) -> Dict[str, List[float]]:
        """Finish MANY streams with batched device calls: every buffered
        full part_len part rides max_streams-row calls like the flush path;
        short tails are scored at their true length — the offline
        no-re-window semantics (the relative-PE index slices to the shorter
        sequence, models/MultiHeadAttention.py:108) — grouped by length so
        each distinct tail length costs one call per group, not one per
        stream.  Returns {stream_id: scores in push order} ([] for empty
        buffers)."""
        out: Dict[str, List[float]] = {}
        full_parts: List[Tuple[str, np.ndarray]] = []
        tails: Dict[int, List[Tuple[str, np.ndarray]]] = {}
        popped: Dict[str, List[np.ndarray]] = {}
        for sid in stream_ids:
            buf = self._buffers.pop(sid, None)
            out[sid] = []
            if not buf:
                continue
            popped[sid] = buf
            n_full = len(buf) - len(buf) % self.part_len
            for start in range(0, n_full, self.part_len):
                full_parts.append((sid, np.concatenate(
                    buf[start:start + self.part_len], axis=0)))
            if len(buf) > n_full:
                tails.setdefault(len(buf) - n_full, []).append(
                    (sid, np.concatenate(buf[n_full:], axis=0)))

        def score_groups(entries, tok_len):
            # dispatch every group before fetching any: group N+1's copy
            # overlaps group N's compute (as the offline _Pipeline does)
            dispatched = []
            for start in range(0, len(entries), self.max_streams):
                group = entries[start:start + self.max_streams]
                dispatched.append((group, self._dispatch(
                    [tok for _, tok in group], tok_len)))
            for group, scores in dispatched:
                for (sid, _), s in zip(group, _fetch(scores)[:len(group)]):
                    out[sid].append(float(s))

        # full parts first (per-stream push order is preserved within the
        # ordered full_parts list), then each stream's single tail
        try:
            score_groups(full_parts, self.part_len * self.n_patch)
            for tail_len, entries in sorted(tails.items()):
                score_groups(entries, tail_len * self.n_patch)
        except Exception:
            # a device error must not lose buffered clips: restore every
            # popped buffer so a retry re-ends the same streams
            self._buffers.update(popped)
            raise
        return out

    def streams(self) -> List[str]:
        """Every stream currently holding buffered clips (push order)."""
        return list(self._buffers)

    def ready(self) -> List[str]:
        return [sid for sid, buf in self._buffers.items()
                if len(buf) >= self.part_len]

    def flush(self) -> List[Tuple[str, float]]:
        """Score every stream holding >= part_len clips; one device call per
        max_streams group, all groups dispatched before any fetch.  Returns
        [(stream_id, score)] in scoring order."""
        ready = self.ready()
        taken: Dict[str, List[np.ndarray]] = {}
        try:
            dispatched = []
            for start in range(0, len(ready), self.max_streams):
                group = ready[start:start + self.max_streams]
                parts = []
                for sid in group:
                    part = self._buffers[sid][:self.part_len]
                    del self._buffers[sid][:self.part_len]
                    if not self._buffers[sid]:
                        # drop drained entries: a long-running server cycling
                        # many stream ids must not accumulate empty buffers
                        del self._buffers[sid]
                    taken[sid] = part
                    parts.append(np.concatenate(part, axis=0))
                dispatched.append((group, self._dispatch(
                    parts, self.part_len * self.n_patch)))
            results: List[Tuple[str, float]] = []
            for group, scores in dispatched:
                results.extend(zip(group,
                                   _fetch(scores)[:len(group)].tolist()))
        except Exception:
            # a device error mid-flush (any group) must not lose buffered
            # clips: re-prepend every popped part so a retry rescores the
            # exact same state
            for sid, part in taken.items():
                self._buffers.setdefault(sid, [])[:0] = part
            raise
        return results


def _decode_feat(feat, n_patch: int, d_model: int) -> np.ndarray:
    """One clip's features from the wire: a base64 string of raw
    little-endian f32 bytes (row-major [n_patch, d_model]) or a nested
    list.  Exact-size checked — a truncated payload is a protocol error,
    never a silently reshaped array."""
    if isinstance(feat, str):
        raw = base64.b64decode(feat, validate=True)
        expect = n_patch * d_model * 4
        if len(raw) != expect:
            raise ValueError(
                f"feat payload is {len(raw)} bytes, expected {expect} "
                f"(little-endian f32 [{n_patch}, {d_model}])")
        return np.frombuffer(raw, dtype="<f4").reshape(n_patch, d_model)
    arr = np.asarray(feat, dtype=np.float32)
    if arr.shape != (n_patch, d_model):
        raise ValueError(f"feat shape {arr.shape} != ({n_patch}, {d_model})")
    return arr


def serve_jsonl(scorer: StreamingScorer, in_stream, out_stream,
                flush_every: int = 0) -> Tuple[int, int]:
    """Line-oriented JSON serving loop (CLI ``serve``): one request object
    per input line, one reply object per output line — the JAX package's
    protocol, line for line.

    Requests:
      {"op": "push", "stream": ID, "feat": FEAT}   buffer one clip
      {"op": "flush"}                              score every ready stream
      {"op": "end",  "stream": ID}                 finish one stream
      {"op": "end_all"}                            finish every stream

    ``FEAT`` is base64 of raw little-endian f32 bytes ([n_patch, d_model]
    row-major) or a nested list.

    Replies (flushed after every request so a pipe peer can read
    synchronously):
      push     -> nothing (or the flush replies, when flush_every fires)
      flush    -> {"stream": ID, "score": S} per scored part — EVERY
                  buffered full part (drained until no stream is ready) —
                  then {"flushed": N}
      end(s)   -> {"stream": ID, "scores": [...], "ended": true} per stream
                  (tails scored at true length); end_all then terminates the
                  burst with {"ended_streams": N} (possibly N=0)
      error    -> {"error": "..."} ; the loop continues (a malformed line
                  must not kill the other streams)

    EOF implicitly ends every remaining stream.  ``flush_every=K`` also
    flushes after every K pushes (when some stream is ready).  Returns
    (n_pushes, n_scores)."""
    n_push = n_scores = 0

    def emit(obj):
        out_stream.write(json.dumps(obj) + "\n")
        out_stream.flush()

    def do_flush():
        # drain EVERY buffered full part (flush() scores one part per ready
        # stream per call): a server that falls behind the push rate must
        # catch up in one flush, not keep one part per cycle
        nonlocal n_scores
        total = 0
        while True:
            results = scorer.flush()
            for sid, s in results:
                emit({"stream": sid, "score": s})
            total += len(results)
            if not results or not scorer.ready():
                break
        emit({"flushed": total})
        n_scores += total

    def do_end(sids, terminator=False):
        nonlocal n_scores
        outs = scorer.end_streams(sids)
        for sid in sids:
            emit({"stream": sid, "scores": outs[sid], "ended": True})
            n_scores += len(outs[sid])
        if terminator:
            # end_all's reply count is data-dependent (one line per stream,
            # possibly zero): a synchronous pipe peer needs a terminator
            emit({"ended_streams": len(sids)})

    for line in in_stream:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
            op = msg.get("op")
            if op == "push":
                scorer.push(str(msg["stream"]),
                            _decode_feat(msg["feat"], scorer.n_patch,
                                         scorer.d_model))
                n_push += 1
                if flush_every and n_push % flush_every == 0 \
                        and scorer.ready():
                    do_flush()
            elif op == "flush":
                do_flush()
            elif op == "end":
                do_end([str(msg["stream"])])
            elif op == "end_all":
                do_end(scorer.streams(), terminator=True)
            else:
                raise ValueError(f"unknown op {op!r}")
        except Exception as e:  # malformed input must not kill the server
            emit({"error": f"{type(e).__name__}: {e}"})
    if scorer.streams():
        try:
            do_end(scorer.streams(), terminator=True)
        except Exception as e:
            # the implicit EOF cleanup must not crash the loop's return (an
            # artifact without tail programs raises here for partial tails)
            emit({"error": f"{type(e).__name__}: {e}"})
    return n_push, n_scores
