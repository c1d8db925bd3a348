"""Batched scorers for evaluation and pseudo labels — PyTorch counterpart of
lstc_vad_tpu/evaluation/scoring.py:29-288, 320-650.

The reference scores one part per device call in a Python loop
(Test/evaluation_shanghaitech_ubnormal.py:77-91 — batch size 1, a host sync
per part).  Here a video's parts — and, in ``score_videos``, many videos'
parts — are gathered on host into one batch of up to ``CHUNK`` parts and
scored in one device call.  Scores are numerically the same per part:
attention never mixes parts, so batching changes nothing but throughput.

Unlike the JAX package, batches are not padded up to bucket sizes: eager
PyTorch compiles nothing per shape, so padding would only move dead rows.

On the card, a batch goes to the device from pinned host memory with a
non-blocking copy, its scores come back the same way, and the ``resolve()``
a dispatch returns is the only point that waits for the device, so the host
fills batch N+1 while the card computes batch N.

Wire type (``transfer_dtype``, ``data.eval_transfer_dtype`` in the Trainer
and the CLI): with "bfloat16" the host buffers are bf16 torch tensors
(numpy has no bf16), filled by a cast rounding to nearest even, so the copy
to the device carries half the bytes; the device upcasts to f32 before the
encoder, which computes in f32 (lstc_vad_tpu/evaluation/scoring.py:111-114,
191-195).  Scores then move by the bf16 rounding of the features, so the
default stays float32.

Variable-length tails (paths without tail re-windowing) are scored at their
true length in a separate call — shorter sequences change the relative-PE
slice, so padding them would NOT be equivalent
(models/MultiHeadAttention.py:108).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import replace
from ..utils.misc import resolve_dtype
from .frame_auc import (part_bounds, part_slices, ucf_bin_edges, ucf_bin_pool,
                        ucf_part_plan)

CHUNK = 2048  # parts per device call (a 49-token f32 LTN chunk is ~0.8 GB)


def _resolve(feats):
    """Accept an array OR a zero-arg callable returning one: the lazy test
    split (data/datasets.py TestVideo.loader) streams each video's features
    through the scorer and lets them be freed before the next video loads."""
    return feats() if callable(feats) else feats


def _read_ahead(feats_list, depth: int = 1):
    """Yield resolved feature arrays, loading ``depth`` videos ahead in a
    reader thread: video N+1's h5 read overlaps video N's host copy and
    device dispatch.  Steady-state liveness is current + depth + 1 arrays.
    Loader exceptions re-raise in the consumer.

    If the consumer abandons the generator (a scoring exception, or an early
    close), the finally block signals the worker and drains the queue: the
    thread exits within its put-poll interval and every parked array is
    released."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        """Bounded put that gives up once the consumer signalled stop."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for f in feats_list:
                if not put((None, _resolve(f))):
                    return
        except BaseException as e:  # surface in the consuming thread
            put((e, None))
            return
        put((None, done))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            err, item = q.get()
            if err is not None:
                raise err
            if item is done:
                return
            yield item
            # drop our reference before blocking in the next get
            del item
    finally:
        stop.set()
        while True:  # release anything still parked in the queue
            try:
                q.get_nowait()
            except queue.Empty:
                break


def fill(buf, index, value):
    """``buf[index] = value`` for a host buffer of ``host_buffer``: a numpy
    array, or a torch tensor of a narrower wire type, which the copy rounds
    to (nearest even)."""
    if isinstance(buf, np.ndarray):
        buf[index] = value
    else:
        buf[index] = torch.as_tensor(value)


def _scorer_apply(encoder, head, kind: str, l2: bool, x: torch.Tensor
                  ) -> torch.Tensor:
    # a narrower wire is upcast on the device: the compute stays f32
    x = x.float()
    if l2:
        # UCF eval-only quirk: F.normalize(p=2) on the raw features
        # (Test/evaluation_UCF.py:77), x / max(||x||, 1e-12)
        x = F.normalize(x, p=2.0, dim=-1, eps=1e-12)
    h = encoder(x)
    out = head(h[:, 0, :])
    if kind == "classifier":
        return out[:, 1]
    return out[:, 0]


class VideoScorer:
    """Encoder + head apply over [B, T, d] token batches on the encoder's
    device.  ``kind``: 'regressor' -> out[:, 0], 'classifier' -> probs[:, 1]
    (abnormal class).  ``l2_normalize``: divide each token by its L2 norm
    first (the UCF final eval).  ``transfer_dtype``: the wire type of the
    token batches (see the module's docstring).  Puts both modules in eval
    mode.  ``n_calls`` counts the encoder calls (one per dispatched
    batch)."""

    def __init__(self, encoder, head, kind: str, l2_normalize: bool = False,
                 transfer_dtype: str = "float32"):
        self.encoder = encoder.eval()
        self.head = head.eval()
        self.kind = kind
        self.l2_normalize = l2_normalize
        self.wire = resolve_dtype(transfer_dtype)
        self.device = next(encoder.parameters()).device
        self.n_calls = 0

    def host_buffer(self, shape):
        """A host buffer of the wire type to fill with tokens (``fill``):
        pinned memory when the scorer runs on the card, so its copy to the
        device needs no staging copy and can run while the host goes on.  A
        float32 numpy array, or a torch tensor of a narrower wire type."""
        pinned = self.device.type == "cuda"
        if self.wire != torch.float32:
            return torch.empty(shape, dtype=self.wire, pin_memory=pinned)
        if pinned:
            return torch.empty(shape, dtype=torch.float32,
                               pin_memory=True).numpy()
        return np.empty(shape, np.float32)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return _scorer_apply(self.encoder, self.head, self.kind,
                             self.l2_normalize, x)

    def _dispatch(self, tokens: np.ndarray):
        """ONE device call; returns a zero-arg resolve() -> scores [n].  On
        the card nothing here waits for the device: the copies and compute
        are enqueued and only resolve() synchronises."""
        self.n_calls += 1
        if isinstance(tokens, torch.Tensor):  # a host_buffer of the wire
            host = tokens
        else:
            host = torch.from_numpy(np.ascontiguousarray(tokens,
                                                         dtype=np.float32))
        host = host.to(self.wire)  # the cast on the host, before the copy
        if self.device.type == "cpu":
            with torch.inference_mode():
                scores = self._forward(host).numpy()
            return lambda: scores
        if not host.is_pinned():
            host = host.pin_memory()
        with torch.cuda.device(self.device), torch.inference_mode():
            x = host.to(self.device, non_blocking=True)
            scores = self._forward(x)
            out = torch.empty(scores.shape, dtype=torch.float32,
                              pin_memory=True)
            out.copy_(scores, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()

        def resolve(host=host):  # holds the pinned input until the copy ran
            ready.synchronize()
            return out.numpy().copy()

        return resolve

    def score_tokens_async(self, tokens: np.ndarray):
        """Dispatch the batch in chunks of at most ``CHUNK`` rows WITHOUT
        waiting; returns a zero-arg resolve() -> scores [B]."""
        resolvers = [self._dispatch(tokens[pos:pos + CHUNK])
                     for pos in range(0, tokens.shape[0], CHUNK)]
        if not resolvers:
            return lambda: np.empty(0, np.float32)
        if len(resolvers) == 1:
            return resolvers[0]
        return lambda: np.concatenate([r() for r in resolvers])

    def score_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """tokens: [B, T, d] float32 -> scores [B] (host numpy)."""
        return self.score_tokens_async(tokens)()


class ArtifactVideoScorer(VideoScorer):
    """A ``VideoScorer`` drop-in backed by an AOT artifact
    (export.py::LoadedScorer): the same pinned-buffer dispatch, with the
    loaded program in place of the modules (lstc_vad_tpu/evaluation/
    scoring.py:291).  Any scorer above takes it as its ``scorer``."""

    def __init__(self, loaded):
        self.loaded = loaded
        self.kind = loaded.meta["kind"]
        self.l2_normalize = loaded.meta.get("l2_normalize", False)
        self.wire = torch.float32  # an exported program takes f32 tokens
        self.device = loaded.device
        self.n_calls = 0

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.loaded.forward(x)


class _Pipeline:
    """Bounded dispatch pipeline for the cross-video scorers: batch N+1's
    copy and compute are enqueued before batch N's scores are fetched.
    ``max_inflight`` bounds the batches alive on the device."""

    def __init__(self, max_inflight: int = 2):
        self._q = collections.deque()
        self._max = max_inflight

    def add(self, resolve, sink):
        """``resolve``: zero-arg -> scores; ``sink``: consumes them."""
        self._q.append((resolve, sink))
        while len(self._q) >= self._max:
            self._pop()

    def _pop(self):
        resolve, sink = self._q.popleft()
        sink(resolve())

    def drain(self):
        while self._q:
            self._pop()


class ClipScorer:
    """STN: every clip of a video scored as one n_patch-token sequence
    (cf. Train/spatio_transformer_shanghaitech.py:133-137).

    ``kind='classifier'`` serves the reference's n_layers==1 pseudo-generator
    switch, which scores clips with a Classifier's abnormal-class
    probability."""

    def __init__(self, encoder, head, n_patch: int, kind: str = "regressor",
                 transfer_dtype: str = "float32"):
        self.scorer = VideoScorer(encoder, head, kind,
                                  transfer_dtype=transfer_dtype)
        self.n_patch = n_patch

    def score_video(self, feats: np.ndarray) -> np.ndarray:
        feats = _resolve(feats)
        tokens = np.ascontiguousarray(feats[:, :self.n_patch, :],
                                      dtype=np.float32)
        return self.scorer.score_tokens(tokens)

    def score_videos(self, feats_list: List[np.ndarray]) -> List[np.ndarray]:
        """All clips of all videos in chunk-sized batches, streamed: the
        whole test set's clips are never held at once."""
        lengths = []
        flat_parts, buf, filled = [], None, 0
        pipe = _Pipeline()
        for f in _read_ahead(feats_list):
            t = np.ascontiguousarray(f[:, :self.n_patch, :], dtype=np.float32)
            del f
            lengths.append(t.shape[0])
            pos = 0
            while pos < len(t):
                if buf is None:
                    buf = self.scorer.host_buffer((CHUNK,) + t.shape[1:])
                    filled = 0
                take = min(CHUNK - filled, len(t) - pos)
                fill(buf, slice(filled, filled + take), t[pos:pos + take])
                filled += take
                pos += take
                if filled == CHUNK:
                    pipe.add(self.scorer.score_tokens_async(buf),
                             flat_parts.append)
                    buf, filled = None, 0
        if buf is not None and filled:
            pipe.add(self.scorer.score_tokens_async(buf[:filled]),
                     flat_parts.append)
        pipe.drain()
        flat = np.concatenate(flat_parts) if flat_parts else np.empty(0)
        out, cursor = [], 0
        for n in lengths:
            out.append(flat[cursor:cursor + n])
            cursor += n
        return out


class PartScorer:
    """LTN: chunk a video into parts of part_len clips, score all parts in
    one batch.  Returns (part_scores [n_parts], counts [n_parts])."""

    def __init__(self, encoder, head, part_len: int, n_patch: int,
                 tail_rewindow: bool = True, transfer_dtype: str = "float32"):
        self.scorer = VideoScorer(encoder, head, "classifier",
                                  transfer_dtype=transfer_dtype)
        self.part_len = part_len
        self.n_patch = n_patch
        self.tail_rewindow = tail_rewindow

    def score_video(self, feats: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        feats = np.ascontiguousarray(_resolve(feats)[:, :self.n_patch, :],
                                     dtype=np.float32)
        n_clips, n_patch, d = feats.shape
        idx_list, counts = part_slices(n_clips, self.part_len,
                                       self.tail_rewindow)
        scores = np.empty(len(idx_list), dtype=np.float32)
        # group parts by token length; full-length parts batch together
        by_len: Dict[int, List[int]] = {}
        for i, idx in enumerate(idx_list):
            by_len.setdefault(len(idx), []).append(i)
        for length, part_ids in by_len.items():
            gathered = np.stack([feats[idx_list[i]] for i in part_ids])
            tokens = gathered.reshape(len(part_ids), length * n_patch, d)
            scores[part_ids] = self.scorer.score_tokens(tokens)
        return scores, counts

    def score_videos(self, feats_list: List[np.ndarray]
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Score MANY videos in large cross-video part batches: one copy to
        the device and one encoder call per chunk of up to ``CHUNK`` parts;
        parts stream through a chunk-sized buffer.  Returns
        [(part_scores, counts)] aligned with ``feats_list``."""
        out: List[np.ndarray] = []
        all_counts: List[np.ndarray] = []
        shorts: List[Tuple[int, int, np.ndarray]] = []
        buf = None
        pending: List[Tuple[int, int]] = []
        pipe = _Pipeline()  # overlap chunk N+1's copy with chunk N's compute

        def new_buffer(n_patch, d):
            return self.scorer.host_buffer(
                (CHUNK, self.part_len * n_patch, d))

        def flush():
            nonlocal buf
            if pending:
                targets = list(pending)

                def sink(scores, targets=targets):
                    for (v, i), s in zip(targets, scores):
                        out[v][i] = s

                pipe.add(self.scorer.score_tokens_async(
                    buf[:len(pending)]), sink)
            buf = None
            pending.clear()

        for v, feats in enumerate(_read_ahead(feats_list)):
            feats = np.ascontiguousarray(feats[:, :self.n_patch, :],
                                         dtype=np.float32)
            n_clips, n_patch, d = feats.shape
            idx_list, counts = part_slices(n_clips, self.part_len,
                                           self.tail_rewindow)
            all_counts.append(counts)
            out.append(np.empty(len(idx_list), dtype=np.float32))
            # parts 0..n_aligned-1 are stride-aligned slices: pack them into
            # the chunk buffer with block copies off one reshape VIEW of the
            # video.  The re-windowed tail (full-length but unaligned) and
            # short tails take the per-part path below.
            n_aligned = n_clips // self.part_len
            full_view = feats[:n_aligned * self.part_len].reshape(
                n_aligned, self.part_len * n_patch, d)
            pos = 0
            while pos < n_aligned:
                if buf is None:
                    buf = new_buffer(n_patch, d)
                take = min(CHUNK - len(pending), n_aligned - pos)
                fill(buf, slice(len(pending), len(pending) + take),
                     full_view[pos:pos + take])
                pending.extend((v, i) for i in range(pos, pos + take))
                pos += take
                if len(pending) == CHUNK:
                    flush()
            del full_view  # a view of feats
            for i in range(n_aligned, len(idx_list)):
                idx = idx_list[i]
                if len(idx) != self.part_len:
                    shorts.append((v, i, feats[idx]))
                    continue
                if buf is None:
                    buf = new_buffer(n_patch, d)
                fill(buf, len(pending), feats[idx].reshape(-1, d))
                pending.append((v, i))
                if len(pending) == CHUNK:
                    flush()
        flush()
        pipe.drain()
        # short tails grouped by length: one batched call per distinct tail
        # length instead of one batch-1 call per video
        shorts_by_len: Dict[int, List[Tuple[int, int, np.ndarray]]] = {}
        for v, i, gathered in shorts:
            shorts_by_len.setdefault(gathered.shape[0], []).append(
                (v, i, gathered))
        for entries in shorts_by_len.values():
            tokens = np.stack([g for _, _, g in entries])
            tokens = tokens.reshape(len(entries), -1, tokens.shape[-1])
            scores = self.scorer.score_tokens(tokens)
            for (v, i, _), s in zip(entries, scores):
                out[v][i] = s
        return list(zip(out, all_counts))


class UCFBinnedScorer:
    """UCF long-video path: linspace-compress to max_clips bins, mean-pool,
    optional L2 norm, part-chunk in bin space (Test/evaluation_UCF.py:44-85;
    Train/pseudo_labels_generator_temporal.py:72-107 without re-windowing).

    Returns (part_scores, parts [(beg, end) in bin space], bin_edges r).

    Three reference variants map onto the flags:
    - final eval (Test/evaluation_UCF.py): l2_normalize=True,
      tail_rewindow=True, adaptive_bins=False, n_clips from n_frames//16;
    - in-training eval (Train/temporal_transformer_UCF.py:144-172):
      l2_normalize=False, tail_rewindow=False, adaptive_bins=True, n_clips
      from the feature array length;
    - pseudo-label gen (Train/pseudo_labels_generator_temporal.py:72-107):
      l2_normalize=False, tail_rewindow=False, adaptive_bins=False."""

    # flush the cross-video groups every this-many accumulated parts: bounds
    # resident binned arrays to a window (~120 UCF-scale videos) while still
    # batching far beyond one video per device call
    _FLUSH_PARTS = 2048

    def __init__(self, encoder, head, part_len: int, n_patch: int,
                 max_clips: int = 32, l2_normalize: bool = True,
                 tail_rewindow: bool = True, adaptive_bins: bool = False,
                 transfer_dtype: str = "float32"):
        self.scorer = VideoScorer(encoder, head, "classifier",
                                  l2_normalize=l2_normalize,
                                  transfer_dtype=transfer_dtype)
        self.part_len = part_len
        self.n_patch = n_patch
        self.max_clips = max_clips
        self.tail_rewindow = tail_rewindow
        self.adaptive_bins = adaptive_bins

    def score_video(self, feats: np.ndarray, n_clips: int):
        return self.score_videos([(feats, n_clips)])[0]

    def _plan(self, feats: np.ndarray, n_clips: int):
        feats = np.ascontiguousarray(feats[:, :self.n_patch, :],
                                     dtype=np.float32)
        bins = min(self.max_clips, n_clips) if self.adaptive_bins \
            else self.max_clips
        r = ucf_bin_edges(n_clips, bins)
        binned = ucf_bin_pool(feats, r)
        parts = (ucf_part_plan(bins, self.part_len) if self.tail_rewindow
                 else part_bounds(bins, self.part_len))
        return binned, parts, r

    def score_videos(self, items):
        """items = [(feats or a zero-arg loader, n_clips)] ->
        [(part_scores, parts, r)] aligned with items: one device call per
        token-length group per flush window.

        Groups are flushed every ``_FLUSH_PARTS`` accumulated parts, so the
        binned arrays of only a window of videos stay resident: the UCF
        train split is ~1,600 videos, against the one-video-resident
        streaming the other scorers promise."""
        items = list(items)
        metas = []   # (parts, r) per video — small, kept for the return
        outs: List[np.ndarray] = []
        groups: Dict[int, List[Tuple[int, int, np.ndarray]]] = {}
        pending_parts = 0
        pipe = _Pipeline()  # overlap group N+1's copy with group N's compute

        def flush():
            nonlocal pending_parts
            for entries in groups.values():
                buf = self.scorer.host_buffer(
                    (len(entries),) + entries[0][2].shape)
                for j, (_, _, tok) in enumerate(entries):
                    fill(buf, j, tok)
                targets = [(v, i) for v, i, _ in entries]

                def sink(scores, targets=targets):
                    for (v, i), s in zip(targets, scores):
                        outs[v][i] = s

                pipe.add(self.scorer.score_tokens_async(buf), sink)
            groups.clear()  # drops the token views -> binned arrays free
            pending_parts = 0

        for v, (feats, (_, n)) in enumerate(
                zip(_read_ahead([f for f, _ in items]), items)):
            binned, parts, r = self._plan(feats, n)
            del feats  # raw video array: only the pooled ``binned`` is kept
            metas.append((parts, r))
            outs.append(np.empty(len(parts), np.float32))
            d = binned.shape[-1]
            for i, (beg, end) in enumerate(parts):
                tok = binned[beg:end].reshape((end - beg) * self.n_patch, d)
                groups.setdefault(end - beg, []).append((v, i, tok))
            pending_parts += len(parts)
            if pending_parts >= self._FLUSH_PARTS:
                flush()
        flush()
        pipe.drain()
        return [(outs[v], parts, r) for v, (parts, r) in enumerate(metas)]


class UCFClipBinScorer:
    """UCF STN eval: each non-empty bin mean-pooled to ONE clip and scored by
    the regressor (Train/spatio_transformer_UCF.py:120-135).

    Returns (scores [n_non_empty], bin_ids [n_non_empty], r)."""

    def __init__(self, encoder, head, n_patch: int, max_clips: int = 32,
                 transfer_dtype: str = "float32"):
        self.scorer = VideoScorer(encoder, head, "regressor",
                                  transfer_dtype=transfer_dtype)
        self.n_patch = n_patch
        self.max_clips = max_clips

    def score_video(self, feats: np.ndarray, n_clips: int):
        return self.score_videos([(feats, n_clips)])[0]

    def score_videos(self, items):
        """items = [(feats or a zero-arg loader, n_clips)] ->
        [(scores, bin_ids, r)].  Every video's pooled bin tokens stream
        through chunk-sized host buffers, one device call per ``CHUNK``
        tokens.  A video with no non-empty bin (n_frames < segment_len)
        scores nothing, as the reference loop moves on
        (Train/spatio_transformer_UCF.py:123)."""
        items = list(items)
        plans = []
        flat_parts, buf, filled = [], None, 0
        pipe = _Pipeline()
        for feats, (_, n_clips) in zip(_read_ahead([f for f, _ in items]),
                                       items):
            feats = np.ascontiguousarray(feats[:, :self.n_patch, :],
                                         dtype=np.float32)
            r = ucf_bin_edges(n_clips, self.max_clips)
            bin_ids = [i for i in range(self.max_clips) if r[i] != r[i + 1]]
            plans.append((np.asarray(bin_ids, np.int64), r))
            for i in bin_ids:
                if buf is None:
                    buf = self.scorer.host_buffer((CHUNK,) + feats.shape[1:])
                    filled = 0
                fill(buf, filled, feats[r[i]:r[i + 1]].mean(axis=0))
                filled += 1
                if filled == CHUNK:
                    pipe.add(self.scorer.score_tokens_async(buf),
                             flat_parts.append)
                    buf, filled = None, 0
            del feats
        if buf is not None and filled:
            pipe.add(self.scorer.score_tokens_async(buf[:filled]),
                     flat_parts.append)
        pipe.drain()
        flat = (np.concatenate(flat_parts) if flat_parts
                else np.empty(0, np.float32))
        out, cursor = [], 0
        for bin_ids, r in plans:
            n = len(bin_ids)
            out.append((flat[cursor:cursor + n], bin_ids, r))
            cursor += n
        return out


def ucf_final_eval_shapes(cfg):
    """The UCF LTN final eval builds the encoder at part_len=2 and its
    ckpts carry the window_depth=2 RPE table (Test/evaluation_UCF.py:33,42 +
    README command --part_len 2); any other config is returned as is."""
    if cfg.data.dataset == "UCF" and not cfg.model.startswith("stn"):
        return replace(cfg, **{"encoder.window_depth": 2,
                               "data.part_len": 2})
    return cfg


def ucf_final_eval_scorer(cfg, encoder, head) -> UCFBinnedScorer:
    """The UCF LTN final-eval scorer (Test/evaluation_UCF.py) for ``cfg``
    at ``ucf_final_eval_shapes``: fixed max_clips bins (from n_frames // 16
    in the caller's items), L2-normalized features, tails re-windowed, the
    config's evaluation wire."""
    d = cfg.data
    return UCFBinnedScorer(encoder, head, d.part_len, d.n_patch,
                           max_clips=cfg.max_clips, l2_normalize=True,
                           tail_rewindow=True,
                           transfer_dtype=d.eval_transfer_dtype)
