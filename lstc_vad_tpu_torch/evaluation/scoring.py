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

On a mesh whose data axis has more than one rank (modules laid out by
parallel/mesh.py::shard_params, which sets ``encoder.mesh``), every scorer
is data parallel (lstc_vad_tpu/evaluation/scoring.py:196-217): a batch is
padded to a multiple of the data axis, each data rank scores its rows
through the tensor-parallel modules, and the scores are all-gathered, so
every process gets every score and computes the same AUC.  That dispatch
runs its collectives at once, in program order, and returns scores already
fetched: the deferral of ``_Pipeline`` then reorders nothing across
processes.

Every scorer hands its rows to one chunk packer (``_Packer``), which keeps a
chunk per token length: variable-length tails (paths without tail
re-windowing) are scored at their true length in chunks of their own —
shorter sequences change the relative-PE slice, so padding them would NOT
be equivalent (models/MultiHeadAttention.py:108).  The packer's float32
copies into a chunk's host buffer run on a small pool of copy threads
(``FILL_THREADS``, one pool a process): the unit thread plans and submits
them, and a chunk is dispatched once its own copies have landed, so the card
receives the same chunks as with copies made inline.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import threading
from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import replace
from ..utils.misc import resolve_dtype
from ..utils.profiling import annotate
from .frame_auc import (part_bounds, part_slices, ucf_bin_edges, ucf_bin_pool,
                        ucf_part_plan)

CHUNK = 2048  # parts per device call (a 49-token f32 LTN chunk is ~0.8 GB)
# The packer's copy threads.  On an 8-core H100 host an eval pass's pack stops
# gaining past 4 of them (PERF.md); the unit thread, the reader and the CUDA
# runtime's threads keep the other cores.
FILL_THREADS = max(1, min(4, len(os.sched_getaffinity(0)) - 2))
# A copy of fewer bytes runs inline on the unit thread: handing it to a copy
# thread costs the unit thread more than copying it (a re-windowed tail's one
# row, a short video).
FILL_MIN_BYTES = 1 << 20
# A larger copy goes to the copy threads in at most FILL_THREADS row ranges of
# at least this many bytes: a video's block is one range, a long one is
# split.  Each range costs the unit thread a hand-off, so ranges stay large.
FILL_RANGE_BYTES = 8 << 20
# The videos whose copies may be pending at once: each holds its array.
FILL_VIDEOS = 2 * FILL_THREADS

_pool_lock = threading.Lock()
_pool = None


def _fill_pool() -> concurrent.futures.ThreadPoolExecutor:
    """The process's copy threads, started on first use."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = concurrent.futures.ThreadPoolExecutor(
                FILL_THREADS, thread_name_prefix="scorer-fill")
        return _pool


def _read_ahead(feats_list, depth: int = 1):
    """Yield the feature arrays of ``feats_list``, each an array or a
    zero-arg loader of one (the lazy test split, data/datasets.py
    TestVideo.loader, frees each video before the next loads), loading
    ``depth`` videos ahead in a reader thread: video N+1's h5 read overlaps
    video N's host copy and device dispatch.  Steady-state liveness is
    current + depth + 1 arrays, and under ``_Packer`` those of at most
    ``FILL_VIDEOS`` videos more, whose copies are pending.  Loader
    exceptions re-raise in the consumer.

    If the consumer abandons the generator (a scoring exception, or an early
    close), the finally block signals the worker and drains the queue: the
    thread exits within its put-poll interval and every parked array is
    released."""
    import queue

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

    def read(f):
        with annotate("scorer.read"):
            return f() if callable(f) else f

    def worker():
        try:
            for f in feats_list:
                if not put((None, read(f))):
                    return
        except BaseException as e:  # surface in the consuming thread
            put((e, None))
            return
        put((None, done))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            with annotate("scorer.read_wait"):
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


def _pooled_fill(buf, index, value):
    """``fill`` on a copy thread."""
    with annotate("scorer.fill"):
        fill(buf, index, value)


def _settle(copies, check: bool = True):
    """Wait until every copy of ``copies`` has landed; then, with ``check``,
    re-raise the first one's exception."""
    if not all(f.done() for f in copies):
        with annotate("scorer.fill_wait"):
            concurrent.futures.wait(copies)
    if check:
        for f in copies:
            f.result()


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


def _data_parallel(mesh):
    """``mesh`` where its data axis splits a batch, else None: on a data
    axis of one the plain dispatch scores every row, and the model axis's
    collectives run inside the forward, in program order."""
    from ..parallel.tp import mesh_axis

    if mesh is None or mesh_axis(mesh, "data").size == 1:
        return None
    return mesh


class VideoScorer:
    """Encoder + head apply over [B, T, d] token batches on the encoder's
    device.  ``kind``: 'regressor' -> out[:, 0], 'classifier' -> probs[:, 1]
    (abnormal class).  ``l2_normalize``: divide each token by its L2 norm
    first (the UCF final eval).  ``transfer_dtype``: the wire type of the
    token batches (see the module's docstring).  Puts both modules in eval
    mode.  ``n_calls`` counts the encoder calls (one per dispatched
    batch); ``fill_pooled_bytes`` and ``fill_inline_bytes`` the bytes of the
    rows ``_Packer`` copied into its buffers on the copy threads and on the
    unit thread."""

    def __init__(self, encoder, head, kind: str, l2_normalize: bool = False,
                 transfer_dtype: str = "float32"):
        self.encoder = encoder.eval()
        self.head = head.eval()
        self.kind = kind
        self.l2_normalize = l2_normalize
        self.wire = resolve_dtype(transfer_dtype)
        self.device = next(encoder.parameters()).device
        self.mesh = _data_parallel(getattr(encoder, "mesh", None))
        self.n_calls = 0
        self.fill_pooled_bytes = 0
        self.fill_inline_bytes = 0

    def host_buffer(self, shape):
        """A host buffer of the wire type to fill with tokens (``fill``):
        pinned memory when the scorer runs on the card, so its copy to the
        device needs no staging copy and can run while the host goes on.  A
        float32 numpy array, or a torch tensor of a narrower wire type."""
        pinned = self.device.type == "cuda"
        with annotate("scorer.alloc"):
            if self.wire != torch.float32:
                return torch.empty(shape, dtype=self.wire,
                                   pin_memory=pinned)
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
        with annotate("scorer.dispatch"):
            if isinstance(tokens, torch.Tensor):  # a host_buffer of the wire
                host = tokens
            else:
                host = torch.from_numpy(np.ascontiguousarray(
                    tokens, dtype=np.float32))
            host = host.to(self.wire)  # the cast on the host, before the copy
            if self.mesh is not None:
                scores = self._sharded(host)
                return lambda: scores
            if self.device.type == "cpu":
                with torch.inference_mode(), annotate("scorer.forward"):
                    scores = self._forward(host).numpy()
                return lambda: scores
            if not host.is_pinned():
                host = host.pin_memory()
            with torch.cuda.device(self.device), torch.inference_mode():
                with annotate("scorer.h2d"):
                    x = host.to(self.device, non_blocking=True)
                with annotate("scorer.forward"):
                    scores = self._forward(x)
                with annotate("scorer.d2h"):
                    out = torch.empty(scores.shape, dtype=torch.float32,
                                      pin_memory=True)
                    out.copy_(scores, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record()

        def resolve(host=host):  # holds the pinned input until the copy ran
            with annotate("scorer.wait"):
                ready.synchronize()
            return out.numpy().copy()

        return resolve

    def _sharded(self, host: torch.Tensor) -> np.ndarray:
        """This data rank's rows of ``host`` (padded to a multiple of the
        data axis) scored, every rank's scores gathered: a collective, run
        now."""
        from ..parallel.mesh import batch_sharding
        from ..parallel.multihost import fetch
        from ..parallel.tp import mesh_axis

        n = host.shape[0]
        pad = -n % mesh_axis(self.mesh, "data").size
        if pad:
            host = torch.cat([host, host.new_zeros((pad,) + host.shape[1:])])
        rows = host[batch_sharding(self.mesh, host.shape[0])]
        with torch.inference_mode():
            scores = self._forward(rows.to(self.device))
            return fetch(scores, self.mesh)[:n].float().cpu().numpy()

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
        self.mesh = None
        self.n_calls = 0
        self.fill_pooled_bytes = 0
        self.fill_inline_bytes = 0

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


class _Packer:
    """The chunk packer under the offline scorers.  ``add`` copies rows into
    the open ``CHUNK``-row ``host_buffer`` of their shape (one per token
    length), a buffer that fills is dispatched at once into one
    ``_Pipeline``, and its sink scatters the scores to the videos' arrays.
    ``finish`` dispatches the partly filled buffers, the shape seen first
    going first, drains, and returns the arrays.

    A float32 copy of ``FILL_MIN_BYTES`` or more runs on the copy threads,
    in row ranges; a chunk is dispatched once its own copies have landed.
    Used as a context manager, which on leaving waits for every copy still
    pending: no copy writes into a buffer after the packer has let it go
    (the caching host allocator hands a freed pinned block to the next
    buffer)."""

    def __init__(self, scorer: VideoScorer):
        self.scorer = scorer
        self.out: List[np.ndarray] = []
        # row shape -> its open chunk, None once dispatched; the keys keep
        # the order in which the shapes were first seen
        self._open: Dict[tuple, SimpleNamespace] = {}
        self._pipe = _Pipeline()  # chunk N+1's copy beside chunk N's compute
        # video -> its pooled copies, oldest video first
        self._copies: "collections.OrderedDict[int, list]" = \
            collections.OrderedDict()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        _settle([f for fs in self._copies.values() for f in fs],
                check=exc_type is None)

    def video(self, n: int) -> int:
        """A score array of ``n`` rows for the next video; its index."""
        self.out.append(np.empty(n, np.float32))
        return len(self.out) - 1

    def add(self, v: int, i: int, rows: np.ndarray):
        """rows [k, L, d], scored into ``out[v][i:i+k]``: copied in slices
        of what fits, so a block of rows stays one copy a chunk."""
        shape = rows.shape[1:]
        pos = 0
        while pos < len(rows):
            c = self._open.get(shape)
            if c is None:
                c = self._open[shape] = SimpleNamespace(
                    buf=self.scorer.host_buffer((CHUNK,) + shape), filled=0,
                    targets=[], copies=[])
            take = min(CHUNK - c.filled, len(rows) - pos)
            self._fill(c, v, rows[pos:pos + take])
            c.targets.append((c.filled, v, i + pos, take))  # (row, v, i, k)
            c.filled += take
            pos += take
            if c.filled == CHUNK:
                self._dispatch(shape)

    def _fill(self, c, v: int, rows: np.ndarray):
        """``rows`` into ``c.buf`` from row ``c.filled``: inline below
        ``FILL_MIN_BYTES`` or into a narrower wire, else in row ranges of
        ``FILL_RANGE_BYTES`` or more on the copy threads, with at most
        ``FILL_VIDEOS`` videos' copies pending."""
        n = len(rows)
        # a torch buffer's copy casts to a narrower wire on torch's own
        # threads already: a copy thread would only contend with them
        if rows.nbytes < FILL_MIN_BYTES or not isinstance(c.buf, np.ndarray):
            fill(c.buf, slice(c.filled, c.filled + n), rows)
            self.scorer.fill_inline_bytes += rows.nbytes
            return
        pool = _fill_pool()
        step = -(-n // max(1, min(FILL_THREADS, n,
                                  rows.nbytes // FILL_RANGE_BYTES)))
        copies = [pool.submit(_pooled_fill, c.buf,
                              slice(c.filled + a, c.filled + min(a + step, n)),
                              rows[a:a + step])
                  for a in range(0, n, step)]
        c.copies += copies
        self._copies.setdefault(v, []).extend(copies)
        self.scorer.fill_pooled_bytes += rows.nbytes
        while len(self._copies) > FILL_VIDEOS:
            _settle(self._copies.popitem(last=False)[1])

    def _dispatch(self, shape):
        c = self._open[shape]
        self._open[shape] = None
        _settle(c.copies)

        def sink(scores):
            for row, v, i, k in c.targets:
                self.out[v][i:i + k] = scores[row:row + k]

        self._pipe.add(self.scorer.score_tokens_async(c.buf[:c.filled]), sink)

    def finish(self) -> List[np.ndarray]:
        for shape in list(self._open):
            if self._open[shape] is not None:
                self._dispatch(shape)
        self._pipe.drain()
        return self.out


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
        return self.score_videos([feats])[0]

    def score_videos(self, feats_list: List[np.ndarray]) -> List[np.ndarray]:
        """All clips of all videos in chunk-sized batches, streamed: the
        whole test set's clips are never held at once."""
        with _Packer(self.scorer) as packer:
            for f in _read_ahead(feats_list):
                with annotate("scorer.pack"):
                    t = np.ascontiguousarray(f[:, :self.n_patch, :],
                                             dtype=np.float32)
                    del f
                    packer.add(packer.video(len(t)), 0, t)
            return packer.finish()


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
        return self.score_videos([feats])[0]

    def score_videos(self, feats_list: List[np.ndarray]
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Score MANY videos in large cross-video part batches: one copy to
        the device and one encoder call per chunk of up to ``CHUNK`` parts
        of a token length.  Returns [(part_scores, counts)] aligned with
        ``feats_list``."""
        all_counts: List[np.ndarray] = []
        with _Packer(self.scorer) as packer:
            for feats in _read_ahead(feats_list):
                with annotate("scorer.pack"):
                    feats = np.ascontiguousarray(feats[:, :self.n_patch, :],
                                                 dtype=np.float32)
                    n_clips, n_patch, d = feats.shape
                    idx_list, counts = part_slices(n_clips, self.part_len,
                                                   self.tail_rewindow)
                    all_counts.append(counts)
                    v = packer.video(len(idx_list))
                    # parts 0..n_aligned-1 are stride-aligned slices: one
                    # block off a reshape VIEW of the video.  The tail,
                    # re-windowed (full length, unaligned) or short, is one
                    # row of its own.
                    n_aligned = n_clips // self.part_len
                    packer.add(v, 0, feats[:n_aligned * self.part_len]
                               .reshape(n_aligned, self.part_len * n_patch, d))
                    for i in range(n_aligned, len(idx_list)):
                        packer.add(v, i,
                                   feats[idx_list[i]].reshape(1, -1, d))
            return list(zip(packer.finish(), all_counts))


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
        [(part_scores, parts, r)] aligned with items, one device call per
        ``CHUNK`` parts of a token length.  A video's binned array is freed
        before the next loads: the ~1,600 videos of the UCF train split
        stream as the other scorers' do."""
        items = list(items)
        metas = []   # (parts, r) per video — small, kept for the return
        with _Packer(self.scorer) as packer:
            for feats, (_, n) in zip(_read_ahead([f for f, _ in items]),
                                     items):
                with annotate("scorer.pack"):
                    binned, parts, r = self._plan(feats, n)
                    del feats  # the raw video: only ``binned`` stays
                    metas.append((parts, r))
                    v = packer.video(len(parts))
                    for i, (beg, end) in enumerate(parts):
                        packer.add(v, i, binned[beg:end].reshape(
                            1, (end - beg) * self.n_patch, binned.shape[-1]))
            return [(s, parts, r) for s, (parts, r) in zip(packer.finish(),
                                                           metas)]


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
        with _Packer(self.scorer) as packer:
            for feats, (_, n_clips) in zip(
                    _read_ahead([f for f, _ in items]), items):
                with annotate("scorer.pack"):
                    feats = np.ascontiguousarray(feats[:, :self.n_patch, :],
                                                 dtype=np.float32)
                    r = ucf_bin_edges(n_clips, self.max_clips)
                    bin_ids = [i for i in range(self.max_clips)
                               if r[i] != r[i + 1]]
                    plans.append((np.asarray(bin_ids, np.int64), r))
                    v = packer.video(len(bin_ids))
                    for j, i in enumerate(bin_ids):
                        packer.add(v, j,
                                   feats[r[i]:r[i + 1]].mean(axis=0)[None])
                    del feats
            return [(s, bin_ids, r) for s, (bin_ids, r)
                    in zip(packer.finish(), plans)]


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
