"""Batching and background prefetch — PyTorch counterpart of
lstc_vad_tpu/data/pipeline.py:27-141.

The reference feeds its train step through torch DataLoader worker processes
(Train/spatio_transformer_shanghaitech.py:45).  Here a host thread (a
``BatchWorker``) builds the next batch (store reads + snippet sampling)
while the card runs the current step.  ``Prefetcher`` runs one worker over
one iterable.  ``EpochPrefetcher``, the Trainer's, keeps one worker across
epochs and has it build each next epoch while the current one's steps run:
at the end of an epoch's draws the worker applies the epoch's reshuffle to
its own copy of the sampling state (``PairedTrainDataset.fork``) and draws
the next epoch from it, in the order of draws of a plain loop (build,
shuffle, build).  The prepared epoch is used only if the caller's dataset
still draws like that copy when the epoch begins (``draws_like``), so the
batches are those of a plain loop, bit for bit.
On the card the thread copies each batch into pinned host tensors and
from there to the device with non-blocking copies on a side CUDA stream; the
consumer's stream waits on the copy's event, and each tensor is marked as used
on that stream (``record_stream``) so that the caching allocator does not
hand its memory out while the step still reads it.  On the CPU the batch
comes out as CPU tensors.

Batch layout matches the reference collation: four stacked arrays
(norm_feats [B, pn*pl, n_patch, d], norm_labs [B, pn*pl], abnorm_feats,
abnorm_labs); iteration order is sequential over the per-epoch permutation
(torch's default sampler), with drop_last=True.  With a ``feature_dtype``
(``data.transfer_dtype="bfloat16"``) the two feature arrays are cast on the
host, rounded to nearest even as numpy's ml_dtypes cast does in the JAX
package, so the pinned buffers and the copy to the card carry half the
bytes; the labels keep their type.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
import weakref
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import annotate

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


class BatchIterator:
    """Sequential fixed-size batches over a PairedTrainDataset epoch."""

    def __init__(self, dataset, batch_size: int, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        n = len(self.dataset)
        end = n - n % self.batch_size if self.drop_last else n
        get_batch = getattr(self.dataset, "get_batch", None)
        for start in range(0, end, self.batch_size):
            stop = min(start + self.batch_size, n)
            if get_batch is not None:
                # the whole-batch gather (a PackedStore), when the dataset
                # can take it; None means build the batch per item
                batch = get_batch(start, stop)
                if batch is not None:
                    yield batch
                    continue
            items = [self.dataset[i] for i in range(start, stop)]
            yield tuple(np.stack([it[j] for it in items]) for j in range(4))


class _Shared:
    """What the worker thread and its owner share: never the owner itself,
    so dropping the owner ends the thread (``BatchWorker``'s finalizer)."""

    def __init__(self, device: torch.device, depth: int, mesh):
        self.device = device
        self.mesh = mesh
        self.stream = (torch.cuda.Stream(device=device)
                       if device.type == "cuda" else None)
        self.jobs: "queue.Queue" = queue.Queue()
        self.items: "queue.Queue" = queue.Queue()
        self.room = threading.Semaphore(depth)  # staged batches not taken
        self.stop = threading.Event()


def _stage(shared: _Shared, batch, feature_dtype: torch.dtype):
    """Runs in the worker thread: (tensors, copy event or None)."""
    with annotate("batch.stage"):
        if shared.mesh is not None:
            from ..parallel.multihost import to_global

            batch = to_global(batch, shared.mesh)
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
        dtypes = [feature_dtype if i in (0, 2) else h.dtype
                  for i, h in enumerate(host)]
        if shared.stream is None:
            return tuple(h.to(dt) for h, dt in zip(host, dtypes)), None
        pinned = []
        for h, dt in zip(host, dtypes):
            p = torch.empty(h.shape, dtype=dt, pin_memory=True)
            p.copy_(h)  # the cast, if any, in the same pass
            pinned.append(p)
        with torch.cuda.stream(shared.stream):
            out = tuple(p.to(shared.device, non_blocking=True)
                        for p in pinned)
            ready = torch.cuda.Event()
            ready.record(shared.stream)
        return out, ready


_END = object()


def _work(shared: _Shared):
    """The worker thread: each job's batches built, staged and queued in
    turn, then the job's end with what its ``finish`` returns."""
    try:
        while True:
            job = shared.jobs.get()
            if job is None or shared.stop.is_set():
                return
            batches, feature_dtype, finish = job
            batches = iter(batches)
            while True:
                with annotate("batch.build"):
                    batch = next(batches, _END)
                if batch is _END:
                    break
                if shared.stop.is_set():
                    return  # the owner went away: stop cleanly
                built_at = time.perf_counter()
                staged = _stage(shared, batch, feature_dtype)
                while not shared.room.acquire(timeout=0.1):
                    if shared.stop.is_set():
                        return
                shared.items.put(("batch", staged, built_at))
            shared.items.put(("end", finish() if finish else None, None))
    except BaseException as e:  # propagate to the consumer
        shared.items.put(("error", e, None))


def _close(shared: _Shared, thread: threading.Thread) -> int:
    """Stop the worker, wait for it (unless called on its own thread, by
    the garbage collector) and drop what it staged: the number of batches
    dropped."""
    shared.stop.set()
    shared.jobs.put(None)
    if thread is not threading.current_thread():
        thread.join()
    dropped = 0
    while True:
        try:
            kind, _, _ = shared.items.get_nowait()
        except queue.Empty:
            return dropped
        dropped += kind == "batch"


class BatchWorker:
    """One daemon thread that builds and stages the batches of the jobs it
    is given, one job after another, and at most ``depth`` staged batches
    ahead of the consumer.  One thread, so its builds never read a store
    side by side with each other; other readers may (``Trainer.fit``'s
    evaluation of the train split runs beside the next epoch's build),
    which both stores allow: the HDF5 one reads under a lock, the pack is
    a read-only map.  ``close`` (also run when the worker is dropped)
    ends the thread, after the batch it is building, and frees what it
    staged."""

    def __init__(self, device: torch.device, depth: int = 2, mesh=None):
        """``mesh``: every process builds the whole batch and copies only
        its rows of the features (parallel/multihost.py::to_global)."""
        with annotate("batch.start"):
            self._shared = _Shared(torch.device(device), depth, mesh)
            thread = threading.Thread(target=_work, args=(self._shared,),
                                      daemon=True)
            thread.start()
        self._close = weakref.finalize(self, _close, self._shared, thread)
        self._close.atexit = False  # a daemon thread ends with the process

    def submit(self, batches, feature_dtype: torch.dtype = torch.float32,
               finish=None):
        """Queue a job: every batch of the iterable ``batches`` (built in
        the worker thread), then the job's end, which hands the consumer
        ``finish()``, also called in the worker thread.  Batch elements 0
        and 2 (the features) travel and arrive as ``feature_dtype``."""
        self._shared.jobs.put((batches, feature_dtype, finish))

    def get(self):
        """The current job's next batch as ``(tensors, built_at)``, the
        tensors ready for the consumer's stream and ``built_at`` the
        ``time.perf_counter()`` at which its build ended; at the job's end
        ``(None, what finish returned)``.  Raises the worker's error."""
        shared = self._shared
        with annotate("batch.wait"):
            kind, value, built_at = shared.items.get()
        if kind == "error":
            raise value
        if kind == "end":
            return None, value
        shared.room.release()
        batch, ready = value
        if ready is not None:
            stream = torch.cuda.current_stream(shared.device)
            stream.wait_event(ready)
            for tensor in batch:
                tensor.record_stream(stream)
        return batch, built_at

    def close(self) -> int:
        """End the thread and drop the staged batches; returns how many
        (0 once closed)."""
        return self._close() or 0


class Prefetcher:
    """Wraps a batch iterable; a ``BatchWorker`` stays ``depth`` batches
    ahead and hands out tuples of tensors on ``device``."""

    def __init__(self, iterable, device: torch.device, depth: int = 2,
                 feature_dtype: torch.dtype = torch.float32, mesh=None):
        """``feature_dtype``: the type batch elements 0 and 2 (the features)
        travel and arrive in.  ``mesh``: as ``BatchWorker``'s."""
        self.iterable = iterable
        self.device = torch.device(device)
        self.depth = depth
        self.feature_dtype = feature_dtype
        self.mesh = mesh

    def __iter__(self):
        worker = BatchWorker(self.device, self.depth, self.mesh)
        try:
            worker.submit(self.iterable, self.feature_dtype)
            while True:
                batch, _ = worker.get()
                if batch is None:
                    return
                yield batch
        finally:
            # consumer exited early (exception in the train step, interrupt):
            # release the worker and drop any staged batches so the thread
            # and its device buffers don't leak
            worker.close()


class _Prepared(NamedTuple):
    """The epoch the worker builds ahead: what it was asked for, a fork of
    its sampling state to check the caller's dataset against, and the
    worker's own copy that the epoch is drawn from."""
    plan: tuple  # (dataset, batch_size, feature_dtype)
    fork: object
    shadow: object


def _epoch_end(shadow):
    """Runs in the worker thread at the end of an epoch's draws: the
    generator's state after them, then the epoch's reshuffle applied to
    ``shadow`` and a fork of what the next epoch draws from."""
    after = shadow.rng.bit_generator.state
    shadow.shuffle_keys()
    return after, shadow.fork()


class EpochPrefetcher:
    """A ``PairedTrainDataset``'s epochs through one ``BatchWorker`` that
    outlives them: while an epoch's steps run, the worker builds the next
    epoch on its own fork of the sampling state, reshuffled as the caller
    will reshuffle the dataset after the epoch.

    ``epoch`` yields one epoch's batches.  When it ends, the dataset's
    generator holds what it would after the epoch's draws; the caller
    then calls ``dataset.shuffle_keys()`` as in a plain loop.  The next
    ``epoch`` takes the prepared batches only if the same dataset, batch
    size and feature type come back and the dataset still draws like the
    fork (``draws_like``); otherwise it drops them, restarts the worker and
    builds the epoch from the dataset as it is.  ``ahead``: the last
    epoch's batches built before it began; ``discarded``: prepared batches
    dropped at its start."""

    def __init__(self, device: torch.device, mesh=None):
        self.device = torch.device(device)
        self.mesh = mesh
        self._worker: Optional[BatchWorker] = None
        self._next: Optional[_Prepared] = None
        self.ahead = self.discarded = 0

    def epoch(self, dataset, batch_size: int,
              feature_dtype: torch.dtype = torch.float32
              ) -> Iterator[Tuple[torch.Tensor, ...]]:
        began = time.perf_counter()
        plan = (dataset, batch_size, feature_dtype)
        self.ahead = self.discarded = 0
        prepared, self._next = self._next, None
        if self._worker is not None and not (
                prepared is not None and prepared.plan == plan
                and dataset.draws_like(prepared.fork)):
            # also after an epoch that did not end: its rest is queued
            with annotate("batch.discard"):
                self.discarded = self.close()
            prepared = None
        if self._worker is None:
            self._worker = BatchWorker(self.device, mesh=self.mesh)
        worker = self._worker
        if prepared is None:
            shadow = dataset.fork()
            worker.submit(BatchIterator(shadow, batch_size), feature_dtype,
                          functools.partial(_epoch_end, shadow))
        else:
            shadow = prepared.shadow
        # the next epoch, built while this one's steps run
        worker.submit(BatchIterator(shadow, batch_size), feature_dtype,
                      functools.partial(_epoch_end, shadow))
        done = False
        try:
            while True:
                batch, value = worker.get()
                if batch is None:
                    break
                self.ahead += value < began
                yield batch
            done = True
        finally:
            if not done and self._worker is worker:
                self.close()  # the consumer left, or the worker failed
        after, fork = value
        dataset.rng.bit_generator.state = after
        self._next = _Prepared(plan, fork, shadow)

    def close(self) -> int:
        """End the worker and drop what it prepared; returns the number of
        staged batches dropped.  The next ``epoch`` starts a new one."""
        worker, self._worker, self._next = self._worker, None, None
        return worker.close() if worker is not None else 0
