"""Batching and background prefetch — PyTorch counterpart of
lstc_vad_tpu/data/pipeline.py:27-141.

The reference feeds its train step through torch DataLoader worker processes
(Train/spatio_transformer_shanghaitech.py:45).  Here a host thread builds the
next batch (store reads + snippet sampling) while the card runs the current
step.  On the card the thread copies each batch into pinned host tensors and
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

import queue
import threading
from typing import Iterator, Tuple

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


class Prefetcher:
    """Wraps a batch iterable; a daemon thread stays ``depth`` batches ahead
    and hands out tuples of tensors on ``device``."""

    _SENTINEL = object()

    def __init__(self, iterable, device: torch.device, depth: int = 2,
                 feature_dtype: torch.dtype = torch.float32, mesh=None):
        """``feature_dtype``: the type batch elements 0 and 2 (the features)
        travel and arrive in.  ``mesh``: every process builds the whole
        batch and copies only its rows of the features
        (parallel/multihost.py::to_global)."""
        self.iterable = iterable
        self.device = torch.device(device)
        self.depth = depth
        self.feature_dtype = feature_dtype
        self.mesh = mesh

    def _put(self, batch):
        """Runs in the worker thread: (tensors, copy event or None)."""
        with annotate("batch.stage"):
            if self.mesh is not None:
                from ..parallel.multihost import to_global

                batch = to_global(batch, self.mesh)
            host = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
            dtypes = [self.feature_dtype if i in (0, 2) else h.dtype
                      for i, h in enumerate(host)]
            if self.device.type != "cuda":
                return tuple(h.to(dt) for h, dt in zip(host, dtypes)), None
            pinned = []
            for h, dt in zip(host, dtypes):
                p = torch.empty(h.shape, dtype=dt, pin_memory=True)
                p.copy_(h)  # the cast, if any, in the same pass
                pinned.append(p)
            with torch.cuda.stream(self._stream):
                out = tuple(p.to(self.device, non_blocking=True)
                            for p in pinned)
                ready = torch.cuda.Event()
                ready.record(self._stream)
            return out, ready

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        err: list = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                batches = iter(self.iterable)
                while True:
                    with annotate("batch.build"):
                        batch = next(batches, self._SENTINEL)
                    if batch is self._SENTINEL:
                        break
                    if not put(self._put(batch)):
                        return  # consumer went away: stop cleanly
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                put(self._SENTINEL)

        with annotate("batch.start"):
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(device=self.device)
            t = threading.Thread(target=worker, daemon=True)
            t.start()
        try:
            while True:
                with annotate("batch.wait"):
                    item = q.get()
                if item is self._SENTINEL:
                    if err:
                        raise err[0]
                    return
                batch, ready = item
                if ready is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    for tensor in batch:
                        tensor.record_stream(stream)
                yield batch
        finally:
            # consumer exited early (exception in the train step, interrupt):
            # release the worker and drop any staged batches so the thread
            # and its device buffers don't leak
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)
