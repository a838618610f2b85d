"""Host-to-device prefetching (port of ``rnntransducer_tpu/data/prefetch.py``).

``ordered_readahead`` runs a batch's row fetches on a small thread pool
ahead of the consumer; ``DevicePrefetcher`` moves collated host batches to
the device on a background thread while the current step runs.  On a CUDA
device every batch is pinned and copied with ``non_blocking=True`` on a side
stream, an event is recorded there, and the consumer's stream waits on that
event before the batch is handed out, so copies overlap compute and a step
never reads a batch before it has landed.  While a profiler records, the
consumer's wait is the span ``data/prefetch_wait``, and the counters
``data/batches`` and ``data/prefetch_empty`` count the batches handed out
and the fetches that found the queue empty (``utils/profiling``).
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch

from rnntransducer_tpu_torch.utils import profiling


def ordered_readahead(thunks: Iterable[Callable], workers: int = 2,
                      depth: int = 4) -> Iterator:
    """Run ``thunks`` (zero-argument callables) on a pool of ``workers``
    threads with at most ``depth`` in flight, yielding their results in
    submission order.  Arrow reads release the GIL, so upcoming batches'
    page faults overlap the current batch's collation.  A thunk's exception
    surfaces at its own position.  ``workers <= 1`` runs them serially, with
    no pool."""
    if workers <= 1:
        for t in thunks:
            yield t()
        return
    it = iter(thunks)
    pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="readahead")
    pending: collections.deque = collections.deque()
    try:
        for t in it:
            pending.append(pool.submit(t))
            if len(pending) >= depth:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        # cancel anything still queued; running fetches finish harmlessly
        for f in pending:
            f.cancel()
        pool.shutdown(wait=False)


def to_device(batch: Mapping[str, np.ndarray], device, non_blocking: bool = False
              ) -> dict:
    """A host batch (name -> numpy array) as tensors on ``device``; pinned
    first where the copy is to a CUDA device and ``non_blocking``."""
    device = torch.device(device)
    pin = non_blocking and device.type == "cuda"
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if pin:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=non_blocking)
    return out


class DevicePrefetcher:
    """Wraps a host batch iterator and yields device-resident batches, at
    most ``size`` of them queued ahead of the consumer.  ``close()``
    releases the worker and every queued batch; call it when abandoning the
    iterator early."""

    _SENTINEL = object()

    def __init__(self, host_iter: Iterator, device="cuda", size: int = 2):
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=size)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, args=(host_iter,),
                                        daemon=True)
        self._thread.start()

    def _copy(self, batch):
        if not self._cuda:
            return to_device(batch, self._device), None
        with torch.cuda.stream(self._stream):
            out = to_device(batch, self._device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _qput(self, item) -> bool:
        """A put that close() can interrupt: a worker blocked for ever in
        Queue.put would keep its queued batches alive."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, host_iter):
        try:
            for batch in host_iter:
                if self._stop.is_set() or not self._qput(self._copy(batch)):
                    return
        except BaseException as e:  # raised again on the consumer's side
            self._err = e
        finally:
            self._qput(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        with profiling.annotate("data/prefetch_wait"):
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                profiling.count("data/prefetch_empty")
                item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for t in batch.values():
                # the side stream's allocation is now used on this stream
                t.record_stream(stream)
        profiling.count("data/batches")
        return batch

    def close(self) -> None:
        """Release the worker and every queued batch."""
        self._stop.set()
        for _ in range(2):  # drain; once more after the thread exits
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
