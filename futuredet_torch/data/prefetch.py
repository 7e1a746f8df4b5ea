"""Background batch prefetching.

The port's copy of `futuredet_tpu/data/prefetch.py`, the counterpart of
the reference's torch DataLoader workers
(`det3d/datasets/loader/build_loader.py:25`): one thread builds the
upcoming batches (file IO and packing in the C++ sweep loader, which runs
without the GIL) while the card computes the current one. At most `depth`
finished batches wait in the queue; an error raised in the thread reaches
the consumer at the batch where it arose.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional


class PrefetchIterator:
    """Wrap a batch iterator; keep `depth` batches materialized ahead.
    `close()` stops the thread after the batch it is building."""

    def __init__(self, it: Iterator, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _pump(self):
        try:
            for item in self._it:
                if not self._put(item):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            self._q.put(self._done)     # later calls end the same way
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join()


def prefetch(it: Iterator, depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(it, depth)
