"""Asynchronous feeding: a background thread and a bounded queue — the
counterpart of ``paddle_tpu/reader/prefetch.py``.

The reference's ``DataProvider`` keeps a double buffer, so the next batch
is converted and staged while the trainer computes (DataProvider.h
DoubleBuffer, PyDataProvider2.cpp's load thread).  ``DevicePrefetcher``
runs the host side of the feed (the converters, the pinned copy and the
issue of the host-to-device copies, ``DataFeeder.stage``) on a worker
thread, so batch N+1's copy overlaps step N's compute.  A batch staged on
the card carries the CUDA event its copies recorded; the consumer's stream
waits on it (``DataFeeder.consume``).

Queue depth 2 is the reference's double buffer: one batch in use, one
staged.  A failure on the worker (the reader, a converter, a CUDA error, a
failed pin) is raised again on the consuming thread, never swallowed.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

__all__ = ["DevicePrefetcher", "prefetch"]


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


class DevicePrefetcher:
    """Iterate ``prepare(item)`` for each item of ``source``, the prepare
    calls running ahead on a background thread; the batches come out in
    order.  ``wait_s`` sums the consumer's time blocked on the queue: about 0
    when feeding hides behind compute, large when the reader or the copy
    is the bottleneck."""

    def __init__(self, source: Iterable, prepare: Optional[Callable] = None, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._prepare = prepare if prepare is not None else (lambda x: x)
        self._source = source
        self._stop = threading.Event()
        self._terminal = None  # sticky: _DONE or a _Failure once seen
        self.wait_s = 0.0
        self._thread = threading.Thread(target=self._run, name="paddle-feed", daemon=True)
        self._thread.start()

    # -- worker ----------------------------------------------------------
    def _put(self, item) -> bool:
        """A bounded put that stays responsive to close(); False when
        stopping."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for item in self._source:
                if self._stop.is_set() or not self._put(self._prepare(item)):
                    return
        except BaseException as e:  # raised again on the consuming thread
            self._put(_Failure(e))
        else:
            self._put(_DONE)

    # -- consumer --------------------------------------------------------
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        # terminal states are sticky: the worker is gone, so a consumer that
        # calls next() again keeps getting StopIteration or the error
        # instead of blocking forever
        if self._terminal is not None:
            if self._terminal is _DONE:
                raise StopIteration
            raise self._terminal.exc
        t0 = time.perf_counter()
        got = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if got is _DONE:
            self._terminal = got
            raise StopIteration
        if isinstance(got, _Failure):
            self._terminal = got
            raise got.exc
        return got

    def close(self) -> None:
        """Stop the worker (an early exit of the loop); safe to repeat."""
        self._stop.set()
        while True:  # unblock a worker stuck in put()
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch(source: Iterable, prepare: Optional[Callable] = None, depth: int = 2):
    """A generator over a DevicePrefetcher that stops the worker even when
    the consumer leaves the loop early."""
    pf = DevicePrefetcher(source, prepare, depth)
    try:
        for item in pf:
            yield item
    finally:
        pf.close()
