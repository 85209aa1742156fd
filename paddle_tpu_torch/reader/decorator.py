"""Reader decorators — same surface as ``paddle.v2.reader`` (reference:
python/paddle/v2/reader/decorator.py).  A *reader creator* is a zero-arg
callable returning an iterable of samples; decorators wrap creators.
"""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading
from typing import Any, Callable, Iterable, List

from paddle_tpu_torch.utils.queues import bounded_put

Reader = Callable[[], Iterable[Any]]


def map_readers(func, *readers: Reader) -> Reader:
    """Apply func element-wise over zipped readers (decorator.py:30)."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader: Reader, buf_size: int, rng=None) -> Reader:
    """Buffered shuffle (decorator.py:60).

    ``rng`` is the shuffling stream (anything with ``.shuffle``, e.g.
    ``random.Random(seed)``); None uses the process-global ``random``
    stream, which ``paddle.init(seed=...)`` seeds — pass an explicit rng
    for order reproducible independent of other global-stream consumers
    (self-lint rule A203)."""
    stream = rng if rng is not None else _random

    def shuffled():
        buf: List[Any] = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                stream.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            stream.shuffle(buf)
            for b in buf:
                yield b

    return shuffled


def chain(*readers: Reader) -> Reader:
    """Concatenate readers (decorator.py:90)."""

    def chained():
        for r in readers:
            for e in r():
                yield e

    return chained


class ComposeNotAligned(ValueError):
    pass


def compose(*readers: Reader, check_alignment: bool = True) -> Reader:
    """Zip readers into flat tuples (decorator.py:118)."""

    def _flatten(item):
        if isinstance(item, tuple):
            return item
        return (item,)

    def composed():
        rs = [r() for r in readers]
        if check_alignment:
            for items in itertools.zip_longest(*rs):
                if any(i is None for i in items):
                    raise ComposeNotAligned(
                        "readers of compose() have different lengths"
                    )
                yield sum((_flatten(i) for i in items), ())
        else:
            for items in zip(*rs):
                yield sum((_flatten(i) for i in items), ())

    return composed


def buffered(reader: Reader, size: int) -> Reader:
    """Background-thread prefetch queue (decorator.py:160) — the host-side
    double-buffering that replaces the reference DataProvider's async load
    thread (paddle/gserver/dataproviders/DataProvider.h DoubleBuffer).

    Teardown contract: abandoning the iteration early (``break``, GC,
    ``.close()`` on the generator) stops and JOINS the fill thread — the
    worker's puts are bounded polls against a stop flag, so it can never
    stay parked forever on a full queue (the leak class the lock
    sanitizer's thread_report drills check for).  A reader that raises on
    the fill thread re-raises on the CONSUMING thread (the DevicePrefetcher
    discipline) instead of silently truncating the stream."""

    class _End:
        pass

    def buffered_reader():
        q: queue.Queue = queue.Queue(maxsize=size)
        stop = threading.Event()
        error: List[BaseException] = []

        def fill():
            try:
                for d in reader():
                    if not bounded_put(q, d, stop.is_set):
                        return
            except BaseException as e:  # re-raised by the consumer
                error.append(e)
            finally:
                bounded_put(q, _End, stop.is_set)

        t = threading.Thread(
            target=fill, name="paddle-buffered-fill", daemon=True
        )
        t.start()
        try:
            while True:
                e = q.get()
                if e is _End:
                    if error:
                        raise error[0]
                    return
                yield e
        finally:
            stop.set()
            while True:  # wake a worker parked on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)

    return buffered_reader


def firstn(reader: Reader, n: int) -> Reader:
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i >= n:
                return
            yield item

    return firstn_reader


def cache(reader: Reader) -> Reader:
    """Materialize once in memory, replay after (the CACHE_PASS_IN_MEM mode of
    PyDataProvider2, reference PyDataProvider2.cpp:69)."""
    holder: List[Any] = []
    done = [False]

    def cached():
        if done[0]:
            for e in holder:
                yield e
            return
        for e in reader():
            holder.append(e)
            yield e
        done[0] = True

    return cached


def xmap_readers(mapper, reader: Reader, process_num: int, buffer_size: int, order: bool = False) -> Reader:
    """Parallel map over a thread pool (decorator.py:230).

    Same teardown contract as :func:`buffered`: a consumer that abandons
    the loop early stops, wakes, and joins the feed + worker threads —
    every queue op in the pool is a bounded poll against the stop flag.
    A mapper (or source reader) that raises re-raises on the CONSUMING
    thread: the dying thread still delivers its end sentinel, so the
    consumer drains, learns the error, and tears the pool down instead of
    blocking forever on a stream that will never finish."""

    class _End:
        pass

    def xreader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)
        stop = threading.Event()
        errors: List[BaseException] = []

        def _get(q: queue.Queue):
            while not stop.is_set():
                try:
                    return q.get(timeout=0.1)
                except queue.Empty:
                    continue
            return _End

        def feed():
            try:
                for i, sample in enumerate(reader()):
                    if not bounded_put(in_q, (i, sample), stop.is_set):
                        return
            except BaseException as e:  # surfaced by the consumer
                errors.append(e)
            finally:
                # always hand every worker its sentinel — a dead feed must
                # not strand the pool waiting on in_q
                for _ in range(process_num):
                    if not bounded_put(in_q, _End, stop.is_set):
                        return

        def work():
            try:
                while True:
                    item = _get(in_q)
                    if item is _End:
                        return
                    i, sample = item
                    if not bounded_put(out_q, (i, mapper(sample)),
                                       stop.is_set):
                        return
            except BaseException as e:  # surfaced by the consumer
                errors.append(e)
            finally:
                bounded_put(out_q, _End, stop.is_set)

        threads = [threading.Thread(
            target=feed, name="paddle-xmap-feed", daemon=True
        )]
        threads.extend(
            threading.Thread(
                target=work, name=f"paddle-xmap-work-{n}", daemon=True
            )
            for n in range(process_num)
        )
        for t in threads:
            t.start()

        try:
            finished = 0
            pending = {}
            next_i = 0
            while finished < process_num:
                item = out_q.get()
                if item is _End:
                    finished += 1
                    continue
                if not order:
                    yield item[1]
                else:
                    pending[item[0]] = item[1]
                    while next_i in pending:
                        yield pending.pop(next_i)
                        next_i += 1
            if errors:
                raise errors[0]
            if order:
                for i in sorted(pending):
                    yield pending[i]
        finally:
            stop.set()
            for q in (in_q, out_q):
                while True:  # wake workers parked on full queues
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
            for t in threads:
                t.join(timeout=5.0)

    return xreader
