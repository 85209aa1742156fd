"""Reader creators (reference: python/paddle/v2/reader/creator.py) — build
readers from arrays, text files and local recordio shards; a copy of the
JAX package's ``reader/creator.py``.  ``cloud_reader`` needs the elastic
master plane, which the port has not taken over yet, and raises.
"""

from __future__ import annotations

import glob as _glob
import pickle
from typing import Sequence


def np_array(x):
    """A reader yielding the rows of a numpy array (reference creator.np_array)."""

    def reader():
        yield from x

    return reader


def text_file(path: str):
    """A reader yielding stripped lines of a text file (reference
    creator.text_file)."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def _expand(paths: Sequence[str]):
    if isinstance(paths, str):
        paths = [paths]
    out = []
    for p in paths:
        hits = sorted(_glob.glob(p))
        out.extend(hits if hits else [p])
    return out


def recordio_local(paths, buf_size: int = 100, pickled: bool = True):
    """A reader over local recordio shard files (glob patterns supported) —
    reference creator.recordio_local.  ``pickled=True`` unpickles each
    record (the dataset.common.convert format); False yields raw bytes."""
    from paddle_tpu_torch.io import recordio
    from paddle_tpu_torch.reader.decorator import buffered

    def reader():
        for path in _expand(paths):
            with recordio.Reader(path) as r:
                while True:
                    rec = r.next()
                    if rec is None:
                        break
                    yield pickle.loads(rec) if pickled else rec  # wire: allow[A206] operator-written recordio dataset (common.convert pickled these samples to local disk); v2 reader-API parity, never a network peer's bytes

    return buffered(reader, buf_size)


def cloud_reader(paths, master, buf_size: int = 64, pickled: bool = True):
    """A reader that leases tasks from the elastic master (reference
    creator.cloud_reader over the Go master client, creator.py:87).

    ``master`` is a ``paddle_tpu_torch.master.Service`` (in-process) or a
    ``(host, port)`` address of a ``master.Server`` (of either package: the
    wire is shared).  The shard set is registered once; each reader pass
    drains the master's task queue with consume-then-ack leases, so
    concurrent trainers split the shards and a crashed trainer's tasks
    re-serve."""
    from paddle_tpu_torch.master import Client
    from paddle_tpu_torch.reader.decorator import buffered

    client = Client(master)
    client.set_dataset(_expand(paths))

    def reader():
        while True:
            rec = client.next_record()
            if rec is None:
                return
            yield pickle.loads(rec) if pickled else rec  # wire: allow[A206] records are the operator's own common.convert output streamed back opaquely by the master; the RPC envelope around them rides the safe codec

    return buffered(reader, buf_size)
