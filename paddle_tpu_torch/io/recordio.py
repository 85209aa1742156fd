"""recordio: chunked record files + native background prefetch.

The format mirrors the role of the reference's Go recordio (reference:
go/master/service.go:105 partitions datasets by recordio chunk) and the C++
DataProvider's async double-buffer (reference:
paddle/gserver/dataproviders/DataProvider.h):

    chunk := magic:u32 | crc32(body):u32 | body_len:u32 | n_records:u32 | body
    body  := len_i:u32 × n | payload_i × n          (little-endian)

Two interchangeable backends over the same bytes-on-disk: the C++ library
(native/recordio.cc of this package, built on demand with g++ into _build/,
or taken from the build store under the ``aot_cache_dir`` flag,
core/aot_cache.py; threads + ring buffer) and a
pure-Python fallback.  `Prefetcher` always exists; it is native when possible.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import struct
import subprocess
import threading
import time
import queue as _queue
import zlib
from typing import Iterable, List, Optional, Sequence

from paddle_tpu_torch.core import aot_cache as _aot

_MAGIC = 0x7061646C

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# native source ships inside the package (native/) so installed wheels can
# build it too; the library goes to the package's _build/
_SRC = os.path.join(_PKG_ROOT, "native", "recordio.cc")
_BUILD_DIR = os.path.join(_PKG_ROOT, "_build")
_SO = os.path.join(_BUILD_DIR, "libpaddle_tpu_torch_io.so")
_GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lib_tried = False
from paddle_tpu_torch.utils.queues import bounded_put as _bounded_put

# a plain lock: the JAX package's instrumented lock factory belongs to its
# lock-sanitizer tooling, which the port has not taken over yet
_lib_lock = threading.Lock()


def _load_native():
    global _lib, _lib_tried
    with _lib_lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        try:
            # built in _build/ (rebuilt when older than its source), or from
            # the build store under the aot_cache_dir flag (core/aot_cache.py)
            path = _aot.host_library(_SRC, _SO, _GXX_FLAGS)
            if path is None:
                return None  # neither a prebuilt .so nor source to build
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError, FileNotFoundError):
            return None
        lib.rio_writer_create.restype = ctypes.c_void_p
        lib.rio_writer_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32]
        lib.rio_writer_write.restype = ctypes.c_int
        lib.rio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        lib.rio_writer_close.restype = ctypes.c_int
        lib.rio_writer_close.argtypes = [ctypes.c_void_p]
        lib.rio_reader_open.restype = ctypes.c_void_p
        lib.rio_reader_open.argtypes = [ctypes.c_char_p]
        lib.rio_reader_seek.restype = ctypes.c_int
        lib.rio_reader_seek.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rio_reader_next.restype = ctypes.c_int64
        lib.rio_reader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.rio_reader_close.restype = None
        lib.rio_reader_close.argtypes = [ctypes.c_void_p]
        lib.rio_scan_chunks.restype = ctypes.c_int64
        lib.rio_scan_chunks.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64,
        ]
        lib.rio_prefetcher_create.restype = ctypes.c_void_p
        lib.rio_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.rio_prefetcher_next.restype = ctypes.c_int64
        lib.rio_prefetcher_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ]
        lib.rio_prefetcher_destroy.restype = None
        lib.rio_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_native() is not None


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One chunk's location inside a recordio file — the master's task unit."""

    path: str
    offset: int
    n_records: int


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class Writer:
    """Append records (bytes) to a recordio file."""

    def __init__(self, path: str, max_chunk_records: int = 1000,
                 max_chunk_bytes: int = 1 << 20):
        self._path = path
        self._lib = _load_native()
        if self._lib is not None:
            self._h = self._lib.rio_writer_create(
                path.encode(), max_chunk_records, max_chunk_bytes
            )
            if not self._h:
                raise IOError(f"cannot open {path} for writing")
        else:
            self._f = open(path, "wb")
            self._pending: List[bytes] = []
            self._pending_bytes = 0
            self._max_records = max_chunk_records
            self._max_bytes = max_chunk_bytes

    def write(self, record: bytes) -> None:
        if self._lib is not None:
            rc = self._lib.rio_writer_write(self._h, record, len(record))
            if rc != 0:
                raise IOError(f"write failed on {self._path}")
            return
        self._pending.append(bytes(record))
        self._pending_bytes += len(record)
        if (len(self._pending) >= self._max_records
                or self._pending_bytes >= self._max_bytes):
            self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        body = b"".join(
            [struct.pack("<I", len(r)) for r in self._pending] + self._pending
        )
        self._f.write(struct.pack("<IIII", _MAGIC, zlib.crc32(body),
                                  len(body), len(self._pending)))
        self._f.write(body)
        self._pending = []
        self._pending_bytes = 0

    def close(self) -> None:
        if self._lib is not None:
            if self._lib.rio_writer_close(self._h) != 0:
                raise IOError(f"close failed on {self._path}")
            return
        self._flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class Reader:
    """Iterate records of one file, optionally from a chunk offset."""

    def __init__(self, path: str, offset: int = 0):
        self._path = path
        self._lib = _load_native()
        if self._lib is not None:
            self._h = self._lib.rio_reader_open(path.encode())
            if not self._h:
                raise IOError(f"cannot open {path}")
            if offset:
                if self._lib.rio_reader_seek(self._h, offset) != 0:
                    self._lib.rio_reader_close(self._h)
                    raise IOError(f"{path}: cannot seek to offset {offset}")
        else:
            self._f = open(path, "rb")
            if offset:
                self._f.seek(offset)
            self._records: List[bytes] = []

    def _load_chunk_py(self) -> bool:
        head = self._f.read(16)
        if len(head) < 16:
            return False
        magic, crc, body_len, n = struct.unpack("<IIII", head)
        if magic != _MAGIC:
            raise IOError(f"{self._path}: bad chunk magic {magic:#x}")
        # Header fields are outside the CRC (it covers the body only), so a
        # crafted n or record length must surface as a corrupt chunk, not an
        # out-of-bounds slice or struct.error.
        if 4 * n > body_len:
            raise IOError(f"{self._path}: corrupt chunk")
        body = self._f.read(body_len)
        if len(body) != body_len or zlib.crc32(body) != crc:
            raise IOError(f"{self._path}: corrupt chunk")
        lens = struct.unpack(f"<{n}I", body[: 4 * n])
        off = 4 * n
        for ln in lens:
            if ln > body_len - off:
                self._records.clear()
                raise IOError(f"{self._path}: corrupt chunk")
            self._records.append(body[off : off + ln])
            off += ln
        return True

    def next(self) -> Optional[bytes]:
        if self._lib is not None:
            out = ctypes.POINTER(ctypes.c_uint8)()
            ln = self._lib.rio_reader_next(self._h, ctypes.byref(out))
            if ln == -1:
                return None
            if ln == -2:
                raise IOError(f"{self._path}: corrupt chunk")
            return ctypes.string_at(out, ln)
        while not self._records:
            if not self._load_chunk_py():
                return None
        return self._records.pop(0)

    def __iter__(self):
        while True:
            r = self.next()
            if r is None:
                return
            yield r

    def close(self) -> None:
        if self._lib is not None:
            self._lib.rio_reader_close(self._h)
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def scan_chunks(path: str) -> List[Chunk]:
    """Chunk index of a file — what the master partitions into tasks.
    Always returns every chunk (both backends)."""
    lib = _load_native()
    if lib is not None:
        # modest initial guess; rio_scan_chunks reports the true count when
        # undersized and the loop rescans with the exact size
        cap = 1 << 16
        while True:
            offsets = (ctypes.c_uint64 * cap)()
            counts = (ctypes.c_uint32 * cap)()
            n = lib.rio_scan_chunks(path.encode(), offsets, counts, cap)
            if n < 0:
                raise IOError(f"{path}: malformed recordio file")
            if n <= cap:
                return [
                    Chunk(path, int(offsets[i]), int(counts[i]))
                    for i in range(n)
                ]
            cap = n  # undersized — rescan with the exact size
    chunks = []
    fsize = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while True:
            head = f.read(16)
            if len(head) < 16:
                break
            magic, _, body_len, n = struct.unpack("<IIII", head)
            if magic != _MAGIC or 4 * n > body_len or pos + 16 + body_len > fsize:
                raise IOError(f"{path}: malformed recordio file")
            chunks.append(Chunk(path, pos, n))
            pos += 16 + body_len
            f.seek(pos)
    return chunks


# ---------------------------------------------------------------------------
# Prefetcher
# ---------------------------------------------------------------------------

class Prefetcher:
    """Background prefetch over many files (native threads when available,
    Python threads otherwise) — the DataProvider double-buffer generalized."""

    def __init__(self, paths: Sequence[str], n_threads: int = 2, capacity: int = 1024):
        self._lib = _load_native()
        self._paths = list(paths)
        # Guards the native (pointer, copy) pair: the C side reuses one
        # internal record buffer per prefetcher, so the pointer must be
        # copied out before another consumer can advance it.
        self._next_lock = threading.Lock()
        self._worker_error: Optional[BaseException] = None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self._paths))(
                *[p.encode() for p in self._paths]
            )
            self._h = self._lib.rio_prefetcher_create(
                arr, len(self._paths), n_threads, capacity
            )
        else:
            self._q: _queue.Queue = _queue.Queue(maxsize=capacity)
            self._stopped = False
            self._n_workers = max(1, min(n_threads, len(self._paths)))
            per = (len(self._paths) + self._n_workers - 1) // self._n_workers
            self._done = 0
            self._done_lock = threading.Lock()
            self._threads: List[threading.Thread] = []
            for t in range(self._n_workers):
                part = self._paths[t * per : (t + 1) * per]
                th = threading.Thread(
                    target=self._worker, args=(part,),
                    name=f"paddle-recordio-prefetch-{t}", daemon=True,
                )
                self._threads.append(th)
                th.start()

    def _worker(self, paths):
        stopped = lambda: self._stopped  # noqa: E731 — the shared teardown contract
        try:
            for p in paths:
                with Reader(p) as r:
                    for rec in r:
                        # bounded put that notices close(): don't block
                        # forever (leaking the thread + fd) when the
                        # consumer stops early
                        if not _bounded_put(self._q, rec, stopped):
                            return
        except BaseException as exc:  # surfaced to the consumer in next()
            self._worker_error = exc
        finally:
            with self._done_lock:
                self._done += 1
                last = self._done == self._n_workers
            if last:
                # the sentinel must reach a live consumer even if the queue
                # is momentarily full; only a close() may drop it
                _bounded_put(self._q, None, stopped)

    def next(self) -> Optional[bytes]:
        if self._lib is not None:
            with self._next_lock:
                out = ctypes.POINTER(ctypes.c_uint8)()
                ln = self._lib.rio_prefetcher_next(self._h, ctypes.byref(out))
                if ln == -2:
                    raise IOError(
                        "prefetcher: unreadable or corrupt recordio input"
                    )
                if ln < 0:
                    return None
                return ctypes.string_at(out, ln)
        item = self._q.get()
        if item is None:
            self._q.put(None)  # keep the sentinel for other consumers
            if self._worker_error is not None:
                raise IOError(
                    f"prefetcher worker failed: {self._worker_error!r}"
                ) from self._worker_error
            return None
        return item

    def __iter__(self):
        while True:
            r = self.next()
            if r is None:
                return
            yield r

    def close(self) -> None:
        if self._lib is not None:
            if self._h:
                self._lib.rio_prefetcher_destroy(self._h)
                self._h = None
            return
        self._stopped = True
        # unblock any worker waiting on a full queue, then JOIN them: a
        # worker's puts are bounded polls against _stopped, so every thread
        # (and its open Reader fd) is gone when close() returns — the
        # teardown-leak contract thread_report() checks.  The join is
        # DEADLINED: a worker wedged inside file i/o (hung NFS read never
        # reaches a _stopped check) must degrade to leaking one daemon
        # thread, not hang every `with Prefetcher(...)` exit forever
        deadline = time.monotonic() + 5.0
        for th in self._threads:
            while th.is_alive() and time.monotonic() < deadline:
                try:
                    self._q.get_nowait()
                except _queue.Empty:
                    pass
                th.join(timeout=0.2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path: str, records: Iterable[bytes], **kw) -> int:
    n = 0
    with Writer(path, **kw) as w:
        for r in records:
            w.write(r)
            n += 1
    return n
