"""DataFormat.proto binary data reader — feeds the reference's checked-in
binary datasets directly (paddle/trainer/tests/mnist_bin_part,
data_bin_part), completing TrainerOnePass parity.

Reference format (proto/DataFormat.proto; ProtoReader.h:53 read();
ProtoDataProvider.cpp:210 loadDataFile): a stream of varint32-length-framed
proto2 messages — one ``DataHeader`` then N ``DataSample``s — optionally
gzip-compressed when the filename ends in ``.gz``.

Implemented as a minimal proto2 wire-format decoder: the schema is four
small messages, so no protoc/generated code is needed (and the environment
bakes none in).  Packed and unpacked repeated scalar encodings are both
accepted, as protobuf parsers must.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gzip
import os
import struct
import subprocess
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

# SlotDef.SlotType (DataFormat.proto:50-58)
VECTOR_DENSE = 0
VECTOR_SPARSE_NON_VALUE = 1
VECTOR_SPARSE_VALUE = 2
INDEX = 3
VAR_MDIM_DENSE = 4
VAR_MDIM_INDEX = 5
STRING = 6


@dataclasses.dataclass(frozen=True)
class SlotDef:
    type: int
    dim: int


# ---------------------------------------------------------------------------
# proto2 wire format
# ---------------------------------------------------------------------------


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value); value is int for varint/fixed
    and bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            v, pos = _varint(buf, pos)
        elif wt == 5:  # fixed32
            v = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wt == 1:  # fixed64
            v = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _varint(buf, pos)
            v = buf[pos : pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _packed_varints(v: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(v):
        x, pos = _varint(v, pos)
        out.append(x)
    return out


def _collect_uint32(acc: List[int], wt: int, v) -> None:
    """repeated uint32 — packed (wt 2) or single (wt 0)."""
    if wt == 2:
        acc.extend(_packed_varints(v))
    else:
        acc.append(v)


def _collect_float(acc: List[float], wt: int, v) -> None:
    """repeated float — packed (wt 2, concatenated fixed32) or single."""
    if wt == 2:
        acc.extend(np.frombuffer(v, dtype="<f4").tolist())
    else:
        acc.append(struct.unpack("<f", struct.pack("<I", v))[0])


def _parse_slot_def(buf: bytes) -> SlotDef:
    t = dim = 0
    for field, _wt, v in _fields(buf):
        if field == 1:
            t = v
        elif field == 2:
            dim = v
    return SlotDef(t, dim)


def _parse_header(buf: bytes) -> List[SlotDef]:
    defs: List[SlotDef] = []
    for field, _wt, v in _fields(buf):
        if field == 1:
            defs.append(_parse_slot_def(v))
    if not defs:
        raise ValueError("DataHeader declares no slots")
    return defs


@dataclasses.dataclass
class VectorSlot:
    values: List[float]
    ids: List[int]
    dims: List[int]
    strs: List[bytes]


def _parse_vector_slot(buf: bytes) -> VectorSlot:
    vs = VectorSlot([], [], [], [])
    for field, wt, v in _fields(buf):
        if field == 1:
            _collect_float(vs.values, wt, v)
        elif field == 2:
            _collect_uint32(vs.ids, wt, v)
        elif field == 3:
            _collect_uint32(vs.dims, wt, v)
        elif field == 4:
            vs.strs.append(v)
    return vs


@dataclasses.dataclass
class SubseqSlot:
    slot_id: int
    lens: List[int]


@dataclasses.dataclass
class DataSample:
    is_beginning: bool
    vector_slots: List[VectorSlot]
    id_slots: List[int]
    var_id_slots: List[VectorSlot]
    subseq_slots: List[SubseqSlot]


def _parse_sample(buf: bytes) -> DataSample:
    s = DataSample(True, [], [], [], [])
    for field, wt, v in _fields(buf):
        if field == 1:
            s.is_beginning = bool(v)
        elif field == 2:
            s.vector_slots.append(_parse_vector_slot(v))
        elif field == 3:
            _collect_uint32(s.id_slots, wt, v)
        elif field == 4:
            s.var_id_slots.append(_parse_vector_slot(v))
        elif field == 5:
            ss = SubseqSlot(0, [])
            for f2, wt2, v2 in _fields(v):
                if f2 == 1:
                    ss.slot_id = v2
                elif f2 == 2:
                    _collect_uint32(ss.lens, wt2, v2)
            s.subseq_slots.append(ss)
    return s


# ---------------------------------------------------------------------------
# native fast path (native/protodata.cc of this package, built with g++ at
# first use into _build/): one-pass C++ decode of
# DENSE+INDEX files (the mnist_bin_part shape) into contiguous numpy
# buffers; anything else (sparse, sequences, gzip) falls back to the
# pure-Python decoder below.
# ---------------------------------------------------------------------------

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_SRC = os.path.join(_PKG_ROOT, "native", "protodata.cc")
_NATIVE_SO = os.path.join(_PKG_ROOT, "_build", "libpaddle_tpu_torch_protodata.so")
_native_lib = None
_native_tried = False
# a plain lock: the JAX package's instrumented lock factory belongs to its
# lock-sanitizer tooling, which the port has not taken over yet
_native_lock = threading.Lock()


def _load_native():
    global _native_lib, _native_tried
    with _native_lock:
        if _native_tried:
            return _native_lib
        _native_tried = True
        try:
            have_so = os.path.exists(_NATIVE_SO)
            have_src = os.path.exists(_NATIVE_SRC)
            stale = (
                have_so and have_src
                and os.path.getmtime(_NATIVE_SO) < os.path.getmtime(_NATIVE_SRC)
            )
            if (not have_so or stale) and have_src:
                os.makedirs(os.path.dirname(_NATIVE_SO), exist_ok=True)
                # build to a per-pid temp and rename: concurrent processes
                # (pytest workers, multi-process launch) must never CDLL a
                # half-written .so
                tmp = f"{_NATIVE_SO}.{os.getpid()}.tmp"
                subprocess.run(  # lock: allow[C304] one-time lazy native build; the lock exists to serialize exactly this compile
                    ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                     _NATIVE_SRC, "-o", tmp],
                    check=True, capture_output=True,
                )
                os.replace(tmp, _NATIVE_SO)
            elif not have_so:
                return None
            lib = ctypes.CDLL(_NATIVE_SO)
            lib.pdx_scan.restype = ctypes.c_int
            lib.pdx_scan.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_uint),
                ctypes.c_int,
            ]
            lib.pdx_decode_dense_index.restype = ctypes.c_int
            lib.pdx_decode_dense_index.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_longlong,
            ]
            _native_lib = lib
        except Exception:
            _native_lib = None
        return _native_lib


# (path, size, mtime_ns) -> (defs, count) or None: skips the full scan walk
# on later epochs, and remembers which files can NEVER take the fast path so
# they don't pay a C++ parse before every Python fallback.
_scan_cache: dict = {}


def _native_scan(lib, path: str):
    key = None
    try:
        st = os.stat(path)
        key = (str(path), st.st_size, st.st_mtime_ns)
        if key in _scan_cache:
            return _scan_cache[key]
    except OSError:
        pass
    max_slots = 64
    n = ctypes.c_longlong(0)
    ns = ctypes.c_int(0)
    types = (ctypes.c_int * max_slots)()
    dims = (ctypes.c_uint * max_slots)()
    rc = lib.pdx_scan(
        str(path).encode(), ctypes.byref(n), ctypes.byref(ns), types, dims,
        max_slots,
    )
    out = (
        ([SlotDef(types[i], int(dims[i])) for i in range(ns.value)], int(n.value))
        if rc == 0
        else None
    )
    if key is not None:
        if len(_scan_cache) > 1024:
            _scan_cache.clear()
        _scan_cache[key] = out
    return out


def native_decode_dense_index(path: str):
    """(defs, arrays-aligned-to-defs) via the C++ decoder, or None when the
    file is not the dense/index fast path (or the native lib is absent)."""
    if str(path).endswith(".gz"):
        return None
    lib = _load_native()
    if lib is None:
        return None
    scanned = _native_scan(lib, path)
    if scanned is None:
        return None
    defs, count = scanned
    dense_arrays = [
        np.empty((count, d.dim), np.float32) for d in defs if d.type == VECTOR_DENSE
    ]
    index_arrays = [
        np.empty((count,), np.int32) for d in defs if d.type == INDEX
    ]
    dense_ptrs = (ctypes.c_void_p * max(len(dense_arrays), 1))(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in dense_arrays]
    )
    index_ptrs = (ctypes.c_void_p * max(len(index_arrays), 1))(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in index_arrays]
    )
    rc = lib.pdx_decode_dense_index(
        str(path).encode(), dense_ptrs, index_ptrs, ctypes.c_longlong(count)
    )
    if rc != 0:
        return None
    out = []
    di = ii = 0
    for d in defs:
        if d.type == VECTOR_DENSE:
            out.append(dense_arrays[di])
            di += 1
        else:
            out.append(index_arrays[ii])
            ii += 1
    return defs, out


# ---------------------------------------------------------------------------
# file reading
# ---------------------------------------------------------------------------


def _read_framed(path: str) -> Iterator[bytes]:
    """Varint-length-framed messages (ProtoReader.h:92-101)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        size, pos = _varint(data, pos)
        yield data[pos : pos + size]
        pos += size


def read_proto_data(path: str) -> Tuple[List[SlotDef], List[DataSample]]:
    """One file -> (slot_defs, samples)."""
    it = _read_framed(path)
    try:
        header = _parse_header(next(it))
    except StopIteration:
        raise ValueError(f"{path}: empty proto data file") from None
    return header, [_parse_sample(b) for b in it]


def read_proto_header(path: str) -> List[SlotDef]:
    """Just the DataHeader (for slot-type resolution at config-parse time)."""
    for buf in _read_framed(path):
        return _parse_header(buf)
    raise ValueError(f"{path}: empty proto data file")


def _slot_offsets(defs: Sequence[SlotDef]) -> List[int]:
    """Per-slot index into its kind's storage list (vector_slots / id_slots /
    var_id_slots each count separately — DataSample stores the three kinds
    in separate repeated fields, so a shared offset mis-reads any header
    whose kinds interleave)."""
    counts = {"vec": 0, "id": 0, "var": 0}
    offs = []
    for d in defs:
        k = "id" if d.type == INDEX else "var" if d.type == VAR_MDIM_INDEX else "vec"
        offs.append(counts[k])
        counts[k] += 1
    return offs


def _slot_value(sample: DataSample, off: int, d: SlotDef):
    """Python value of a slot, by declared type; ``off`` is the slot's index
    within its kind's storage list (see _slot_offsets)."""
    if d.type == INDEX:
        return int(sample.id_slots[off])
    if d.type == VAR_MDIM_INDEX:
        return [int(x) for x in sample.var_id_slots[off].ids]
    vs = sample.vector_slots[off]
    if d.type == VECTOR_DENSE:
        return np.asarray(vs.values, np.float32)
    if d.type == VECTOR_SPARSE_NON_VALUE:
        return [int(x) for x in vs.ids]
    if d.type == VECTOR_SPARSE_VALUE:
        return list(zip((int(x) for x in vs.ids), vs.values))
    if d.type == STRING:
        return [s.decode("utf-8", "replace") for s in vs.strs]
    if d.type == VAR_MDIM_DENSE:
        a = np.asarray(vs.values, np.float32)
        return a.reshape([int(x) for x in vs.dims]) if vs.dims else a
    raise ValueError(f"unsupported slot type {d.type}")


def slot_input_types(defs: Sequence[SlotDef], sequence: bool = False):
    """Map SlotDefs onto the framework's InputTypes (the provider-side
    contract PyDataProvider2.cpp:54-69 expresses for py providers)."""
    from paddle_tpu_torch.core import data_types as dt

    out = []
    for d in defs:
        if d.type == VECTOR_DENSE:
            t = dt.dense_vector_sequence(d.dim) if sequence else dt.dense_vector(d.dim)
        elif d.type == VECTOR_SPARSE_NON_VALUE:
            t = (
                dt.sparse_binary_vector_sequence(d.dim)
                if sequence
                else dt.sparse_binary_vector(d.dim)
            )
        elif d.type == VECTOR_SPARSE_VALUE:
            t = (
                dt.sparse_float_vector_sequence(d.dim)
                if sequence
                else dt.sparse_float_vector(d.dim)
            )
        elif d.type == INDEX:
            t = dt.integer_value_sequence(d.dim) if sequence else dt.integer_value(d.dim)
        elif d.type == VAR_MDIM_INDEX:
            # a var-length id LIST per sample — inherently a sequence slot
            # even in non-sequence mode (its _slot_value is a list)
            t = dt.integer_value_sequence(d.dim)
        else:
            raise ValueError(f"slot type {d.type} has no InputType mapping")
        out.append(t)
    return out


# ---------------------------------------------------------------------------
# writing (round-trip tests + converting py datasets into the binary format)
# ---------------------------------------------------------------------------


def _enc_varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_key(field: int, wt: int) -> bytes:
    return _enc_varint((field << 3) | wt)


def _enc_len_delim(field: int, payload: bytes) -> bytes:
    return _enc_key(field, 2) + _enc_varint(len(payload)) + payload


def _enc_packed_varints(field: int, xs: Sequence[int]) -> bytes:
    if not xs:
        return b""
    return _enc_len_delim(field, b"".join(_enc_varint(int(x)) for x in xs))


def _enc_packed_floats(field: int, xs: Sequence[float]) -> bytes:
    if len(xs) == 0:
        return b""
    return _enc_len_delim(field, np.asarray(xs, "<f4").tobytes())


def _enc_vector_slot(field: int, values=(), ids=()) -> bytes:
    return _enc_len_delim(
        field, _enc_packed_floats(1, values) + _enc_packed_varints(2, ids)
    )


def write_proto_data(path: str, defs: Sequence[SlotDef], rows, is_beginning=None):
    """Encode rows (tuples in slot order, python values as `_slot_value`
    returns them) into the varint-framed DataFormat.proto layout the
    reference trainer reads.  ``is_beginning``: optional parallel iterable of
    bools for sequence grouping (default: every sample begins a sequence)."""
    # SlotDef wire: field1(type)=key 0x08 varint, field2(dim)=key 0x10 varint
    header = b"".join(
        _enc_len_delim(
            1, b"\x08" + _enc_varint(d.type) + b"\x10" + _enc_varint(d.dim)
        )
        for d in defs
    )
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(_enc_varint(len(header)) + header)
        begins = iter(is_beginning) if is_beginning is not None else None
        for row in rows:
            body = b""
            if begins is not None and not next(begins):
                body += _enc_key(1, 0) + _enc_varint(0)  # is_beginning=false
            ids_tail = []
            for v, d in zip(row, defs):
                if d.type == INDEX:
                    ids_tail.append(int(v))
                elif d.type == VECTOR_DENSE:
                    body += _enc_vector_slot(2, values=np.asarray(v, np.float32))
                elif d.type == VECTOR_SPARSE_NON_VALUE:
                    body += _enc_vector_slot(2, ids=[int(x) for x in v])
                elif d.type == VECTOR_SPARSE_VALUE:
                    body += _enc_vector_slot(
                        2,
                        values=[float(x) for _, x in v],
                        ids=[int(i) for i, _ in v],
                    )
                else:
                    raise ValueError(f"write: unsupported slot type {d.type}")
            body += _enc_packed_varints(3, ids_tail)
            f.write(_enc_varint(len(body)) + body)


def make_reader(
    paths: Sequence[str],
    sequence: bool = False,
):
    """Reader factory over proto data files (the v2 reader contract: a
    callable returning a fresh generator).

    sequence=False: one tuple per DataSample (ProtoDataProvider semantics).
    sequence=True: samples grouped by ``is_beginning`` into sequences, each
    slot a per-timestep list (ProtoSequenceDataProvider semantics,
    ProtoDataProvider.cpp:528).
    """
    paths = list(paths)

    def reader():
        expect: Optional[List[SlotDef]] = None
        seq_acc: Optional[List[list]] = None
        for path in paths:
            if not sequence:
                nat = native_decode_dense_index(path)
                if nat is not None:
                    defs, arrays = nat
                    if expect is None:
                        expect = defs
                    elif defs != expect:
                        raise ValueError(
                            f"{path}: slot defs {defs} differ from first "
                            f"file's {expect}"
                        )
                    count = arrays[0].shape[0] if arrays else 0
                    for i in range(count):
                        yield tuple(
                            a[i] if a.ndim == 2 else int(a[i]) for a in arrays
                        )
                    continue
            defs, samples = read_proto_data(path)
            if expect is None:
                expect = defs
            elif defs != expect:
                raise ValueError(
                    f"{path}: slot defs {defs} differ from first file's "
                    f"{expect} (checkDataHeader consistency rule)"
                )
            offs = _slot_offsets(defs)
            for s in samples:
                row = tuple(
                    _slot_value(s, off, d) for off, d in zip(offs, defs)
                )
                if not sequence:
                    yield row
                    continue
                if s.is_beginning and seq_acc is not None:
                    yield tuple(seq_acc)
                    seq_acc = None
                if seq_acc is None:
                    seq_acc = [[] for _ in defs]
                for acc, v in zip(seq_acc, row):
                    acc.append(v)
        if sequence and seq_acc is not None:
            yield tuple(seq_acc)

    return reader
