"""Versioned, CRC-framed, size-bounded wire codec for the master RPC plane.

The reference pserver treats the network as a FAULT DOMAIN: LightNetwork/
SocketChannel frame every message, time out, retry, and never trust a peer
byte (paddle/pserver/LightNetwork.cpp, SocketChannel.cpp).  Our RPC plane
instead rode ``multiprocessing.connection``'s implicit pickle — unversioned,
size-unbounded, and ``pickle.loads`` EXECUTES attacker-controlled bytes.
This module is the replacement: every message that crosses a process
boundary is one frame of

    MAGIC(3) | version(1) | length(4) | crc32(4) | payload(length)

(integers big-endian; the CRC covers ``version|length|payload``) whose
payload is a RESTRICTED typed encoding — primitives, dict/list/tuple,
numpy arrays — that a decoder can verify byte-by-byte without ever
executing anything.  A corrupt, oversized, truncated or unknown-version
frame is a structured :class:`MasterWireError` subclass, never an OOM and
never an exec of foreign bytes.

Size discipline (the ``rpc_max_message_mb`` flag): the bound is enforced on
SEND (an over-budget gradient tree fails fast with a structured error
instead of wedging against a frozen peer's full socket buffer) and on RECV
(``Connection.recv_bytes(maxlength)`` refuses before allocating, so a
hostile length prefix cannot balloon the heap).

Payload type tags (1 ASCII byte each)::

    N           None
    T / F       True / False
    i           int64 (struct >q)
    I           big int (u32 length + ASCII decimal)
    f           float64 (struct >d)
    s           str   (u32 length + utf-8)
    b           bytes (u32 length + raw)
    l / t       list / tuple (u32 count + items)
    d           dict (u32 count + key,value pairs; keys must be hashable
                primitives — None/bool/int/float/str/bytes)
    a           numpy ndarray (u8 dtype-str length + dtype str + u8 ndim +
                u32 dims... + raw C-order bytes); dtype kind must be one of
                b/i/u/f/c — object/void dtypes are REJECTED on both sides
    q / Q       numpy int8 / uint8 ndarray (u8 ndim + u32 dims... + raw
                bytes) — the compact spelling for quantized payloads, which
                skips the dtype string entirely so a tree of small blocks
                does not pay per-array dtype framing
    z           numpy scalar (u8 dtype-str length + dtype str + raw bytes)

Decoding is allocation-bounded: collection counts are validated against the
remaining buffer (every element costs >= 1 byte), array extents are
validated against the remaining raw bytes before any allocation, and
container nesting is capped at :data:`MAX_DEPTH`.

The counterpart of ``paddle_tpu/master_wire.py``: both encode the same
bytes, so the two packages' masters, workers and journals interoperate.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Dict, Optional

import numpy as np

from paddle_tpu_torch.analysis.lock_sanitizer import make_lock

__all__ = [
    "MAGIC",
    "VERSION",
    "FRAME_OVERHEAD",
    "MAX_DEPTH",
    "MasterWireError",
    "WireTypeError",
    "WireOversizeError",
    "WireVersionError",
    "WireCorruptError",
    "encode_payload",
    "decode_payload",
    "encode_frame",
    "decode_frame",
    "send_msg",
    "recv_msg",
    "count_bytes",
    "default_max_bytes",
    "counters",
]

MAGIC = b"PTW"
VERSION = 1
_HEAD = struct.Struct(">3sBI")  # magic, version, payload length
_CRC = struct.Struct(">I")
FRAME_OVERHEAD = _HEAD.size + _CRC.size

_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")
_U32 = struct.Struct(">I")
_U8 = struct.Struct(">B")

MAX_DEPTH = 64          # container nesting bound (a crafted nesting bomb
                        # must exhaust the depth check, not the C stack)
_MAX_DTYPE_LEN = 16
_MAX_NDIM = 32

# numpy dtype KINDS the codec will materialize: bool, signed/unsigned int,
# float, complex.  'O' (arbitrary python objects = pickle-by-the-back-door)
# and 'V' (void/structured) are rejected on encode AND decode.
_SAFE_DTYPE_KINDS = frozenset("biufc")

# dict keys must decode to something hashable without running user code
_KEY_TYPES = (type(None), bool, int, float, str, bytes)


class MasterWireError(RuntimeError):
    """Base of the structured wire-codec error taxonomy.  Every subclass
    names WHAT the codec refused (type, size, version, integrity) — a
    hostile or damaged frame surfaces as exactly one of these, never as a
    MemoryError, a pickle exec, or a silent misparse.

    Each class carries its protocol-conformance rule id and fix hint (the
    ``P###`` namespace of the JAX package's protocol lint) and
    builds a structured ``diagnostics`` list on construction, so the CLI
    and tests consume wire failures the same way as lint findings.  Still
    a plain RuntimeError subclass: a wire error must NEVER be swallowed
    by the broad ``except ValueError`` recovery paths in the journal/
    config planes."""

    kind = "wire"
    rule = "P501"
    hint = "keep RPC payloads inside the typed wire universe"

    def __init__(self, *args):
        super().__init__(*args)
        from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity
        message = args[0] if args else self.__class__.__doc__.split("\n")[0]
        self.diagnostics = [Diagnostic(
            rule=self.rule, severity=Severity.ERROR, message=str(message),
            source="master_wire.py", hint=self.hint,
        )]

    @property
    def rules(self):
        return [d.rule for d in self.diagnostics]


class WireTypeError(MasterWireError):
    """The object graph contains a type outside the restricted wire set
    (deterministic: re-sending the same payload fails the same way)."""

    kind = "type"
    rule = "P501"
    hint = ("reply with None/bool/int/float/str/bytes/list/tuple/dict/"
            "ndarray only — convert sets to sorted lists, objects to dicts")


class WireOversizeError(MasterWireError):
    """The frame exceeds the ``rpc_max_message_mb`` bound — raised on send
    BEFORE any byte hits the wire, and on recv BEFORE any allocation."""

    kind = "oversize"
    rule = "P506"
    hint = ("shrink the payload (chunk the task / quantize the gradient) "
            "or raise the rpc_max_message_mb flag on BOTH peers")


class WireVersionError(MasterWireError):
    """The frame announces a wire version this decoder does not speak
    (version skew between fleet processes)."""

    kind = "version"
    rule = "P507"
    hint = ("upgrade the older peer — wire VERSION must match across the "
            "fleet (rolling restarts go through drain, not mixed versions)")


class WireCorruptError(MasterWireError):
    """The frame failed structural verification: bad magic, length
    mismatch, CRC mismatch, or an undecodable payload."""

    kind = "corrupt"
    rule = "P508"
    hint = ("treat the connection as dead and re-dial — a CRC/framing "
            "mismatch means the stream is unsynchronized, not retryable "
            "in place")


class _Counters:
    """Tiny thread-safe counter table for the codec/netem observability
    plane (Service.stats() exports a snapshot as its ``wire`` field)."""

    def __init__(self, name: str):
        self._lock = make_lock(name)
        self._c: Dict[str, int] = {}

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)

    def reset(self) -> None:
        with self._lock:
            self._c.clear()


counters = _Counters("master_wire.counters")


def default_max_bytes() -> int:
    """The ``rpc_max_message_mb`` flag resolved to bytes (64 MB when the
    flag plane is unavailable — stripped deployments)."""
    try:
        from paddle_tpu_torch.utils import flags as _flags

        mb = _flags.get_flag("rpc_max_message_mb")
    except Exception:  # noqa: BLE001 — flag plane not loaded
        mb = 64
    return max(int(float(mb) * 1024 * 1024), FRAME_OVERHEAD + 1)


# ---------------------------------------------------------------------------
# payload encoding
# ---------------------------------------------------------------------------

def _enc(obj: Any, out: bytearray, depth: int, path: str) -> None:
    if depth > MAX_DEPTH:
        raise WireTypeError(
            f"payload nesting exceeds MAX_DEPTH={MAX_DEPTH} at {path}"
        )
    if obj is None:
        out += b"N"
    elif obj is True:
        out += b"T"
    elif obj is False:
        out += b"F"
    elif isinstance(obj, int):
        try:
            out += b"i" + _I64.pack(obj)
        except struct.error:
            digits = str(obj).encode("ascii")
            out += b"I" + _U32.pack(len(digits)) + digits
    elif isinstance(obj, float):
        out += b"f" + _F64.pack(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += b"s" + _U32.pack(len(raw)) + raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out += b"b" + _U32.pack(len(raw)) + raw
    elif isinstance(obj, np.ndarray):
        _enc_array(obj, out, path)
    elif isinstance(obj, np.generic):
        _enc_scalar(obj, out, path)
    elif isinstance(obj, (list, tuple)):
        out += b"l" if isinstance(obj, list) else b"t"
        out += _U32.pack(len(obj))
        for k, item in enumerate(obj):
            _enc(item, out, depth + 1, f"{path}[{k}]")
    elif isinstance(obj, dict):
        out += b"d" + _U32.pack(len(obj))
        for key, value in obj.items():
            if not isinstance(key, _KEY_TYPES):
                raise WireTypeError(
                    f"dict key of type {type(key).__name__} at {path} — "
                    f"wire dict keys must be hashable primitives"
                )
            _enc(key, out, depth + 1, f"{path}.key")
            _enc(value, out, depth + 1, f"{path}[{key!r}]")
    else:
        raise WireTypeError(
            f"type {type(obj).__name__} at {path} is outside the "
            f"restricted wire set (primitives, dict/list/tuple, numpy "
            f"arrays) — the RPC plane does not pickle"
        )


def _check_dtype(dt: np.dtype, path: str) -> bytes:
    s = dt.str
    if dt.kind not in _SAFE_DTYPE_KINDS or dt.hasobject or len(s) > _MAX_DTYPE_LEN:
        raise WireTypeError(
            f"numpy dtype {s!r} at {path} is outside the safe wire set "
            f"(kinds {''.join(sorted(_SAFE_DTYPE_KINDS))}; object/void "
            f"dtypes would smuggle pickle back in)"
        )
    return s.encode("ascii")


# int8/uint8 arrays (the quantized-gradient payload blocks) get dedicated
# one-byte tags with no dtype string: a gradient tree split into many small
# blocks would otherwise pay the 5-byte dtype framing per block.
_COMPACT_TAGS = {np.dtype(np.int8): b"q", np.dtype(np.uint8): b"Q"}
_COMPACT_DTYPES = {tag: dt for dt, tag in _COMPACT_TAGS.items()}


def _enc_array(arr: np.ndarray, out: bytearray, path: str) -> None:
    if arr.ndim > _MAX_NDIM:
        raise WireTypeError(f"ndarray ndim {arr.ndim} > {_MAX_NDIM} at {path}")
    compact = _COMPACT_TAGS.get(arr.dtype)
    if compact is not None:
        out += compact + _U8.pack(arr.ndim)
    else:
        ds = _check_dtype(arr.dtype, path)
        out += b"a" + _U8.pack(len(ds)) + ds + _U8.pack(arr.ndim)
    for dim in arr.shape:
        out += _U32.pack(dim)
    out += np.ascontiguousarray(arr).tobytes()


def _enc_scalar(val: np.generic, out: bytearray, path: str) -> None:
    dt = np.dtype(type(val))
    ds = _check_dtype(dt, path)
    out += b"z" + _U8.pack(len(ds)) + ds + val.tobytes()


def encode_payload(obj: Any) -> bytes:
    """Encode one message object into restricted typed bytes.  Raises
    :class:`WireTypeError` on anything outside the wire set."""
    out = bytearray()
    _enc(obj, out, 0, "$")
    return bytes(out)


# ---------------------------------------------------------------------------
# payload decoding — verify-before-allocate over a bounded cursor
# ---------------------------------------------------------------------------

class _Cursor:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise WireCorruptError(
                f"payload truncated: wanted {n} bytes at offset {self.pos}, "
                f"{len(self.data) - self.pos} remain"
            )
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def remaining(self) -> int:
        return len(self.data) - self.pos


def _dec_dtype(cur: _Cursor) -> np.dtype:
    (dlen,) = _U8.unpack(cur.take(1))
    if dlen == 0 or dlen > _MAX_DTYPE_LEN:
        raise WireCorruptError(f"dtype string length {dlen} out of range")
    ds = cur.take(dlen)
    try:
        dt = np.dtype(ds.decode("ascii"))
    except (TypeError, ValueError, UnicodeDecodeError) as exc:
        raise WireCorruptError(f"undecodable dtype {ds!r}: {exc}") from exc
    if dt.kind not in _SAFE_DTYPE_KINDS or dt.hasobject or dt.itemsize == 0:
        raise WireCorruptError(
            f"dtype {dt.str!r} outside the safe wire set (refusing to "
            f"materialize)"
        )
    return dt


def _dec(cur: _Cursor, depth: int) -> Any:
    if depth > MAX_DEPTH:
        raise WireCorruptError(f"payload nesting exceeds MAX_DEPTH={MAX_DEPTH}")
    tag = cur.take(1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return _I64.unpack(cur.take(8))[0]
    if tag == b"I":
        (n,) = _U32.unpack(cur.take(4))
        raw = cur.take(n)
        try:
            return int(raw.decode("ascii"))
        except (ValueError, UnicodeDecodeError) as exc:
            raise WireCorruptError(f"bad big-int digits {raw[:32]!r}") from exc
    if tag == b"f":
        return _F64.unpack(cur.take(8))[0]
    if tag == b"s":
        (n,) = _U32.unpack(cur.take(4))
        try:
            return cur.take(n).decode("utf-8")
        except UnicodeDecodeError as exc:
            raise WireCorruptError(f"bad utf-8 in string payload: {exc}") from exc
    if tag == b"b":
        (n,) = _U32.unpack(cur.take(4))
        return cur.take(n)
    if tag in (b"l", b"t"):
        (count,) = _U32.unpack(cur.take(4))
        if count > cur.remaining():  # every element costs >= 1 byte
            raise WireCorruptError(
                f"collection count {count} exceeds remaining payload "
                f"({cur.remaining()} bytes) — refusing to preallocate"
            )
        items = [_dec(cur, depth + 1) for _ in range(count)]
        return items if tag == b"l" else tuple(items)
    if tag == b"d":
        (count,) = _U32.unpack(cur.take(4))
        if 2 * count > cur.remaining():
            raise WireCorruptError(
                f"dict count {count} exceeds remaining payload "
                f"({cur.remaining()} bytes) — refusing to preallocate"
            )
        out: Dict[Any, Any] = {}
        for _ in range(count):
            key = _dec(cur, depth + 1)
            if not isinstance(key, _KEY_TYPES):
                raise WireCorruptError(
                    f"dict key of type {type(key).__name__} — keys must be "
                    f"hashable primitives"
                )
            out[key] = _dec(cur, depth + 1)
        return out
    if tag == b"a" or tag in _COMPACT_DTYPES:
        dt = _COMPACT_DTYPES[tag] if tag != b"a" else _dec_dtype(cur)
        (ndim,) = _U8.unpack(cur.take(1))
        if ndim > _MAX_NDIM:
            raise WireCorruptError(f"ndarray ndim {ndim} > {_MAX_NDIM}")
        shape = []
        n_items = 1
        for _ in range(ndim):
            (dim,) = _U32.unpack(cur.take(4))
            shape.append(dim)
            n_items *= dim
        n_bytes = n_items * dt.itemsize
        if n_bytes > cur.remaining():
            raise WireCorruptError(
                f"ndarray claims {n_bytes} raw bytes, {cur.remaining()} "
                f"remain — refusing to allocate"
            )
        raw = cur.take(n_bytes)
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    if tag == b"z":
        dt = _dec_dtype(cur)
        raw = cur.take(dt.itemsize)
        return np.frombuffer(raw, dtype=dt)[0]
    raise WireCorruptError(f"unknown payload type tag {tag!r}")


def decode_payload(data: bytes) -> Any:
    """Decode restricted typed bytes back into the message object.  Every
    structural violation is a :class:`WireCorruptError` — decoding never
    executes payload bytes and never allocates past the buffer it holds."""
    cur = _Cursor(bytes(data))
    obj = _dec(cur, 0)
    if cur.remaining():
        raise WireCorruptError(
            f"{cur.remaining()} trailing bytes after a complete payload"
        )
    return obj


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def encode_frame(payload: bytes, max_bytes: Optional[int] = None) -> bytes:
    """``MAGIC|version|len|crc32|payload`` with the size bound enforced
    BEFORE any byte is handed to the transport."""
    if max_bytes is None:
        max_bytes = default_max_bytes()
    if len(payload) + FRAME_OVERHEAD > max_bytes:
        raise WireOversizeError(
            f"outbound frame of {len(payload) + FRAME_OVERHEAD} bytes "
            f"exceeds the {max_bytes}-byte bound (flag rpc_max_message_mb) "
            f"— refusing to send"
        )
    head = _HEAD.pack(MAGIC, VERSION, len(payload))
    crc = zlib.crc32(head[3:] + payload) & 0xFFFFFFFF
    return head + _CRC.pack(crc) + payload


def decode_frame(buf: bytes, max_bytes: Optional[int] = None) -> bytes:
    """Verify one complete frame and return its payload bytes.  The
    transport preserves message boundaries, so ``buf`` must be exactly one
    frame — any mismatch is corruption, not a partial read."""
    if max_bytes is None:
        max_bytes = default_max_bytes()
    if len(buf) > max_bytes:
        raise WireOversizeError(
            f"inbound frame of {len(buf)} bytes exceeds the {max_bytes}-"
            f"byte bound (flag rpc_max_message_mb)"
        )
    if len(buf) < FRAME_OVERHEAD:
        raise WireCorruptError(
            f"frame of {len(buf)} bytes is shorter than the "
            f"{FRAME_OVERHEAD}-byte header"
        )
    if buf[:3] != MAGIC:
        raise WireCorruptError(f"bad frame magic {bytes(buf[:3])!r}")
    version = buf[3]
    if version != VERSION:
        raise WireVersionError(
            f"unknown wire version {version} (this build speaks "
            f"{VERSION}) — version skew between fleet processes"
        )
    (length,) = _U32.unpack_from(buf, 4)
    if length + FRAME_OVERHEAD != len(buf):
        raise WireCorruptError(
            f"frame length field says {length} payload bytes but the "
            f"message carries {len(buf) - FRAME_OVERHEAD}"
        )
    (crc,) = _U32.unpack_from(buf, 8)
    payload = buf[FRAME_OVERHEAD:]
    want = zlib.crc32(buf[3:8] + payload) & 0xFFFFFFFF
    if crc != want:
        raise WireCorruptError(
            f"frame crc mismatch (stored {crc:#010x}, computed {want:#010x})"
        )
    return payload


# ---------------------------------------------------------------------------
# transport helpers (one frame per Connection message)
# ---------------------------------------------------------------------------

def count_bytes(direction: str, n: int, label: Optional[str] = None) -> None:
    """Tally ``n`` wire bytes under ``wire_bytes_{direction}`` — the metric
    the quantized-allreduce bench gates on.  The aggregate row always
    updates; ``label`` adds a per-connection row (``wire_bytes_sent[repl]``)
    so a fleet's traffic decomposes by endpoint.  Mirrored into the global
    StatSet when the timers plane is importable (never a hard dependency —
    the codec must stay loadable from stripped wire-only processes)."""
    key = f"wire_bytes_{direction}"
    counters.incr(key, n)
    if label:
        counters.incr(f"{key}[{label}]", n)
    try:
        from paddle_tpu_torch.utils.timers import global_stats

        global_stats.incr(key, n)
    except Exception:  # noqa: BLE001 — timers plane not loaded
        pass


def send_msg(conn, obj: Any, max_bytes: Optional[int] = None,
             label: Optional[str] = None) -> None:
    """Encode + frame + send one message over a
    ``multiprocessing.connection`` Connection (or a netem wrapper)."""
    frame = encode_frame(encode_payload(obj), max_bytes)
    count_bytes("sent", len(frame), label)
    conn.send_bytes(frame)


def recv_msg(conn, max_bytes: Optional[int] = None,
             label: Optional[str] = None) -> Any:
    """Receive + verify + decode one message.  The recv-side size bound
    rides ``recv_bytes(maxlength)`` so an over-budget length prefix is
    refused BEFORE allocation (the transport closes the desynced stream;
    the structured :class:`WireOversizeError` tells the caller why)."""
    if max_bytes is None:
        max_bytes = default_max_bytes()
    try:
        buf = conn.recv_bytes(max_bytes)
    except OSError as exc:
        if "bad message length" in str(exc):
            raise WireOversizeError(
                f"inbound frame exceeds the {max_bytes}-byte bound (flag "
                f"rpc_max_message_mb) — refused before allocation, "
                f"connection dropped"
            ) from exc
        raise
    count_bytes("recv", len(buf), label)
    return decode_payload(decode_frame(buf, max_bytes))
