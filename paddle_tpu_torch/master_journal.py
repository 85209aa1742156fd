"""CRC-framed append-only journal for the master's durable state plane.

The reference Go master journals every queue transition into etcd so a
standby that wins the next campaign RESUMES the job instead of restarting
it (go/master/etcd_client.go; the TF fault-tolerance model of
arXiv:1605.08695 §4.4).  etcd-free equivalent: one append-only file next to
the ``master_state.json`` snapshot.  The snapshot is the compaction target
(periodically rewritten), the journal is the fsync'd delta on top of it —
recovery = load snapshot, replay the journal records whose ``seq`` exceeds
the snapshot's.

Frame format (all integers big-endian)::

    MAGIC(4) | seq(8) | length(4) | crc32(4) | payload(length)

``crc32`` covers ``seq|length|payload``, so a torn header, a torn payload
and a bit-flipped record are all detected.  The payload is the dict
``{"t": <record type>, ...}`` in the master_wire restricted typed encoding
(``PTJ2`` frames) — the same safe codec the RPC plane the records arrived
on uses, so numpy gradient trees round-trip bit-exactly and a damaged or
foreign payload can never execute.  Pre-wire-codec generations (``PTJ1``
frames, payload pickled) remain READABLE for the one upgrade boot that
replays them; everything written from then on is ``PTJ2`` (the first
compaction rewrites the plane).

Durability discipline:

* every append is ``flush`` + ``fsync`` before the RPC that caused it is
  acknowledged — a worker that saw ``task_finished`` return True can rely
  on the result surviving a master kill -9;
* an incomplete final frame (crash mid-append) is TOLERATED on replay: the
  journal is a prefix-consistent history, so recovery applies the prefix
  and moves on;
* a CRC-corrupt COMPLETE frame is flagged (``corrupt``) — replay still
  stops at the prefix (never applies unverifiable bytes), but the journal
  lint reports it as an error so an operator sees silent media rot;
* an UNKNOWN record type is a hard error everywhere: a typo'd or
  version-skewed record must never be silently dropped from a recovery.

Generations: compaction writes a NEW journal file (``master_journal-
NNNNNN.log``), re-emits the retained per-pass results into it, then
atomically publishes a snapshot referencing it; the old generation is
deleted only after the snapshot rename lands.  A deposed leader that
somehow keeps appending writes to a generation no snapshot references —
the second fence behind the HA lease.
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

from paddle_tpu_torch import master_wire as _wire

__all__ = [
    "MAGIC",
    "MAGIC_V1",
    "RECORD_TYPES",
    "JournalError",
    "JournalWriter",
    "encode_frame",
    "read_records",
    "verify_journal",
    "journal_filename",
    "parse_generation",
]

MAGIC = b"PTJ2"      # payload = master_wire restricted typed encoding
MAGIC_V1 = b"PTJ1"   # legacy: payload pickled (read-only upgrade path)
_HEADER = struct.Struct(">QI")  # seq, payload length
_CRC = struct.Struct(">I")
_FRAME_OVERHEAD = len(MAGIC) + _HEADER.size + _CRC.size

# every record type the replay plane understands; replaying (or linting) a
# record outside this set is a HARD error — version skew and corruption
# must never be silently dropped from a recovery
RECORD_TYPES = frozenset({
    "lease",     # todo -> pending (task, epoch, worker)
    "finish",    # pending/todo -> done, + per-pass result payload
    "fail",      # pending -> todo|discarded via the failure_max discipline
    "ret",       # pending -> todo, no failure event (graceful give-back)
    "rotate",    # pass boundary: done -> todo, pass_id++
    "frotate",   # forced rotation: every live worker attested the pass
                 # was applied on a deposed leader (failover-regression
                 # heal) — whole queue recycles, result map poisoned
    "unres",     # requeue_unresulted: done -> todo (results lost)
    "join",      # worker registry join
    "leave",     # worker registry leave (graceful or pruned)
    "farrive",   # fence arrival (first arrival per worker, with meta)
    "frelease",  # fence release (frozen membership view)
})

# how many trailing passes of result maps compaction re-emits mirrors the
# Service's own retention (see Service._rotate_pass)


class JournalError(RuntimeError):
    """The journal cannot be (fully) trusted: unknown record type,
    non-monotonic sequence, or a caller asked for strict framing."""


def encode_frame(seq: int, record: Dict[str, Any]) -> bytes:
    payload = _wire.encode_payload(record)
    header = _HEADER.pack(seq, len(payload))
    crc = zlib.crc32(header + payload) & 0xFFFFFFFF
    return MAGIC + header + _CRC.pack(crc) + payload


class JournalWriter:
    """Appender for one journal generation.  ``fsync=False`` is for tests
    that grind thousands of records; production masters keep it on — the
    append is the durability point the RPC ack stands on."""

    def __init__(self, path: str, fsync: bool = True, fresh: bool = True,
                 exclusive: bool = False):
        self.path = path
        self.fsync = fsync
        # exclusive: refuse to open a generation file someone else already
        # created (FileExistsError) — compaction's collision fence
        mode = "xb" if exclusive else ("wb" if fresh else "ab")
        self._f = open(path, mode)

    def append(self, seq: int, record: Dict[str, Any],
               sync: bool = True) -> int:
        from paddle_tpu_torch import obs as _obs

        # the fsync here is what every RPC ack's durability stands on —
        # exactly the hold a merged timeline must show when a drill asks
        # "where did the ack latency go"
        with _obs.span(
            "journal_append", cat="master", seq=seq, t=record.get("t"),
        ):
            frame = encode_frame(seq, record)
            self._f.write(frame)
            if sync:
                self.sync()
        return len(frame)

    def sync(self) -> None:
        """Flush + fsync everything appended so far.  ``sync=False``
        appends (compaction's bulk re-emission) stand on one trailing
        call here — same crash ordering, one fsync instead of N."""
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def tell(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


def _iter_frames(
    data: bytes, base_offset: int = 0
) -> Iterator[Tuple[int, int, Dict[str, Any]]]:
    """Yield ``(end_offset, seq, record)`` per valid frame; raise
    ``_Torn``/``_Corrupt`` (internal) at the first bad frame."""
    o = 0
    n = len(data)
    while o < n:
        if n - o < _FRAME_OVERHEAD:
            raise _Torn(base_offset + o)
        magic = data[o : o + 4]
        if magic not in (MAGIC, MAGIC_V1):
            raise _Corrupt(base_offset + o, "bad frame magic")
        seq, length = _HEADER.unpack_from(data, o + 4)
        payload_start = o + _FRAME_OVERHEAD
        if payload_start + length > n:
            # the frame claims more bytes than the file holds: a crash
            # mid-append (torn tail) — or a corrupt length field, which is
            # indistinguishable without trusting the corrupt bytes
            raise _Torn(base_offset + o)
        (crc,) = _CRC.unpack_from(data, o + 4 + _HEADER.size)
        blob = data[payload_start : payload_start + length]
        want = zlib.crc32(data[o + 4 : o + 4 + _HEADER.size] + blob) & 0xFFFFFFFF
        if crc != want:
            raise _Corrupt(base_offset + o, "crc mismatch")
        try:
            if magic == MAGIC_V1:
                record = pickle.loads(blob)  # wire: allow[A206] pre-wire-codec (PTJ1) journal generations pickled their payloads; this CRC-verified, operator-owned local file is replayed exactly once at the upgrade boot — the first compaction rewrites the plane as PTJ2
            else:
                record = _wire.decode_payload(blob)
        except Exception as exc:  # noqa: BLE001 — any undecodable payload
            raise _Corrupt(base_offset + o, f"undecodable payload: {exc!r}")
        # end offset is ABSOLUTE (base_offset + position in this read):
        # a tailer feeds it straight back as its next resume offset
        yield base_offset + payload_start + length, seq, record
        o = payload_start + length


class _Torn(Exception):
    def __init__(self, offset: int):
        self.offset = offset


class _Corrupt(Exception):
    def __init__(self, offset: int, why: str):
        self.offset = offset
        self.why = why


def read_records(
    path: str, offset: int = 0
) -> Tuple[List[Tuple[int, Dict[str, Any]]], Dict[str, Any]]:
    """Read every complete, CRC-verified frame from ``offset`` on.

    Returns ``(records, info)`` where records is ``[(seq, record), ...]``
    and info carries ``end_offset`` (byte position after the last good
    frame — a tailer resumes here), ``torn`` (incomplete final frame:
    expected after a crash mid-append, tolerated), and ``corrupt`` (a
    COMPLETE frame failed its CRC or didn't decode: media rot / foreign
    bytes; replay still stops at the good prefix, the lint flags it)."""
    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read()
    records: List[Tuple[int, Dict[str, Any]]] = []
    info: Dict[str, Any] = {
        "end_offset": offset, "torn": False, "corrupt": False, "error": None,
    }
    try:
        for end, seq, rec in _iter_frames(data, offset):
            records.append((seq, rec))
            info["end_offset"] = end
    except _Torn as t:
        info["torn"] = True
        info["error"] = f"incomplete frame at byte {t.offset}"
    except _Corrupt as c:
        info["corrupt"] = True
        info["error"] = f"{c.why} at byte {c.offset}"
    return records, info


def verify_journal(path: str) -> List[Dict[str, str]]:
    """Journal lint: framing, CRC, record-type and sequence checks.

    Returns a list of ``{"rule", "severity", "message"}`` findings (empty =
    clean), in the shape the JAX package's ``lint --journal`` maps onto its
    diagnostic model.  Rules:

    * J001 — framing/CRC corruption (complete frame failed verification)
    * J002 — unknown record type (hard error: version skew or corruption)
    * J003 — non-monotonic sequence numbers
    * J004 — torn final frame (warning: expected after a crash mid-append)
    """
    findings: List[Dict[str, str]] = []
    try:
        records, info = read_records(path)
    except OSError as exc:
        return [{"rule": "J001", "severity": "error",
                 "message": f"unreadable journal {path}: {exc}"}]
    if info["corrupt"]:
        findings.append({
            "rule": "J001", "severity": "error",
            "message": f"{path}: {info['error']} — replay stops at the "
                       f"good prefix ({len(records)} records)",
        })
    elif info["torn"]:
        findings.append({
            "rule": "J004", "severity": "warning",
            "message": f"{path}: {info['error']} (torn tail — a crash "
                       f"mid-append; the prefix is consistent)",
        })
    last_seq: Optional[int] = None
    for seq, rec in records:
        t = rec.get("t") if isinstance(rec, dict) else None
        if t not in RECORD_TYPES:
            findings.append({
                "rule": "J002", "severity": "error",
                "message": f"{path}: unknown record type {t!r} at seq "
                           f"{seq} — refusing to interpret (version skew?)",
            })
        if last_seq is not None and seq <= last_seq:
            findings.append({
                "rule": "J003", "severity": "error",
                "message": f"{path}: sequence went {last_seq} -> {seq} "
                           f"(journal records must be strictly increasing)",
            })
        last_seq = seq
    return findings


def journal_filename(generation: int) -> str:
    return f"master_journal-{generation:06d}.log"


def parse_generation(filename: str) -> int:
    """Generation number from a journal filename; 0 when unparseable."""
    base = os.path.basename(filename)
    if base.startswith("master_journal-") and base.endswith(".log"):
        try:
            return int(base[len("master_journal-"):-len(".log")])
        except ValueError:
            pass
    return 0
