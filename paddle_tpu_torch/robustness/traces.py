"""Request-lifecycle trace record/replay — the ``.ptt`` format; the
counterpart of ``paddle_tpu/robustness/traces.py`` (no torch), whose bytes
it reads and writes, so a trace written by either package replays in the
other.

Every resilience number before this plane was proven against *synthetic*
traffic: the open-loop loadgen draws arrivals/prompts/sessions from a
seeded RNG, so "the workload" exists only as (generator code, seed).
This module makes a served workload itself the durable artifact — the
TF-paper's treatment of inputs as replayable data (arXiv:1605.08695
§4.4) applied to the serving plane's request lifecycles:

* **Record** (``python -m paddle_tpu_torch serve --record-trace day.ptt``, router tier
  too): every submitted request appends one framed record — arrival
  offset on the run's own clock, request id, the FULL source token ids
  (bit-determinism beats compactness here), ``max_new_tokens``,
  deadline, session id, priority class — and every cancel appends a
  cancel record.  The writer is append-only and CRC-framed so a crash
  mid-run leaves a *detectably* torn file, never a silently short one.
* **Replay** (``python -m paddle_tpu_torch serve --replay day.ptt``,
  :class:`TraceReplayLoadGen`): the recorded day re-offers against a
  changed build **bit-deterministically** — requests are built purely
  from the records (prompts, sessions, deadlines, priorities all come
  from the trace, never a live RNG — the affinity keys a fleet router
  derives are therefore identical) and arrivals follow the recorded
  offsets on a virtual arrival clock.

Format (text, one record per line, canonical JSON so that
read → re-serialize is **byte-identical** — the roundtrip contract):

.. code-block:: text

    #ptt1 {"meta":{...},"version":1}
    {"dl":0.25,"ev":"req","id":"r0","mnt":8,"o":0.0131,...}|9f3c2a01
    {"ev":"cancel","id":"r0","o":0.2,"reason":"client gave up"}|55aa0102
    #ptt-end {"crc":"c0ffee12","n":2}

Every record line carries its own crc32 suffix; the footer carries the
record count and the rolling crc over all record lines.  A missing
footer (torn write), a count/crc mismatch, or a corrupt line raises
:class:`TraceError` with structured fields — a truncated trace is a
*diagnosed* artifact, not a shorter workload.
"""

from __future__ import annotations

import json
import math
import os
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "TRACE_VERSION",
    "TraceError",
    "TraceWriter",
    "Trace",
    "read_trace",
    "serialize_trace",
    "arrival_stats",
    "TraceReplayLoadGen",
]

TRACE_VERSION = 1

_HEADER_TAG = "#ptt1 "
_FOOTER_TAG = "#ptt-end "

# canonical record schema: every request record carries ALL of these keys
# (None where absent) so serialization is shape-stable across writers
_REQ_KEYS = ("dl", "ev", "id", "mnt", "o", "prio", "sess", "src")


class TraceError(ValueError):
    """Structured trace-format rejection: ``path``/``line_no``/``reason``
    name exactly what is wrong (torn footer, crc mismatch, bad record)
    so a replay harness can report the artifact, not a stack trace."""

    def __init__(self, reason: str, *, path: Optional[str] = None,
                 line_no: Optional[int] = None):
        self.reason = reason
        self.path = path
        self.line_no = line_no
        where = path or "<trace>"
        at = f", line {line_no}" if line_no is not None else ""
        super().__init__(f"{where}{at}: {reason}")


def _dump(obj: Any) -> str:
    """The ONE canonical JSON serialization (sorted keys, no spaces):
    byte-identical re-serialization falls out of parse→_dump."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def _frame(payload: str) -> str:
    return f"{payload}|{zlib.crc32(payload.encode()):08x}"


def serialize_trace(records: List[Dict[str, Any]],
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Serialize ``records`` (+``meta``) to the full ``.ptt`` text —
    the writer and the roundtrip test share this one code path."""
    head = _HEADER_TAG + _dump(
        {"meta": meta or {}, "version": TRACE_VERSION}
    )
    lines = [head]
    rolling = 0
    for rec in records:
        line = _frame(_dump(rec))
        rolling = zlib.crc32((line + "\n").encode(), rolling)
        lines.append(line)
    foot = _FOOTER_TAG + _dump({"crc": f"{rolling:08x}", "n": len(records)})
    lines.append(foot)
    return "\n".join(lines) + "\n"


class TraceWriter:
    """Append-only ``.ptt`` writer.  Offsets default to the writer's own
    clock relative to its first record (the live-capture path); explicit
    ``offset_s`` makes deterministic traces (tests, converters).  The
    footer lands in :meth:`close` — an unclosed (crashed) writer leaves
    a file :func:`read_trace` rejects as torn, by design."""

    def __init__(self, path: str, meta: Optional[Dict[str, Any]] = None,
                 *, clock=time.perf_counter):
        self.path = str(path)
        self._clock = clock
        self._t0: Optional[float] = None
        self._n = 0
        self._rolling = 0
        self._closed = False
        self._f = open(self.path, "w")
        self._f.write(_HEADER_TAG + _dump(
            {"meta": meta or {}, "version": TRACE_VERSION}
        ) + "\n")
        self._f.flush()

    def _offset(self, offset_s: Optional[float]) -> float:
        if offset_s is not None:
            return float(offset_s)
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        return now - self._t0

    def _write(self, rec: Dict[str, Any]) -> None:
        if self._closed:
            raise TraceError("write on a closed TraceWriter",
                             path=self.path)
        line = _frame(_dump(rec))
        self._rolling = zlib.crc32((line + "\n").encode(), self._rolling)
        self._n += 1
        self._f.write(line + "\n")
        self._f.flush()

    def record_request(self, request, offset_s: Optional[float] = None,
                       ) -> Dict[str, Any]:
        """Append one request record from a serving ``Request``-shaped
        object (``src_ids``/``max_new_tokens``/``deadline_s``/
        ``session_id``/``priority`` duck-typed)."""
        rec = {
            "ev": "req",
            "o": round(self._offset(offset_s), 6),
            "id": str(request.req_id),
            "src": [int(t) for t in request.src_ids],
            "mnt": (int(request.max_new_tokens)
                    if request.max_new_tokens is not None else None),
            "dl": (float(request.deadline_s)
                   if request.deadline_s is not None else None),
            "sess": (str(request.session_id)
                     if getattr(request, "session_id", None) is not None
                     else None),
            "prio": int(getattr(request, "priority", 1)),
        }
        self._write(rec)
        return rec

    def record_cancel(self, req_id: str, offset_s: Optional[float] = None,
                      reason: str = "") -> Dict[str, Any]:
        rec = {
            "ev": "cancel",
            "o": round(self._offset(offset_s), 6),
            "id": str(req_id),
            "reason": str(reason),
        }
        self._write(rec)
        return rec

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._f.write(_FOOTER_TAG + _dump(
            {"crc": f"{self._rolling:08x}", "n": self._n}
        ) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Trace:
    """A parsed trace: ``meta`` + ordered ``records``.
    :meth:`serialize` re-emits the byte-identical file text."""

    def __init__(self, meta: Dict[str, Any],
                 records: List[Dict[str, Any]],
                 path: Optional[str] = None):
        self.meta = meta
        self.records = records
        self.path = path

    def requests(self) -> List[Dict[str, Any]]:
        return [r for r in self.records if r.get("ev") == "req"]

    def cancels(self) -> List[Dict[str, Any]]:
        return [r for r in self.records if r.get("ev") == "cancel"]

    def serialize(self) -> str:
        return serialize_trace(self.records, self.meta)

    def arrival_stats(self) -> Dict[str, Any]:
        return arrival_stats(self)

    def __len__(self) -> int:
        return len(self.records)


def _parse_line(raw: str, path: str, line_no: int) -> Dict[str, Any]:
    payload, sep, crc = raw.rpartition("|")
    if not sep:
        raise TraceError("record line has no crc frame",
                         path=path, line_no=line_no)
    if f"{zlib.crc32(payload.encode()):08x}" != crc:
        raise TraceError(
            f"record crc mismatch (stored {crc!r})",
            path=path, line_no=line_no,
        )
    try:
        rec = json.loads(payload)
    except ValueError as exc:
        raise TraceError(f"record is not valid JSON: {exc}",
                         path=path, line_no=line_no) from None
    if not isinstance(rec, dict) or "ev" not in rec or "o" not in rec:
        raise TraceError("record missing ev/o fields",
                         path=path, line_no=line_no)
    return rec


def read_trace(path: str) -> Trace:
    """Parse + validate a ``.ptt`` file.  Raises :class:`TraceError`
    on a torn/truncated/corrupt file — the replay contract is
    all-or-nothing, a partial workload is not a workload."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError as exc:
        raise TraceError(f"unreadable: {exc}", path=path) from None
    lines = text.splitlines()
    if not lines or not lines[0].startswith(_HEADER_TAG):
        raise TraceError("missing #ptt1 header (not a trace file)",
                         path=path, line_no=1)
    try:
        head = json.loads(lines[0][len(_HEADER_TAG):])
    except ValueError as exc:
        raise TraceError(f"header is not valid JSON: {exc}",
                         path=path, line_no=1) from None
    if head.get("version") != TRACE_VERSION:
        raise TraceError(
            f"unsupported trace version {head.get('version')!r} "
            f"(this reader speaks {TRACE_VERSION})",
            path=path, line_no=1,
        )
    if not text.endswith("\n"):
        raise TraceError("torn trace: last line has no newline "
                         "(crash mid-record)", path=path,
                         line_no=len(lines))
    if len(lines) < 2 or not lines[-1].startswith(_FOOTER_TAG):
        raise TraceError(
            "torn trace: missing #ptt-end footer (writer never closed)",
            path=path, line_no=len(lines),
        )
    try:
        foot = json.loads(lines[-1][len(_FOOTER_TAG):])
    except ValueError as exc:
        raise TraceError(f"footer is not valid JSON: {exc}",
                         path=path, line_no=len(lines)) from None
    body = lines[1:-1]
    records: List[Dict[str, Any]] = []
    rolling = 0
    for i, raw in enumerate(body):
        rec = _parse_line(raw, path, i + 2)
        rolling = zlib.crc32((raw + "\n").encode(), rolling)
        records.append(rec)
    if foot.get("n") != len(records):
        raise TraceError(
            f"truncated trace: footer declares {foot.get('n')} records, "
            f"file holds {len(records)}",
            path=path, line_no=len(lines),
        )
    if foot.get("crc") != f"{rolling:08x}":
        raise TraceError(
            f"trace body crc mismatch (footer {foot.get('crc')!r})",
            path=path, line_no=len(lines),
        )
    last = -math.inf
    for i, rec in enumerate(records):
        if float(rec["o"]) < last - 1e-9:
            raise TraceError(
                f"arrival offsets not monotonic at record {i}",
                path=path, line_no=i + 2,
            )
        last = float(rec["o"])
    return Trace(head.get("meta", {}), records, path=path)


def arrival_stats(trace: Trace) -> Dict[str, Any]:
    """Arrival-process reconstruction from a recorded trace: count,
    span, mean rate and the inter-arrival coefficient of variation —
    the statistic that separates the loadgen's processes (uniform
    CV→0, Poisson CV→1, burst CV>1), so a recorded workload's process
    is checkable without the generator that made it."""
    offs = [float(r["o"]) for r in trace.requests()]
    n = len(offs)
    if n < 2:
        return {"n": n, "span_s": 0.0, "rate_rps": 0.0, "cv": 0.0,
                "gap_mean_s": 0.0, "gap_std_s": 0.0}
    gaps = [b - a for a, b in zip(offs, offs[1:])]
    mean = sum(gaps) / len(gaps)
    var = sum((g - mean) ** 2 for g in gaps) / len(gaps)
    std = math.sqrt(var)
    span = offs[-1] - offs[0]
    return {
        "n": n,
        "span_s": span,
        "rate_rps": (n - 1) / span if span > 0 else 0.0,
        "cv": std / mean if mean > 0 else 0.0,
        "gap_mean_s": mean,
        "gap_std_s": std,
    }


def _default_factory(rec: Dict[str, Any]):
    """Build a serving ``Request`` purely from a trace record — prompts,
    session, deadline, priority ALL come from the record (never a live
    RNG): the replayed day reproduces the same affinity keys."""
    from paddle_tpu_torch.serving.scheduler import Request

    return Request(
        list(rec["src"]),
        rec.get("mnt"),
        req_id=str(rec["id"]),
        deadline_s=rec.get("dl"),
        session_id=rec.get("sess"),
        priority=int(rec.get("prio", 1)),
    )


class TraceReplayLoadGen:
    """Open-loop replay of a recorded trace: arrivals follow the
    recorded offsets on a fresh virtual arrival clock (``speedup``
    compresses/stretches them uniformly); requests are built by
    ``request_factory(record)`` (default: a serving ``Request`` built
    purely from the record).  Mirrors ``OpenLoopLoadGen.run`` —
    ``submit(request)`` per arrival, bounded-poll sleeps (C306),
    ``stop()`` truncation — plus ``cancel(req_id, reason)`` callbacks
    at the recorded cancel offsets."""

    def __init__(
        self,
        trace: Trace,
        *,
        request_factory: Optional[
            Callable[[Dict[str, Any]], Any]] = None,
        speedup: float = 1.0,
        clock=time.perf_counter,
        sleep=time.sleep,
    ):
        if speedup <= 0:
            raise ValueError("speedup must be > 0")
        self.trace = trace
        self.request_factory = (
            request_factory if request_factory is not None
            else _default_factory
        )
        self.speedup = float(speedup)
        self._clock = clock
        self._sleep = sleep

    @property
    def offered_duration_s(self) -> float:
        recs = self.trace.records
        return float(recs[-1]["o"]) / self.speedup if recs else 0.0

    def run(
        self,
        submit: Callable[[Any], Any],
        stop: Optional[Callable[[], bool]] = None,
        cancel: Optional[Callable[[str, str], Any]] = None,
    ) -> List[Any]:
        submitted: List[Any] = []
        t0 = self._clock()
        for rec in self.trace.records:
            at = float(rec["o"]) / self.speedup
            while True:
                if stop is not None and stop():
                    return submitted
                delay = (t0 + at) - self._clock()
                if delay <= 0:
                    break
                self._sleep(min(delay, 0.05))
            if rec["ev"] == "req":
                submitted.append(submit(self.request_factory(rec)))
            elif rec["ev"] == "cancel" and cancel is not None:
                cancel(str(rec["id"]), rec.get("reason", ""))
        return submitted
