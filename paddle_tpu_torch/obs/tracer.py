"""Span tracer — the cross-process timeline recorder of the obs plane.

The reference visualizes a distributed step end-to-end (the TensorFlow
paper treats the timeline as a first-class system component, arXiv:
1605.08695 §5; the reference's own host plane is Stat.h/REGISTER_TIMER
printed per log_period).  ``StatSet`` aggregates *how much* time each
host phase costs; this module records *what happened when, in which
process, to which request* — the question every scenario drill and
failover postmortem actually asks.

Design:

* **Per-thread bounded ring buffers** of begin/end/instant events.  One
  ``deque(maxlen=ring_events)`` per thread, appended under one short
  lock hold (~micro-seconds against the milliseconds-scale dispatches it
  instruments); memory is bounded by ``threads x ring_events`` events —
  the recorder can stay armed in production forever (the flight
  recorder).
* **Monotonic clock only** (injectable for tests).  Wall clock must
  never stamp a span — NTP steps would fold spans backward in time;
  the JAX package's self-lint rule A205 holds its copy to this.  One wall-clock *anchor* pair is recorded at
  init (pragma'd) purely so the merger can coarse-align processes that
  share no RPC edge.
* **Chrome-trace-event JSON** (``dump``): the per-process file opens
  directly in Perfetto / chrome://tracing.  Events carry ``ph`` (B/E/i),
  ``ts`` (µs), ``pid``, ``tid``, ``name``, ``cat`` (the plane: trainer /
  serving / master / rpc / elastic) and ``args`` — correlation ids
  (``req`` for a serving request, ``task`` for an elastic task, ``rpc``
  for an RPC exchange) ride in ``args`` so one request's
  submit→queued→admit→prefill→decode→deliver spans line up across
  processes after ``python -m paddle_tpu_torch trace merge``.
* **Trace context**: trace id (inherited from ``PADDLE_TPU_TORCH_TRACE_ID`` so
  a launcher's whole process tree shares one), pid, and a process
  ``role`` (trainer / worker / master / serve) stamped by each CLI
  entry point.
* **Profiler nesting**: a device profiler may install an annotation
  factory (e.g. ``torch.profiler.record_function``) so every host span
  also appears on the device timeline under the same name.  The factory
  is *injected* — this module never imports torch (master.py and the
  numpy elastic plane stay import-light).
* **Flight recorder**: recording is on by default (``flight_recorder``
  flag) at bounded memory; :func:`flight_dump` writes the last events
  to ``flight-<pid>.json`` — wired to SIGUSR1, every firing chaos point
  (robustness/chaos.py), the divergence sentinel, and the serving
  scheduler's crash guard, so a kill -9 fleet drill leaves postmortem
  timelines from the survivors.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from paddle_tpu_torch.analysis.lock_sanitizer import make_lock

__all__ = [
    "Tracer",
    "tracer",
    "span",
    "instant",
    "next_rpc_id",
    "flight_dump",
]

_log = logging.getLogger("paddle_tpu_torch.obs")

_US = 1e6

# process-wide RPC correlation counter (rpc ids must be unique per process;
# the pid prefix makes them unique per RUN, so the merger can pair one
# client call with one server handling across trace files)
_rpc_counter = itertools.count()


def next_rpc_id() -> str:
    return f"{os.getpid()}-{next(_rpc_counter)}"


class Tracer:
    """Process-wide span recorder.  One instance (the module singleton
    ``tracer``) serves every plane; tests build private instances with an
    injected clock."""

    def __init__(self, clock=time.monotonic, ring_events: Optional[int] = None):
        from paddle_tpu_torch.utils import flags as _flags

        self._clock = clock  # monotonic by contract (rule A205)
        self._lock = make_lock("obs-tracer")
        # tid -> deque of (ph, ts_us, name, cat, args); guarded by _lock
        self._rings: Dict[int, collections.deque] = {}
        self._thread_names: Dict[int, str] = {}  # guarded by _lock
        self._ring_events = int(
            ring_events if ring_events is not None
            else _flags.get_flag("trace_ring_events")
        )
        self._recording = bool(_flags.get_flag("flight_recorder"))
        self._annotation_factory = None  # injected by utils.profiler
        self.role = "proc"
        self.pid = os.getpid()
        self.trace_id = os.environ.get(
            "PADDLE_TPU_TORCH_TRACE_ID", f"t{self.pid:x}"
        )
        self._export_dir: Optional[str] = None
        self._atexit_registered = False
        # one wall-clock anchor so `trace merge` can coarse-align processes
        # that share no RPC edge; NEVER used to stamp a span (A205)
        self._anchor_mono_us = self._clock() * _US
        self._anchor_wall_us = time.time() * _US  # obs: allow-wall-clock one-time merge anchor, never a span timestamp

    # -- arming ----------------------------------------------------------
    @property
    def recording(self) -> bool:
        return self._recording

    def set_recording(self, on: bool) -> None:
        """Arm/disarm the ring recorder (the bench's A/B lever).  Off =
        every emit is one attribute read."""
        self._recording = bool(on)

    @property
    def exporting(self) -> bool:
        return self._export_dir is not None

    @property
    def export_dir(self) -> Optional[str]:
        return self._export_dir

    def set_annotation_factory(self, factory) -> None:
        """Install a context-manager factory (a device profiler's
        annotation) that every span nests under — host and device
        timelines then share names."""
        self._annotation_factory = factory

    def configure(
        self,
        role: Optional[str] = None,
        trace_dir: Optional[str] = None,
        trace_id: Optional[str] = None,
        install_sigusr1: bool = True,
    ) -> None:
        """Adopt the process trace context.  Called once by each CLI entry
        point (train → trainer, worker, master, serve); ``trace_dir``
        defaults to the ``trace_dir`` flag (env
        ``PADDLE_TPU_TORCH_TRACE_DIR`` reaches subprocesses), and a non-empty
        dir arms EXPORT: the process dumps its Chrome-trace file there at
        exit (atexit — a kill -9 leaves only the flight recorder).

        The recorder flags are RE-READ here: the singleton froze
        ``flight_recorder``/``trace_ring_events`` at first import, so a
        ``set_flag`` between import and the CLI entry (the same runtime
        pattern ``trace_dir`` supports) takes effect now.  A changed ring
        size applies to rings created from here on."""
        from paddle_tpu_torch.utils import flags as _flags

        self._recording = bool(_flags.get_flag("flight_recorder"))
        self._ring_events = int(_flags.get_flag("trace_ring_events"))
        if role is not None:
            self.role = role
        if trace_id is not None:
            self.trace_id = trace_id
        if trace_dir is None:
            trace_dir = _flags.get_flag("trace_dir")
        if trace_dir:
            self._export_dir = trace_dir
            if not self._atexit_registered:
                self._atexit_registered = True
                atexit.register(self._atexit_dump)
        if install_sigusr1:
            self._install_sigusr1()

    def _install_sigusr1(self) -> None:
        import signal

        def _handler(signum, frame):
            # the handler runs on the MAIN thread between bytecodes — if
            # the signal lands inside _emit's lock hold (any hot-path
            # span), dumping synchronously would self-deadlock on the
            # non-reentrant tracer lock.  A side thread takes the lock
            # only once the interrupted frame releases it.
            threading.Thread(
                target=self.flight_dump, args=("SIGUSR1",),
                name="paddle-obs-flight", daemon=True,
            ).start()

        try:
            if signal.getsignal(signal.SIGUSR1) in (
                signal.SIG_DFL, signal.SIG_IGN,
            ):
                signal.signal(signal.SIGUSR1, _handler)
        except (ValueError, AttributeError, OSError):
            # not the main thread, or a platform without SIGUSR1
            pass

    def _atexit_dump(self) -> None:
        try:
            self.dump()
        except Exception:  # noqa: BLE001 — exit path must never raise
            _log.exception("trace export at exit failed")

    # -- recording -------------------------------------------------------
    def _emit(self, ph: str, name: str, cat: str,
              args: Optional[Dict[str, Any]]) -> None:
        if not self._recording:
            return
        ts_us = self._clock() * _US
        tid = threading.get_ident()
        with self._lock:
            ring = self._rings.get(tid)
            if ring is None:
                ring = collections.deque(maxlen=self._ring_events)
                self._rings[tid] = ring
                self._thread_names[tid] = threading.current_thread().name
            ring.append((ph, ts_us, name, cat, args))

    def instant(self, name: str, cat: str = "host", **args: Any) -> None:
        """One point-in-time event (ph 'i') — lifecycle transitions
        (submit / shed / fence-release) that have no duration."""
        self._emit("i", name, cat, args or None)

    def begin(self, name: str, cat: str = "host", **args: Any) -> None:
        self._emit("B", name, cat, args or None)

    def end(self, name: str, cat: str = "host") -> None:
        self._emit("E", name, cat, None)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", **args: Any) -> Iterator[None]:
        """Scoped begin/end pair.  Disarmed cost: one attribute read and a
        generator frame — cheap enough to leave on hot paths."""
        if not self._recording:
            yield
            return
        ann = self._annotation_factory
        ctx = ann(name) if ann is not None else None
        self._emit("B", name, cat, args or None)
        if ctx is not None:
            ctx.__enter__()
        try:
            yield
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
            self._emit("E", name, cat, None)

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
            self._thread_names.clear()

    # -- export ----------------------------------------------------------
    def _snapshot(self):
        with self._lock:
            rings = {tid: list(ring) for tid, ring in self._rings.items()}
            names = dict(self._thread_names)
        return rings, names

    def events(self) -> List[Dict[str, Any]]:
        """Chrome-trace-event dicts of everything currently in the rings,
        time-sorted, metadata (process/thread names) first."""
        rings, names = self._snapshot()
        evs: List[Dict[str, Any]] = []
        for tid, ring in rings.items():
            for ph, ts_us, name, cat, args in ring:
                ev: Dict[str, Any] = {
                    "ph": ph,
                    "ts": round(ts_us, 3),
                    "pid": self.pid,
                    "tid": tid,
                    "name": name,
                    "cat": cat,
                }
                if args:
                    ev["args"] = dict(args)
                evs.append(ev)
        evs.sort(key=lambda e: e["ts"])
        meta = [{
            "ph": "M", "name": "process_name", "pid": self.pid, "tid": 0,
            "ts": 0,
            "args": {"name": f"{self.role} (pid {self.pid})"},
        }]
        meta.extend({
            "ph": "M", "name": "thread_name", "pid": self.pid, "tid": tid,
            "ts": 0, "args": {"name": names.get(tid, str(tid))},
        } for tid in sorted(rings))
        return meta + evs

    def trace_object(self, reason: Optional[str] = None) -> Dict[str, Any]:
        obj: Dict[str, Any] = {
            "traceEvents": self.events(),
            "otherData": {
                "trace_id": self.trace_id,
                "role": self.role,
                "pid": self.pid,
                "clock_anchor": {
                    "mono_us": self._anchor_mono_us,
                    "wall_us": self._anchor_wall_us,
                },
            },
        }
        if reason is not None:
            obj["otherData"]["reason"] = reason
        return obj

    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Write this process's Chrome-trace JSON.  Default path:
        ``<trace_dir>/trace-<role>-<pid>.json``; None (nothing written)
        when neither a path nor an export dir is armed."""
        if path is None:
            if self._export_dir is None:
                return None
            path = os.path.join(
                self._export_dir, f"trace-{self.role}-{self.pid}.json"
            )
        obj = self.trace_object()
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.{self.pid}.tmp"
            with open(tmp, "w") as f:
                # default=str: an exotic span arg (numpy scalar, path
                # object) degrades to its repr instead of losing the dump
                json.dump(obj, f, default=str)
            os.replace(tmp, path)
        except OSError as exc:
            _log.warning("trace dump %s unwritable: %s", path, exc)
            return None
        return path

    def flight_dump(self, reason: str,
                    extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Postmortem: the ring buffers' last events to
        ``flight-<pid>.json`` (under the ``trace_dir`` flag when set,
        else the system temp dir — never the working directory).  Safe
        from signal handlers and except blocks; never raises.  ``extra``
        merges into ``otherData`` — the numerics sanitizer rides its
        first-non-finite-eqn postmortem here (``otherData.numerics``)."""
        try:
            from paddle_tpu_torch.utils import flags as _flags

            d = (
                self._export_dir
                or _flags.get_flag("trace_dir")
                or tempfile.gettempdir()
            )
            path = os.path.join(d, f"flight-{self.pid}.json")
            obj = self.trace_object(reason=reason)
            if extra:
                obj["otherData"].update(extra)
            os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(obj, f, default=str)
            _log.warning(
                "flight recorder: dumped %d event(s) to %s (%s)",
                sum(1 for e in obj["traceEvents"] if e["ph"] != "M"),
                path, reason,
            )
            return path
        except Exception:  # noqa: BLE001 — a postmortem must never crash
            _log.exception("flight dump failed (%s)", reason)
            return None


# the process singleton + module-level conveniences every plane imports
tracer = Tracer()
span = tracer.span
instant = tracer.instant
flight_dump = tracer.flight_dump
