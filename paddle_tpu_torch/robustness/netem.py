"""Fault-injecting transport wrapper — the network itself as a chaos point.

The chaos harness (robustness/chaos.py) can kill a process but could not
touch a MESSAGE: production networks delay, drop, duplicate, reorder,
corrupt and partition, and the reference pserver's LightNetwork layer
treats all of that as routine input (retry/timeout over epoll/RDMA,
paddle/pserver/SocketChannel.cpp).  This module arms those faults on the
master RPC plane: :func:`maybe_wrap` wraps a ``multiprocessing.connection``
Connection in a :class:`FaultyConnection` whenever a ``net_*`` chaos point
is armed, so Server/Client/HAClient — and every subprocess fleet that
inherits ``PADDLE_TPU_TORCH_CHAOS`` through its environment — transparently ride
a hostile network.

Fault points (armed via the ``--chaos`` spec / ``PADDLE_TPU_TORCH_CHAOS``; the
``@occurrence`` counts egress messages per point, process-wide)::

    net_delay      hold the message for NETEM_DELAY_MS (+ uniform jitter
                   of NETEM_JITTER_MS) before sending
    net_drop       silently discard the message (the peer's deadline path
                   must detect and retry)
    net_dup        send the message TWICE (at-least-once delivery drill:
                   the server must dedupe, the client must discard the
                   stale duplicate reply by sequence number)
    net_reorder    hold the message back and release it AFTER the next one
    net_corrupt    flip a byte inside the wire frame (the CRC must reject;
                   the payload must never deserialize)
    net_drip       bandwidth emulation: sleep len/NETEM_DRIP_KBPS before
                   the message leaves (a 64 KB/s trickle makes a multi-MB
                   payload a multi-second stall)
    net_partition  from the firing consultation on, the link is DOWN for
                   NETEM_PARTITION_SECS in the configured DIRECTION —
                   egress dropped (``send``), ingress discarded (``recv``),
                   or both.  One-sided arming (only one process carries the
                   chaos env) + a single direction = a genuinely ASYMMETRIC
                   partition: requests arrive, replies vanish.

Environment knobs (the ``PADDLE_TPU_TORCH_CHAOS_HANG_SECS`` convention)::

    PADDLE_TPU_TORCH_NETEM_DELAY_MS        per-message delay (default 50)
    PADDLE_TPU_TORCH_NETEM_JITTER_MS       uniform jitter on top (default 0)
    PADDLE_TPU_TORCH_NETEM_PARTITION_SECS  partition duration (default 2)
    PADDLE_TPU_TORCH_NETEM_DIRECTION       send | recv | both (default both;
                                     partitions only — per-message faults
                                     inject on egress, the tc-netem model)
    PADDLE_TPU_TORCH_NETEM_DRIP_KBPS       drip bandwidth (default 64)
    PADDLE_TPU_TORCH_NETEM_ROLE            client | server | both (default both):
                                     which side of a connection injects —
                                     lets one process drill "responses
                                     lost" vs "requests lost"

Faults are injected ABOVE the transport's own message framing (the frame
bytes are mutated/dropped/replayed whole), so a corrupt message is exactly
what media rot or a buggy middlebox produces: an intact delivery whose
CONTENT is damaged — the master_wire CRC's job.  Partition state is
process-global (a host loses its link, not one socket): a client that
times out, hangs up, and re-dials stays partitioned on the fresh
connection until the window elapses.

Unarmed cost is zero: :func:`maybe_wrap` returns the raw connection
untouched unless a ``net_*`` point is armed at wrap time.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np

from paddle_tpu_torch.analysis.lock_sanitizer import make_lock
from paddle_tpu_torch.master_wire import _Counters
from paddle_tpu_torch.robustness import chaos as _chaos

__all__ = [
    "NETEM_POINTS",
    "FaultyConnection",
    "maybe_wrap",
    "active_points",
    "counters",
    "last_partition_start",
    "reset",
]

_log = logging.getLogger("paddle_tpu_torch.robustness.netem")

NETEM_POINTS = frozenset({
    "net_delay", "net_drop", "net_dup", "net_reorder", "net_corrupt",
    "net_drip", "net_partition",
})

# process-global link state: one partition covers every wrapped connection
# (and every FUTURE connection — a re-dial does not heal a dead link)
_state_lock = make_lock("netem.state")
_partition_until = 0.0
_partition_started = 0.0  # wall-clock stamp drills measure recovery from


def reset() -> None:
    """Clear link state + counters (test/drill teardown)."""
    global _partition_until, _partition_started
    with _state_lock:
        _partition_until = 0.0
        _partition_started = 0.0
    counters.reset()


def last_partition_start() -> float:
    """Wall-clock time the most recent partition began (0.0 = never) —
    the zero point of a drill's recovery-after-partition metric."""
    with _state_lock:
        return _partition_started


def _start_partition(duration_s: float, clock) -> None:
    global _partition_until, _partition_started
    with _state_lock:
        _partition_until = clock() + duration_s
        _partition_started = time.time()
    _log.warning("netem: partition begins for %.2fs", duration_s)


def _partition_active(clock) -> bool:
    with _state_lock:
        return clock() < _partition_until


def active_points() -> frozenset:
    """The armed ``net_*`` subset of the chaos spec."""
    return _chaos.armed_points() & NETEM_POINTS


# the same thread-safe counter table the wire codec uses (one
# implementation; master_wire only imports lock_sanitizer, so no cycle)
counters = _Counters("netem.counters")


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class FaultyConnection:
    """One wrapped Connection.  Per-message faults inject on EGRESS
    (``send_bytes``) — the tc-netem qdisc model — and the process-global
    partition gates both directions per ``PADDLE_TPU_TORCH_NETEM_DIRECTION``.

    The wrapper is used under the same single-threaded-per-connection
    discipline as the raw Connection (the server's per-conn handler
    thread; the client's ``_conn_lock``), so per-connection fault state
    (the reorder stash) needs no lock of its own."""

    def __init__(self, conn, role: str, clock=time.monotonic,
                 sleep=time.sleep, seed: Optional[int] = None):
        self._conn = conn
        self._role = role
        self._clock = clock
        self._sleep = sleep
        self._rng = np.random.RandomState(
            int(os.environ.get("PADDLE_TPU_TORCH_NETEM_SEED", "0"))
            if seed is None else seed
        )
        self._delay_s = _env_f("PADDLE_TPU_TORCH_NETEM_DELAY_MS", 50.0) / 1e3
        self._jitter_s = _env_f("PADDLE_TPU_TORCH_NETEM_JITTER_MS", 0.0) / 1e3
        self._partition_s = _env_f("PADDLE_TPU_TORCH_NETEM_PARTITION_SECS", 2.0)
        self._drip_bps = _env_f("PADDLE_TPU_TORCH_NETEM_DRIP_KBPS", 64.0) * 1024.0
        self._direction = os.environ.get("PADDLE_TPU_TORCH_NETEM_DIRECTION", "both")
        self._reorder_stash: Optional[bytes] = None

    # -- direction / partition gates -------------------------------------
    def _partitioned(self, direction: str) -> bool:
        if not _partition_active(self._clock):
            return False
        return self._direction in ("both", direction)

    def _consult_partition(self) -> None:
        """Consulted on EGRESS only (the ``@occurrence`` grammar counts
        messages leaving this process); the ingress paths merely OBSERVE
        the link state the egress consultation established."""
        if _chaos.fire("net_partition") and not _partition_active(self._clock):
            _start_partition(self._partition_s, self._clock)

    # -- egress ----------------------------------------------------------
    def send_bytes(self, data: bytes) -> None:
        self._consult_partition()
        if self._partitioned("send"):
            counters.incr("partition_dropped")
            return  # the link ate it; the peer's deadline path finds out
        if _chaos.fire("net_drop"):
            counters.incr("dropped")
            return
        if _chaos.fire("net_delay"):
            counters.incr("delayed")
            self._sleep(
                self._delay_s + self._jitter_s * float(self._rng.rand())
            )
        if _chaos.fire("net_drip"):
            counters.incr("dripped")
            self._sleep(len(data) / max(self._drip_bps, 1.0))
        if _chaos.fire("net_corrupt"):
            counters.incr("corrupted")
            data = self._flip_byte(data)
        if _chaos.fire("net_reorder") and self._reorder_stash is None:
            counters.incr("reordered")
            self._reorder_stash = bytes(data)
            return  # held back; released after the NEXT message
        self._conn.send_bytes(data)
        if self._reorder_stash is not None:
            stash, self._reorder_stash = self._reorder_stash, None
            self._conn.send_bytes(stash)
        if _chaos.fire("net_dup"):
            counters.incr("duplicated")
            self._conn.send_bytes(data)

    def _flip_byte(self, data: bytes) -> bytes:
        if not data:
            return data
        buf = bytearray(data)
        # aim past the 12-byte wire header when the frame allows: payload
        # rot is the classic case (the CRC catches header rot identically)
        lo = 12 if len(buf) > 13 else 0
        i = int(self._rng.randint(lo, len(buf)))
        buf[i] ^= 0xFF
        return bytes(buf)

    # -- ingress ---------------------------------------------------------
    def _discard_arrivals(self, maxlength: Optional[int]) -> None:
        """Messages that land while the ingress is partitioned were lost
        on the real link: read and drop them so a heal never delivers
        stale traffic."""
        while self._conn.poll(0):
            try:
                self._conn.recv_bytes(maxlength)
            except OSError:
                return  # oversize/closed: the transport already tore it down
            counters.incr("partition_discarded")

    def recv_bytes(self, maxlength: Optional[int] = None) -> bytes:
        while self._partitioned("recv"):
            self._discard_arrivals(maxlength)
            self._sleep(0.02)
        return self._conn.recv_bytes(maxlength)

    def poll(self, timeout: float = 0.0) -> bool:
        deadline = self._clock() + max(timeout or 0.0, 0.0)
        while self._partitioned("recv"):
            self._discard_arrivals(None)
            if self._clock() >= deadline:
                return False
            self._sleep(min(0.02, max(deadline - self._clock(), 0.001)))
        return self._conn.poll(max(deadline - self._clock(), 0.0))

    # -- passthrough -----------------------------------------------------
    def __getattr__(self, name: str):
        # close / fileno / closed / send — everything unfaulted delegates
        return getattr(self._conn, name)


def maybe_wrap(conn, role: str):
    """Wrap ``conn`` when any ``net_*`` chaos point is armed for this
    process AND ``PADDLE_TPU_TORCH_NETEM_ROLE`` covers ``role`` ("client" dials,
    "server" accepts).  Unarmed: returns ``conn`` untouched — zero cost."""
    if not active_points():
        return conn
    want = os.environ.get("PADDLE_TPU_TORCH_NETEM_ROLE", "both")
    if want not in ("both", role):
        return conn
    return FaultyConnection(conn, role)
