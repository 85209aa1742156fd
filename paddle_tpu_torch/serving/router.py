"""Serving-fleet router — the counterpart of ``paddle_tpu/serving/router.py``
(no torch at module level): an SLO-aware, affinity-routing frontend over N
engines.  Its RPCs, method whitelists, affinity keys and journal are the
JAX package's, so a port router routes to a JAX ``EngineAgent`` (and the
reverse) and a journal written by either package recovers in the other.

One scheduler over one engine caps the serving plane at single-process
throughput.  This module is the router tier: the reference's
control/data-plane split (Go master over C++ pservers) applied to serving —
a router process owns ADMISSION (deadlines, bounded queue, shed: the
``ServingScheduler`` semantics lifted one tier) and dispatches over N
``ServingEngine`` processes, each wrapped by an :class:`EngineAgent`.

The planes, and what each reuses:

* **control plane** — engines register on heartbeat LEASES (the master
  cluster plane's worker-registry discipline, ``master.Service
  register_worker/heartbeat/_prune_workers``): an engine silent past
  ``router_lease_timeout_s`` is pruned and its traffic re-routes to the
  survivors — a SIGKILLed engine costs one lease timeout, not the fleet.
* **data plane** — every RPC (register/heartbeat, serve, stats, drain)
  rides the typed wire codec (``master_wire``) through ``master.Server``/``Client``
  (their ``methods=`` whitelists): requests and results are typed arrays,
  hostile frames are structured rejects, and the netem/chaos transport
  injects faults for free.
* **routing policy** — least-predicted-wait: each engine's scheduler
  exports its queue depth, pages in use and EWMA predicted wait over ONE
  typed stats RPC (``ServingScheduler.export_stats``, the
  ``write_stats_json`` record shape — no Prometheus scrape); the router
  polls these and scores candidates as ``predicted_wait + inflight *
  est_service / slots`` (router-side in-flight count covers staleness
  between polls).  PREFIX/SESSION AFFINITY: the request's session id (or
  the prefix-cache block-chain key of its prompt) rendezvous-hashes
  to a preferred engine, so shared-prefix traffic concentrates where the
  COW blocks already live — a direct hit-rate multiplier.  Affinity is
  overridden when the preferred engine's score trails the best by more
  than ``router_affinity_slack_s``: affinity must never defeat balance.
* **idempotent ack plane** — a journal-backed request LEDGER (per-request
  ids, JSON lines, append + flush) makes finalization first-writer-wins:
  a duplicate result delivery (an at-least-once re-route whose first
  attempt actually executed, a replayed ack) is counted and DISCARDED —
  zero double-served requests, across router failover too (a new router
  recovering the journal refuses to re-serve finalized ids).
* **drain-aware rolling restart** — :meth:`Router.drain_engine` marks the
  engine excluded-from-routing, forwards the scheduler's ``drain()`` protocol
  over the wire, and waits out the router-side in-flight count, so an
  operator can drain+replace every engine one at a time with the fleet
  never below N-1 serving members.
* **autoscaling hook** — sustained shed rate over a sliding window calls
  a ``spawn`` callback; a sustained-idle fleet above the floor calls
  ``retire`` (the callbacks own process management; the router only
  decides WHEN).

Fast units drive the policy in-process (``address=None``,
``client_factory=`` fakes); the process drills run real engine
subprocesses (``python -m paddle_tpu_torch serve --register``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from collections import deque
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch import master as _master
from paddle_tpu_torch import obs as _obs
from paddle_tpu_torch.analysis.diagnostics import protocol_error
from paddle_tpu_torch.analysis.lock_sanitizer import THREAD_PREFIX, make_lock
from paddle_tpu_torch.serving.scheduler import (
    TERMINAL_STATUSES, Request, percentile, status_counts,
)

__all__ = [
    "ROUTER_METHODS",
    "ENGINE_METHODS",
    "affinity_key",
    "rendezvous_pick",
    "Router",
    "EngineAgent",
    "FleetClient",
]

_log = logging.getLogger("paddle_tpu_torch.serving")

# RPC whitelists (the master ``_METHODS`` discipline, one per plane):
# engines + operators call the router's surface; the router calls the
# engine agent's.  Anything else is a structured reject, never a dispatch.
ROUTER_METHODS = (
    "register_engine", "heartbeat", "deregister_engine", "live_engines",
    "serve", "fleet_stats", "drain_engine", "ping",
)
ENGINE_METHODS = ("serve", "stats", "drain", "ping")

# terminal statuses the fleet ledger counts — a REFERENCE to the
# scheduler's declared disjoint set, never a copied literal (lint P503
# flags any parallel status-set literal that drifts from the declaration)
_TERMINAL = TERMINAL_STATUSES


def affinity_key(src_ids: Sequence, session_id: Optional[str] = None,
                 block_tokens: int = 16) -> Optional[str]:
    """The affinity-routing key of a request: its ``session_id`` when
    present (conversation stickiness), else the PREFIX BLOCK-CHAIN key of
    the prompt — the prefix cache's arithmetic (chained per-block
    hashes over whole ``block_tokens`` blocks) with a process-independent
    hash, so every router incarnation maps the same prompt head to the
    same engine.  Prompts shorter than one block key on their full
    tokens; a malformed prompt (validation will reject it) keys None."""
    if session_id:
        return f"sess:{session_id}"
    try:
        toks = [int(t) for t in src_ids]
    except (TypeError, ValueError, OverflowError):
        return None
    if not toks:
        return None
    head = toks[:block_tokens * max(1, len(toks) // block_tokens)] or toks
    h = 0
    for b in range(0, len(head), block_tokens):
        block = head[b:b + block_tokens]
        h = zlib.crc32(",".join(map(str, block)).encode(), h)
    return f"blk:{h:08x}"


def rendezvous_pick(key: str, engine_ids: Sequence[str]) -> Optional[str]:
    """Highest-random-weight (rendezvous) choice of the preferred engine
    for ``key``: stable per (key, engine set), and an engine joining or
    leaving only moves the keys that hashed to it — no global reshuffle
    of warm prefix caches."""
    if not engine_ids:
        return None
    return max(
        engine_ids,
        key=lambda e: (zlib.crc32(f"{key}|{e}".encode()), e),
    )


class _EngineHandle:
    """Router-side view of one registered engine: address, lease, the
    latest polled stats snapshot, and the router's own in-flight count
    (covers snapshot staleness between polls)."""

    def __init__(self, engine_id: str, address: Tuple[str, int]):
        self.engine_id = engine_id
        self.address = (str(address[0]), int(address[1]))
        self.lease_deadline = 0.0
        self.draining = False
        self.stats: Dict[str, Any] = {}
        self.inflight = 0
        self.served = 0

    def view(self) -> Dict[str, Any]:
        return {
            "engine_id": self.engine_id,
            "address": list(self.address),
            "draining": bool(self.draining),
            "inflight": int(self.inflight),
            "served": int(self.served),
            "stats": dict(self.stats),
        }


class Router:
    """The fleet frontend.  RPC surface = :data:`ROUTER_METHODS` (served
    by ``master.Server`` when ``address`` is given; fast units call the
    methods in-process with ``address=None``).

    ``client_factory(address, call_timeout_s)`` builds the router->engine
    data-plane client (default: ``master.Client`` with the
    :data:`ENGINE_METHODS` whitelist) — injectable, so the policy units
    run against fake engines with scripted stats and no sockets.

    ``journal_path``: append-only JSON-lines routing journal.  Passing a
    path holding a previous incarnation's journal RECOVERS the request
    ledger first — the HA-failover half of the zero-double-serve
    contract."""

    def __init__(
        self,
        *,
        address: Optional[Tuple[str, int]] = ("127.0.0.1", 0),
        authkey: bytes = b"paddle-tpu",
        lease_timeout_s: Optional[float] = None,
        queue_limit: Optional[int] = None,
        default_deadline_s: Optional[float] = None,
        affinity: Optional[bool] = None,
        affinity_slack_s: Optional[float] = None,
        stats_poll_s: Optional[float] = None,
        call_timeout_s: Optional[float] = None,
        journal_path: Optional[str] = None,
        clock=time.monotonic,
        sleep=time.sleep,
        stats=None,
        client_factory: Optional[Callable] = None,
    ):
        from paddle_tpu_torch.utils import flags as _flags
        from paddle_tpu_torch.utils.timers import global_stats

        def _flag(v, name):
            return v if v is not None else _flags.get_flag(name)

        self.lease_timeout_s = float(
            _flag(lease_timeout_s, "router_lease_timeout_s"))
        self.queue_limit = int(_flag(queue_limit, "router_queue_limit"))
        self.default_deadline_s = float(
            _flag(default_deadline_s, "serving_default_deadline_s"))
        self.affinity = bool(_flag(affinity, "router_affinity"))
        self.affinity_slack_s = float(
            _flag(affinity_slack_s, "router_affinity_slack_s"))
        self.stats_poll_s = float(_flag(stats_poll_s, "router_stats_poll_s"))
        self.call_timeout_s = float(
            _flag(call_timeout_s, "router_call_timeout_s"))
        self._block_tokens = int(_flags.get_flag("serving_block_tokens"))
        self._clock = clock
        self._sleep = sleep  # injectable per the C306 discipline
        self._stats = stats if stats is not None else global_stats
        self._authkey = authkey
        self._lock = make_lock("serving-router")
        self._engines: Dict[str, _EngineHandle] = {}
        # req_id -> the FULL terminal result record: a duplicate delivery
        # (an at-least-once client retry whose first attempt executed)
        # gets the original tokens back, not just a refusal
        self._ledger: Dict[str, Dict[str, Any]] = {}
        self._depth = 0  # requests inside admission/dispatch; guarded
        self._latencies_ms: deque = deque(maxlen=4096)
        self._shed_times: deque = deque(maxlen=1024)
        self._closed = False
        self.reroutes = 0
        self.duplicates_discarded = 0
        # autoscaling hook state (set_autoscaler arms it)
        self._scale: Optional[Dict[str, Any]] = None
        self._scale_last = 0.0
        self._client_factory = (
            client_factory if client_factory is not None
            else self._default_client_factory
        )
        # journal: recover BEFORE opening for append — a failed-over
        # router must refuse to double-serve ids its predecessor settled
        self._jlock = make_lock("serving-router-journal")
        self._jfile = None
        if journal_path:
            self._recover_journal(journal_path)
            self._jfile = open(journal_path, "a")
        # federation gauges: fleet size once, per-engine series on join
        from paddle_tpu_torch.obs.metrics import register_gauge

        self._fleet_gauge = lambda: float(len(self._engines))
        register_gauge(
            "paddle_tpu_fleet_engines", self._fleet_gauge,
            "serving engines currently holding a live router lease",
        )
        self._engine_gauges: Dict[str, List] = {}
        self._stop = threading.Event()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name=THREAD_PREFIX + "router-poll",
            daemon=True,
        )
        self._poll_thread.start()
        self._server = None
        if address is not None:
            self._server = _master.Server(
                self, address=address, authkey=authkey,
                methods=ROUTER_METHODS, backlog=128,
            )
            self.address = self._server.address
        else:
            self.address = None

    # -- plumbing ---------------------------------------------------------
    def _default_client_factory(self, address, call_timeout_s):
        return _master.Client(
            tuple(address), authkey=self._authkey,
            methods=ENGINE_METHODS, call_timeout_s=call_timeout_s,
            reconnect_tries=1,
        )

    def _journal(self, rec: Dict[str, Any]) -> None:
        if self._jfile is None:
            return
        with self._jlock:
            try:
                self._jfile.write(json.dumps(rec) + "\n")
                self._jfile.flush()
                os.fsync(self._jfile.fileno())  # lock: allow[C304] ledger ordering: the fsync must serialize with the write under _jlock, else a crash can reorder "done" records and break exactly-once recovery; records are one short line each
            except (OSError, ValueError):
                # a torn journal write must not take routing down; the
                # recovery path tolerates a truncated tail line
                self._stats.incr("fleet/journal_errors")

    def _recover_journal(self, path: str) -> None:
        if not os.path.exists(path):
            return
        recovered = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # truncated tail (torn final write)
                if rec.get("t") == "done" and rec.get("req"):
                    # the journal keeps status, not payload: a failed-over
                    # router refuses to re-serve the id (zero double-serve)
                    # but cannot replay the tokens
                    self._ledger[rec["req"]] = {
                        "req_id": rec["req"],
                        "status": rec.get("status", "served"),
                        "tokens": [],
                        "error": "recovered from journal "
                                 "(result payload not retained)",
                        "engine": rec.get("engine"),
                    }
                    recovered += 1
        if recovered:
            _log.info(
                "router: recovered %d finalized request id(s) from %s",
                recovered, path,
            )

    # -- control plane: the heartbeat-lease engine registry ---------------
    def register_engine(self, engine_id: str, host: str,
                        port: int) -> Dict[str, Any]:
        """Join (or rejoin) the engine registry under a heartbeat lease —
        the master plane's ``register_worker`` discipline.  Idempotent:
        an engine that outlived a router failover just re-registers."""
        from paddle_tpu_torch.obs.metrics import register_gauge

        engine_id = str(engine_id)
        with self._lock:
            self._prune_engines()
            h = self._engines.get(engine_id)
            if h is None or h.address != (str(host), int(port)):
                h = _EngineHandle(engine_id, (host, port))
                self._engines[engine_id] = h
                self._journal({
                    "t": "join", "engine": engine_id,
                    "host": str(host), "port": int(port),
                })
            h.lease_deadline = self._clock() + self.lease_timeout_s
            h.draining = False
            if engine_id not in self._engine_gauges:
                gauges = []
                for family, field, help_ in (
                    ("paddle_tpu_fleet_queue_depth", "queue_depth",
                     "per-engine pre-admission queue depth (federated "
                     "from the engine's typed stats RPC)"),
                    ("paddle_tpu_fleet_pages_in_use", "pages_in_use",
                     "per-engine device blocks held by in-flight sequences"),
                    ("paddle_tpu_fleet_predicted_wait_seconds",
                     "predicted_wait_s",
                     "per-engine EWMA-predicted queue wait — the routing "
                     "score's base term"),
                ):
                    fn = (lambda hh=h, ff=field:
                          float(hh.stats.get(ff, 0.0)))
                    register_gauge(fn=fn, name=family, help_=help_,
                                   labels={"engine": engine_id})
                    gauges.append((family, fn))
                self._engine_gauges[engine_id] = gauges
            _obs.instant("fleet/join", cat="serving", engine=engine_id)
            return {
                "timeout_s": self.lease_timeout_s,
                "engines": sorted(self._engines),
            }

    def heartbeat(self, engine_id: str) -> bool:
        """Renew the lease; False = expired (or router failover) — the
        engine must ``register_engine`` again."""
        with self._lock:
            self._prune_engines()
            h = self._engines.get(str(engine_id))
            if h is None:
                return False
            h.lease_deadline = self._clock() + self.lease_timeout_s
            return True

    def deregister_engine(self, engine_id: str) -> bool:
        """Graceful leave (the drain/rolling-restart path): no failure
        event, traffic simply stops routing there."""
        with self._lock:
            return self._drop_engine(str(engine_id), pruned=False)

    def live_engines(self) -> List[str]:
        with self._lock:
            self._prune_engines()
            return sorted(self._engines)

    def ping(self) -> str:
        return "router"

    def _drop_engine(self, engine_id: str, pruned: bool) -> bool:
        """Remove one engine (callers hold the lock)."""
        from paddle_tpu_torch.obs.metrics import unregister_gauge

        h = self._engines.pop(engine_id, None)
        if h is None:
            return False
        for family, fn in self._engine_gauges.pop(engine_id, ()):
            unregister_gauge(family, fn, labels={"engine": engine_id})
        self._journal({"t": "leave", "engine": engine_id, "pruned": pruned})
        _obs.instant(
            "fleet/leave", cat="serving", engine=engine_id, pruned=pruned,
        )
        if pruned:
            self._stats.incr("fleet/engines_pruned")
            _log.warning(
                "router: engine %s lease expired — pruned; traffic "
                "re-routes to %d survivor(s)", engine_id, len(self._engines),
            )
        return True

    def _prune_engines(self) -> None:
        """Expire silent engines NOW (callers hold the lock) — the
        kill-one-of-N path: a dead engine costs one lease timeout."""
        now = self._clock()
        for e in [e for e, h in self._engines.items()
                  if h.lease_deadline < now]:
            self._drop_engine(e, pruned=True)

    # -- routing policy ---------------------------------------------------
    def _score(self, h: _EngineHandle) -> float:
        """Predicted wait of a request routed to ``h`` NOW: the engine's
        own EWMA prediction, plus the router's in-flight count amortized
        over its slots (covers snapshot staleness between polls)."""
        st = h.stats
        per_req = float(st.get("est_service_s", 0.0) or 0.0)
        slots = max(1, int(st.get("max_slots", 1) or 1))
        return float(st.get("predicted_wait_s", 0.0) or 0.0) + (
            h.inflight * per_req / slots
        )

    def pick_engine(self, key: Optional[str] = None,
                    exclude: Sequence[str] = ()) -> Optional[str]:
        """One routing decision: least-predicted-wait over live,
        non-draining engines, with rendezvous affinity for ``key`` unless
        the preferred engine trails the best by more than
        ``affinity_slack_s``.  Returns the engine id (None = no candidate
        — empty fleet, or every engine excluded/draining)."""
        with self._lock:
            self._prune_engines()
            cands = [
                h for e, h in self._engines.items()
                if not h.draining and e not in exclude
            ]
            if not cands:
                return None
            best = min(cands, key=lambda h: (self._score(h), h.engine_id))
            if self.affinity and key is not None and len(cands) > 1:
                pref_id = rendezvous_pick(key, [h.engine_id for h in cands])
                pref = self._engines[pref_id]
                if self._score(pref) <= (
                    self._score(best) + self.affinity_slack_s
                ):
                    return pref_id
            return best.engine_id

    # -- data plane: admission + dispatch ---------------------------------
    def serve(
        self,
        req_id: str,
        src_ids: Sequence,
        max_new_tokens: Optional[int] = None,
        deadline_s: Optional[float] = None,
        beam_size: Optional[int] = None,
        session_id: Optional[str] = None,
        priority: Optional[int] = None,
    ) -> Dict[str, Any]:
        """One request through the fleet: dedup (idempotent ack plane) ->
        frontend validation -> bounded-queue admission -> deadline shed ->
        least-predicted-wait/affinity dispatch with transparent re-route
        around a dying engine.  Blocks until terminal; returns the result
        record ``{req_id, status, tokens, error, engine}``.  Runs on the
        caller's thread — ``master.Server`` gives each client connection
        its own handler thread, so concurrency comes free."""
        req_id = str(req_id)
        t0 = self._clock()
        with self._lock:
            prior = self._ledger.get(req_id)
        if prior is not None:
            # already finalized (this incarnation or a journal-recovered
            # predecessor): a client retry must NOT re-serve it — it gets
            # the ORIGINAL result record back, flagged as a duplicate
            self._stats.incr("fleet/duplicate_submits")
            return dict(prior, duplicate=True)
        if deadline_s is None and self.default_deadline_s > 0:
            deadline_s = self.default_deadline_s
        # frontend validation BEFORE any network hop (satellite: reject
        # at the router with the same disjoint ledger semantics)
        err = _validate_frontend(src_ids, max_new_tokens, deadline_s,
                                 beam_size, priority)
        if err is not None:
            return self._finalize(req_id, "rejected", error=err, t0=t0)
        refuse = None
        with self._lock:
            if self._closed:
                refuse = "rejected: router closed"
            elif self.queue_limit and self._depth >= self.queue_limit:
                refuse = (
                    f"rejected: router queue full ({self._depth} >= "
                    f"queue_limit {self.queue_limit})"
                )
            else:
                self._depth += 1
        if refuse is not None:
            return self._finalize(req_id, "rejected", error=refuse, t0=t0)
        try:
            return self._dispatch(
                req_id, src_ids, max_new_tokens, deadline_s, beam_size,
                session_id, priority, t0,
            )
        finally:
            with self._lock:
                self._depth -= 1

    def _dispatch(self, req_id, src_ids, max_new_tokens, deadline_s,
                  beam_size, session_id, priority, t0) -> Dict[str, Any]:
        key = affinity_key(src_ids, session_id, self._block_tokens)
        t_deadline = (
            t0 + float(deadline_s)
            if deadline_s is not None and deadline_s > 0 else None
        )
        tried: set = set()
        attempts = 0
        sweeps = 0
        while True:
            attempts += 1
            engine_id = self.pick_engine(key, exclude=tried)
            if engine_id is None and tried:
                # every live engine failed this request's transport:
                # start over on whatever the registry holds NOW (a
                # replacement may have joined mid-flight).  Found by the
                # interleave explorer (analysis/interleave.py): without
                # the sweep bound + backoff below, a no-deadline request
                # against a leased-but-unreachable engine (partial
                # partition: heartbeats land, the data plane doesn't)
                # re-routed in a ZERO-DELAY infinite loop — no timeout
                # path at all (the P505 hazard, dynamic edition).
                sweeps += 1
                if sweeps > 8:
                    status = (
                        "timeout" if t_deadline is not None else "rejected"
                    )
                    return self._finalize(
                        req_id, status, t0=t0,
                        error="no reachable serving engine (every live "
                              "engine failed transport across "
                              f"{sweeps - 1} full sweeps)",
                    )
                # back off so lease expiry / the deadline can fire
                self._sleep(min(0.05, self.stats_poll_s))
                if (t_deadline is not None
                        and self._clock() >= t_deadline):
                    return self._finalize(
                        req_id, "timeout", t0=t0,
                        error="timeout: every live engine failed "
                              "transport and the deadline passed",
                    )
                tried = set()
                engine_id = self.pick_engine(key)
            if engine_id is None:
                # empty fleet: wait out (bounded by the deadline or one
                # lease timeout) for an engine to (re)register rather
                # than failing the request during a rolling bounce
                wait_until = min(
                    t_deadline if t_deadline is not None else float("inf"),
                    t0 + max(self.lease_timeout_s * 2, 1.0) * attempts,
                )
                if self._clock() >= wait_until or attempts > 8:
                    status = "timeout" if t_deadline is not None else "rejected"
                    return self._finalize(
                        req_id, status, t0=t0,
                        error="no live serving engine (fleet empty)",
                    )
                self._sleep(min(0.05, self.stats_poll_s))
                continue
            with self._lock:
                h = self._engines.get(engine_id)
                if h is None:
                    continue
                # shed at the frontend: the chosen (= least-wait) engine's
                # predicted completion already blows the deadline
                if t_deadline is not None:
                    eta = self._clock() + self._score(h) + float(
                        h.stats.get("est_service_s", 0.0) or 0.0)
                    if h.stats and eta > t_deadline:
                        return self._finalize(
                            req_id, "shed", t0=t0,
                            error=(
                                f"shed: fleet-predicted completion "
                                f"{eta - t0:.3f}s after submit blows the "
                                f"{float(deadline_s):.3f}s deadline"
                            ),
                        )
                h.inflight += 1
                address = h.address
            self._journal({"t": "route", "req": req_id, "engine": engine_id})
            _obs.instant(
                "fleet/route", cat="serving", req=req_id, engine=engine_id,
                attempt=attempts,
            )
            remaining = (
                None if t_deadline is None else t_deadline - self._clock()
            )
            call_timeout = self.call_timeout_s if remaining is None else min(
                self.call_timeout_s, max(remaining, 0.0) + 5.0
            )
            try:
                client = self._client_factory(address, call_timeout)
                try:
                    res = client.serve(
                        req_id, list(src_ids), max_new_tokens,
                        None if deadline_s is None else float(deadline_s),
                        beam_size, session_id,
                        None if priority is None else int(priority),
                    )
                finally:
                    try:
                        client.close()
                    except (OSError, AttributeError):
                        pass
            except (_master.MasterTimeoutError, _master.MasterTransportError,
                    _master.MasterRPCError, OSError, EOFError) as exc:
                # the engine died (or froze) under this request: it will
                # be pruned on lease expiry; re-route NOW.  The attempt
                # may have executed engine-side — the first-writer-wins
                # ledger keeps delivery single either way.
                with self._lock:
                    h2 = self._engines.get(engine_id)
                    if h2 is not None:
                        h2.inflight = max(0, h2.inflight - 1)
                tried.add(engine_id)
                self.reroutes += 1
                self._stats.incr("fleet/reroutes")
                _log.warning(
                    "router: engine %s failed request %s (%s) — "
                    "re-routing", engine_id, req_id, type(exc).__name__,
                )
                if (t_deadline is not None
                        and self._clock() >= t_deadline):
                    return self._finalize(
                        req_id, "timeout", t0=t0,
                        error=f"timeout: engine transport failed and the "
                              f"deadline passed ({exc!r})",
                    )
                continue
            with self._lock:
                h2 = self._engines.get(engine_id)
                if h2 is not None:
                    h2.inflight = max(0, h2.inflight - 1)
                    if res.get("status") == "served":
                        h2.served += 1
            return self._finalize(
                req_id, str(res.get("status", "rejected")),
                tokens=res.get("tokens"), error=res.get("error"),
                engine=engine_id, t0=t0,
                beam_score=res.get("beam_score"),
            )

    def _finalize(self, req_id: str, status: str, *, tokens=None, error=None,
                  engine=None, t0=None, beam_score=None) -> Dict[str, Any]:
        """First-writer-wins terminal record for ``req_id`` — the
        idempotent ack plane.  A second finalization (duplicate result
        delivery, re-route race) is counted and DISCARDED: the ledger
        keeps exactly one terminal status per request id, so nothing is
        ever double-served."""
        if status not in _TERMINAL:
            status = "rejected"
        out = {
            "req_id": req_id, "status": status,
            "tokens": [int(t) for t in tokens] if tokens else [],
            "error": error, "engine": engine,
        }
        if beam_score is not None:
            out["beam_score"] = float(beam_score)
        with self._lock:
            prior = self._ledger.get(req_id)
            if prior is not None:
                self.duplicates_discarded += 1
                self._stats.incr("fleet/duplicate_results")
                return dict(prior, duplicate=True)
            self._ledger[req_id] = out
            if status == "shed":
                self._shed_times.append(self._clock())
            if status == "served" and t0 is not None:
                self._latencies_ms.append((self._clock() - t0) * 1e3)
        self._stats.incr(f"fleet/{status}")
        self._journal({
            "t": "done", "req": req_id, "status": status,
            "engine": engine,
        })
        _obs.instant(
            "fleet/done", cat="serving", req=req_id, status=status,
            engine=engine,
        )
        return out

    # -- federation / observability --------------------------------------
    def fleet_stats(self) -> Dict[str, Any]:
        """The federated fleet snapshot: per-engine gauges (latest typed-
        RPC poll + router-side in-flight), the disjoint request ledger
        (scheduler ``status_counts`` REUSED over the ledger — not a third
        copy), and served-latency percentiles (scheduler ``percentile``,
        same nearest-rank rule as every serving metric)."""
        with self._lock:
            engines = {e: h.view() for e, h in self._engines.items()}
            ledger = status_counts(
                SimpleNamespace(status=rec["status"])
                for rec in self._ledger.values()
            )
            lats = sorted(self._latencies_ms)
            depth = self._depth
            reroutes = self.reroutes
            dups = self.duplicates_discarded
        return {
            "n_engines": len(engines),
            "engines": engines,
            "router_queue_depth": int(depth),
            "ledger": ledger,
            "reroutes": int(reroutes),
            "duplicates_discarded": int(dups),
            "latency_ms": {
                "p50": percentile(lats, 0.50),
                "p95": percentile(lats, 0.95),
                "p99": percentile(lats, 0.99),
            },
        }

    # -- drain-aware rolling restart --------------------------------------
    def drain_engine(self, engine_id: str, timeout_s: float = 30.0) -> bool:
        """Rolling-restart primitive: exclude ``engine_id`` from routing,
        forward the scheduler's ``drain()`` protocol over the wire (the engine
        finishes everything in flight, rejects new admissions), wait out
        the router-side in-flight count, then deregister.  True = clean
        (everything in flight completed)."""
        engine_id = str(engine_id)
        with self._lock:
            h = self._engines.get(engine_id)
            if h is None:
                return False
            h.draining = True
            address = h.address
        _obs.instant("fleet/drain", cat="serving", engine=engine_id)
        clean = False
        try:
            client = self._client_factory(address, timeout_s + 10.0)
            try:
                clean = bool(client.drain(timeout_s))
            finally:
                try:
                    client.close()
                except (OSError, AttributeError):
                    pass
        except (_master.MasterTimeoutError, _master.MasterTransportError,
                _master.MasterRPCError, OSError, EOFError):
            clean = False  # it died instead of draining; lease will expire
        deadline = self._clock() + timeout_s
        while self._clock() < deadline:
            with self._lock:
                h = self._engines.get(engine_id)
                if h is None or h.inflight == 0:
                    break
            self._sleep(0.02)
        self.deregister_engine(engine_id)
        return clean

    # -- autoscaling hook --------------------------------------------------
    def set_autoscaler(
        self,
        spawn: Optional[Callable[["Router"], Any]] = None,
        retire: Optional[Callable[["Router", str], Any]] = None,
        *,
        shed_rate_threshold: float = 1.0,
        window_s: float = 5.0,
        min_engines: int = 1,
        max_engines: int = 8,
        cooldown_s: float = 5.0,
    ) -> None:
        """Arm the autoscaling hook: sustained shed rate (sheds/s over the
        sliding ``window_s``) above ``shed_rate_threshold`` calls
        ``spawn(router)``; a shed-free window with a fleet above
        ``min_engines`` calls ``retire(router, idlest_engine_id)``.  The
        callbacks own process management (the scenario/ops layer); the
        router only decides WHEN, at most once per ``cooldown_s``."""
        self._scale = {
            "spawn": spawn, "retire": retire,
            "threshold": float(shed_rate_threshold),
            "window_s": float(window_s),
            "min": int(min_engines), "max": int(max_engines),
            "cooldown_s": float(cooldown_s),
        }

    def maybe_autoscale(self, now: Optional[float] = None) -> Optional[str]:
        """One autoscale evaluation (the poll loop calls this; units call
        it directly with a virtual clock).  Returns "spawn"/"retire" when
        a callback fired, else None."""
        cfg = self._scale
        if cfg is None:
            return None
        now = self._clock() if now is None else now
        if now - self._scale_last < cfg["cooldown_s"]:
            return None
        with self._lock:
            n = len(self._engines)
            recent = [t for t in self._shed_times
                      if t >= now - cfg["window_s"]]
            idlest = min(
                (h for h in self._engines.values() if not h.draining),
                key=lambda h: (h.inflight, self._score(h), h.engine_id),
                default=None,
            )
        rate = len(recent) / cfg["window_s"]
        if rate > cfg["threshold"] and n < cfg["max"] and cfg["spawn"]:
            self._scale_last = now
            self._stats.incr("fleet/autoscale_spawns")
            _obs.instant("fleet/autoscale", cat="serving", action="spawn",
                         shed_rate=round(rate, 3))
            try:
                cfg["spawn"](self)
            except Exception:  # noqa: BLE001 — ops callback must not kill routing
                _log.exception("router: autoscale spawn callback failed")
            return "spawn"
        if (rate == 0.0 and n > cfg["min"] and cfg["retire"]
                and idlest is not None and idlest.inflight == 0):
            self._scale_last = now
            self._stats.incr("fleet/autoscale_retires")
            _obs.instant("fleet/autoscale", cat="serving", action="retire",
                         engine=idlest.engine_id)
            try:
                cfg["retire"](self, idlest.engine_id)
            except Exception:  # noqa: BLE001 — ops callback must not kill routing
                _log.exception("router: autoscale retire callback failed")
            return "retire"
        return None

    # -- stats poll loop ---------------------------------------------------
    def _poll_loop(self) -> None:
        """Per-engine stats poll: ONE typed RPC per engine per period
        (scheduler.export_stats over the wire codec).  A failing poll is
        ignored — the lease plane, not the poll, decides liveness."""
        while not self._stop.wait(self.stats_poll_s):
            with self._lock:
                targets = [
                    (e, h.address) for e, h in self._engines.items()
                ]
            for engine_id, address in targets:
                if self._stop.is_set():
                    return
                try:
                    client = self._client_factory(address, 5.0)
                    try:
                        st = client.stats()
                    finally:
                        try:
                            client.close()
                        except (OSError, AttributeError):
                            pass
                except (_master.MasterTimeoutError,
                        _master.MasterTransportError,
                        _master.MasterRPCError, OSError, EOFError):
                    continue
                if not isinstance(st, dict):
                    continue
                with self._lock:
                    h = self._engines.get(engine_id)
                    if h is not None:
                        h.stats = st
                        if st.get("draining"):
                            h.draining = True
            self.maybe_autoscale()

    # -- lifecycle ---------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """The final run record (``python -m paddle_tpu_torch route`` writes this via
        ``write_stats_json``): the fleet ledger + latency percentiles."""
        out = self.fleet_stats()
        out["statuses"] = out.pop("ledger")
        return out

    def close(self) -> None:
        from paddle_tpu_torch.obs.metrics import unregister_gauge

        with self._lock:
            if self._closed:
                return
            self._closed = True
            for engine_id in list(self._engines):
                self._drop_engine(engine_id, pruned=False)
        self._stop.set()
        self._poll_thread.join(timeout=10)
        if self._server is not None:
            self._server.close()
            self._server = None
        unregister_gauge("paddle_tpu_fleet_engines", self._fleet_gauge)
        if self._jfile is not None:
            with self._jlock:
                try:
                    self._jfile.close()
                except OSError:
                    pass
                self._jfile = None

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _validate_frontend(src_ids, max_new_tokens, deadline_s,
                       beam_size, priority=None) -> Optional[str]:
    """Router-side admission validation — the subset of the scheduler's
    ``_validate`` that needs no engine (vocab/page bounds re-check
    engine-side): a malformed request is rejected BEFORE paying a network
    hop, with the same disjoint ledger semantics."""
    try:
        n = len(src_ids)
    except TypeError:
        return f"source ids must be a sequence, got {type(src_ids).__name__}"
    if n == 0:
        return "empty source"
    for t in src_ids:
        f = (
            float(t)
            if isinstance(t, (int, float, np.floating, np.integer))
            else None
        )
        if f is None or not np.isfinite(f) or f != int(f) or int(f) < 0:
            return f"non-integral source token {t!r}"
    for name, v in (("max_new_tokens", max_new_tokens),
                    ("beam_size", beam_size)):
        if v is None:
            continue
        f = (
            float(v)
            if isinstance(v, (int, float, np.floating, np.integer))
            else None
        )
        if f is None or not np.isfinite(f) or f != int(f) or int(f) < 1:
            return f"{name} must be a positive integer, got {v!r}"
    if deadline_s is not None:
        f = (
            float(deadline_s)
            if isinstance(deadline_s, (int, float, np.floating, np.integer))
            else None
        )
        if f is None or not np.isfinite(f) or f < 0:
            return (
                f"deadline_s must be a finite non-negative number, got "
                f"{deadline_s!r}"
            )
    if priority is not None:
        f = (
            float(priority)
            if isinstance(priority, (int, float, np.floating, np.integer))
            else None
        )
        if f is None or not np.isfinite(f) or f != int(f) or int(f) < 0:
            return (
                f"priority must be a non-negative integer, got {priority!r}"
            )
    return None


class EngineAgent:
    """One engine process's fleet plumbing: the data-plane RPC surface
    (:data:`ENGINE_METHODS` served by ``master.Server`` over the wire
    codec) wrapping a ``ServingScheduler``, plus the register+heartbeat
    lease loop against the router (``router_addr``; None = data plane
    only, the router is told about us some other way — units do this).

    ``serve`` blocks its (per-connection) handler thread on the
    scheduler: concurrency across requests comes from the server's
    thread-per-connection model, and the scheduler's continuous batching
    does the rest."""

    def __init__(
        self,
        scheduler,
        engine_id: str,
        router_addr: Optional[Tuple[str, int]] = None,
        *,
        address: Tuple[str, int] = ("127.0.0.1", 0),
        authkey: bytes = b"paddle-tpu",
        advertise_host: Optional[str] = None,
        clock=time.monotonic,
        sleep=time.sleep,
        default_wait_s: float = 110.0,
    ):
        self._sched = scheduler
        self.engine_id = str(engine_id)
        self._clock = clock
        self._sleep = sleep  # injectable per the C306 discipline
        self.default_wait_s = float(default_wait_s)
        self._server = _master.Server(
            self, address=address, authkey=authkey, methods=ENGINE_METHODS,
            backlog=128,
        )
        self.address = self._server.address
        self._advertise = (
            advertise_host if advertise_host is not None
            else self.address[0]
        )
        self._stop = threading.Event()
        self.registered = threading.Event()
        self._router_addr = (
            tuple(router_addr) if router_addr is not None else None
        )
        self._authkey = authkey
        self._client = None  # dialed lazily: the engine may outrun the router
        self._hb_thread = None
        if self._router_addr is not None:
            self._hb_thread = threading.Thread(
                target=self._lease_loop,
                name=THREAD_PREFIX + "engine-lease", daemon=True,
            )
            self._hb_thread.start()

    # -- RPC surface (the router calls these) ------------------------------
    def serve(self, req_id, src_ids, max_new_tokens=None, deadline_s=None,
              beam_size=None, session_id=None,
              priority=None) -> Dict[str, Any]:
        """One request end-to-end on this engine: submit to the scheduler,
        wait out finalization (bounded by the deadline + grace), return
        the terminal record.  A request the wait outlives is CANCELED —
        its slot and pages free instead of decoding for a router that
        already re-routed."""
        r = Request(
            src_ids, max_new_tokens, req_id=str(req_id),
            deadline_s=deadline_s, beam_size=beam_size,
            session_id=session_id, priority=priority,
        )
        try:
            self._sched.submit(r)
        except RuntimeError as exc:
            return {
                "req_id": r.req_id, "status": "closed", "tokens": [],
                "error": str(exc), "engine": self.engine_id,
            }
        wait_s = (
            float(deadline_s) + 5.0
            if deadline_s is not None and deadline_s > 0
            else self.default_wait_s
        )
        if not r.wait(wait_s):
            self._sched.cancel(
                r, reason=f"timeout: engine wait exceeded {wait_s:.1f}s",
            )
            r.wait(10.0)
        out = {
            "req_id": r.req_id,
            "status": r.status if r.done() else "timeout",
            "tokens": [int(t) for t in (r.tokens or [])],
            "error": r.error,
            "engine": self.engine_id,
        }
        if r.beam_score is not None:
            out["beam_score"] = float(r.beam_score)
        return out

    def stats(self) -> Dict[str, Any]:
        """The ONE typed stats RPC the router polls: the scheduler's SLO
        gauge snapshot (``write_stats_json`` record shape) + identity."""
        st = self._sched.export_stats()
        st["engine_id"] = self.engine_id
        return st

    def drain(self, timeout_s: float = 30.0) -> bool:
        """The scheduler's drain protocol over the wire: finish everything in
        flight, reject new admissions, then close.  True = clean."""
        return bool(self._sched.drain(float(timeout_s)))

    def ping(self) -> str:
        return self.engine_id

    # -- lease loop ---------------------------------------------------------
    def _lease_loop(self) -> None:
        """Register, then heartbeat at a third of the lease timeout;
        a False heartbeat (lease expired / router failed over) or a
        transport error re-registers with bounded backoff."""
        period = 0.2
        backoff = 0.1
        while not self._stop.is_set():
            try:
                if self._client is None:
                    # lazy dial with backoff: an engine that starts before
                    # its router (or outlives a router bounce) keeps
                    # retrying instead of dying at construction
                    self._client = _master.Client(
                        self._router_addr, authkey=self._authkey,
                        methods=ROUTER_METHODS, call_timeout_s=10.0,
                        reconnect_tries=1,
                    )
                got = self._client.register_engine(
                    self.engine_id, self._advertise, int(self.address[1]),
                )
                period = max(0.05, float(got.get("timeout_s", 1.0)) / 3.0)
                self.registered.set()
                backoff = 0.1
            except (_master.MasterTimeoutError, _master.MasterTransportError,
                    _master.MasterRPCError, OSError, EOFError):
                self.registered.clear()
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 2.0)
                continue
            while not self._stop.wait(period):
                try:
                    if not self._client.heartbeat(self.engine_id):
                        break  # expired: re-register
                except (_master.MasterTimeoutError,
                        _master.MasterTransportError,
                        _master.MasterRPCError, OSError, EOFError):
                    break
            self.registered.clear()

    def close(self, deregister: bool = True) -> None:
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
        if self._client is not None:
            if deregister:
                try:
                    self._client.deregister_engine(self.engine_id)
                except (_master.MasterTimeoutError,
                        _master.MasterTransportError,
                        _master.MasterRPCError, OSError, EOFError):
                    pass
            try:
                self._client.close()
            except (OSError, EOFError):
                pass
            self._client = None
        self._server.close()

    def __enter__(self) -> "EngineAgent":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class FleetClient:
    """Scheduler-shaped client over the router's serve RPC: ``submit``
    returns the (local) ``Request`` immediately; a bounded worker thread
    performs the blocking typed-RPC exchange and finalizes it — callback,
    ``wait()``/``result()``, status, exactly the ``ServingScheduler``
    surface, so the loadgen/scenario/bench harnesses drive a fleet and a
    single engine with the same code."""

    def __init__(
        self,
        router_addr: Tuple[str, int],
        *,
        authkey: bytes = b"paddle-tpu",
        call_timeout_s: Optional[float] = None,
        max_inflight: int = 64,
        clock=time.perf_counter,
    ):
        from paddle_tpu_torch.utils import flags as _flags

        self._addr = tuple(router_addr)
        self._authkey = authkey
        self.call_timeout_s = float(
            call_timeout_s if call_timeout_s is not None
            else _flags.get_flag("router_call_timeout_s")
        )
        self._clock = clock
        self._sem = threading.Semaphore(int(max_inflight))
        self._threads_lock = make_lock("serving-fleet-client")
        self._threads: List[threading.Thread] = []
        self._closed = False

    def submit(self, request: Request) -> Request:
        request.t_submit = self._clock()
        with self._threads_lock:
            if self._closed:
                raise protocol_error(
                    "P509",
                    f"submit({request.req_id}) on a closed FleetClient — "
                    "the client joined its workers and will finalize "
                    "nothing",
                    source="serving/router.py",
                    hint="submit before close(); a drained client must be "
                    "re-constructed, not reused",
                )
            t = threading.Thread(
                target=self._run, args=(request,),
                name=THREAD_PREFIX + "fleet-submit", daemon=True,
            )
            self._threads.append(t)
        t.start()
        return request

    def _run(self, r: Request) -> None:
        self._sem.acquire()
        try:
            client = _master.Client(
                self._addr, authkey=self._authkey, methods=ROUTER_METHODS,
                call_timeout_s=self.call_timeout_s,
            )
            try:
                res = client.serve(
                    r.req_id, list(r.src_ids), r.max_new_tokens,
                    r.deadline_s, r.beam_size, r.session_id,
                    getattr(r, "priority", None),
                )
            finally:
                client.close()
            r.tokens = [int(t) for t in res.get("tokens", [])]
            r.error = res.get("error")
            r.status = str(res.get("status", "rejected"))
            if res.get("beam_score") is not None:
                r.beam_score = float(res["beam_score"])
        except (_master.MasterTimeoutError, _master.MasterTransportError,
                _master.MasterRPCError, OSError, EOFError) as exc:
            r.error = f"router unreachable: {exc!r}"
            r.status = "rejected"
        finally:
            r.t_done = self._clock()
            self._sem.release()
            r._event.set()
            if r.callback is not None:
                try:
                    r.callback(r)
                except Exception:  # noqa: BLE001 — client callback boundary
                    _log.exception("fleet client callback failed")

    def close(self, timeout: float = 30.0) -> None:
        with self._threads_lock:
            self._closed = True
            threads = list(self._threads)
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))

    def __enter__(self) -> "FleetClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
