"""Deterministic interleaving explorer over the port's distributed planes;
the counterpart of ``paddle_tpu/analysis/interleave.py`` (same models,
same event vocabulary, same seeded schedules: a spec found by either
package replays on the other).

The DYNAMIC leg of the protocol conformance plane (the static leg is
:mod:`~paddle_tpu_torch.analysis.protocol_lint`): instead of asserting the
drill invariants (zero double-serve, epoch-fenced acks, single fenced
leader, journal replay == live state) along the N interleavings the
hand-written chaos drills happen to exercise, this module SEARCHES the
schedule space, in the lineage of MODIST and TLA+ model checking.

Three properties make the search honest:

* **Real state machines.**  Each :class:`Model` drives the production
  code — ``serving.router.Router`` (``address=None``, injected
  ``client_factory``), ``master.Service`` (journaled), and
  ``master_ha.LeaseFile`` — never a re-implementation.  A bug found
  here is a bug in the shipping protocol.
* **Virtual time, zero threads.**  Clocks and sleeps are injected
  (:class:`VirtualClock`; the injectable-clock discipline), the
  router's poll thread is parked, and every event applies synchronously
  on the explorer's thread — a schedule is a pure function of its event
  list, so the same seed replays bit-identically forever.
* **Faults are events.**  The netem fault vocabulary (drop / lost reply
  = executed-but-unacked / duplicate submit / partition / heal /
  crash-restart of engines, routers, masters / clock advance = lease
  expiry) is part of each model's enabled-event set, so the scheduler
  interleaves faults with protocol steps instead of bolting them on.

Exploration is seeded-random (``explore_schedules``) or bounded-DFS
(``dfs_explore``); any violating schedule is SHRUNK by delta debugging
(:func:`shrink_events`) to a minimal event list and emitted as a
JSON spec replayable forever via ``python -m paddle_tpu_torch explore --replay
<spec.json>`` (:func:`replay_spec`) — a found bug becomes a one-file
regression test, not a flaky repro recipe.

``planted="double_serve"`` arms the acceptance canary: the router's
journal silently drops ``done`` records, so a crash-restart forgets
settled requests and a client retry re-serves one — the explorer must
detect it, shrink it to <= 6 events (submit → crash → restart → retry)
and replay the spec.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "VirtualClock",
    "Model",
    "RouterModel",
    "MasterModel",
    "LeaseModel",
    "MODELS",
    "make_model",
    "run_schedule",
    "explore_schedules",
    "dfs_explore",
    "shrink_events",
    "replay_spec",
]

# Events are plain JSON dicts: {"op": <name>, ...params}.  Their JSON
# dump (sorted keys) is the identity used by DFS branching and shrinking.


def event_key(ev: Dict[str, Any]) -> str:
    return json.dumps(ev, sort_keys=True)


class VirtualClock:
    """Deterministic time: callable (the ``clock=`` injection point) and
    a ``sleep`` whose only effect is advancing it — a schedule never
    touches wall time."""

    def __init__(self, t: float = 1000.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)

    def sleep(self, dt: float) -> None:
        self.advance(dt)


class Model:
    """One explorable protocol plane.  Subclasses own real production
    state machines and expose them as an event-enabled transition system:

    * ``reset()``        — fresh incarnation under the model's workdir
    * ``enabled()``      — the currently-applicable events (JSON dicts)
    * ``apply(event)``   — perform one event synchronously
    * ``check()``        — invariant violations AFTER the last event
    * ``finish()``       — end-of-schedule (deep/expensive) invariants
    * ``close()``        — tear down OS resources

    ``apply`` may itself record violations into ``self.violations`` for
    hazards only visible at the call boundary (a stale ack accepted, a
    renew that lied)."""

    name = "model"

    def __init__(self, workdir: str, planted: Optional[str] = None):
        self.workdir = workdir
        self.planted = planted
        self.violations: List[str] = []

    # -- transition-system surface ----------------------------------------
    def reset(self) -> None:
        raise NotImplementedError

    def enabled(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def apply(self, event: Dict[str, Any]) -> None:
        raise NotImplementedError

    def check(self) -> List[str]:
        return []

    def finish(self) -> List[str]:
        return []

    def close(self) -> None:
        pass

    # -- shared helpers ----------------------------------------------------
    def applicable(self, event: Dict[str, Any]) -> bool:
        key = event_key(event)
        return any(event_key(e) == key for e in self.enabled())

    def drain_violations(self) -> List[str]:
        out, self.violations = self.violations, []
        return out


# ---------------------------------------------------------------------------
# Router model — the serving fleet's zero-double-serve contract
# ---------------------------------------------------------------------------

class _SimEngine:
    def __init__(self, engine_id: str, port: int):
        self.engine_id = engine_id
        self.port = port
        self.alive = True
        self.partitioned = False
        self.drop_next_reply = False


class _SimEngineClient:
    """The router->engine data plane over virtual transport: executes the
    request on the sim engine (recording the execution tick — the
    double-serve evidence trail) and injects the netem fault vocabulary:
    a dead/partitioned engine raises before executing; an armed
    ``drop_next_reply`` raises AFTER executing (the at-least-once hazard
    the ledger must absorb)."""

    def __init__(self, model: "RouterModel", address):
        from paddle_tpu_torch import master as _master

        self._m = model
        self._master = _master
        self._engine = model.engine_by_port(int(address[1]))

    def _check_up(self):
        e = self._engine
        if e is None or not e.alive or e.partitioned:
            raise self._master.MasterTransportError(
                "sim engine unreachable")

    def serve(self, req_id, src_ids, max_new_tokens=None, deadline_s=None,
              beam_size=None, session_id=None, priority=None):
        self._check_up()
        m = self._m
        m.tick += 1
        m.executions.append((m.tick, str(req_id), self._engine.engine_id))
        if self._engine.drop_next_reply:
            self._engine.drop_next_reply = False
            raise self._master.MasterTransportError(
                "reply lost after execution")
        return {
            "req_id": str(req_id), "status": "served",
            "tokens": [int(x) + 1 for x in src_ids], "error": None,
        }

    def stats(self):
        self._check_up()
        return {}

    def drain(self, timeout_s=0.0):
        return True

    def ping(self):
        return "pong"

    def close(self):
        pass


class RouterModel(Model):
    """Real ``serving.router.Router`` (no sockets, parked poll thread,
    virtual clock) over simulated engines.

    Invariant (the fleet drills' contract, now schedule-searched): once a
    request id is SETTLED (its first non-duplicate terminal result), no
    engine may execute it again — across re-routes, retries, engine
    crashes, partitions AND router crash-restarts recovering the ledger
    from the journal."""

    name = "router"
    REQS = ("q1", "q2", "q3")
    ENGINES = ("e1", "e2")

    def __init__(self, workdir: str, planted: Optional[str] = None):
        super().__init__(workdir, planted)
        self.router = None
        self._incarnation = 0

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        self.close()
        self.violations = []
        self.clock = VirtualClock()
        self.tick = 0
        self.executions: List[Tuple[int, str, str]] = []
        self.settled: Dict[str, Tuple[int, str]] = {}
        self.submitted: set = set()
        self.results: List[Dict[str, Any]] = []
        self.engines: Dict[str, _SimEngine] = {}
        self._incarnation += 1
        inc_dir = os.path.join(self.workdir, f"run{self._incarnation}")
        os.makedirs(inc_dir, exist_ok=True)
        self.journal_path = os.path.join(inc_dir, "router.journal")
        self._start_router()
        for i, eid in enumerate(self.ENGINES):
            self.engines[eid] = _SimEngine(eid, 9000 + i)
            self.router.register_engine(eid, "sim", 9000 + i)

    def _start_router(self) -> None:
        from paddle_tpu_torch.serving.router import Router

        r = Router(
            address=None,
            journal_path=self.journal_path,
            clock=self.clock,
            sleep=self.clock.sleep,
            stats_poll_s=1e9,          # park the poll thread: zero async
            lease_timeout_s=5.0,
            queue_limit=16,
            default_deadline_s=0.0,    # no implicit deadlines
            affinity=False,
            call_timeout_s=5.0,
            client_factory=lambda addr, t: _SimEngineClient(self, addr),
        )
        if self.planted == "double_serve":
            # the acceptance canary: the journal silently drops "done"
            # records, so a failed-over router forgets settled ids and a
            # client retry re-serves one — detect, shrink, replay
            orig = r._journal

            def dropping(rec, _orig=orig):
                if rec.get("t") != "done":
                    _orig(rec)

            r._journal = dropping
        self.router = r

    def _crash_router(self) -> None:
        """Crash semantics, not shutdown: the journal file handle drops
        dead (no close-time "leave" records) and then the incarnation is
        torn down without journaling anything further."""
        r = self.router
        with r._jlock:
            if r._jfile is not None:
                try:
                    r._jfile.close()
                except OSError:
                    pass
                r._jfile = None
        r.close()  # journals nothing (jfile gone); joins the poll thread
        self.router = None

    def close(self) -> None:
        if self.router is not None:
            self._crash_router()
        self.engines = {}

    def engine_by_port(self, port: int) -> Optional[_SimEngine]:
        for e in self.engines.values():
            if e.port == port:
                return e
        return None

    # -- transition system -------------------------------------------------
    def enabled(self) -> List[Dict[str, Any]]:
        evs: List[Dict[str, Any]] = []
        up = self.router is not None
        if up:
            for q in self.REQS:
                if q not in self.submitted:
                    evs.append({"op": "submit", "req": q})
            for q in sorted(self.settled):
                evs.append({"op": "retry", "req": q})
            evs.append({"op": "crash_router"})
        else:
            evs.append({"op": "restart_router"})
        for eid in sorted(self.engines):
            e = self.engines[eid]
            if e.alive:
                evs.append({"op": "crash_engine", "engine": eid})
                if not e.partitioned:
                    if self.router is not None:
                        evs.append({"op": "heartbeat", "engine": eid})
                    evs.append({"op": "drop_reply", "engine": eid})
                    evs.append({"op": "partition", "engine": eid})
                else:
                    evs.append({"op": "heal", "engine": eid})
            else:
                evs.append({"op": "restart_engine", "engine": eid})
        evs.append({"op": "advance", "dt": 3.0})
        return evs

    def _serve(self, req: str) -> Dict[str, Any]:
        res = self.router.serve(req, [1, 2, 3])
        self.results.append(res)
        if not res.get("duplicate") and req not in self.settled:
            self.settled[req] = (self.tick, res["status"])
        return res

    def apply(self, event: Dict[str, Any]) -> None:
        op = event["op"]
        if op == "submit":
            self.submitted.add(event["req"])
            self._serve(event["req"])
        elif op == "retry":
            self._serve(event["req"])
        elif op == "crash_engine":
            self.engines[event["engine"]].alive = False
        elif op == "restart_engine":
            e = self.engines[event["engine"]]
            e.alive = True
            e.partitioned = False
            if self.router is not None:
                self.router.register_engine(e.engine_id, "sim", e.port)
        elif op == "heartbeat":
            # the agent's renew loop: an expired lease re-registers
            e = self.engines[event["engine"]]
            if not self.router.heartbeat(e.engine_id):
                self.router.register_engine(e.engine_id, "sim", e.port)
        elif op == "partition":
            self.engines[event["engine"]].partitioned = True
        elif op == "heal":
            self.engines[event["engine"]].partitioned = False
        elif op == "drop_reply":
            self.engines[event["engine"]].drop_next_reply = True
        elif op == "crash_router":
            self._crash_router()
        elif op == "restart_router":
            self._start_router()
            # surviving engines re-register with the new incarnation
            # (their agents' heartbeat loop does this in production)
            for e in self.engines.values():
                if e.alive:
                    self.router.register_engine(e.engine_id, "sim", e.port)
        elif op == "advance":
            self.clock.advance(event["dt"])
        else:  # pragma: no cover - scheduler only draws from enabled()
            raise ValueError(f"unknown router event {op!r}")

    def check(self) -> List[str]:
        out = self.drain_violations()
        from paddle_tpu_torch.serving.router import _TERMINAL

        for tick, req, eid in self.executions:
            s = self.settled.get(req)
            if s is not None and tick > s[0]:
                out.append(
                    f"double-serve: request {req!r} executed on engine "
                    f"{eid!r} (tick {tick}) AFTER being settled as "
                    f"{s[1]!r} at tick {s[0]}"
                )
        for res in self.results:
            if res["status"] not in _TERMINAL:
                out.append(
                    f"non-terminal ledger status {res['status']!r} for "
                    f"{res['req_id']!r}"
                )
        return out

    def finish(self) -> List[str]:
        return self.check()


# ---------------------------------------------------------------------------
# Master model — epoch-fenced leases + journal replay == live state
# ---------------------------------------------------------------------------

class MasterModel(Model):
    """Real journaled ``master.Service`` with virtual workers.

    Invariants: task-set conservation (todo+pending+done+discarded is
    constant under every interleaving of leases, acks, failures, lease
    expiries and crash-restarts); epoch fencing (an ack carrying a
    superseded epoch must be REFUSED — the mirror tracks the newest
    leased epoch per task); recovery fidelity (a restart from
    snapshot+journal reproduces the live fingerprint exactly)."""

    name = "master"
    WORKERS = ("w0", "w1")

    def __init__(self, workdir: str, planted: Optional[str] = None):
        super().__init__(workdir, planted)
        self.svc = None
        self._incarnation = 0

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        self.close()
        self.violations = []
        self.clock = VirtualClock()
        self._incarnation += 1
        self.dir = os.path.join(self.workdir, f"m{self._incarnation}")
        os.makedirs(self.dir, exist_ok=True)
        data = os.path.join(self.dir, "d.rio")
        from paddle_tpu_torch.io import recordio

        recordio.write_records(
            data, (f"{i}".encode() for i in range(80)),
            max_chunk_records=10,
        )
        self.svc = self._make_service()
        self.svc.set_dataset([data])
        self.total = self.svc.n_tasks()
        for w in self.WORKERS:
            self.svc.register_worker(w)
        self.holding: Dict[str, Tuple[int, int]] = {}
        self.lease_epoch: Dict[int, int] = {}
        self.finished: List[Tuple[int, int]] = []

    def _make_service(self):
        from paddle_tpu_torch import master as _master

        return _master.Service(
            snapshot_path=os.path.join(self.dir, "snap.json"),
            clock=self.clock,
            chunks_per_task=2,
            auto_rotate=False,
            journal=True,
            journal_fsync=False,
            timeout_s=5.0,
            failure_max=3,
            worker_timeout_s=1e9,  # registry churn is its own event space
        )

    def close(self) -> None:
        if self.svc is not None:
            try:
                self.svc.close()
            except Exception:  # noqa: BLE001 — teardown of a crashed twin
                pass
            self.svc = None

    # -- transition system -------------------------------------------------
    def enabled(self) -> List[Dict[str, Any]]:
        evs: List[Dict[str, Any]] = []
        for w in self.WORKERS:
            evs.append({"op": "get", "worker": w})
            if w in self.holding:
                evs.append({"op": "finish", "worker": w})
                evs.append({"op": "fail", "worker": w})
                evs.append({"op": "ret", "worker": w})
        if self.finished:
            evs.append({"op": "stale_ack"})
        evs.append({"op": "advance", "dt": 6.0})  # past the task lease
        evs.append({"op": "restart"})
        return evs

    def apply(self, event: Dict[str, Any]) -> None:
        import numpy as np

        op = event["op"]
        if op == "get":
            w = event["worker"]
            got = self.svc.get_task(w)
            if isinstance(got, dict):
                tid = int(got["task"]["task_id"])
                epoch = int(got["epoch"])
                self.holding[w] = (tid, epoch)
                self.lease_epoch[tid] = max(
                    self.lease_epoch.get(tid, epoch), epoch)
        elif op in ("finish", "fail", "ret"):
            w = event["worker"]
            tid, epoch = self.holding.pop(w)
            if op == "finish":
                ok = self.svc.task_finished(
                    tid, epoch,
                    {"g": np.arange(4, dtype=np.float32) + tid, "rows": 10},
                )
                if ok:
                    self.finished.append((tid, epoch))
            elif op == "fail":
                ok = self.svc.task_failed(tid, epoch)
            else:
                ok = self.svc.task_returned(tid, epoch)
            if ok and self.lease_epoch.get(tid, epoch) > epoch:
                self.violations.append(
                    f"epoch fence breached: {op} of task {tid} accepted "
                    f"at stale epoch {epoch} (newest lease is epoch "
                    f"{self.lease_epoch[tid]})"
                )
        elif op == "stale_ack":
            # A client retry re-sends an already-landed (task, epoch) ack —
            # the reply-lost case.  task_finished deliberately accepts the
            # duplicate (at-least-once ack delivery), so the invariant is
            # state-INVARIANCE, not rejection: the queue fingerprint must
            # not move and the first delivery's result payload must win
            # (the duplicate carries a zeros payload, so any clobbering
            # is bit-detectable).
            tid, epoch = self.finished[-1]
            fp = self._fingerprint()
            ok = self.svc.task_finished(
                tid, epoch,
                {"g": np.zeros(4, dtype=np.float32), "rows": 0},
            )
            if not ok:
                self.violations.append(
                    f"duplicate ack rejected: task {tid} epoch {epoch} — "
                    f"a reply-lost retry must be accepted-and-deduped, "
                    f"not bounced into a recompute"
                )
            if self._fingerprint() != fp:
                self.violations.append(
                    f"duplicate ack mutated queue state: task {tid} "
                    f"epoch {epoch}"
                )
            stored = self.svc.results.get(self.svc.pass_id, {}).get(tid)
            if stored is not None and stored.get("rows") == 0:
                self.violations.append(
                    f"duplicate ack clobbered the landed result of task "
                    f"{tid}: zeros payload overwrote the original"
                )
        elif op == "advance":
            self.clock.advance(event["dt"])
        elif op == "restart":
            fp = self._fingerprint()
            self.svc.fence()
            self.svc = self._make_service()  # recovers snapshot+journal
            if self._fingerprint() != fp:
                self.violations.append(
                    "recovery infidelity: snapshot+journal replay does "
                    "not reproduce the live queue state"
                )
        else:  # pragma: no cover - scheduler only draws from enabled()
            raise ValueError(f"unknown master event {op!r}")

    def _fingerprint(self) -> Dict[str, Any]:
        svc = self.svc
        with svc._lock:
            return {
                "pass_id": svc.pass_id,
                "todo": sorted((t.task_id, t.epoch) for t in svc.todo),
                "pending": sorted(
                    (tid, ent[0].epoch) for tid, ent in svc.pending.items()
                ),
                "done": sorted((t.task_id, t.epoch) for t in svc.done),
                "discarded": sorted(t.task_id for t in svc.discarded),
                "fail_events": svc.fail_events,
            }

    def check(self) -> List[str]:
        out = self.drain_violations()
        svc = self.svc
        with svc._lock:
            n = (len(svc.todo) + len(svc.pending) + len(svc.done)
                 + len(svc.discarded))
        if n != self.total:
            out.append(
                f"task-set conservation broken: todo+pending+done+"
                f"discarded = {n}, expected {self.total}"
            )
        return out

    def finish(self) -> List[str]:
        out = self.check()
        fp = self._fingerprint()
        self.svc.fence()
        self.svc = self._make_service()
        if self._fingerprint() != fp:
            out.append(
                "recovery infidelity at end of schedule: snapshot+journal "
                "replay does not reproduce the live queue state"
            )
        return out


# ---------------------------------------------------------------------------
# Lease model — HA leader election fencing
# ---------------------------------------------------------------------------

class LeaseModel(Model):
    """Real ``master_ha.LeaseFile`` candidates on one shared directory
    under a virtual clock.

    Invariants: ``renew()`` must never report success to a usurped
    owner (that would be TWO fenced writers); ``release()`` by a
    non-owner must not delete the owner's lease; at most one candidate
    passes ``held_by_me()`` at any instant."""

    name = "ha"
    CANDS = ("a", "b")

    def __init__(self, workdir: str, planted: Optional[str] = None):
        super().__init__(workdir, planted)
        self._incarnation = 0

    def reset(self) -> None:
        self.violations = []
        self.clock = VirtualClock()
        self._incarnation += 1
        d = os.path.join(self.workdir, f"ha{self._incarnation}")
        os.makedirs(d, exist_ok=True)
        from paddle_tpu_torch.master_ha import LeaseFile

        self.leases = {
            c: LeaseFile(d, c, lease_timeout=5.0, clock=self.clock,
                         sleep=self.clock.sleep)
            for c in self.CANDS
        }
        self.believes = {c: False for c in self.CANDS}

    def enabled(self) -> List[Dict[str, Any]]:
        evs: List[Dict[str, Any]] = []
        for c in self.CANDS:
            evs.append({"op": "acquire", "cand": c})
            if self.believes[c]:
                evs.append({"op": "renew", "cand": c})
                evs.append({"op": "release", "cand": c})
        evs.append({"op": "advance", "dt": 3.0})
        return evs

    def apply(self, event: Dict[str, Any]) -> None:
        op, c = event["op"], event.get("cand")
        if op == "acquire":
            self.believes[c] = self.leases[c].try_acquire()
        elif op == "renew":
            ok = self.leases[c].renew()
            self.believes[c] = ok
            if ok and self.leases[c].current_owner() != c:
                self.violations.append(
                    f"fence breach: renew() by {c!r} reported success "
                    f"while {self.leases[c].current_owner()!r} owns the "
                    f"lease (two writers believe they are fenced in)"
                )
        elif op == "release":
            owner_before = self.leases[c].current_owner()
            self.leases[c].release()
            self.believes[c] = False
            owner_after = self.leases[c].current_owner()
            if owner_before not in (None, c) and owner_after != owner_before:
                self.violations.append(
                    f"release() by non-owner {c!r} destroyed "
                    f"{owner_before!r}'s lease"
                )
        elif op == "advance":
            self.clock.advance(event["dt"])
        else:  # pragma: no cover - scheduler only draws from enabled()
            raise ValueError(f"unknown ha event {op!r}")

    def check(self) -> List[str]:
        out = self.drain_violations()
        holders = [c for c in self.CANDS if self.leases[c].held_by_me()]
        if len(holders) > 1:
            out.append(f"dual leader: {holders} both hold a live lease")
        return out

    def finish(self) -> List[str]:
        return self.check()


MODELS: Dict[str, Callable[..., Model]] = {
    RouterModel.name: RouterModel,
    MasterModel.name: MasterModel,
    LeaseModel.name: LeaseModel,
}


def make_model(name: str, workdir: str,
               planted: Optional[str] = None) -> Model:
    if name not in MODELS:
        raise ValueError(
            f"unknown model {name!r}; choose from {sorted(MODELS)}")
    return MODELS[name](workdir, planted=planted)


# ---------------------------------------------------------------------------
# schedulers: replay, seeded-random, bounded DFS
# ---------------------------------------------------------------------------

def run_schedule(model: Model,
                 events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Replay ``events`` on a fresh incarnation of ``model``.  An event
    no longer applicable in the (possibly shrunk) context is SKIPPED —
    the ddmin contract: subsets of a violating schedule stay meaningful.
    Returns ``{violations, applied, trace}``; ``trace`` is the applied
    prefix up to (and including) the first violating event."""
    model.reset()
    trace: List[Dict[str, Any]] = []
    applied = 0
    for ev in events:
        if not model.applicable(ev):
            continue
        model.apply(ev)
        applied += 1
        trace.append(ev)
        vs = model.check()
        if vs:
            return {"violations": vs, "applied": applied,
                    "trace": list(trace)}
    vs = model.finish()
    return {"violations": vs, "applied": applied, "trace": list(trace)}


def _random_schedule(model: Model, rng: random.Random,
                     max_events: int) -> Dict[str, Any]:
    model.reset()
    trace: List[Dict[str, Any]] = []
    for _ in range(max_events):
        evs = model.enabled()
        if not evs:
            break
        ev = evs[rng.randrange(len(evs))]
        model.apply(ev)
        trace.append(ev)
        vs = model.check()
        if vs:
            return {"violations": vs, "trace": trace}
    return {"violations": model.finish(), "trace": trace}


def shrink_events(model: Model, events: Sequence[Dict[str, Any]],
                  max_rounds: int = 64) -> List[Dict[str, Any]]:
    """ddmin delta debugging: the smallest sub-sequence of ``events``
    that still violates (each candidate replays on a fresh incarnation;
    deterministic models make this exact, not probabilistic)."""
    def fails(cand: Sequence[Dict[str, Any]]) -> bool:
        return bool(run_schedule(model, cand)["violations"])

    current = list(events)
    if not fails(current):
        return current  # not reproducible: return as-is, caller decides
    n = 2
    rounds = 0
    while len(current) >= 2 and rounds < max_rounds:
        rounds += 1
        chunk = max(1, len(current) // n)
        reduced = False
        # try removing each chunk (complement testing)
        for i in range(0, len(current), chunk):
            cand = current[:i] + current[i + chunk:]
            if cand and fails(cand):
                current = cand
                n = max(n - 1, 2)
                reduced = True
                break
        if not reduced:
            if chunk == 1:
                break
            n = min(n * 2, len(current))
    # final greedy single-event pass
    i = 0
    while i < len(current) and rounds < max_rounds * 2:
        rounds += 1
        cand = current[:i] + current[i + 1:]
        if cand and fails(cand):
            current = cand
        else:
            i += 1
    return current


def _spec(model: Model, seed: Optional[int], events: List[Dict[str, Any]],
          violations: List[str]) -> Dict[str, Any]:
    return {
        "version": 1,
        "model": model.name,
        "planted": model.planted,
        "seed": seed,
        "events": events,
        "violations": violations,
    }


def explore_schedules(
    model: Model,
    schedules: int = 50,
    seed: int = 0,
    max_events: int = 14,
    shrink: bool = True,
) -> Dict[str, Any]:
    """Seeded-random exploration: ``schedules`` independent schedules of
    up to ``max_events`` events each (schedule ``i`` draws from
    ``random.Random(f"{seed}:{i}")``, so any subset of the batch replays
    independently).  Stops at the first violation; when ``shrink``, the
    violating schedule is ddmin-minimized and returned as a replayable
    spec."""
    for i in range(int(schedules)):
        rng = random.Random(f"{seed}:{i}")
        out = _random_schedule(model, rng, max_events)
        if out["violations"]:
            events = out["trace"]
            if shrink:
                events = shrink_events(model, events)
                out = run_schedule(model, events)
            return {
                "violation_found": True,
                "schedules_run": i + 1,
                "spec": _spec(model, seed, list(events),
                              out["violations"]),
            }
    return {"violation_found": False, "schedules_run": int(schedules),
            "spec": None}


def dfs_explore(model: Model, depth: int = 4,
                branch_limit: int = 6,
                max_paths: int = 2000) -> Dict[str, Any]:
    """Bounded-DFS exploration: every event sequence up to ``depth``
    (first ``branch_limit`` enabled events per state, depth-first,
    at most ``max_paths`` path replays).  Deterministic models replay
    each prefix from scratch, so no state snapshotting is needed."""
    stack: List[List[Dict[str, Any]]] = [[]]
    paths = 0
    while stack and paths < max_paths:
        prefix = stack.pop()
        paths += 1
        out = run_schedule(model, prefix)
        if out["violations"]:
            events = shrink_events(model, out["trace"])
            final = run_schedule(model, events)
            return {
                "violation_found": True,
                "paths_run": paths,
                "spec": _spec(model, None, list(events),
                              final["violations"]),
            }
        if out["applied"] < len(prefix):
            continue  # an event became inapplicable: pruned branch
        if len(prefix) < depth:
            frontier = model.enabled()[:branch_limit]
            for ev in reversed(frontier):
                stack.append(prefix + [ev])
    return {"violation_found": False, "paths_run": paths, "spec": None}


def replay_spec(spec: Dict[str, Any],
                workdir: Optional[str] = None) -> Dict[str, Any]:
    """Re-run a shrunk violation spec (``python -m paddle_tpu_torch explore
    --replay``).
    Returns ``{violations, applied, reproduced}`` — ``reproduced`` means
    the replay hit a violation again, the regression-test contract."""
    own_dir = workdir is None
    if own_dir:
        workdir = tempfile.mkdtemp(prefix="paddle-tpu-torch-explore-")
    model = make_model(spec["model"], workdir, planted=spec.get("planted"))
    try:
        out = run_schedule(model, spec.get("events", ()))
        return {
            "violations": out["violations"],
            "applied": out["applied"],
            "reproduced": bool(out["violations"]),
        }
    finally:
        model.close()
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
