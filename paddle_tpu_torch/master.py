"""Elastic master — fault-tolerant task-queue data dispatch (reference:
go/master/service.go, the Go master the v2 python API reaches through
python/paddle/v2/master/client.py).

The reference partitions recordio chunks into tasks and serves them to
stateless trainers over RPC with etcd-snapshotted todo/pending/done/failed
queues; a timed-out pending task is requeued, and a task failing more than
`failure_max` times is discarded (service.go:80-459).  This implementation
keeps the exact queue semantics but is etcd-free: queue snapshots go to a
JSON file (atomic rename) and leadership is a filesystem lease — a fleet
of GPU hosts has one coordinator host, so file-lease is the idiomatic
replacement for etcd election.  The counterpart of ``paddle_tpu/master.py``:
the same queues, journal and wire bytes, so either package's workers lease
from either package's master.  This module imports neither torch nor the
port's device modules.

Pieces:
  * ``Service``    — the queue state machine (thread-safe, in-process).
  * ``Server``     — serves a Service over ``multiprocessing.connection``
                     (a real process/network boundary like the Go RPC server).
  * ``Client``     — ``set_dataset / next_record / ...`` parity with
                     python/paddle/v2/master/client.py; works against an
                     in-process Service or a remote Server address.

Hostile-network plane: every message between Server and Client
rides the master_wire codec — versioned CRC frames over a restricted typed
payload encoder, bounded by ``rpc_max_message_mb`` on send AND recv — so a
corrupt, oversized or version-skewed frame is a counted, structured
rejection, never an exec of peer bytes or an unbounded allocation.
Replies are seq-correlated (duplicated/reordered deliveries discard as
stale), and when a ``net_*`` chaos point is armed the transport itself
injects faults (robustness/netem.py): the retry/timeout/fencing story
below is drilled against delay, drop, duplication, reordering, corruption
and one-way partitions, not just process death.

Durable state plane (``journal=True`` — the mode master_ha runs): every
queue/registry/fence transition appends one CRC-framed, fsync'd record to
an append-only journal (master_journal.py) BEFORE the RPC that caused it is
acknowledged, and the JSON snapshot becomes the journal's periodic
compaction target.  Recovery (or a hot standby tailing the file) replays
``snapshot + journal`` to the exact pre-crash state — task leases stay
warm, per-task result payloads survive, and a failover mid-pass completes
the pass with ZERO recomputed tasks (the etcd-journaled design of
go/master/etcd_client.go, minus etcd).

Elastic cluster plane (the scale-out completion of the Go master's
fault-tolerance model, arXiv:1605.08695 §4.4):
  * worker registry — ``register_worker``/``heartbeat`` leases, pruned by
    the same clock discipline as task leases; a dead worker's pending task
    leases requeue to survivors immediately (the etcd-lease-expiry path of
    go/master/service.go, minus etcd).
  * pass fence — ``fence_arrive``/``fence_status``: a barrier over the LIVE
    membership, so a worker that died (and was pruned) never wedges the
    pass boundary.
  * result plane — ``task_finished(task_id, epoch, result)`` attaches a
    per-task payload (the epoch guard rejects zombie owners);
    ``pass_results`` hands the full map back so every worker reduces the
    pass deterministically in task-id order (trainer/elastic.py).
"""

from __future__ import annotations

import dataclasses
import errno as _errno
import glob as _glob
import json
import logging
import os
import socket as _socket
import struct as _struct
import threading
import time
from multiprocessing.connection import Client as _ConnClient, Listener
from typing import Any, Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch import master_journal as _mj
from paddle_tpu_torch import master_wire as _wire
from paddle_tpu_torch import obs as _obs
from paddle_tpu_torch.analysis.lock_sanitizer import make_lock, make_rlock
from paddle_tpu_torch.io import recordio
from paddle_tpu_torch.robustness import chaos as _chaos
from paddle_tpu_torch.robustness import netem as _netem

_log = logging.getLogger("paddle_tpu_torch.master")

__all__ = [
    "Service", "Server", "Client", "MasterRPCError", "MasterTransportError",
    "MasterTimeoutError",
]


class MasterRPCError(RuntimeError):
    """The master executed the call and reported an application error —
    distinct from transport failures so HA clients do not reconnect-retry
    deterministic errors."""


class MasterTransportError(ConnectionError):
    """The TRANSPORT failed (broken pipe / EOF / refused) and the client's
    short reconnect-retry window was exhausted — the call may or may not
    have executed.  Subclasses ConnectionError so HA wrappers (master_ha.
    HAClient) treat it as 'leader gone, re-discover', never as an
    application error."""


class MasterTimeoutError(MasterTransportError):
    """The per-call DEADLINE elapsed with no reply — the socket may be
    half-open (a master that bounced without an RST, a frozen leader) and
    the call may or may not have executed.  Distinct from the generic
    transport error so callers can observe stuck-vs-dead; still a
    MasterTransportError/ConnectionError subclass so every HA
    reconnect-and-rediscover path treats it as 'leader gone' (the whole
    master surface is idempotent-or-epoch-guarded, so the at-least-once
    retry that follows is absorbed server-side)."""


@dataclasses.dataclass
class Task:
    task_id: int
    chunks: List[recordio.Chunk]
    epoch: int = 0  # failure count (reference service.go Task.Epoch)

    def to_json(self):
        return {
            "task_id": self.task_id,
            "epoch": self.epoch,
            "chunks": [
                {"path": c.path, "offset": c.offset, "n_records": c.n_records}
                for c in self.chunks
            ],
        }

    @staticmethod
    def from_json(d):
        return Task(
            d["task_id"],
            [recordio.Chunk(c["path"], c["offset"], c["n_records"]) for c in d["chunks"]],
            d["epoch"],
        )


class Service:
    """Queue state machine: todo / pending / done / failed (reference
    go/master/service.go:80)."""

    def __init__(
        self,
        snapshot_path: Optional[str] = None,
        chunks_per_task: int = 8,
        timeout_s: float = 60.0,
        failure_max: int = 3,
        auto_rotate: bool = True,
        snapshot_min_interval_s: float = 1.0,
        clock=time.time,
        worker_timeout_s: float = 10.0,
        journal: bool = False,
        journal_fsync: bool = True,
        journal_compact_every: int = 512,
    ):
        """auto_rotate=True mirrors the reference: the moment a pass drains,
        done tasks recycle into todo and other trainers stream straight into
        the next pass (pass-end is a per-client observation, service.go:404).
        auto_rotate=False holds the pass boundary until start_new_pass() —
        the synchronized-pass mode a sync-SGD trainer wants.

        ``journal=True`` turns the snapshot file into a journaled state
        plane: transitions append fsync'd records to master_journal files
        next to ``snapshot_path``, the snapshot is rewritten only at
        compaction (every ``journal_compact_every`` records, at
        set_dataset, and at promotion), and recovery replays snapshot +
        journal — keeping task leases, results, registry and fences warm
        across a master death.  ``journal=False`` keeps the legacy
        debounced-snapshot behavior byte-for-byte."""
        self._lock = make_rlock("master.Service._lock")
        self._clock = clock  # injectable for deterministic lease tests
        self.chunks_per_task = chunks_per_task
        self.timeout_s = timeout_s
        self.failure_max = failure_max
        self.auto_rotate = auto_rotate
        self.snapshot_path = snapshot_path
        self.snapshot_min_interval_s = snapshot_min_interval_s
        self._last_snapshot = 0.0
        self._flush_timer: Optional[threading.Timer] = None
        self.todo: List[Task] = []
        # id -> (task, lease deadline, owner worker id or None)
        self.pending: Dict[int, Tuple[Task, float, Optional[str]]] = {}
        self.done: List[Task] = []
        self.discarded: List[Task] = []
        self.fail_events = 0
        self.pass_id = 0
        self._save_holder: Optional[Tuple[str, float]] = None
        # -- elastic cluster plane (registry / fences / results) ----------
        self.worker_timeout_s = worker_timeout_s
        self.workers: Dict[str, float] = {}  # worker id -> heartbeat deadline
        # pass_id -> {task_id: payload}; only the trailing passes are
        # retained (a slow or late-joining worker may still need pass P's
        # map while P+1 streams)
        self.results: Dict[int, Dict[int, Any]] = {}
        self._pass_done: Dict[int, int] = {}  # pass -> done count at rotation
        # fence id -> {"arrived": set, "released": None | frozen info dict}
        self.fences: Dict[str, Dict[str, Any]] = {}
        # worker id -> attested target pass (see start_new_pass): the
        # failover-regression heal's unanimous-vote ledger, runtime-only
        self._repass_votes: Dict[str, int] = {}
        self._repass_unanimous_since: Optional[float] = None
        # -- durable journal plane (master_journal.py) ---------------------
        self._journaled = bool(journal)
        self._journal_fsync = bool(journal_fsync)
        self.journal_compact_every = int(journal_compact_every)
        self._journal_writer: Optional[_mj.JournalWriter] = None
        self._journal_gen = 0
        self._seq = 0  # last assigned/applied journal sequence number
        self._records_since_compact = 0
        self.replayed_records = 0  # how many journal records recovery applied
        if snapshot_path and os.path.exists(snapshot_path):
            self._recover()
        if self._journaled and self.snapshot_path:
            # own the plane: start a fresh generation so (a) the next
            # failover's replay is bounded by THIS leadership's appends and
            # (b) a deposed predecessor's stragglers land in a file no
            # snapshot references
            self._compact(reclaim_orphan=True)

    # -- dataset ---------------------------------------------------------
    def set_dataset(self, patterns: Sequence[str]) -> int:
        """Partition the recordio files into tasks (reference
        service.go:105 partition()).  Idempotent: only the first caller wins,
        like the reference's SetDataset."""
        with self._lock:
            if self.todo or self.pending or self.done:
                return self.n_tasks()
            chunks: List[recordio.Chunk] = []
            for pat in patterns:
                for path in sorted(_glob.glob(pat)):
                    chunks.extend(recordio.scan_chunks(path))
            tasks = []
            for i in range(0, len(chunks), self.chunks_per_task):
                tasks.append(Task(len(tasks), chunks[i : i + self.chunks_per_task]))
            self.todo = tasks
            if self._journaled:
                self._compact()  # structural change: re-anchor the plane
            else:
                self._snapshot(force=True)
            return len(tasks)

    def n_tasks(self) -> int:
        with self._lock:
            return len(self.todo) + len(self.pending) + len(self.done)

    # -- task lifecycle --------------------------------------------------
    def get_task(self, worker_id: Optional[str] = None):
        """Pop a todo task into pending with a lease deadline (reference
        service.go:362 GetTask).  Returns the task dict, the string "wait"
        when all remaining tasks are leased to other workers (mid-pass
        starvation), or None at a pass boundary.  ``worker_id`` (when the
        caller is a registered elastic worker) records the lease owner so
        a pruned worker's leases requeue without waiting out the per-task
        timeout."""
        with self._lock:
            self._prune_workers()
            self._requeue_expired()
            if worker_id is not None:
                # a polling worker is alive by definition: auto-(re)register
                # even if the prune just expired it (prune targets SILENT
                # workers — hung or dead — which never reach this line)
                self._touch_worker(worker_id)
                # at-least-once lease delivery: if THIS worker already holds
                # a pending lease, re-serve it instead of granting another.
                # The healthy flow never hits this (workers ack before the
                # next get_task); it exists for the reply-lost case — the
                # old leader journaled the lease and died before answering,
                # so the standby's replica holds a warm lease the worker
                # never heard about.  Re-serving (with a fresh deadline)
                # completes the delivery; letting it strand would cost a
                # full task-lease timeout + a recompute.
                held = sorted(
                    tid for tid, ent in self.pending.items()
                    if ent[2] == worker_id
                )
                if held:
                    task = self.pending[held[0]][0]
                    self.pending[task.task_id] = (
                        task, self._clock() + self.timeout_s, worker_id
                    )
                    return {
                        "task": task.to_json(),
                        "epoch": task.epoch,
                        "timeout_s": self.timeout_s,
                        "pass_id": self.pass_id,
                    }
            if not self.todo and not self.pending and self.done:
                if not self.auto_rotate:
                    return None  # hold the barrier until start_new_pass()
                self._rotate_pass()
                return None  # signal pass boundary to the observing client
            if not self.todo:
                return "wait" if self.pending else None
            task = self.todo.pop(0)
            self.pending[task.task_id] = (
                task, self._clock() + self.timeout_s, worker_id
            )
            # the lease grant is journaled so a failover keeps it WARM: the
            # new leader serves the in-flight worker's eventual ack instead
            # of re-serving (= recomputing) the task
            self._journal({
                "t": "lease", "task": task.task_id, "epoch": task.epoch,
                "worker": worker_id,
            })
            self._snapshot()
            return {
                "task": task.to_json(),
                "epoch": task.epoch,
                "timeout_s": self.timeout_s,
                # which pass this task belongs to: an elastic worker that
                # believes it is on an earlier pass detects the skew here
                # and catches up BEFORE computing with stale parameters
                "pass_id": self.pass_id,
            }

    def _rotate_pass(self) -> None:
        """Recycle done → todo; epochs reset so past failures don't carry."""
        from_pass = self.pass_id
        self._rotate_pass_state()
        self._journal({"t": "rotate", "from": from_pass})
        self._snapshot(force=True)

    def _advance_pass(self, recycled: List[Task],
                      pass_done_mark: int) -> None:
        """Shared tail of every pass rotation (normal or forced): freeze
        the closing pass's done-count marker (late joiners use it to
        verify a retained result map is COMPLETE before replay-applying
        it; -1 = poisoned, never replayable), recycle ``recycled`` into
        todo at epoch 0, advance the pass, clear the per-pass
        attestations, and trim retention to the trailing passes (a slow
        worker may still be fetching pass P's results while P+1
        streams)."""
        self._pass_done[self.pass_id] = pass_done_mark
        for t in recycled:
            t.epoch = 0
        self.todo = recycled
        self.done = []
        self.pass_id += 1
        self._repass_votes.clear()
        self._repass_unanimous_since = None
        for p in [p for p in self.results if p < self.pass_id - 2]:
            del self.results[p]
        for p in [p for p in self._pass_done if p < self.pass_id - 2]:
            del self._pass_done[p]

    def _rotate_pass_state(self) -> None:
        """The pure state transition of a pass rotation — shared by the
        live path and journal replay (``apply_record``)."""
        self._advance_pass(self.done, len(self.done))

    def _force_rotate_state(self) -> None:
        """The failover-regression transition (see ``start_new_pass``):
        recycle EVERY task — todo, pending, done — into the next pass,
        drop the pass's (unfinishable) result map, and poison its frozen
        done-count so retained-map replay is impossible.  Shared by the
        live path and journal replay (``_apply_frotate``)."""
        p = self.pass_id
        tasks = sorted(
            list(self.todo)
            + [ent[0] for ent in self.pending.values()]
            + list(self.done),
            key=lambda t: t.task_id,
        )
        self.pending = {}
        self.results.pop(p, None)
        self._advance_pass(tasks, -1)

    def start_new_pass(self, target_pass: Optional[int] = None,
                       worker_id: Optional[str] = None) -> int:
        """Explicit pass barrier release (auto_rotate=False mode).

        ``target_pass`` makes the release idempotent for a fleet: the pass
        rotates only while ``pass_id < target_pass``, so a straggler that
        calls ``start_new_pass(p+1)`` after a fast worker already drained
        pass p+1 cannot double-rotate the queue past it.

        ``worker_id`` (failover-regression heal): a registered worker
        calling with ``target_pass > pass_id`` while the queue is NOT
        drained is ATTESTING that it already applied this pass — its
        reduction happened against a deposed leader whose final
        acks/rotation died in that leader's fenced journal generation.
        One vote proves nothing; when EVERY live worker has attested, no
        process exists that could legitimately recompute the re-opened
        tasks (everyone's params already include the pass — recomputed
        contributions would carry post-apply bits), so the master
        FORCE-rotates: the stale queue recycles into the next pass and
        the unfinishable pass's retained result map is POISONED
        (``_pass_done = -1``) so a late joiner can never replay it as
        complete — the committed-manifest fallback is its heal."""
        with self._lock:
            if (
                not self.todo and not self.pending and self.done
                and (target_pass is None or self.pass_id < target_pass)
            ):
                self._rotate_pass()
            elif (
                target_pass is not None and worker_id is not None
                and target_pass > self.pass_id
                and (self.todo or self.pending)
            ):
                self._prune_workers()
                self._repass_votes[worker_id] = target_pass
                live = set(self.workers)
                attested = {
                    w for w, t in self._repass_votes.items()
                    if t > self.pass_id
                }
                if not (live and live <= attested):
                    self._repass_unanimous_since = None
                else:
                    # unanimity must STAY unanimous for a full worker-
                    # timeout window before it can force anything: a
                    # briefly-silent-but-alive worker (GC pause, load
                    # stall) that was just pruned re-registers well
                    # inside that window, re-enters the live set, and —
                    # not attesting — breaks unanimity.  Only a worker
                    # silent long enough to be declared dead everywhere
                    # else in the system can be absent from the vote.
                    now = self._clock()
                    if self._repass_unanimous_since is None:
                        self._repass_unanimous_since = now
                    if now - self._repass_unanimous_since >= (
                        self.worker_timeout_s
                    ):
                        _log.warning(
                            "master: every live worker (%s) attests pass "
                            "%d was already applied on a deposed leader "
                            "(stable for %.1fs) — force-rotating past "
                            "the unrecoverable queue state",
                            sorted(live), self.pass_id,
                            now - self._repass_unanimous_since,
                        )
                        from_pass = self.pass_id
                        self._force_rotate_state()
                        self._journal({"t": "frotate", "from": from_pass})
                        self._snapshot(force=True)
            return self.pass_id

    def renew_lease(self, task_id: int, epoch: int) -> bool:
        """Extend a pending task's lease (consume-then-ack keeps the lease
        open while the trainer drains records; renewal prevents a slow
        consumer's task from expiring into the failure path).  The epoch
        guard rejects a stale holder whose task was already re-served."""
        with self._lock:
            ent = self.pending.get(task_id)
            if ent is None or ent[0].epoch != epoch:
                return False
            self.pending[task_id] = (
                ent[0], self._clock() + self.timeout_s, ent[2]
            )
            return True

    def task_finished(
        self, task_id: int, epoch: Optional[int] = None, result: Any = None,
        pass_id: Optional[int] = None,
    ) -> bool:
        """epoch (when given) guards against a stale holder acking a task
        that expired and was re-served at a higher epoch — same discipline
        as task_failed (reference service.go:404 checks task epoch).

        ``result`` (elastic workers): the task's reduction payload — e.g. a
        gradient-contribution tree — stored under the current pass for
        ``pass_results``.  A rejected (zombie) ack never stores its result,
        so the surviving re-computation's bits win.

        ``pass_id`` (elastic workers, from the lease's ``get_task`` reply)
        closes the guard rotation re-opens: epochs reset to 0 at every
        rotation, so (task, epoch) alone cannot tell a pass-N ack from a
        pass-N+1 task — a sufficiently delayed retry could land a stale
        contribution in the wrong pass.  A pass-tagged ack for any pass
        but the current one is rejected outright.

        IDEMPOTENT under client retries: a worker whose first ack landed
        but whose reply was lost (master bounce mid-call, per-call deadline
        fired) re-sends the same ``(task, epoch)`` — the duplicate is
        accepted-and-deduped against ``done``, never double-counted.  And
        a pass-tagged ack whose lease record died with a legacy
        (journal-less) master is accepted straight from ``todo`` at the
        matching epoch, so even a cold failover loses no landed
        computation (pass-LESS acks — the legacy streaming client — never
        claim from todo: their task simply re-serves, the flow's normal
        at-least-once story)."""
        if _chaos.fire("kill_master"):
            # the leader-death drill: die BEFORE executing the transition,
            # mid-pass — the worker's retry must land on the standby
            _chaos.kill_self()
        with self._lock:
            if pass_id is not None and pass_id != self.pass_id:
                return False  # cross-pass zombie: that pass already closed
            ent = self.pending.get(task_id)
            if ent is not None and (epoch is None or ent[0].epoch == epoch):
                del self.pending[task_id]
                self.done.append(ent[0])
                self._record_finish(task_id, ent[0].epoch, result)
                return True
            if epoch is None:
                return False
            # duplicate re-ack after a client retry: already done at this
            # epoch — accept and dedupe (store the result only if the first
            # delivery didn't; contributions are deterministic, so either
            # copy carries the same bits)
            for t in self.done:
                if t.task_id == task_id and t.epoch == epoch:
                    cur = self.results.get(self.pass_id, {})
                    if result is not None and task_id not in cur:
                        self._record_finish(task_id, epoch, result)
                    return True
            # post-failover ack: the lease evaporated with the old master
            # (legacy snapshot recovery requeues pending) but the worker's
            # computation is done — accept it from todo at the matching
            # epoch instead of forcing a recompute.  Pass-tagged acks only:
            # rotation resets epochs, so an untagged ack could claim a
            # LATER pass's copy of the task (the guard above already
            # rejected tagged acks for a closed pass)
            if pass_id is None:
                return False
            for i, t in enumerate(self.todo):
                if t.task_id == task_id and t.epoch == epoch:
                    self.todo.pop(i)
                    self.done.append(t)
                    self._record_finish(task_id, epoch, result)
                    return True
            return False

    def _record_finish(self, task_id: int, epoch: int, result) -> None:
        """One acked completion: retain the result payload for the current
        pass, journal the transition, publish.  Caller holds the lock and
        has already moved the task into ``done``."""
        if result is not None:
            self.results.setdefault(self.pass_id, {})[task_id] = result
        self._journal({
            "t": "finish", "task": task_id, "epoch": epoch,
            "pass": self.pass_id, "result": result,
        })
        self._snapshot()

    def task_failed(self, task_id: int, epoch: int) -> bool:
        """(reference service.go:442 TaskFailed → processFailedTask:308)"""
        with self._lock:
            ent = self.pending.get(task_id)
            if ent is None or ent[0].epoch != epoch:
                return False
            del self.pending[task_id]
            self._process_failed(ent[0])
            self._journal({"t": "fail", "task": task_id, "epoch": epoch})
            self._snapshot()
            return True

    def task_returned(self, task_id: int, epoch: int) -> bool:
        """Graceful give-back: a client closing with unconsumed records hands
        its task back to the todo queue WITHOUT burning a failure event —
        deliberate abandonment (early stop, capped test pass) is not a crash,
        and must not walk the task toward the failure_max discard."""
        with self._lock:
            ent = self.pending.get(task_id)
            if ent is None or ent[0].epoch != epoch:
                return False
            del self.pending[task_id]
            self.todo.append(ent[0])
            self._journal({"t": "ret", "task": task_id, "epoch": epoch})
            self._snapshot()
            return True

    def _process_failed(self, task: Task) -> None:
        """epoch++, discard past failure_max, else requeue (service.go:308)."""
        self.fail_events += 1
        task.epoch += 1
        if task.epoch >= self.failure_max:
            self.discarded.append(task)  # discard (service.go:336)
        else:
            self.todo.append(task)

    def _requeue_expired(self) -> None:
        now = self._clock()
        expired = [tid for tid, ent in self.pending.items() if ent[1] < now]
        for tid in expired:
            task = self.pending.pop(tid)[0]
            epoch = task.epoch  # _process_failed bumps it; journal the
            self._process_failed(task)  # epoch the replayed pop must match
            self._journal({"t": "fail", "task": tid, "epoch": epoch})

    # -- elastic cluster plane: registry / fences / results ---------------
    def _touch_worker(self, worker_id: str) -> None:
        """(Re)grant the worker's registry lease; callers hold the lock.
        Journal AFTER the insert: _journal may compact, and the snapshot it
        publishes must already contain the transition (the record's seq
        folds below the snapshot's base)."""
        is_new = worker_id not in self.workers
        self.workers[worker_id] = self._clock() + self.worker_timeout_s
        if is_new:
            # a (re)joining incarnation must not inherit a dead one's
            # force-rotate attestation: a restarted worker whose params
            # never applied the attested pass would otherwise keep a
            # spurious unanimity alive and get stranded by its own
            # ghost's vote
            self._repass_votes.pop(worker_id, None)
            self._journal({"t": "join", "worker": worker_id})

    def register_worker(self, worker_id: str) -> Dict[str, Any]:
        """Join (or rejoin) the worker registry under a heartbeat lease.
        Returns the cluster view the worker needs to enter the pass loop —
        idempotent, so a worker that outlived a master failover (the new
        leader recovers queues from the snapshot but the registry is
        runtime state) just re-registers."""
        with self._lock:
            self._prune_workers()
            self._touch_worker(worker_id)
            return {
                "pass_id": self.pass_id,
                "timeout_s": self.worker_timeout_s,
                "auto_rotate": self.auto_rotate,
                "workers": sorted(self.workers),
            }

    def heartbeat(self, worker_id: str) -> bool:
        """Renew the registry lease; False means the worker expired (or the
        master failed over) and must ``register_worker`` again."""
        with self._lock:
            self._prune_workers()
            if worker_id not in self.workers:
                return False
            self.workers[worker_id] = self._clock() + self.worker_timeout_s
            return True

    def deregister_worker(self, worker_id: str) -> None:
        """Graceful leave: held task leases go back to todo WITHOUT a
        failure event (the task_returned discipline — leaving is not a
        crash)."""
        with self._lock:
            self._repass_votes.pop(worker_id, None)
            if self.workers.pop(worker_id, None) is not None:
                self._journal({"t": "leave", "worker": worker_id})
            held = [
                tid for tid, ent in self.pending.items() if ent[2] == worker_id
            ]
            for tid in held:
                task = self.pending.pop(tid)[0]
                self.todo.append(task)
                self._journal({"t": "ret", "task": tid, "epoch": task.epoch})
            if held:
                self._snapshot()

    def live_workers(self) -> List[str]:
        with self._lock:
            self._prune_workers()
            return sorted(self.workers)

    def _prune_workers(self) -> None:
        """Expire silent workers and requeue their task leases NOW — the
        kill-one-of-N path: a dead worker costs one registry lease timeout,
        not the job (and not even the longer per-task lease timeout)."""
        now = self._clock()
        dead = [w for w, dl in self.workers.items() if dl < now]
        for w in dead:
            del self.workers[w]
            self._journal({"t": "leave", "worker": w, "pruned": True})
            held = [tid for tid, ent in self.pending.items() if ent[2] == w]
            for tid in held:
                task = self.pending.pop(tid)[0]
                epoch = task.epoch
                self._process_failed(task)
                self._journal({"t": "fail", "task": tid, "epoch": epoch})
            if held:
                self._snapshot()

    def fence_arrive(
        self, fence_id: str, worker_id: str,
        meta: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Arrive at a barrier.  The fence releases once every LIVE worker
        has arrived (membership is evaluated per poll, so a worker that
        died — and was pruned — never wedges the boundary).  Release
        freezes the arrived set and the done-task count: late arrivals see
        the frozen view and can tell they missed the membership cut.

        ``meta`` declares per-worker capabilities; ``{"ckpt": True}`` opts
        the worker into the frozen ``writers`` set, so the shard-writer
        roster is negotiated among checkpoint-enabled workers rather than
        assumed equal to the whole membership (one checkpoint-less worker
        must not doom every manifest commit)."""
        with self._lock:
            f = self.fences.setdefault(
                fence_id, {"arrived": set(), "released": None, "meta": {}}
            )
            if f["released"] is None and worker_id not in f["arrived"]:
                # journal FIRST arrivals only: fence polling re-arrives at
                # worker heartbeat cadence and must not flood the journal
                f["arrived"].add(worker_id)
                if meta:
                    f["meta"][worker_id] = dict(meta)
                _obs.instant(
                    "fence_arrive", cat="master",
                    fence=fence_id, worker=worker_id,
                )
                self._journal({
                    "t": "farrive", "fence": fence_id, "worker": worker_id,
                    "meta": dict(meta) if meta else None,
                })
            elif f["released"] is None and meta:
                changed = f["meta"].get(worker_id) != dict(meta)
                f["meta"][worker_id] = dict(meta)
                if changed:
                    # a CHANGED meta on re-arrival is durable state too —
                    # the frozen writers roster derives from it, so a warm
                    # standby must see the update (re-journaling farrive is
                    # replay-idempotent: set-add + meta overwrite).  The
                    # unchanged re-arrivals of fence polling still skip the
                    # journal, keeping the no-flood property
                    self._journal({
                        "t": "farrive", "fence": fence_id,
                        "worker": worker_id, "meta": dict(meta),
                    })
            if worker_id in self.workers:
                # arriving (and re-arriving while polling) is a liveness
                # signal: renew so a worker parked at a slow barrier is
                # never pruned mid-wait.  Renew-only — a PRUNED worker
                # re-joins through register_worker/get_task, keeping the
                # missed-the-membership-cut semantics observable.
                self.workers[worker_id] = self._clock() + self.worker_timeout_s
            if len(self.fences) > 64:  # bound runtime state
                for stale in list(self.fences)[: len(self.fences) - 64]:
                    if stale != fence_id:
                        del self.fences[stale]
            return self._fence_view(fence_id)

    def fence_status(self, fence_id: str) -> Dict[str, Any]:
        with self._lock:
            return self._fence_view(fence_id)

    def _fence_view(self, fence_id: str) -> Dict[str, Any]:
        f = self.fences.get(fence_id)
        if f is None:
            return {"known": False, "released": False}
        if f["released"] is None:
            self._prune_workers()
            members = None
            if self.workers and set(self.workers) <= f["arrived"]:
                members = sorted(f["arrived"] & set(self.workers))
            elif not self.workers and f["arrived"]:
                # no registry (legacy/single-worker use): whoever arrived
                # is the membership
                members = sorted(f["arrived"])
            if members is not None:
                f["released"] = {
                    "workers": members,
                    "writers": [
                        w for w in members
                        if f["meta"].get(w, {}).get("ckpt")
                    ],
                    "n_done": len(self.done),
                    "pass_id": self.pass_id,
                }
                _obs.instant(
                    "fence_release", cat="master", fence=fence_id,
                    workers=members,
                )
                # the frozen membership view is durable state: a standby
                # taking over mid-barrier must release the SAME view, not
                # re-evaluate membership it never observed
                self._journal({
                    "t": "frelease", "fence": fence_id,
                    "view": dict(f["released"]),
                })
        if f["released"] is None:
            return {
                "known": True, "released": False,
                "n_arrived": len(f["arrived"]),
            }
        return {"known": True, "released": True, **f["released"]}

    def pass_results(self, pass_id: int) -> Dict[str, Any]:
        """``{"results": {task_id: payload}, "n_done": int|None}`` for one
        pass — every worker reduces the map in sorted task-id order, so the
        update is bit-identical fleet-wide regardless of which worker
        computed which task.  ``n_done`` is the pass's frozen done count
        once it rotated (None while the pass is still current — the fence
        view carries the authoritative count there): a late joiner replays
        a retained pass only when ``len(results) == n_done``."""
        with self._lock:
            return {
                "results": dict(self.results.get(pass_id, {})),
                "n_done": self._pass_done.get(pass_id),
            }

    def requeue_unresulted(self) -> int:
        """Move done tasks that have NO stored result for the current pass
        back to todo.  After a master failover the queue snapshot survives
        but the in-memory result payloads do not; recomputing the orphaned
        tasks is safe because contributions are deterministic per task.
        Returns the number requeued.  (Never call this from the legacy
        record-streaming flow — its done tasks legitimately carry no
        results.)"""
        with self._lock:
            have = self.results.get(self.pass_id, {})
            orphaned = [t for t in self.done if t.task_id not in have]
            if orphaned:
                self.done = [t for t in self.done if t.task_id in have]
                self.todo.extend(orphaned)
                self._journal({
                    "t": "unres", "tasks": [t.task_id for t in orphaned],
                })
                self._snapshot()
            return len(orphaned)

    def stats(self) -> Dict[str, Any]:
        """Cluster-plane observability snapshot (cheap, lock-consistent)."""
        with self._lock:
            self._prune_workers()
            return {
                "pass_id": self.pass_id,
                "n_todo": len(self.todo),
                "n_pending": len(self.pending),
                "n_done": len(self.done),
                "n_discarded": len(self.discarded),
                "fail_events": self.fail_events,
                "workers": sorted(self.workers),
                # codec-rejection observability: the corrupt-frame drills
                # assert server_rejected_frames > 0 IN-RUN through this
                # field (Server and Service share the process, so the
                # module counters are one coherent view)
                "wire": _wire.counters.snapshot(),
            }

    # -- save-model arbitration (reference service.go:461-497) -----------
    def request_save_model(self, trainer_id: str, block_secs: float) -> bool:
        """Exactly one trainer in each window gets True."""
        with self._lock:
            now = self._clock()
            if self._save_holder and self._save_holder[1] > now:
                return self._save_holder[0] == trainer_id
            self._save_holder = (trainer_id, now + block_secs)
            return True

    # -- snapshot / journal / recover (service.go:165-273, etcd → file) --
    def fence(self) -> None:
        """Stop this (deposed) Service from ever writing the shared snapshot
        OR appending to the shared journal again, and cancel any pending
        debounced flush — a new leader owns the files now (the etcd design
        gets this for free from leases on keys)."""
        with self._lock:
            self.snapshot_path = None
            if self._journal_writer is not None:
                self._journal_writer.close()
                self._journal_writer = None
            if self._flush_timer is not None:
                self._flush_timer.cancel()
                self._flush_timer = None

    def _snapshot(self, force: bool = False) -> None:
        """Legacy (journal-less) persistence — debounced: per-task
        transitions at most one write per snapshot_min_interval_s; a skipped
        write is flushed by a timer so the last transition of a burst always
        reaches disk.  Structural changes (set_dataset, pass rotation)
        always write.  In journaled mode this is a no-op: the fsync'd
        journal append IS the per-transition durability point, and the
        snapshot is rewritten only at compaction."""
        if not self.snapshot_path or self._journaled:
            return
        now = time.time()
        if not force and now - self._last_snapshot < self.snapshot_min_interval_s:
            if self._flush_timer is None:
                t = threading.Timer(self.snapshot_min_interval_s, self._flush)
                t.daemon = True
                self._flush_timer = t
                t.start()
            return
        self._last_snapshot = now
        self._write_snapshot()

    def _flush(self) -> None:
        with self._lock:
            self._flush_timer = None
            if not self.snapshot_path:
                return  # fenced between schedule and fire
            self._last_snapshot = time.time()
            self._write_snapshot()

    def _journal(self, rec: Dict[str, Any]) -> None:
        """Append one fsync'd record; compact when the generation has grown
        past ``journal_compact_every`` records.  No-op unless journaled
        (and not fenced).  Caller holds the lock."""
        if not self._journaled or self._journal_writer is None:
            return
        self._seq += 1
        self._journal_writer.append(self._seq, rec)
        self._records_since_compact += 1
        if self._records_since_compact >= self.journal_compact_every:
            self._compact()

    def _compact(self, reclaim_orphan: bool = False) -> None:
        """Fold the journal into the snapshot and start a new generation.

        Crash-ordering: (1) write + fsync the NEW journal generation with
        the retained per-pass results re-emitted into it (seq > the
        snapshot's base, so replay re-applies them — the snapshot itself
        stays pure JSON and never carries binary payloads); (2) atomically
        publish the snapshot referencing the new generation; (3) delete
        older generations.  A crash before (2) leaves the old snapshot +
        old journal fully consistent (the new file is an unreferenced
        orphan); a crash before (3) leaves a stale-but-unreferenced old
        generation that the next compaction sweeps.

        Fencing: compaction REWRITES the shared plane (truncates into a
        generation file, replaces the snapshot, sweeps the rest), so a
        deposed-but-not-yet-fenced leader running it would corrupt the new
        leader's live state — the append-side fence ("stragglers land in
        an unreferenced file") does not cover it.  Two guards: the
        published snapshot is the ownership record (referencing a
        generation we did not write means someone else owns the plane →
        fence, return), and the new generation is created EXCLUSIVELY (a
        mid-life collision means a racing new leader → fence).  Only a
        caller that just acquired the HA lease (boot recovery, promote)
        may pass ``reclaim_orphan=True`` to take over a predecessor's
        crash orphan — a compaction that died before publishing."""
        if not self._journaled or not self.snapshot_path:
            return
        d = os.path.dirname(self.snapshot_path) or "."
        # ownership precheck parses the snapshot every time: compaction is
        # already O(dataset) (result re-emission + full snapshot rewrite),
        # and a stat-compare shortcut could miss a new leader's publish
        # (coarse mtime + equal size + recycled inode) — fencing must not
        # ride on that
        try:
            with open(self.snapshot_path) as f:
                published = json.load(f).get("journal_file")
        except (OSError, ValueError):
            published = None  # fresh cluster: no snapshot yet
        if published is not None and published != _mj.journal_filename(
            self._journal_gen
        ):
            if not reclaim_orphan:
                self.fence()  # deposed: a new leader published its gen
                return
            # we hold the FRESH lease (boot/promote): an unexpected
            # publisher is a deposed zombie's last-gasp compaction in the
            # lease-gap window — the RIGHTFUL leader must not cede the
            # plane (fencing here would leave it serving with snapshot and
            # journal silently OFF).  Adopt the published generation as
            # the base and re-anchor above it; the zombie's stragglers are
            # swept with its file
            _log.warning(
                "compaction: snapshot references %s, not our generation "
                "%s — reclaiming the plane over a deposed leader's "
                "last-gasp publish (we hold the fresh lease)",
                published, _mj.journal_filename(self._journal_gen),
            )
            self._journal_gen = _mj.parse_generation(published)
        base_seq = self._seq
        gen_at_entry = self._journal_gen
        self._journal_gen += 1
        fname = _mj.journal_filename(self._journal_gen)
        jpath = os.path.join(d, fname)
        writer = None
        try:
            try:
                writer = _mj.JournalWriter(
                    jpath, fsync=self._journal_fsync, exclusive=True
                )
            except FileExistsError:
                if not reclaim_orphan:
                    self._journal_gen = gen_at_entry  # honest while fenced
                    self.fence()  # a racing new leader created it: deposed
                    return
                # a predecessor's unpublished file sits on our target name:
                # a crash orphan — or a zombie's compaction STILL IN FLIGHT.
                # Removing and recreating the name would defeat the O_EXCL
                # fence the zombie's own publish path relies on, so NEVER
                # reuse a contested name: skip above it (the post-publish
                # sweep collects the leftovers)
                while writer is None:
                    self._journal_gen += 1
                    fname = _mj.journal_filename(self._journal_gen)
                    jpath = os.path.join(d, fname)
                    try:
                        writer = _mj.JournalWriter(
                            jpath, fsync=self._journal_fsync, exclusive=True
                        )
                    except FileExistsError:
                        continue
            for p in sorted(self.results):
                for tid in sorted(self.results[p]):
                    self._seq += 1
                    writer.append(self._seq, {
                        "t": "finish", "task": tid, "pass": p,
                        "result": self.results[p][tid],
                    }, sync=False)
            writer.sync()  # one fsync covers the whole re-emission
            # last-moment ownership re-verify: if we stalled past the lease
            # DURING this compaction (e.g. a slow fsync), a new leader may
            # have re-anchored the plane — and since reclaim skips
            # contested names, our O_EXCL create cannot catch that case.
            # Publishing now would replace the rightful leader's snapshot
            # with stale state, so the snapshot must still reference what
            # it referenced when we prechecked ownership.
            try:
                with open(self.snapshot_path) as f:
                    published_now = json.load(f).get("journal_file")
            except (OSError, ValueError):
                published_now = None
            if published_now != published:
                writer.close()
                try:
                    os.remove(jpath)
                except OSError:
                    pass
                self.fence()  # deposed mid-compaction
                return
            self._write_snapshot(seq=base_seq, journal_file=fname)
        except OSError as exc:
            # transient disk failure (ENOSPC, EIO) mid-compaction.  Roll
            # the generation back so the ownership precheck keeps matching
            # the published snapshot — a dangling bump would make the NEXT
            # attempt self-fence this healthy leader, after which every
            # acked transition would silently skip the journal.  With a
            # live old writer we keep appending durably to the old
            # generation and retry after another journal_compact_every
            # records; at boot/promote there is no old writer to fall back
            # to (durability would be OFF), so the failure must propagate.
            if writer is not None:
                writer.close()
                try:
                    os.remove(jpath)  # else the retry would hit O_EXCL
                except OSError:
                    pass
            self._journal_gen = gen_at_entry
            self._records_since_compact = 0
            if self._journal_writer is None:
                raise
            _log.warning(
                "journal compaction into %s failed (%s: %s) — keeping the "
                "current generation, will retry", fname,
                type(exc).__name__, exc,
            )
            return
        old_writer, self._journal_writer = self._journal_writer, writer
        if old_writer is not None:
            old_writer.close()
        # Sweep ONLY generations strictly below our own.  An "everything
        # but fname" sweep re-opens the fencing hole the publish path just
        # closed: a zombie stalled between its publish and its sweep can
        # wake to find a new leader re-anchored ABOVE it (reclaim adopts
        # the published generation as its base), and deleting higher-
        # numbered files would unlink the live generation the current
        # snapshot references — every transition acked after that would be
        # invisible to recovery.  Generations are monotonic, so "< ours"
        # only ever collects our own predecessors and crash orphans we
        # skipped; a zombie's higher-numbered orphan survives until a
        # later sweep passes above it.
        for stale in _glob.glob(os.path.join(d, "master_journal-*.log")):
            if _mj.parse_generation(stale) < self._journal_gen:
                try:
                    os.remove(stale)
                except OSError:
                    pass
        self._records_since_compact = 0

    def state_dict(self) -> Dict[str, Any]:
        """The JSON-able snapshot of everything but result payloads (those
        live in the journal).  Caller holds the lock."""
        return {
            "pass_id": self.pass_id,
            "todo": [t.to_json() for t in self.todo],
            "pending": [
                {"task": t.to_json(), "deadline": dl, "owner": owner}
                for (t, dl, owner) in self.pending.values()
            ],
            "done": [t.to_json() for t in self.done],
            "discarded": [t.to_json() for t in self.discarded],
            "fail_events": self.fail_events,
            "workers": sorted(self.workers),
            "pass_done": {str(p): n for p, n in self._pass_done.items()},
            "fences": {
                fid: {
                    "arrived": sorted(f["arrived"]),
                    "meta": f["meta"],
                    "released": f["released"],
                }
                for fid, f in self.fences.items()
            },
        }

    def _write_snapshot(
        self, seq: Optional[int] = None, journal_file: Optional[str] = None
    ) -> None:
        state = self.state_dict()
        if self._journaled:
            state["version"] = 2
            state["seq"] = self._seq if seq is None else seq
            state["journal_file"] = journal_file
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
            if self._journaled:
                # compaction publish: the snapshot must be durable before
                # the old generation is swept.  Legacy mode stays the
                # best-effort debounced write it always was.
                f.flush()
                os.fsync(f.fileno())  # lock: allow[C304] compaction publish: the snapshot must be durable before the old journal generation is swept — fsync-before-ack IS the durability contract
        os.replace(tmp, self.snapshot_path)

    def load_state(self, state: Dict[str, Any], warm: bool = True) -> None:
        """Restore from a v2 (journaled) snapshot dict.  ``warm=True``
        keeps OWNED pending leases pending with FRESH deadlines (the
        failover path: the owners are probably alive and mid-compute, and
        their retried acks / re-served get_tasks key on the owner id); the
        owners that aren't expire into the normal failure path.  An
        OWNERLESS lease (a legacy streaming client's) requeues immediately
        even when warm: its holder has no identity to re-serve to, so
        keeping it warm would just stall the pass for a full task timeout —
        and the holder's eventual ack still lands via the matching-epoch
        accept-from-todo branch of ``task_finished``."""
        with self._lock:
            now = self._clock()
            self.pass_id = state["pass_id"]
            self.todo = [Task.from_json(t) for t in state["todo"]]
            self.done = [Task.from_json(t) for t in state["done"]]
            self.discarded = [
                Task.from_json(t) for t in state.get("discarded", [])
            ]
            self.pending = {}
            for ent in state["pending"]:
                task = Task.from_json(ent["task"])
                owner = ent.get("owner")
                if warm and owner is not None:
                    self.pending[task.task_id] = (
                        task, now + self.timeout_s, owner
                    )
                else:
                    self.todo.append(task)
            self.fail_events = int(state.get("fail_events", 0))
            self.workers = {
                w: now + self.worker_timeout_s
                for w in state.get("workers", [])
            }
            self._pass_done = {
                int(p): n for p, n in state.get("pass_done", {}).items()
            }
            self.fences = {
                fid: {
                    "arrived": set(f.get("arrived", ())),
                    "meta": dict(f.get("meta", {})),
                    "released": f.get("released"),
                }
                for fid, f in state.get("fences", {}).items()
            }
            self.results = {}
            self._seq = int(state.get("seq", 0))

    def apply_record(self, seq: int, rec: Dict[str, Any]) -> bool:
        """Replay one journal record onto this state (recovery, and the hot
        standby's tail loop).  Sequence-guarded: a double-delivered record
        (re-read tail, compaction re-emission already applied) is a no-op,
        so replay is idempotent.  Unknown record types are a HARD error —
        a version-skewed or corrupt record must never silently vanish from
        a recovery."""
        with self._lock:
            if seq <= self._seq:
                return False
            t = rec.get("t")
            if t not in _mj.RECORD_TYPES:
                raise _mj.JournalError(
                    f"unknown journal record type {t!r} at seq {seq} — "
                    f"refusing to recover past it (version skew or "
                    f"corruption; check it with master_journal.verify_journal)"
                )
            getattr(self, f"_apply_{t}")(rec)
            self._seq = seq
            self.replayed_records += 1
            return True

    # -- per-record replay ops (pure state; never journal, never prune) --
    def _pop_todo(self, task_id: int, epoch: Optional[int]) -> Optional[Task]:
        for i, task in enumerate(self.todo):
            if task.task_id == task_id and (
                epoch is None or task.epoch == epoch
            ):
                return self.todo.pop(i)
        return None

    def _apply_lease(self, rec) -> None:
        task = self._pop_todo(rec["task"], rec.get("epoch"))
        if task is not None:
            self.pending[task.task_id] = (
                task, self._clock() + self.timeout_s, rec.get("worker")
            )

    def _apply_finish(self, rec) -> None:
        p, tid, epoch = rec["pass"], rec["task"], rec.get("epoch")
        if rec.get("result") is not None:
            self.results.setdefault(p, {})[tid] = rec["result"]
        if p != self.pass_id:
            return  # compaction re-emission for a retained earlier pass
        ent = self.pending.get(tid)
        if ent is not None and (epoch is None or ent[0].epoch == epoch):
            del self.pending[tid]
            self.done.append(ent[0])
            return
        task = self._pop_todo(tid, epoch)
        if task is not None:
            self.done.append(task)
        # else: already done (double delivery across generations) — dedupe

    def _apply_fail(self, rec) -> None:
        tid, epoch = rec["task"], rec["epoch"]
        ent = self.pending.get(tid)
        if ent is not None and ent[0].epoch == epoch:
            del self.pending[tid]
            self._process_failed(ent[0])
            return
        task = self._pop_todo(tid, epoch)
        if task is not None:
            self._process_failed(task)

    def _apply_ret(self, rec) -> None:
        ent = self.pending.get(rec["task"])
        if ent is not None and ent[0].epoch == rec["epoch"]:
            del self.pending[rec["task"]]
            self.todo.append(ent[0])

    def _apply_rotate(self, rec) -> None:
        if self.pass_id != rec["from"]:
            _log.warning(
                "journal replay: rotate record for pass %d but replica is "
                "at pass %d — skipping (divergence heals via "
                "requeue_unresulted)", rec["from"], self.pass_id,
            )
            return
        self._rotate_pass_state()

    def _apply_frotate(self, rec) -> None:
        if self.pass_id != rec["from"]:
            _log.warning(
                "journal replay: force-rotate record for pass %d but "
                "replica is at pass %d — skipping", rec["from"],
                self.pass_id,
            )
            return
        self._force_rotate_state()

    def _apply_unres(self, rec) -> None:
        ids = set(rec["tasks"])
        moved = [t for t in self.done if t.task_id in ids]
        self.done = [t for t in self.done if t.task_id not in ids]
        self.todo.extend(moved)
        for t in moved:
            self.results.get(self.pass_id, {}).pop(t.task_id, None)

    def _apply_join(self, rec) -> None:
        self.workers[rec["worker"]] = self._clock() + self.worker_timeout_s

    def _apply_leave(self, rec) -> None:
        self.workers.pop(rec["worker"], None)

    def _apply_farrive(self, rec) -> None:
        f = self.fences.setdefault(
            rec["fence"], {"arrived": set(), "released": None, "meta": {}}
        )
        if f["released"] is None:
            f["arrived"].add(rec["worker"])
            if rec.get("meta"):
                f["meta"][rec["worker"]] = dict(rec["meta"])
        if len(self.fences) > 64:  # mirror the live bound
            for stale in list(self.fences)[: len(self.fences) - 64]:
                if stale != rec["fence"]:
                    del self.fences[stale]

    def _apply_frelease(self, rec) -> None:
        f = self.fences.setdefault(
            rec["fence"], {"arrived": set(), "released": None, "meta": {}}
        )
        f["released"] = dict(rec["view"])
        f["arrived"].update(rec["view"].get("workers", ()))

    def promote(
        self,
        snapshot_path: str,
        journal_fsync: Optional[bool] = None,
        journal_compact_every: Optional[int] = None,
    ) -> None:
        """Turn a replayed standby replica into THE serving, journaling
        leader: refresh every lease deadline (standby deadlines are stale
        by construction — the owners get a full fresh window before the
        prune/expiry discipline judges them), then compact into a fresh
        journal generation this instance owns."""
        with self._lock:
            now = self._clock()
            self.snapshot_path = snapshot_path
            self._journaled = True
            if journal_fsync is not None:
                self._journal_fsync = bool(journal_fsync)
            if journal_compact_every is not None:
                self.journal_compact_every = int(journal_compact_every)
            pending, self.pending = self.pending, {}
            for tid, (task, _dl, owner) in pending.items():
                if owner is not None:
                    self.pending[tid] = (task, now + self.timeout_s, owner)
                else:
                    # replayed ownerless lease (legacy streaming client):
                    # same requeue-now rationale as load_state — no
                    # identity to re-serve to, the epoch-matched ack from
                    # todo still lands
                    self.todo.append(task)
            for w in list(self.workers):
                self.workers[w] = now + self.worker_timeout_s
            self._compact(reclaim_orphan=True)  # we hold the fresh lease

    def _recover(self) -> None:
        with open(self.snapshot_path) as f:
            state = json.load(f)
        if state.get("journal_file") is not None:
            # journaled-shape recovery: warm state + bounded journal replay
            self.load_state(state, warm=True)
            d = os.path.dirname(self.snapshot_path) or "."
            self._journal_gen = _mj.parse_generation(state["journal_file"])
            jpath = os.path.join(d, state["journal_file"])
            if os.path.exists(jpath):
                records, info = _mj.read_records(jpath)
                if info["corrupt"]:
                    # the prefix is consistent; anything past the rot is
                    # healed by lease expiry + requeue_unresulted recompute
                    _log.warning(
                        "journal %s: %s — recovered the good prefix "
                        "(%d records)", jpath, info["error"], len(records),
                    )
                for seq, rec in records:
                    self.apply_record(seq, rec)
            return
        # legacy snapshot (journal-less master, or an upgrade boot)
        self.pass_id = state["pass_id"]
        self.todo = [Task.from_json(t) for t in state["todo"]]
        self.done = [Task.from_json(t) for t in state["done"]]
        self.discarded = [Task.from_json(t) for t in state.get("discarded", [])]
        # pending leases do not survive a legacy master restart: requeue
        # immediately (the reference instead waits for timeout; restart is
        # the slow path).  A landed-but-unleased computation still counts:
        # task_finished accepts a matching-epoch ack straight from todo.
        for ent in state["pending"]:
            self.todo.append(Task.from_json(ent["task"]))


def reader_over(next_record_fn):
    """Reader-creator over a next_record callable: one call = one pass
    (shared by Client and master_ha.HAClient)."""

    def _reader():
        while True:
            rec = next_record_fn()
            if rec is None:
                return
            yield rec

    return _reader


# ---------------------------------------------------------------------------
# RPC layer
# ---------------------------------------------------------------------------

# the bound on Server.close's wake-up dial of its own accept loop
_WAKE_DIAL_S = 5.0


def _dial_with_deadline(address, authkey: bytes, timeout: Optional[float]):
    """Connect + authenticate with a hard deadline.

    The TCP connect itself fails fast against a dead port (RST), but the
    multiprocessing auth handshake can block FOREVER against a half-open
    peer — a listener that accepted into its backlog and then froze (the
    exact state a bouncing master leaves behind).  The stock _ConnClient
    has no timeout hook, so the dial runs in a watchdog'd helper thread:
    on deadline the caller raises :class:`MasterTimeoutError` and the
    helper, when (if) it finally returns, closes the abandoned connection
    itself.  A timed-out dial parks one daemon thread on the dead socket —
    bounded by the caller's retry budget, and freed when the peer's TCP
    stack gives up."""
    if timeout is None:
        return _ConnClient(tuple(address), authkey=authkey)
    box: Dict[str, Any] = {}
    done = threading.Event()
    abandoned = threading.Event()
    lock = make_lock("master._dial_handoff")  # serializes the store-vs-abandon handoff

    def _dial():
        try:
            conn = _ConnClient(tuple(address), authkey=authkey)
            with lock:
                if abandoned.is_set():
                    conn.close()
                else:
                    box["conn"] = conn
        except Exception as exc:  # noqa: BLE001 — re-raised by the caller
            box["err"] = exc
        finally:
            done.set()

    t = threading.Thread(target=_dial, name="paddle-master-dial",
                         daemon=True)
    t.start()
    if not done.wait(timeout):
        # the helper may complete the dial concurrently with this timeout:
        # under the lock, exactly one side owns (and closes) the conn
        with lock:
            abandoned.set()
            conn = box.pop("conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        raise MasterTimeoutError(
            f"master dial {tuple(address)}: no auth handshake in {timeout}s "
            f"(half-open listener?)"
        )
    if "err" in box:
        raise box["err"]
    _set_io_timeouts(box["conn"], timeout)
    return box["conn"]


def _set_io_timeouts(conn, timeout: float) -> None:
    """Arm SO_RCVTIMEO + SO_SNDTIMEO on the connection's socket.
    ``poll(deadline)`` bounds the wait for the FIRST byte of a reply, but
    Connection.recv() then blocks until the complete message arrives, and
    Connection.send() blocks whenever the peer stops draining its socket
    (a multi-MB pickled gradient tree vs a SIGSTOP'd leader fills the
    kernel buffer) — either way a frozen peer would hang the client past
    every deadline.  With i/o timeouts on the shared file description, a
    stalled read/write raises BlockingIOError, which ``_call`` translates
    into :class:`MasterTimeoutError`.  Best-effort: where the socket op
    is unavailable the poll() deadline still covers the no-reply case."""
    if os.name != "posix":
        # the raw struct-timeval pack below is POSIX layout; Windows
        # reads SO_RCVTIMEO as a DWORD of MILLISECONDS and would misread
        # tv_sec as ms, arming absurdly short timeouts — skip, keeping
        # the poll() deadline coverage
        return
    try:
        s = _socket.socket(fileno=os.dup(conn.fileno()))
    except OSError:
        return
    try:
        tv_sec = int(timeout)
        tv_usec = int((timeout - tv_sec) * 1_000_000)
        tv = _struct.pack("ll", tv_sec, tv_usec)
        s.setsockopt(_socket.SOL_SOCKET, _socket.SO_RCVTIMEO, tv)
        s.setsockopt(_socket.SOL_SOCKET, _socket.SO_SNDTIMEO, tv)
    except OSError:
        pass
    finally:
        s.close()


_METHODS = ("set_dataset", "get_task", "task_finished", "task_failed",
            "task_returned", "renew_lease", "request_save_model", "n_tasks",
            "start_new_pass",
            # elastic cluster plane
            "register_worker", "heartbeat", "deregister_worker",
            "live_workers", "fence_arrive", "fence_status", "pass_results",
            "requeue_unresulted", "stats")


class Server:
    """Serve a Service over multiprocessing.connection — the process/network
    boundary of the Go master's net/rpc server.  Every message rides the
    master_wire codec (versioned CRC framing over the restricted typed
    payload encoder): a corrupt, oversized or unknown-version frame is
    REJECTED — counted, answered with a structured wire-reject the client
    retries through — and never crashes the accept loop, never allocates
    unbounded, never deserializes damaged bytes.  ``max_message_bytes``
    bounds both directions (default: the ``rpc_max_message_mb`` flag)."""

    def __init__(self, service: Service, address=("127.0.0.1", 0), authkey=b"paddle-tpu",
                 sleep=time.sleep, max_message_bytes: Optional[int] = None,
                 methods: Optional[Tuple[str, ...]] = None,
                 backlog: int = 16):
        """``methods``: the RPC whitelist to dispatch (default: the master
        ``_METHODS`` surface).  Other planes — the serving-fleet router and
        its engine agents (serving/router.py) — reuse this hardened
        server (codec rejects, hostile-handshake accept loop, per-conn
        threads) by passing their own service object + whitelist.

        ``backlog``: the listen queue depth.  The Listener default (1) is
        fine for a training fleet whose workers dial once at staggered
        times, but a SERVING plane dials in bursts — per-request client
        connections arriving together overflow a 1-deep accept queue, and
        the dropped SYNs park on kernel retransmit timers (1s, 2s, 4s...)
        that read as multi-second routing latency.  The serving fleet
        passes a deeper queue still."""
        self.service = service
        self._methods = tuple(methods) if methods is not None else _METHODS
        self._authkey = authkey
        self._sleep = sleep  # injectable: tests drive the accept-loop backoff
        self._max_msg = max_message_bytes or _wire.default_max_bytes()
        self._listener = Listener(address, backlog=int(backlog),
                                  authkey=authkey)
        self.address = self._listener.address
        self._stop = False
        self._conns: List = []
        self._conns_lock = make_lock("master.Server._conns_lock")
        self._thread = threading.Thread(
            target=self._serve, name="paddle-master-accept", daemon=True
        )
        self._thread.start()

    def _serve(self) -> None:
        while not self._stop:
            try:
                conn = self._listener.accept()
            except OSError as exc:
                if self._stop:
                    return  # the listener itself closed (Server.close)
                if isinstance(exc, ConnectionError):
                    # ConnectionResetError / BrokenPipeError from the auth
                    # handshake: ONE client hung up (RST mid-challenge) —
                    # per-client, same discipline as the clause below
                    continue
                if exc.errno is None:
                    # no errno = not a socket-level failure at all: the
                    # AUTH HANDSHAKE choked on garbage bytes — e.g.
                    # multiprocessing's "bad message length" when a port
                    # scanner's random length prefix blows its bound.
                    # Strictly per-client; treating it as a broken
                    # listener let ONE hostile connect close the master's
                    # port (found by the corrupt-frame storm drill)
                    continue
                if exc.errno in (
                    _errno.EMFILE, _errno.ENFILE,
                    _errno.ECONNABORTED, _errno.EINTR,
                ):
                    # transient: fd exhaustion under a dial storm (every
                    # timed-out client dial parks a socket) or an aborted
                    # connect.  The LISTENER is fine — bailing out here
                    # would leave the port bound-but-dead with clients
                    # queueing in the backlog until their dial deadlines
                    self._sleep(0.05)
                    continue
                # the listening socket itself is broken: close it so
                # clients get RST (fail fast into their retry loops)
                # instead of queueing in a dead backlog
                try:
                    self._listener.close()
                except OSError:
                    pass
                return
            except Exception:  # noqa: BLE001 — per-CLIENT handshake failure
                # A dialer that hung up mid-auth (its deadline fired and it
                # abandoned the socket — routine during a master bounce) or
                # presented a bad authkey surfaces here as EOFError /
                # AuthenticationError.  One client's failed handshake must
                # never kill the accept loop: the server would keep the
                # port bound (looking alive) while serving NOBODY — the
                # exact half-open state the client-side dial deadline
                # exists to escape.  Drop the connection, keep accepting.
                continue
            # hostile-network drills: when a net_* chaos point is armed the
            # accepted connection serves through the fault-injecting
            # transport (robustness/netem.py); unarmed this is a no-op
            conn = _netem.maybe_wrap(conn, role="server")
            with self._conns_lock:
                self._conns.append(conn)
            if self._stop:  # closed while accepting: don't serve it
                try:
                    conn.close()
                except OSError:
                    pass
                return
            threading.Thread(
                target=self._handle, args=(conn,),
                name="paddle-master-conn", daemon=True,
            ).start()

    def _reject_frame(self, conn, exc: Exception) -> bool:
        """One codec rejection: count it, tell the client with a structured
        wire-reject reply (the request never executed, so the client's
        bounded retry re-sends it whole).  Returns False when the reply
        itself cannot be delivered — drop the connection then."""
        _wire.counters.incr("server_rejected_frames")
        _log.warning("master: rejected inbound frame: %s", exc)
        try:
            _wire.send_msg(
                conn, (False, {"__wire_reject__": str(exc)}), self._max_msg
            )
            return True
        except (OSError, ValueError, _wire.MasterWireError):
            return False

    def _reply(self, conn, ok: bool, result, seq) -> None:
        """Send one reply, echoing the request's correlation ``seq`` (the
        client discards stale/duplicated replies by it).  A reply the
        codec refuses — an unencodable or over-budget result — degrades to
        a structured application error instead of a wedged client."""
        reply = (ok, result) if seq is None else (ok, result, seq)
        try:
            _wire.send_msg(conn, reply, self._max_msg, label="server")
        except _wire.MasterWireError as exc:
            _wire.counters.incr("server_reply_rejected")
            fallback = (False, repr(exc))
            _wire.send_msg(
                conn, fallback if seq is None else fallback + (seq,),
                self._max_msg,
            )

    def _handle(self, conn) -> None:
        try:
            while not self._stop:  # deposed leader: stop serving stale state
                try:
                    msg = _wire.recv_msg(conn, self._max_msg, label="server")
                except _wire.WireOversizeError as exc:
                    # the transport refused the length prefix BEFORE
                    # allocating and closed the (now desynced) stream —
                    # count, log, drop this client; the listener keeps
                    # accepting
                    _wire.counters.incr("server_rejected_frames")
                    _wire.counters.incr("server_oversize_frames")
                    _log.warning("master: dropped connection: %s", exc)
                    return
                except _wire.MasterWireError as exc:
                    # corrupt/unknown-version frame inside an INTACT
                    # message boundary: stream sync is preserved by the
                    # transport's own framing, so reject the frame and
                    # keep serving the connection
                    if not self._reject_frame(conn, exc):
                        return
                    continue
                # requests are (method, args[, meta]); meta carries the obs
                # correlation id and the reply-matching seq.  A structurally
                # alien — but validly encoded — message is a reject, not a
                # crash (hostile peers send anything).
                if (not isinstance(msg, (tuple, list)) or len(msg) < 2
                        or not isinstance(msg[0], str)):
                    if not self._reject_frame(
                        conn, _wire.WireCorruptError(
                            f"request shape {type(msg).__name__} is not "
                            f"(method, args[, meta])"
                        )
                    ):
                        return
                    continue
                method, args = msg[0], msg[1]
                meta = msg[2] if len(msg) > 2 else None
                if not isinstance(meta, dict):
                    meta = None
                seq = meta.get("seq") if meta else None
                if method == "__close__":
                    return
                if method not in self._methods:
                    self._reply(conn, False, f"no such method {method}", seq)
                    continue
                # the server-side half of the skew-alignment pair: span
                # `rpc:<method>` with the CLIENT's correlation id — `trace
                # merge` pins its midpoint to the client span's midpoint
                with _obs.span(
                    "rpc:" + method, cat="master",
                    rpc=(meta or {}).get("rpc"),
                ):
                    try:
                        ok, result = True, getattr(self.service, method)(*args)
                    except Exception as exc:  # noqa: BLE001 — RPC boundary
                        ok, result = False, repr(exc)
                    self._reply(conn, ok, result, seq)
        except (EOFError, OSError, TypeError, AttributeError):
            # TypeError/AttributeError: Server.close() closed this conn while
            # recv() was blocked (multiprocessing nulls the handle mid-read)
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def close(self) -> None:
        """Stop accepting AND drop live per-connection handler threads — a
        deposed HA leader must not keep serving stale state to connected
        clients.  The accept loop is WOKEN with a dummy connection before
        the listener closes: a thread blocked in accept() holds the
        listening socket open past Listener.close(), which would keep the
        port bound and break a master restarting on its own address."""
        self._stop = True
        try:
            # deadline-guarded: an accept loop that saw _stop between two
            # accepts has already returned, and a dial into a backlog that
            # nobody accepts would wait for the auth challenge forever
            _dial_with_deadline(self.address, self._authkey, _WAKE_DIAL_S).close()
        except Exception:  # noqa: BLE001 — wake-up is best effort
            pass
        self._listener.close()
        self._thread.join(timeout=5)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class Client:
    """python/paddle/v2/master/client.py parity: set_dataset + next_record.

    `master` is either an in-process Service or a (host, port) address of a
    Server.  Records stream task-by-task; at a pass boundary next_record
    returns None once (like the reference's empty-record pass signal)."""

    def __init__(
        self,
        master,
        authkey: bytes = b"paddle-tpu",
        trainer_id: str = "0",
        reconnect_tries: int = 5,
        reconnect_backoff: float = 0.1,
        call_timeout_s: Optional[float] = 60.0,
        sleep=time.sleep,
        max_message_bytes: Optional[int] = None,
        methods: Optional[Tuple[str, ...]] = None,
    ):
        """``call_timeout_s`` is the per-RPC deadline (dial + reply): a
        call against a half-open socket — a master that bounced without an
        RST, a frozen leader — surfaces as :class:`MasterTimeoutError`
        instead of blocking forever.  ``None`` disables the deadline.
        ``max_message_bytes`` bounds frames BOTH ways (default: the
        ``rpc_max_message_mb`` flag)."""
        self.call_timeout_s = (
            None if call_timeout_s is None else float(call_timeout_s)
        )
        # the delegation surface __getattr__ exposes; other planes (the
        # serving-fleet router/engine RPC) pass their own whitelist
        self._methods = tuple(methods) if methods is not None else _METHODS
        self._sleep = sleep  # injectable: reconnect backoff + lease polls
        self._max_msg = max_message_bytes or _wire.default_max_bytes()
        self._seq = 0  # per-call correlation: stale replies discard by it
        if isinstance(master, Service):
            self._service = master
            self._conn = None
        else:
            self._service = None
            self._address = tuple(master)
            self._authkey = authkey
            self._conn = self._dial()
            self._conn_lock = make_lock("master.Client._conn_lock")
        self.reconnect_tries = max(int(reconnect_tries), 1)
        self.reconnect_backoff = float(reconnect_backoff)
        self.trainer_id = trainer_id
        self._records: List[bytes] = []
        self._pending_task = None  # (task_id, epoch) awaiting ack-on-drain
        self._last_renew = 0.0
        self.lease_renew_secs = 10.0  # renewal throttle ceiling
        self._renew_interval = self.lease_renew_secs

    def _dial(self):
        """Deadline-guarded dial, wrapped in the netem fault transport
        when a ``net_*`` chaos point is armed (a re-dial during an active
        partition stays partitioned — the link is down, not the socket)."""
        return _netem.maybe_wrap(
            _dial_with_deadline(
                self._address, self._authkey, self.call_timeout_s
            ),
            role="client",
        )

    def _timeout(self, msg: str) -> "MasterTimeoutError":
        """Tear down the (half-open) connection and build the deadline
        error for the caller to raise: a frozen peer stays frozen, so the
        socket is dead either way."""
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None
        return MasterTimeoutError(msg)

    def _call(self, method: str, *args):
        """One RPC.  Transient TRANSPORT failures (connection reset / EOF on
        the pipe — a master restarting, a dropped socket) get a short
        reconnect-retry with exponential backoff before surfacing as
        :class:`MasterTransportError`; the retried call is re-sent whole
        (every master method is idempotent-or-epoch-guarded, so an
        at-least-once duplicate is absorbed server-side).  Application
        errors surface as :class:`MasterRPCError` immediately — the master
        EXECUTED the call; retrying a deterministic failure is futile.

        Every remote call carries a DEADLINE (``call_timeout_s``): if the
        reply doesn't arrive in time — a half-open socket after a master
        bounce, a frozen leader — the connection is dropped and
        :class:`MasterTimeoutError` raises immediately (no in-client
        retry: a frozen peer stays frozen; the HA layer re-discovers the
        leader instead).  The abandoned call may still execute
        server-side, which the idempotent surface absorbs on retry.

        Hostile-network discipline: the request is wire-encoded ONCE up
        front — an unencodable or over-budget payload raises a structured
        :class:`~paddle_tpu_torch.master_wire.MasterWireError` immediately
        (deterministic; retrying cannot shrink a gradient tree) — and the
        reply is matched by a per-call ``seq``: a duplicated or reordered
        delivery (netem drills, at-least-once retries) surfaces as a
        STALE reply that is discarded, never as a reply credited to the
        wrong call.  A corrupt reply frame, or the server's structured
        rejection of our (corrupted-in-flight) request, rides the same
        bounded reconnect-retry as a transport blip."""
        if self._service is not None:
            with _obs.span("rpc_call:" + method, cat="rpc"):
                return getattr(self._service, method)(*args)
        last_err: Optional[Exception] = None
        # the client-side half of the skew-alignment pair: the rpc id rides
        # the wire in the meta dict so the server span carries the SAME
        # correlation id; `seq` is the reply-matching correlation every
        # call carries
        rpc_id = _obs.next_rpc_id() if _obs.tracer.recording else None
        with self._conn_lock:
            # seq is minted UNDER the exchange lock: two threads sharing
            # this client must never carry the same seq, or a late/
            # duplicated reply could be credited to the wrong call —
            # the exact misattribution the correlation exists to prevent
            self._seq += 1
            seq = self._seq
            meta: Dict[str, Any] = {"seq": seq}
            if rpc_id is not None:
                meta["rpc"] = rpc_id
            # encode ONCE, outside the retry loop: WireTypeError/
            # WireOversizeError are deterministic and surface immediately
            # as the structured send-side bound (satellite: a multi-MB
            # tree no longer wedges against a frozen peer — it fails
            # fast, named)
            frame = _wire.encode_frame(
                _wire.encode_payload((method, args, meta)), self._max_msg
            )
            for attempt in range(self.reconnect_tries):
                try:
                    if self._conn is None:
                        self._conn = self._dial()
                    # the span covers ONLY the send->recv exchange (not
                    # the lock-queue wait or dial retries above): its
                    # midpoint is what `trace merge` pins the server
                    # handling span to, and client-side-only latencies
                    # would bias the skew estimate
                    with _obs.span(
                        "rpc_call:" + method, cat="rpc", rpc=rpc_id,
                    ):
                        try:
                            self._conn.send_bytes(frame)  # lock: allow[C304] _conn_lock serializes the whole RPC exchange by design; the poll deadline + SO_SNDTIMEO bound the hold
                            _wire.count_bytes("sent", len(frame), "client")
                        except BlockingIOError as exc:
                            # SO_SNDTIMEO fired: the peer stopped draining
                            # its socket mid-request (frozen master, full
                            # buffer)
                            raise self._timeout(
                                f"master RPC {method}: request stalled "
                                f"mid-send (frozen master)"
                            ) from exc
                        ok, result = self._recv_reply(method, seq)
                    break
                except MasterTimeoutError:
                    raise
                except (
                    _wire.MasterWireError, ConnectionError, EOFError, OSError,
                ) as exc:
                    last_err = exc
                    if self._conn is not None:
                        try:
                            self._conn.close()
                        except OSError:
                            pass
                        self._conn = None
                    if attempt + 1 >= self.reconnect_tries:
                        raise MasterTransportError(
                            f"master RPC {method}: transport failed after "
                            f"{self.reconnect_tries} attempt(s): {exc!r}"
                        ) from exc
                    # backoff keeps _conn_lock deliberately: a second
                    # caller dialing concurrently would race the fresh
                    # connection (injected sleep: tests drive it)
                    self._sleep(self.reconnect_backoff * (2 ** attempt))
        if not ok:
            raise MasterRPCError(f"master RPC {method} failed: {result}")
        return result

    def _recv_reply(self, method: str, seq: int) -> Tuple[bool, Any]:
        """Wait out ONE reply matching ``seq`` under the per-call
        deadline.  Stale replies (an abandoned call's late answer, a
        netem-duplicated delivery) are counted and discarded; a corrupt
        frame or the server's structured wire-reject raises the
        (retryable) wire error.  Only reached while ``_conn_lock`` is
        held by ``_call``."""
        deadline = (
            None if self.call_timeout_s is None
            else time.monotonic() + self.call_timeout_s
        )
        discarded = 0
        while True:
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._conn.poll(remaining):
                    raise self._timeout(
                        f"master RPC {method}: no reply in "
                        f"{self.call_timeout_s}s (half-open socket "
                        f"or frozen master); the call may have "
                        f"executed"
                    )
            try:
                buf = self._conn.recv_bytes(self._max_msg)  # lock: allow[C304] same intentional hold: one in-flight RPC per connection, bounded by SO_RCVTIMEO
            except BlockingIOError as exc:
                # SO_RCVTIMEO fired mid-message: the peer froze
                # after sending a PARTIAL reply — past poll()'s
                # first-byte deadline, so surface the same way
                raise self._timeout(
                    f"master RPC {method}: reply stalled "
                    f"mid-message (frozen master); the call "
                    f"may have executed"
                ) from exc
            except OSError as exc:
                if "bad message length" in str(exc):
                    # recv-side size bound: refused before allocation
                    _wire.counters.incr("client_rejected_frames")
                    _wire.counters.incr("client_oversize_frames")
                    raise _wire.WireOversizeError(
                        f"master RPC {method}: reply exceeds the "
                        f"{self._max_msg}-byte bound (flag "
                        f"rpc_max_message_mb)"
                    ) from exc
                raise
            _wire.count_bytes("recv", len(buf), "client")
            try:
                resp = _wire.decode_payload(
                    _wire.decode_frame(buf, self._max_msg)
                )
            except _wire.MasterWireError:
                _wire.counters.incr("client_rejected_frames")
                raise
            if not isinstance(resp, (tuple, list)) or len(resp) < 2:
                _wire.counters.incr("client_rejected_frames")
                raise _wire.WireCorruptError(
                    f"master RPC {method}: reply shape "
                    f"{type(resp).__name__} is not (ok, result[, seq])"
                )
            if (len(resp) == 2 and resp[0] is False
                    and isinstance(resp[1], dict)
                    and "__wire_reject__" in resp[1]):
                # the server's codec refused OUR frame (corrupted in
                # flight): the call never executed — retry re-sends it
                raise _wire.WireCorruptError(
                    f"master RPC {method}: server rejected request "
                    f"frame: {resp[1]['__wire_reject__']}"
                )
            if len(resp) >= 3 and resp[2] != seq:
                # a duplicated/reordered delivery, or an abandoned
                # call's late reply: never credit it to THIS call
                _wire.counters.incr("stale_replies_discarded")
                discarded += 1
                if discarded > 64:
                    raise _wire.WireCorruptError(
                        f"master RPC {method}: {discarded} consecutive "
                        f"stale replies (reply stream desynced)"
                    )
                continue
            return bool(resp[0]), resp[1]

    # -- surface ---------------------------------------------------------
    def set_dataset(self, patterns: Sequence[str]) -> int:
        return self._call("set_dataset", list(patterns))

    def request_save_model(self, block_secs: float = 60.0) -> bool:
        return self._call("request_save_model", self.trainer_id, block_secs)

    def start_new_pass(self, target_pass: Optional[int] = None,
                       worker_id: Optional[str] = None) -> int:
        return self._call("start_new_pass", target_pass, worker_id)

    def __getattr__(self, name: str):
        """Every other RPC method (the elastic cluster surface — get_task,
        task_finished(task, epoch, result), register_worker/heartbeat,
        fence_arrive/fence_status, pass_results, requeue_unresulted,
        stats, ...) delegates positionally straight from ``_METHODS`` —
        ONE definition instead of a hand-kept mirror per client class.
        Signatures/semantics are the Service methods'."""
        if name != "_methods" and name in self._methods:
            return lambda *args: self._call(name, *args)
        raise AttributeError(
            f"{type(self).__name__!s} has no attribute {name!r}"
        )

    def next_record(self) -> Optional[bytes]:
        """The next record of the current task, fetching a new task when the
        current one drains; None exactly at a pass boundary."""
        if self._records and self._pending_task is not None:
            # Renew the held lease while the trainer drains (throttled to a
            # fraction of the server's lease timeout): a consumer slower than
            # the lease timeout must not trip the failure/discard path.  A
            # failed renewal means the task already expired and was re-served
            # elsewhere — keep serving the buffer (at-least-once duplicates),
            # the epoch-guarded ack below is then a harmless no-op.
            now = time.time()
            if now - self._last_renew >= self._renew_interval:
                self._last_renew = now
                self._call("renew_lease", *self._pending_task)
        while not self._records:
            # Consume-then-ack (at-least-once, reference go/master client
            # semantics): the previous task is finished only once every one
            # of its records has been handed to the trainer, so a crash
            # mid-consumption re-serves the task instead of losing it.
            if self._pending_task is not None:
                self._call("task_finished", *self._pending_task)
                self._pending_task = None
            got = self._call("get_task")
            if got is None:
                return None
            if got == "wait":  # other workers hold the remaining leases
                self._sleep(0.01)
                continue
            fetched: List[bytes] = []
            try:
                for c in got["task"]["chunks"]:
                    with recordio.Reader(c["path"], offset=c["offset"]) as r:
                        for _ in range(c["n_records"]):
                            rec = r.next()
                            if rec is None:
                                break
                            fetched.append(rec)
            except IOError:
                self._call("task_failed", got["task"]["task_id"], got["epoch"])
                continue
            # Lease is held until drain (renewed above while consuming); a
            # crash mid-consumption re-serves the task (duplicates are
            # possible, loss is not).
            self._pending_task = (got["task"]["task_id"], got["epoch"])
            self._last_renew = time.time()
            # Renew well before the server-side lease expires.
            self._renew_interval = min(
                self.lease_renew_secs, got.get("timeout_s", 60.0) / 3.0
            )
            self._records = fetched
        return self._records.pop(0)

    def reader(self):
        """A reader-creator over next_record for the v2 trainer: one call =
        one pass."""
        return reader_over(self.next_record)

    def close(self) -> None:
        # Release a held lease: ack if the buffer drained, otherwise hand the
        # task back (no failure event) so the records re-serve this pass
        # instead of expiring into the failure/discard path.
        if self._pending_task is not None:
            try:
                if self._records:
                    self._call("task_returned", *self._pending_task)
                else:
                    self._call("task_finished", *self._pending_task)
            except (RuntimeError, BrokenPipeError, OSError, EOFError):
                pass
            self._pending_task = None
            self._records = []
        if self._conn is not None:
            try:
                _wire.send_msg(self._conn, ("__close__", ()), self._max_msg)
            except (BrokenPipeError, OSError, _wire.MasterWireError):
                pass
            self._conn.close()
