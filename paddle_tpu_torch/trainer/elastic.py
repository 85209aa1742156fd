"""Elastic multi-process training — the pass-synchronous worker loop over
the master's cluster plane (worker registry, shard leases, fences, results);
the counterpart of ``paddle_tpu/trainer/elastic.py``.  ``python -m
paddle_tpu_torch.trainer.elastic`` (or ``python -m paddle_tpu_torch
worker``) is one worker process.  Its wire bytes, reductions and
checkpoints equal the JAX package's, so the two packages' workers can
share one master and one fleet.

This completes the reference's fault-tolerance story end-to-end (the Go
master's lease-based dispatch, go/master/service.go, in the TF-paper model
of arXiv:1605.08695 §4.4): N trainer processes lease data-shard tasks from
the master, each computes a DETERMINISTIC per-task gradient contribution
(trainer/step.py make_grad_step, or any model honoring the protocol below),
and submits it with the epoch-guarded ``task_finished`` ack.  At the pass
boundary every live worker arrives at a fence; on release each worker
fetches the full ``{task_id: contribution}`` map and reduces it in sorted
task-id order, so the applied update — and therefore the whole parameter
trajectory — is bit-identical no matter which worker computed which task.

That invariant is the elasticity mechanism, not a nicety:

  * kill -9 one of N mid-pass → its registry lease expires, the master
    requeues its held shard leases to survivors (``failure_max`` epoch
    discipline), the pass completes, and final params match an
    uninterrupted run bit-for-bit;
  * a hung worker (GC pause, NFS stall) is pruned the same way; when it
    wakes, its stale acks are rejected by epoch and it rejoins as a late
    worker;
  * a joining worker just registers, restores the latest committed
    checkpoint manifest, and starts leasing.

Checkpoints are **sharded + asynchronous**: after applying a pass, worker
rank r of the fence membership writes shard r of the full state off the hot
path (checkpoint.CheckpointManager.save_shard), and the step commits at the
NEXT fence — once every writer has joined its background write — by
publishing ``MANIFEST.json`` atomically.  A worker that died mid-write
strands an uncommitted shard set that ``restore_latest`` walks straight
past.

Model protocol (duck-typed; see :class:`NumpyLinearModel` and
:class:`TrainerTaskModel`):

    task_grad(records, pass_id, task_id) -> (mean_grad_tree, cost_sum, rows)
        deterministic per (records, pass_id, task_id) — NOT per worker
    apply(mean_grad_tree) -> None        deterministic state transition
    state() -> pytree                    full state for checkpointing
    load(tree, extra) -> None            restore from a checkpoint
"""

from __future__ import annotations

import argparse
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch import master_wire as _wire
from paddle_tpu_torch import obs as _obs
from paddle_tpu_torch.io import recordio
from paddle_tpu_torch.ops import quantize as _bsq
from paddle_tpu_torch.robustness import chaos as _chaos
from paddle_tpu_torch.utils.timers import global_stats

__all__ = [
    "ElasticWorker",
    "NumpyLinearModel",
    "TrainerTaskModel",
    "reduce_results",
    "main",
]

_log = logging.getLogger("paddle_tpu_torch.trainer.elastic")


class _PassSuperseded(Exception):
    """The pass we were reducing closed under us (a force-rotation while
    we were briefly pruned, or a rotation we slept through): its retained
    map can no longer be reduced here — the worker must catch up to the
    master's pass instead.  ``target`` is the master's current pass."""

    def __init__(self, target: int):
        super().__init__(f"pass superseded; master is at pass {target}")
        self.target = target


# ---------------------------------------------------------------------------
# Deterministic reduction over nested-dict gradient trees (numpy only)
# ---------------------------------------------------------------------------

def _tree_axpy(acc, tree, w: float):
    """acc += tree * w, recursively over nested dicts; None acc allocates.
    The scale stays in each leaf's own dtype so every worker runs the exact
    same float ops in the exact same order."""
    if isinstance(tree, dict):
        return {
            k: _tree_axpy(None if acc is None else acc[k], v, w)
            for k, v in tree.items()
        }
    arr = np.asarray(tree)
    if np.issubdtype(arr.dtype, np.floating):
        term = arr * arr.dtype.type(w)
    else:
        term = arr * w
    return term if acc is None else acc + term


def _tree_scale(tree, s: float):
    if isinstance(tree, dict):
        return {k: _tree_scale(v, s) for k, v in tree.items()}
    arr = np.asarray(tree)
    if np.issubdtype(arr.dtype, np.floating):
        return arr * arr.dtype.type(s)
    return arr * s


def reduce_results(results: Dict[int, Any]) -> Tuple[Any, float, int]:
    """(mean_grads, mean_cost, total_rows) from a pass's ``{task_id:
    {"grads", "cost", "rows"}}`` map, reduced in sorted task-id order —
    the canonical order every worker uses, so the reduction is
    bit-identical fleet-wide.

    Contributions may arrive block-scale quantized (the producing worker
    ran with ``elastic_quantized_grads``): dequantize-THEN-reduce keeps
    the determinism contract, because every reducer dequantizes the SAME
    producer bytes before the same sorted-order float ops — which worker
    quantized which task still cannot change the trajectory."""
    order = sorted(results)
    if not order:
        raise ValueError("empty result map: nothing to reduce")
    total_rows = sum(int(results[t]["rows"]) for t in order)
    acc = None
    for t in order:
        grads = _bsq.dequantize_tree(results[t]["grads"])
        acc = _tree_axpy(acc, grads, float(results[t]["rows"]))
    mean = _tree_scale(acc, 1.0 / total_rows)
    mean_cost = sum(float(results[t]["cost"]) for t in order) / total_rows
    return mean, mean_cost, total_rows


def _read_task_records(task_json: Dict[str, Any]) -> List[bytes]:
    recs: List[bytes] = []
    for c in task_json["chunks"]:
        with recordio.Reader(c["path"], offset=c["offset"]) as r:
            for _ in range(c["n_records"]):
                rec = r.next()
                if rec is None:
                    break
                recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# Worker loop
# ---------------------------------------------------------------------------

class ElasticWorker:
    """One trainer process of an elastic fleet.

    ``client`` is a master surface (master.Client or master_ha.HAClient)
    exposing the cluster plane; ``heartbeat_client`` (optional but
    recommended — the CLI always wires one) renews the registry lease from
    a side thread so a long CUDA start-up can't get this worker pruned."""

    def __init__(
        self,
        client,
        worker_id: str,
        model,
        manager=None,
        resume: bool = False,
        heartbeat_client=None,
        heartbeat_interval: Optional[float] = None,
        poll_s: float = 0.02,
        min_workers: int = 1,
        rpc_retry_window_s: float = 60.0,
        quantized_grads: Optional[bool] = None,
        clock=time.time,
        sleep=time.sleep,
    ):
        self.client = client
        self.worker_id = worker_id
        self.model = model
        self.manager = manager
        self.resume = resume
        self.poll_s = poll_s
        # bounded ride-through for a master bounce: transport/timeout
        # failures on the cluster-plane RPCs retry with backoff inside this
        # window (every master method is idempotent-or-epoch-guarded, so
        # the at-least-once re-send is absorbed server-side); past it the
        # worker exits nonzero for its supervisor
        self.rpc_retry_window_s = float(rpc_retry_window_s)
        # gang-start hint: hold the first lease until this many workers
        # have registered, so a fast-booting worker doesn't race through
        # whole (small) passes alone while its peers are still starting —
        # purely a START gate; membership stays fully elastic afterwards
        self.min_workers = max(int(min_workers), 1)
        self._clock = clock
        self._sleep = sleep
        self._hb = heartbeat_client
        self._hb_interval = heartbeat_interval
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_pause = threading.Event()
        self._stop = threading.Event()
        # a pass whose shards this worker wrote but whose manifest is not
        # yet published: (step, num_shards, extra)
        self._pending_commit: Optional[Tuple[int, int, Dict[str, Any]]] = None
        # block-scale quantize this worker's gradient contributions before
        # they ride the wire (reduce_results dequantizes EVERY contribution,
        # so a mixed fleet mid-flag-flip still reduces deterministically);
        # default from the elastic_quantized_grads flag, whose
        # PADDLE_TPU_TORCH_ELASTIC_QUANTIZED_GRADS env spelling reaches launcher-
        # spawned worker processes
        if quantized_grads is None:
            try:
                from paddle_tpu_torch.utils.flags import get_flag

                quantized_grads = bool(get_flag("elastic_quantized_grads"))
            except Exception:  # noqa: BLE001 — flag plane not loaded
                quantized_grads = False
        self.quantized_grads = bool(quantized_grads)
        # observability
        self.pass_costs: List[float] = []
        self.tasks_done = 0
        self.rejected_acks = 0
        self.busy_s = 0.0
        self.grad_payload_bytes = 0
        self.wire_bytes_per_pass: List[int] = []
        self.t_work0: Optional[float] = None
        self.t_work1: Optional[float] = None

    # -- master RPC with bounded ride-through -----------------------------
    def _rpc(self, method: str, *args):
        """One cluster-plane call, retried through a master bounce.

        The client layer already absorbs brief blips (master.Client's
        reconnect-retry, master_ha.HAClient's re-discover loop); what
        surfaces here — MasterTransportError / MasterTimeoutError /
        HAClient's discovery TimeoutError — means the master stayed gone
        for the client's whole window.  A failover can legitimately take
        longer (lease timeout + campaign + replay), so retry with backoff
        until ``rpc_retry_window_s`` elapses, then give up: a supervisor
        restart + startup recovery is the heal path past that.

        The window is checked BETWEEN attempts — a single in-flight call
        blocks for at most the client's own per-call deadline, so wire
        the client's ``call_timeout_s``/discovery timeout to fractions of
        the window (as ``main()`` does) to keep the total overshoot
        bounded.

        A SEND-SIDE wire-codec refusal (``MasterWireError``: the
        contribution payload is unencodable or exceeds
        ``rpc_max_message_mb``) is deterministic — retrying re-encodes the
        same bytes — so it surfaces immediately as a configuration error
        naming the flag, never as a wedged worker burning the window."""
        deadline = self._clock() + self.rpc_retry_window_s
        delay = 0.2
        while True:
            try:
                return getattr(self.client, method)(*args)
            except _wire.MasterWireError as exc:
                raise RuntimeError(
                    f"worker {self.worker_id}: RPC {method} payload "
                    f"refused by the wire codec ({exc}); raise the "
                    f"rpc_max_message_mb flag or shrink the per-task "
                    f"contribution (smaller chunks_per_task)"
                ) from exc
            except (ConnectionError, TimeoutError) as exc:
                if self._clock() >= deadline:
                    raise
                _log.warning(
                    "worker %s: master RPC %s failed (%r); retrying "
                    "through the bounce", self.worker_id, method, exc,
                )
                self._sleep(min(delay, 2.0))
                delay *= 2

    # -- registry ---------------------------------------------------------
    def _hb_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            if self._hb_pause.is_set():
                continue  # simulated full-process freeze: no heartbeats
            try:
                if not self._hb.heartbeat(self.worker_id):
                    # expired (we were pruned) or the master failed over:
                    # rejoin — the registry is runtime state, not snapshot
                    self._hb.register_worker(self.worker_id)
            except Exception:  # noqa: BLE001 — transient; next beat retries
                pass

    def _start_heartbeat(self, worker_timeout_s: float) -> None:
        if self._hb is None:
            return
        interval = self._hb_interval or max(worker_timeout_s / 3.0, 0.05)
        self._hb_thread = threading.Thread(
            target=self._hb_loop, args=(interval,),
            name="paddle-elastic-heartbeat", daemon=True,
        )
        self._hb_thread.start()

    # -- fence ------------------------------------------------------------
    def _fence(self, fence_id: str) -> Dict[str, Any]:
        """Arrive and poll until released.  Polling re-arrives: arrival is
        idempotent, doubles as a liveness signal, and re-registers the
        barrier after a master failover dropped its fences.  The arrival
        meta declares whether this worker checkpoints, so the released
        view's ``writers`` roster covers exactly the shard writers."""
        meta = {"ckpt": self.manager is not None}
        with _obs.span("fence", cat="trainer", fence=fence_id):
            view = self._rpc("fence_arrive", fence_id, self.worker_id, meta)
            while not view.get("released"):
                self._sleep(self.poll_s)
                view = self._rpc(
                    "fence_arrive", fence_id, self.worker_id, meta
                )
        return view

    # -- checkpoints ------------------------------------------------------
    def _write_shard(self, pass_id: int, ranks: List[str]) -> None:
        if self.manager is None or self.worker_id not in ranks:
            return  # not a writer, or we missed the membership cut
        rank, n = ranks.index(self.worker_id), len(ranks)
        step = pass_id + 1
        extra = {"pass_id": pass_id, "step_count": step}
        # off the hot path: the next pass's task compute overlaps this write
        self.manager.save_shard(
            step, rank, n, self.model.state(), async_=True
        )
        self._pending_commit = (step, n, extra)

    def _commit_pending(self) -> None:
        """Publish the previous pass's manifest.  Called right after a
        fence release: every surviving writer joined its async write before
        arriving, so all shards that will ever land have landed.  Any
        worker may commit (idempotent); False just means a writer died
        mid-write and the step stays unrestorable — by design."""
        if self._pending_commit is None:
            return
        step, n, extra = self._pending_commit
        self._pending_commit = None
        if not self.manager.commit(step, n, extra=extra):
            _log.warning(
                "worker %s: checkpoint step %d left uncommitted (a shard "
                "writer died mid-write); restore will use the previous "
                "complete manifest", self.worker_id, step,
            )

    # -- the pass loop ----------------------------------------------------
    def _apply_retained_pass(self, pass_id: int) -> None:
        """Catch up one missed pass from the master's retained result map —
        how a late joiner (or a worker that detected pass skew) reaches the
        exact parameter state the fleet computed without re-leasing any
        task.  Refuses loudly when the retained map is incomplete: applying
        a partial reduction would silently fork the trajectory."""
        pr = self._rpc("pass_results", pass_id)
        results, n_done = pr["results"], pr["n_done"]
        if not results or n_done is None or len(results) != n_done:
            raise RuntimeError(
                f"worker {self.worker_id}: cannot catch up pass {pass_id} "
                f"({len(results)}/{n_done} contributions retained) — joined "
                f"too many passes late with no committed checkpoint "
                f"covering it"
            )
        mean_grads, mean_cost, _ = reduce_results(results)
        self.model.apply(mean_grads)
        self.pass_costs.append(mean_cost)
        _log.info(
            "worker %s caught up pass %d from retained results",
            self.worker_id, pass_id,
        )

    def _catch_up(self, pass_id: int, target: int) -> int:
        """Reach the exact state "after pass target-1" when the fleet moved
        on without us (late join, or a hang long enough to be pruned):
        replay retained result maps; when the gap outruns result retention
        — or a pass was force-rotated and its map POISONED — restore the
        latest committed manifest and replay the remainder.  A manifest
        that does not yet bridge the gap is WAITED for (bounded by the
        RPC retry window): the fleet commits one every pass, so a
        rejoiner stranded behind an unreplayable pass heals as soon as
        the next manifest lands instead of crash-looping."""
        deadline = self._clock() + self.rpc_retry_window_s
        while True:
            try:
                for p in range(pass_id, target):
                    self._apply_retained_pass(p)
                    # advance PER applied pass: a later retry of this loop
                    # (after a partial failure + wait) must never re-apply
                    # a pass these params already include
                    pass_id = p + 1
                return target
            except RuntimeError:
                if self.manager is None:
                    raise
                restored = self.manager.restore_latest(self.model.state())
                if restored is not None:
                    _, tree, extra = restored
                    completed = int(extra.get("pass_id", -1))
                    if completed + 1 > pass_id:
                        # the manifest moves us FORWARD: load and retry
                        # the (now shorter) retained replay
                        self.model.load(tree, extra)
                        pass_id = completed + 1
                        _log.info(
                            "worker %s rejoining via manifest (pass %d "
                            "applied)", self.worker_id, completed,
                        )
                        continue
                if self._clock() >= deadline:
                    raise
                self._sleep(max(self.poll_s, 0.2))
                # the fleet may have moved further on while we waited
                target = max(target, int(self._rpc("stats")["pass_id"]))

    def _run_pass_tasks(self, pass_id: int) -> Optional[int]:
        """Lease and compute this pass's tasks.  Returns None when the pass
        drained, or the MASTER's pass id when it is ahead of ours (the
        fleet fenced and rotated in the gap between our registration and
        our first lease) — the caller must catch up before computing."""
        while True:
            got = self._rpc("get_task", self.worker_id)
            if got is None:
                return None  # pass drained: the master holds the barrier
            if got == "wait":  # remaining leases held by other workers
                self._sleep(self.poll_s)
                continue
            task, epoch = got["task"], got["epoch"]
            tid = task["task_id"]
            # the elastic task lifecycle: lease → compute → ack, correlated
            # by task id so `trace merge` lines this worker's span up with
            # the master's rpc:get_task / rpc:task_finished handling
            _obs.instant(
                "elastic/lease", cat="trainer", task=tid, epoch=epoch,
                p=pass_id,
            )
            master_pass = int(got.get("pass_id", pass_id))
            if master_pass != pass_id:
                # our params lag the fleet (it fenced and rotated between
                # our registration and this lease): hand the task back
                # untouched — no failure event — and replay the gap first
                self._rpc("task_returned", tid, epoch)
                return master_pass
            if _chaos.fire("kill_worker"):
                # die HOLDING the shard lease — the kill-one-of-N drill
                _chaos.kill_self()
            if _chaos.fire("worker_hang"):
                # full-process freeze: heartbeats stop too, so both the
                # registry lease and this shard lease expire underneath us
                self._hb_pause.set()
                _chaos.hang()
                self._hb_pause.clear()
            try:
                records = _read_task_records(task)
            except IOError:
                self._rpc("task_failed", tid, epoch)
                continue
            t0 = self._clock()
            with _obs.span(
                "elastic/compute", cat="trainer", task=tid, p=pass_id,
            ):
                grads, cost_sum, rows = self.model.task_grad(
                    records, pass_id, tid
                )
            self.busy_s += self._clock() - t0
            if self.quantized_grads:
                grads = _bsq.quantize_tree(grads)
            nbytes = _bsq.tree_wire_bytes(grads)
            self.grad_payload_bytes += nbytes
            global_stats.incr("elastic_grad_payload_bytes", nbytes)
            payload = {
                "grads": grads, "cost": float(cost_sum), "rows": int(rows)
            }
            # the ack carries the lease's pass tag: a retry delayed past a
            # rotation is rejected instead of landing in the wrong pass
            with _obs.span("elastic/ack", cat="trainer", task=tid):
                acked = self._rpc("task_finished", tid, epoch, payload,
                                  pass_id)
            if acked:
                self.tasks_done += 1
            else:
                # zombie ack: the lease expired (we hung) and the task was
                # re-served — the surviving recomputation's bits win
                self.rejected_acks += 1

    def _heal_pass_results(self, pass_id: int, view: Dict[str, Any],
                           n_have: int):
        """The fence's frozen done-count disagrees with the retained
        result map: a master failover landed inside the fence window.
        Requeue any done-without-result orphans, recompute whatever the
        queue re-serves (bit-identical: our params have NOT applied this
        pass yet), and return the map only once it provably covers the
        whole pass — rotated-and-frozen-complete, or drained with every
        done task resulted.  Bounded by the RPC retry window; a heal that
        cannot converge surfaces the original refusal."""
        _log.warning(
            "worker %s: pass %d fence froze %s done tasks but the result "
            "map holds %d — master failover mid-fence; healing in place",
            self.worker_id, pass_id, view.get("n_done"), n_have,
        )
        deadline = self._clock() + self.rpc_retry_window_s
        while True:
            st = self._rpc("stats")
            if int(st["pass_id"]) < pass_id:
                # the failover regressed the master to an EARLIER pass
                # than the one we are reducing: that pass must re-drain
                # first.  We already applied it (we are a pass ahead), so
                # attest it forward rather than recompute it with
                # post-apply params.
                self._await_master_repass(int(st["pass_id"]), pass_id)
            self._rpc("requeue_unresulted")
            self._run_pass_tasks(pass_id)
            st = self._rpc("stats")
            pr = self._rpc("pass_results", pass_id)
            results, n_done = pr["results"], pr["n_done"]
            if n_done is not None and results and len(results) == n_done:
                return results  # pass rotated meanwhile: frozen-complete
            if int(st["pass_id"]) > pass_id:
                # rotated but NOT frozen-complete (a force-rotation
                # poisoned the map, or retention dropped it): nothing
                # reducible remains for this pass here
                raise _PassSuperseded(int(st["pass_id"]))
            if (int(st["pass_id"]) == pass_id and st["n_todo"] == 0
                    and st["n_pending"] == 0 and results
                    and len(results) == st["n_done"]):
                return results  # drained: the map covers the whole pass
            if self._clock() >= deadline:
                raise RuntimeError(
                    f"pass {pass_id}: fence froze {view.get('n_done')} "
                    f"done tasks but only {len(results)} contributions "
                    f"exist and in-place recompute did not converge — "
                    f"refusing to apply a partial reduction"
                )
            self._sleep(max(self.poll_s, 0.05))

    def _await_master_repass(self, master_pass: int, pass_id: int) -> None:
        """The master rotated BACKWARD relative to us: a failover replica
        lost rotations/acks that died with the deposed leader, and the
        fleet is re-draining a pass our params already applied.  We must
        neither recompute (our contributions would carry post-apply bits —
        the workers still AT that pass recompute them bit-identically)
        nor re-apply.  While waiting the re-drain out we: re-arrive at
        the re-opened pass's fence (our original arrival may have died
        with the old leader, and an absent live member would wedge the
        healers' barrier forever) and ATTEST our target pass through
        ``start_new_pass(target, worker_id)`` — when every live worker
        attests (nobody is left who could recompute the pass with
        pre-apply params), the master force-rotates past the
        unrecoverable queue state and the fleet recomputes the NEXT pass
        from its common post-apply params, bit-identically."""
        _log.warning(
            "worker %s: master regressed to pass %d (we are at %d) — a "
            "failover lost rotations; waiting for the fleet to re-drain",
            self.worker_id, master_pass, pass_id,
        )
        deadline = self._clock() + self.rpc_retry_window_s
        meta = {"ckpt": self.manager is not None}
        cur = master_pass
        while cur < pass_id:
            if self._clock() >= deadline:
                raise RuntimeError(
                    f"worker {self.worker_id}: master stuck at pass {cur} "
                    f"while we already applied pass {pass_id - 1} — the "
                    f"re-drain never converged"
                )
            self._rpc("fence_arrive", f"pass-{cur}", self.worker_id, meta)
            cur = int(self._rpc(
                "start_new_pass", pass_id, self.worker_id
            ))
            if cur < pass_id:
                self._sleep(max(self.poll_s, 0.05))

    def run(self, num_passes: int) -> Dict[str, Any]:
        info = self._rpc("register_worker", self.worker_id)
        if info.get("auto_rotate"):
            raise RuntimeError(
                "elastic training needs a master with auto_rotate=False: "
                "pass boundaries are fence-synchronized, not free-running"
            )
        self._start_heartbeat(float(info.get("timeout_s", 10.0)))
        try:
            # gang-start wait polls by RE-REGISTERING: registration renews
            # our own lease (and returns the roster), so a worker waiting
            # out a peer's slow boot can never expire into a livelock even
            # with no heartbeat thread wired
            while len(info.get("workers", ())) < self.min_workers:
                self._sleep(max(self.poll_s, 0.05))
                info = self._rpc("register_worker", self.worker_id)
            return self._run(num_passes, info)
        finally:
            self._stop.set()
            if self._hb_thread is not None:
                self._hb_thread.join(timeout=5)
            try:
                self.client.deregister_worker(self.worker_id)
            except Exception:  # noqa: BLE001 — the registry lease will expire
                pass

    def _run(self, num_passes: int, info: Dict[str, Any]) -> Dict[str, Any]:
        current = int(info.get("pass_id", 0))
        completed = None
        # restore when explicitly resuming, OR when joining a cluster that
        # is already past pass 0 — a joiner MUST reach the fleet's exact
        # parameter state before contributing (checkpoint manifest first,
        # retained result maps for the trailing gap)
        if self.manager is not None and (self.resume or current > 0):
            restored = self.manager.restore_latest(self.model.state())
            if restored is not None:
                _, tree, extra = restored
                self.model.load(tree, extra)
                completed = int(extra.get("pass_id", -1))
                _log.info(
                    "worker %s restored committed manifest: pass %d applied",
                    self.worker_id, completed,
                )
        if completed is not None:
            if current < completed:
                raise RuntimeError(
                    f"master is at pass {current} but the checkpoint "
                    f"already applied pass {completed}: the master state "
                    f"dir is stale relative to the checkpoint dir"
                )
            if current == completed:
                if completed + 1 >= num_passes:
                    # the job is already complete (we joined after the last
                    # pass): do NOT rotate the queue past the end — that
                    # would refill todo for a pass nobody asked for
                    current = completed + 1
                else:
                    current = self._rpc("start_new_pass", completed + 1)
            if current == completed:
                raise RuntimeError(
                    f"master cannot rotate past pass {completed} (queue "
                    f"not drained) yet the checkpoint applied it — "
                    f"mismatched master/checkpoint state"
                )
        # late join: replay the passes between the checkpoint (or scratch)
        # and the master's current pass from the retained result maps
        for p in range((completed + 1) if completed is not None else 0,
                       current):
            self._apply_retained_pass(p)
        # a restarted master recovered its queues from the snapshot but the
        # in-memory result payloads died with it: requeue done-but-
        # unresulted tasks so this pass's contributions are recomputed
        # (deterministic, so recomputation cannot move the trajectory)
        requeued = self._rpc("requeue_unresulted")
        if requeued:
            _log.warning(
                "worker %s: recomputing %d task contributions lost with a "
                "restarted master", self.worker_id, requeued,
            )
        self.t_work0 = self._clock()
        pass_id = current
        while pass_id < num_passes:
            wb0 = _wire.counters.snapshot()
            behind = self._run_pass_tasks(pass_id)
            if behind is None:
                # drained — but a pruned-then-rejoined worker (hang) may
                # have slept through whole passes without ever seeing a
                # skewed lease; one stats probe per pass catches that
                actual = int(self._rpc("stats")["pass_id"])
                if actual > pass_id:
                    behind = actual
            if behind is not None:
                if behind > pass_id:
                    # the fleet fenced + rotated without us: replay the
                    # missed passes, then continue at the master's pass
                    pass_id = self._catch_up(pass_id, behind)
                else:
                    # the MASTER is behind us: a failover replica lost the
                    # rotation (and possibly acks) that died with the
                    # deposed leader — heal without recomputing (our
                    # params already include that pass, so our bits would
                    # be wrong) and WITHOUT walking pass_id backwards
                    self._await_master_repass(behind, pass_id)
                continue
            if self.manager is not None:
                self.manager.wait()  # join the async shard write pre-fence
            view = self._fence(f"pass-{pass_id}")
            self._commit_pending()
            results = self._rpc("pass_results", pass_id)["results"]
            if not results or len(results) != int(
                view.get("n_done", len(results))
            ):
                # a master failover landed inside the fence window: the
                # new leader's replica is missing acks that died with the
                # deposed leader (they survive as warm leases / todo), or
                # the frozen fence view predates them — or the pass was
                # force-rotated to nothing under us.  Correctness-first
                # still means NEVER applying a partial (or empty)
                # reduction — but the heal no longer needs a process
                # restart: recompute the missing contributions in place
                # and reduce only a map that covers the WHOLE pass.
                try:
                    results = self._heal_pass_results(
                        pass_id, view, len(results)
                    )
                except _PassSuperseded as sup:
                    # the pass closed under us while we were (briefly)
                    # pruned: nothing left to reduce here — catch up to
                    # the fleet's pass (manifest-bridged if the retained
                    # map was poisoned) and continue there
                    pass_id = self._catch_up(pass_id, sup.target)
                    continue
            mean_grads, mean_cost, _rows = reduce_results(results)
            self.model.apply(mean_grads)
            self.pass_costs.append(mean_cost)
            # this worker's RPC traffic for the whole pass (lease/ack/
            # fence/result-fetch frames) — the per-pass counter the
            # quantized-vs-f32 fleet bench gates its >= 3x reduction on
            wb1 = _wire.counters.snapshot()
            wb = sum(
                wb1.get(k, 0) - wb0.get(k, 0)
                for k in ("wire_bytes_sent", "wire_bytes_recv")
            )
            self.wire_bytes_per_pass.append(wb)
            global_stats.incr("elastic_wire_bytes_pass", wb)
            self._write_shard(pass_id, view.get("writers", []))
            if pass_id + 1 < num_passes:
                self._rpc("start_new_pass", pass_id + 1)
            pass_id += 1
        if self.manager is not None:
            self.manager.wait()
            if self._pending_commit is not None:
                # final pass: every writer joins at one last barrier, then
                # anyone publishes the manifest
                self._fence(f"final-{num_passes - 1}")
                self._commit_pending()
        self.t_work1 = self._clock()
        return {
            "worker_id": self.worker_id,
            "pass_costs": self.pass_costs,
            "tasks_done": self.tasks_done,
            "rejected_acks": self.rejected_acks,
            "busy_s": self.busy_s,
            "t_work0": self.t_work0,
            "t_work1": self.t_work1,
            "quantized_grads": self.quantized_grads,
            "grad_payload_bytes": self.grad_payload_bytes,
            "wire_bytes_per_pass": self.wire_bytes_per_pass,
        }


# ---------------------------------------------------------------------------
# Built-in models
# ---------------------------------------------------------------------------

class NumpyLinearModel:
    """Least-squares regression in pure numpy — the torch-free reference
    model for cluster-plane tests and the scaling bench (worker startup is
    then import-light, so the curve measures coordination + compute, not
    interpreter boot).  Records are float32 vectors ``[x..., y]``.

    ``hidden=0`` (default) is plain linear regression; ``hidden>0`` adds a
    tanh hidden layer (deterministically seeded init) so the per-task
    gradient has real arithmetic weight — what the 1→N scaling bench needs
    to expose coordination overhead honestly."""

    def __init__(self, dim: int, lr: float = 0.1, hidden: int = 0,
                 seed: int = 0):
        self.dim = int(dim)
        self.hidden = int(hidden)
        self.lr = np.float32(lr)
        if self.hidden:
            rng = np.random.RandomState(seed)
            scale = np.float32(1.0 / np.sqrt(self.dim))
            self.w1 = (rng.randn(self.dim, self.hidden)
                       .astype(np.float32) * scale)
            self.b1 = np.zeros((self.hidden,), np.float32)
            self.w = np.zeros((self.hidden,), np.float32)
        else:
            self.w = np.zeros((self.dim,), np.float32)
        self.b = np.zeros((), np.float32)

    def task_grad(self, records, pass_id: int, task_id: int):
        arr = np.stack([np.frombuffer(r, np.float32) for r in records])
        if arr.shape[1] != self.dim + 1:
            raise ValueError(
                f"record width {arr.shape[1]} != dim+1 ({self.dim + 1})"
            )
        x, y = arr[:, :-1], arr[:, -1]
        n = np.float32(len(records))
        if self.hidden:
            h = np.tanh(x @ self.w1 + self.b1)
            err = h @ self.w + self.b - y
            dh = err[:, None] * self.w[None, :] * (1.0 - h * h)
            grads = {
                "w1": x.T @ dh / n,
                "b1": dh.sum(axis=0, dtype=np.float32) / n,
                "w": h.T @ err / n,
                "b": err.mean(dtype=np.float32),
            }
        else:
            err = x @ self.w + self.b - y
            grads = {"w": x.T @ err / n, "b": err.mean(dtype=np.float32)}
        cost_sum = float(0.5 * np.sum(err.astype(np.float64) ** 2))
        return grads, cost_sum, len(records)

    def apply(self, grads) -> None:
        for name, g in grads.items():
            setattr(
                self, name,
                getattr(self, name) - self.lr * np.asarray(g, np.float32),
            )

    def state(self):
        out = {"w": self.w, "b": self.b}
        if self.hidden:
            out.update({"w1": self.w1, "b1": self.b1})
        return out

    def load(self, tree, extra) -> None:
        for name in self.state():
            setattr(self, name, np.asarray(tree[name], np.float32))


def task_seed(seed: int, pass_id: int, task_id: int) -> int:
    """The dropout seed of one task: a function of the trainer's seed, the
    pass and the task only — never of the worker or the lease epoch — so a
    requeued task recomputes the same bits on any survivor."""
    state = np.random.SeedSequence([int(seed), int(pass_id), int(task_id)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(2))


class TrainerTaskModel:
    """Adapts a :class:`paddle_tpu_torch.trainer.SGD` trainer to the elastic
    protocol: per-task gradients come from
    :func:`~paddle_tpu_torch.trainer.step.make_grad_step` on the trainer's
    device, the reduced update goes through the trainer's own optimizer,
    and the checkpointed state is the trainer's full state (params, layer
    state, optimizer state, counters) — so an elastic fleet trains the same
    networks, with the same optimizers, as a single-process
    ``trainer.train`` run.

    ``decode(record) -> sample`` turns one stored record into one feed
    sample for the trainer's DataFeeder.  :meth:`task_grad` hands back a
    tree of host float32 numpy arrays (the wire codec carries numpy, not
    tensors); :meth:`apply` uploads the reduced mean in one copy and
    updates the parameters in place.  As in the JAX package, the forward's
    layer-state update (batch norm's moving statistics) is dropped.

    Bit-identity across worker processes on one card needs deterministic
    kernels in every worker: ``torch.backends.cudnn.deterministic = True``,
    ``torch.backends.cudnn.benchmark = False``,
    ``torch.use_deterministic_algorithms(True)`` with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment, and the same
    TF32 switches everywhere.  This class sets none of them."""

    def __init__(self, trainer, decode):
        from paddle_tpu_torch.core.device import resolve_device
        from paddle_tpu_torch.trainer.step import make_grad_step

        resolve_device(trainer.device)  # raises on a CUDA trainer without CUDA
        self._t = trainer
        self._decode = decode
        self._feeder = trainer._make_feeder(None)
        self._gstep = make_grad_step(trainer.network)

    def task_grad(self, records, pass_id: int, task_id: int):
        from paddle_tpu_torch.utils.tree import map_leaves

        t = self._t
        samples = [self._decode(r) for r in records]
        batch = self._feeder(samples)
        grads, cost = self._gstep(t.parameters.params, t.parameters.state, batch,
                                  task_seed(t._seed, pass_id, task_id))
        grads = map_leaves(lambda g: g.detach().float().cpu().numpy(), grads)
        return grads, float(cost) * len(samples), len(samples)

    def apply(self, grads) -> None:
        import torch

        from paddle_tpu_torch.utils.tree import leaf_paths, set_path

        t = self._t
        paths = [(path, np.asarray(g, np.float32)) for path, g in leaf_paths(grads)]
        flat = torch.from_numpy(np.concatenate([g.reshape(-1) for _, g in paths]))
        if t.device.type == "cuda":
            flat = flat.pin_memory().to(t.device, non_blocking=True)
        dev_grads: Dict[str, Any] = {}
        at = 0
        for path, g in paths:
            set_path(dev_grads, path, flat[at:at + g.size].view(g.shape))
            at += g.size
        t.optimizer.update(dev_grads, t._opt_state, t.parameters.params)
        t._step_count += 1

    def state(self):
        return self._t._full_state()

    def load(self, tree, extra) -> None:
        self._t._apply_restored(tree, extra)


# ---------------------------------------------------------------------------
# CLI — the per-process entry point the launcher/bench/chaos tests spawn
# ---------------------------------------------------------------------------

def _parse_model_args(pairs: List[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for p in pairs:
        k, _, v = p.partition("=")
        out[k.strip()] = v.strip()
    return out


def _build_model(name: str, margs: Dict[str, str], seed: int):
    if name == "numpy":
        return NumpyLinearModel(
            dim=int(margs.get("dim", "8")),
            lr=float(margs.get("lr", "0.1")),
            hidden=int(margs.get("hidden", "0")),
            seed=seed,
        )
    if name == "mlp":
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.core.topology import reset_auto_names

        dim = int(margs.get("dim", "8"))
        classes = int(margs.get("classes", "4"))
        hidden = int(margs.get("hidden", "16"))
        lr = float(margs.get("lr", "0.1"))
        device = margs.get("device", "cuda")
        reset_auto_names()
        paddle.init(seed=seed, device=device)
        x = paddle.layer.data("x", paddle.data_type.dense_vector(dim))
        h = paddle.layer.fc(x, size=hidden, act=paddle.activation.Tanh())
        pred = paddle.layer.fc(
            h, size=classes, act=paddle.activation.Softmax()
        )
        label = paddle.layer.data(
            "label", paddle.data_type.integer_value(classes)
        )
        cost = paddle.layer.classification_cost(input=pred, label=label)
        trainer = paddle.trainer.SGD(
            cost=cost,
            parameters=paddle.parameters.create(cost, seed=seed, device=device),
            update_equation=paddle.optimizer.Momentum(
                learning_rate=lr, momentum=0.9
            ),
            device=device,
        )

        def decode(rec: bytes):
            vec = np.frombuffer(rec, np.float32)
            return vec[:-1].tolist(), int(vec[-1])

        return trainer.elastic_model(decode)
    raise ValueError(f"unknown --model {name!r} (numpy, mlp)")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch worker",
        description="One elastic trainer process: leases data-shard tasks "
        "from the master plane, contributes deterministic per-task "
        "gradients, reduces at pass fences, writes its checkpoint shard.",
    )
    ap.add_argument("--dir", required=True,
                    help="the HA master discovery directory (master_ha)")
    ap.add_argument("--worker-id", default=None,
                    help="default: w<PADDLE_TPU_TORCH_PROCESS_ID> under the "
                    "launcher, else host:pid")
    ap.add_argument("--num-passes", type=int, default=1)
    ap.add_argument("--model", default="numpy", help="numpy | mlp")
    ap.add_argument("--model-arg", action="append", default=[],
                    help="k=v model hyperparameter (repeatable), e.g. dim=8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="sharded-manifest checkpoint directory (shared)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest committed manifest first")
    ap.add_argument("--stats-out", default=None,
                    help="write a JSON work summary here on success; a "
                    "'{worker}' placeholder expands to the worker id, so "
                    "one launcher argv serves the whole fleet")
    ap.add_argument("--poll-s", type=float, default=0.02)
    ap.add_argument("--min-workers", type=int, default=1,
                    help="hold the first lease until this many workers "
                    "registered (gang-start hint; membership stays elastic "
                    "afterwards)")
    ap.add_argument("--client-timeout", type=float, default=None,
                    help="leader-discovery timeout; default derives from "
                    "--rpc-retry-window-s, an explicit value is used as-is")
    ap.add_argument("--rpc-retry-window-s", type=float, default=60.0,
                    help="ride through a master bounce for this long "
                    "before exiting nonzero for the supervisor")
    ap.add_argument("--chaos", default=None,
                    help="arm chaos points in THIS worker, e.g. "
                    "'kill_worker@2' (env PADDLE_TPU_TORCH_CHAOS also works)")
    ap.add_argument("--quantized-grads", action="store_true", default=None,
                    help="block-scale quantize gradient contributions "
                    "(int8 blocks + f32 scales) before they ride the wire; "
                    "default from the elastic_quantized_grads flag / "
                    "PADDLE_TPU_TORCH_ELASTIC_QUANTIZED_GRADS env")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(message)s"
    )
    # obs trace context: one elastic trainer process of the fleet (export
    # armed by the trace_dir flag / PADDLE_TPU_TORCH_TRACE_DIR from the launcher)
    _obs.tracer.configure(role="worker")
    if args.chaos:
        _chaos.arm(args.chaos)
    from paddle_tpu_torch.master_ha import HAClient

    worker_id = args.worker_id
    if worker_id is None:
        proc_id = os.environ.get("PADDLE_TPU_TORCH_PROCESS_ID")
        worker_id = (
            f"w{proc_id}" if proc_id is not None
            else f"{os.uname().nodename}:{os.getpid()}"
        )
    manager = None
    if args.checkpoint_dir:
        from paddle_tpu_torch.checkpoint import CheckpointManager

        manager = CheckpointManager(args.checkpoint_dir)
    model = _build_model(
        args.model, _parse_model_args(args.model_arg), args.seed
    )
    # the retry window is only checked BETWEEN calls, so one blocked call
    # must not be able to eat the whole window: cap the per-call deadline
    # and the leader re-discovery timeout at fractions of it.  An explicit
    # --client-timeout is the operator's call and is used as-is.
    window = args.rpc_retry_window_s
    client_kw = dict(
        timeout=(args.client_timeout if args.client_timeout is not None
                 else max(window / 2.0, 5.0)),
        call_timeout_s=max(min(15.0, window / 4.0), 2.0),
    )
    worker = ElasticWorker(
        HAClient(args.dir, **client_kw),
        worker_id,
        model,
        manager=manager,
        resume=args.resume,
        heartbeat_client=HAClient(args.dir, **client_kw),
        poll_s=args.poll_s,
        min_workers=args.min_workers,
        rpc_retry_window_s=window,
        quantized_grads=args.quantized_grads,
    )
    summary = worker.run(args.num_passes)
    if args.stats_out:
        _obs.write_stats_json(
            args.stats_out.replace("{worker}", worker_id), summary
        )
    _obs.tracer.dump()  # per-process trace file (no-op without trace_dir)
    for i, c in enumerate(summary["pass_costs"]):
        print(f"worker {worker_id} pass cost {c:.6f} (#{i})", flush=True)
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
