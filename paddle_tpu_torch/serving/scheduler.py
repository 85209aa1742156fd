"""Continuous-batching scheduler — the counterpart of
``paddle_tpu/serving/scheduler.py``: a request queue and the step and
delivery threads over one :class:`~paddle_tpu_torch.serving.engine.ServingEngine`.

Clients ``submit()`` requests from any thread; one step thread owns the
engine and, every iteration, (1) drains newly submitted requests and
validates them (a poisoned request is rejected with an error result and
never reaches the batch), (2) admits a FIFO prefix into free slots and
pages (prefill), and (3) runs one decode step for every live sequence:
sequences admit and retire mid-flight (continuous batching).

Overload is an input, not an accident:

* every request may carry a **deadline** (``Request(deadline_s=...)``, or
  the ``serving_default_deadline_s`` flag); ``t_deadline = t_submit +
  deadline_s`` is the SLO the scheduler honors;
* the pre-admission queue is **bounded** (``serving_queue_limit``): a
  submit beyond the bound is rejected at once (``rejected`` status);
* admission is **deadline-aware**: a request whose predicted queue wait
  (EWMA of recent per-token step time x queued-token depth / slot
  concurrency, plus its own expected service time) already blows its
  deadline is finalized at once with the ``shed`` status, so at 2x
  saturation the plane sheds the infeasible excess and keeps serving the
  feasible subset instead of timing everything out;
* abandoned work is **canceled**: ``cancel(req_id)`` (and a timed-out
  ``generate()``) frees the request's slot and pages, and a live request
  whose deadline passes mid-decode is canceled the same way;
* shutdown can be **graceful**: :meth:`drain` stops admitting, finishes
  everything in flight, then closes (``python -m paddle_tpu_torch serve``'s
  SIGTERM path); :meth:`close` finalizes every outstanding request with an
  error, so no client waits forever.

Completion is two-phase so a slow client never stalls decoding:
``Request.wait()`` returns the moment the step thread finalizes the
request; callbacks run on a separate delivery thread, which touches host
lists only.  The chaos points ``nan_request`` (poison a request at submit)
and ``serve_slow_client`` (freeze the delivery thread before a callback)
drill these two boundaries (robustness/chaos.py).

Concurrency: both threads are daemon threads joined by
:meth:`ServingScheduler.close`; the one shared lock comes from the
:mod:`~paddle_tpu_torch.analysis.lock_sanitizer` factory; every blocking
wait is a bounded poll; clocks and sleeps are injectable.  The engine's
dispatches run under ``torch.no_grad()`` (grad mode is per thread), so the
step thread builds no graphs.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np

from paddle_tpu_torch import obs as _obs
from paddle_tpu_torch.analysis.diagnostics import protocol_error
from paddle_tpu_torch.analysis.lock_sanitizer import THREAD_PREFIX, make_lock
from paddle_tpu_torch.robustness import chaos

__all__ = ["Request", "ServingScheduler", "TERMINAL_STATUSES",
           "percentile", "status_counts"]

_log = logging.getLogger("paddle_tpu_torch.serving")

_req_counter = itertools.count()

# terminal request statuses (the disjoint categories every summary/scenario
# reports): served | rejected (validation or queue backpressure) | shed
# (deadline-infeasible before admission) | timeout (canceled: client
# timeout, explicit cancel, or deadline exceeded mid-decode) | closed
# (scheduler shut down underneath it)
_EWMA_DECAY = 0.8  # weight of history in the step-time/token-count EWMAs
# admission headroom on the request's own expected service: service times
# are token-count ragged (p95 runs 2-3x the mean), and admitting a request
# that then times out mid-decode WASTES a slot for its whole residency —
# worse for goodput than shedding it up front
_SERVICE_SAFETY = 1.5


def _parse_class_spec(spec: str) -> dict:
    """Parse a per-class spec string ``"0:0.25,2:1.5"`` (priority ->
    float) — the grammar of ``serving_class_deadline_s`` and
    ``serving_class_shed_slack``."""
    out: dict = {}
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        prio, _, val = part.partition(":")
        out[int(prio)] = float(val)
    return out


def _rung_of(n_live: int) -> int:
    """Concurrency ladder rung of a batch: the smallest power of two
    >= ``n_live``: one step-time EWMA per rung, so steps at batch 8 and at
    batch 1 feed different estimates."""
    n = max(1, int(n_live))
    return 1 << (n - 1).bit_length()


def percentile(xs, p: float):
    """Nearest-rank percentile (None when empty) — the ONE indexing rule
    every serving latency metric shares, so p50/p95/p99 never drift
    between the CLI summary, the router and chip_smoke.py."""
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


# The ONE declared disjoint set of terminal request statuses.  Every
# transition site in the serving planes must land on a member (lint
# P503 cross-checks assignments, status= keywords and comparisons in
# scheduler.py/router.py against this tuple); "pending" is the sole
# transient state.
TERMINAL_STATUSES = ("served", "shed", "rejected", "timeout", "closed")


def status_counts(requests) -> dict:
    """The disjoint status ledger over finalized requests (every summary
    reports exactly these keys, zero-filled)."""
    out = {s: 0 for s in TERMINAL_STATUSES}
    for r in requests:
        out[r.status] = out.get(r.status, 0) + 1
    return out


class Request:
    """One generation request and its result/latency/SLO record.

    ``src_ids``: source token ids; ``max_new_tokens``: per-request decode
    cap (None = the engine's default); ``deadline_s``: end-to-end SLO in
    seconds from submit (None = the ``serving_default_deadline_s`` flag;
    0/unset = no deadline); ``callback(request)`` runs on the delivery
    thread after completion.  ``status`` lands on exactly one of
    served/rejected/shed/timeout/closed.  Timing fields (``t_submit``,
    ``t_admit``, ``t_first_token``, ``t_done``, per-token ``token_times``)
    are stamped by the scheduler/engine clock — the raw material of the
    sustained req/s and p50/p99 per-token metrics.  ``token_logprobs``
    holds each generated token's log-probability (the port's addition)."""

    def __init__(
        self,
        src_ids: Sequence,
        max_new_tokens: Optional[int] = None,
        req_id: Optional[str] = None,
        callback: Optional[Callable[["Request"], Any]] = None,
        deadline_s: Optional[float] = None,
        beam_size: Optional[int] = None,
        session_id: Optional[str] = None,
        priority: Optional[int] = None,
    ):
        self.req_id = req_id if req_id is not None else f"r{next(_req_counter)}"
        self.src_ids = list(src_ids)
        self.max_new_tokens = max_new_tokens
        self.callback = callback
        self.deadline_s = deadline_s
        # priority class: LOWER numbers are more urgent (0 = interactive,
        # 1 = the default, bigger = batch/background).  The scheduler
        # dequeues strict-priority-with-aging and sheds per class; the
        # class label ``p<priority>`` keys the per-class ledger counters
        # and Prometheus labels.
        self.priority = 1 if priority is None else int(priority)
        # conversation/session handle: the fleet router's affinity key —
        # requests sharing a session (and so, in production, a prompt
        # head) concentrate on the engine whose prefix cache already
        # holds their blocks.  Opaque to the single-engine scheduler.
        self.session_id = session_id
        # beam decode as a serving citizen: > 1 routes the request through
        # the engine's paged whole-sequence beam program (one dispatch,
        # best hypothesis in ``tokens`` + its ``beam_score``); None/1 =
        # the continuous greedy/speculative loop
        self.beam_size = beam_size
        self.beam_score: Optional[float] = None
        self.status = "pending"
        self.tokens: Optional[List[int]] = None
        self.error: Optional[str] = None
        self.t_submit: Optional[float] = None
        self.t_deadline: Optional[float] = None  # absolute, set at submit
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.token_times: List[float] = []
        # the log-probability of each generated token under the decode chain
        # (the port's addition; chip_smoke.py holds it to the one-shot path's)
        self.token_logprobs: List[float] = []
        self._resume = None  # engine preemption save-state
        self._event = threading.Event()

    @property
    def class_label(self) -> str:
        """The priority class label (``p0``/``p1``/...) — the ``class``
        dimension of the per-class ledger and Prometheus series."""
        return f"p{self.priority}"

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until finalized (bounded); True when done."""
        return self._event.wait(timeout)

    def result(self) -> List[int]:
        """Generated tokens; raises on a rejected/shed/failed request."""
        if not self._event.is_set():
            raise protocol_error(
                "P509",
                f"result() on request {self.req_id} before it finished",
                source="serving/scheduler.py",
                hint="wait() for the request (it sets the done event) "
                     "before reading result()",
            )
        if self.error is not None:
            raise RuntimeError(f"request {self.req_id}: {self.error}")
        return list(self.tokens or [])

    def __repr__(self) -> str:  # pragma: no cover
        state = self.status if self.done() else "pending"
        return f"Request({self.req_id}, {state}, err={self.error!r})"


class ServingScheduler:
    """Request queue + continuous-batching step loop over one engine."""

    def __init__(
        self,
        engine,
        *,
        clock=time.perf_counter,
        sleep=time.sleep,
        idle_poll_s: float = 0.02,
        queue_limit: Optional[int] = None,
        default_deadline_s: Optional[float] = None,
        priority_aging_s: Optional[float] = None,
        class_deadline_s: Optional[dict] = None,
        class_shed_slack: Optional[dict] = None,
        stats=None,
    ):
        from paddle_tpu_torch.utils import flags as _flags
        from paddle_tpu_torch.utils.timers import global_stats

        self._engine = engine
        self._clock = clock
        self._sleep = sleep  # injectable per the C306 discipline
        self._idle_poll_s = idle_poll_s
        self._stats = stats if stats is not None else global_stats
        self.queue_limit = int(
            queue_limit if queue_limit is not None
            else _flags.get_flag("serving_queue_limit")
        )
        self.default_deadline_s = float(
            default_deadline_s if default_deadline_s is not None
            else _flags.get_flag("serving_default_deadline_s")
        )
        # per-class SLO policy: default deadline and shed-safety slack
        # per priority class (flag spec "prio:value,..."), plus the aging
        # rate of the strict-priority-with-aging dequeue — every
        # ``priority_aging_s`` seconds of queue wait promote a request
        # one priority level, so batch traffic ages into urgency instead
        # of starving behind a steady interactive stream (0 = pure
        # strict priority, starvation is the operator's explicit choice)
        self.priority_aging_s = float(
            priority_aging_s if priority_aging_s is not None
            else _flags.get_flag("serving_priority_aging_s")
        )
        self.class_deadline_s = dict(
            class_deadline_s if class_deadline_s is not None
            else _parse_class_spec(_flags.get_flag(
                "serving_class_deadline_s"))
        )
        self.class_shed_slack = dict(
            class_shed_slack if class_shed_slack is not None
            else _parse_class_spec(_flags.get_flag(
                "serving_class_shed_slack"))
        )
        self._q: "queue.Queue[Request]" = queue.Queue()
        self._deliver_q: "queue.Queue[Request]" = queue.Queue()
        self._cancel_q: "queue.Queue[tuple]" = queue.Queue()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._lock = make_lock("serving-scheduler")
        self._closed = False  # guarded by _lock
        self._depth = 0  # pre-admission queue depth; guarded by _lock
        # step-thread-only SLO predictor state (never shared, no lock):
        # per-ladder-rung step-time EWMAs (rung = smallest power of two
        # >= live batch size) replace the single global EWMA — a step at
        # batch 8 and a step at batch 1 have different per-token costs,
        # and folding them into one average mispredicts BOTH
        self._rung_token_s: dict = {}  # rung -> EWMA per-token seconds
        self._ewma_tokens: Optional[float] = None
        self._pending_cancels: dict = {}  # req_id -> (reason, ttl)
        # advisory per-class waiting-depth snapshot (step thread writes a
        # fresh dict each iteration; gauge/stats reads are point-in-time)
        self._class_waiting: dict = {}
        self._class_gauges: dict = {}  # label -> gauge fn (for unregister)
        # the step loop's crash message, once it crashed (a fleet engine
        # process exits nonzero on it)
        self.crashed: Optional[str] = None
        self._step_thread = threading.Thread(
            target=self._loop, name=THREAD_PREFIX + "serve-step", daemon=True
        )
        self._deliver_thread = threading.Thread(
            target=self._delivery_loop,
            name=THREAD_PREFIX + "serve-deliver",
            daemon=True,
        )
        # live SLO gauges (obs/metrics.py): the SLO quantities,
        # observable while the run is still going.  Reads are advisory
        # snapshots of step-thread state (int/float loads) — stale by at
        # most one scrape period, never blocking the step loop.  The
        # callbacks are retained so close() unregisters only gauges THIS
        # instance still owns (a newer scheduler may have taken the names).
        from paddle_tpu_torch.obs.metrics import register_gauge

        self._gauges = {
            "paddle_tpu_serving_queue_depth": (
                lambda: self._depth,
                "requests queued ahead of admission (serving_queue_limit "
                "rejects past the bound)",
            ),
            "paddle_tpu_serving_pages_in_use": (
                lambda: self._engine.pages.n_used,
                "device blocks held by in-flight sequences "
                "(serving_hbm_budget_mb bounds the pool)",
            ),
            "paddle_tpu_serving_predicted_wait_seconds": (
                lambda: self._predicted_wait_s(self._depth) or 0.0,
                "EWMA-predicted queue wait of a request arriving now — "
                "the shed predictor's own estimate",
            ),
            "paddle_tpu_serving_prefix_cache_hits": (
                lambda: self._engine.prefix_hits,
                "admissions whose full prompt mapped cached blocks — "
                "zero prefill dispatches each (serving_prefix_cache)",
            ),
            "paddle_tpu_serving_prefix_cache_misses": (
                lambda: self._engine.prefix_misses,
                "admissions that prefilled fresh pages (prefix cache "
                "enabled but no full-prompt entry matched)",
            ),
            "paddle_tpu_serving_pages_shared": (
                lambda: self._engine.pages.n_shared,
                "device blocks currently mapped by MORE than one page table "
                "(copy-on-write prefix sharing)",
            ),
            "paddle_tpu_serving_spec_accept_rate": (
                lambda: self._engine.spec_accept_rate(),
                "fraction of speculative draft tokens the target model "
                "confirmed (serving_spec_decode; 0.0 until armed)",
            ),
        }
        for name, (fn, help_) in self._gauges.items():
            register_gauge(name, fn, help_)
        self._step_thread.start()
        self._deliver_thread.start()

    # -- client surface --------------------------------------------------
    def submit(self, request: Request) -> Request:
        """Enqueue a request (any thread).  The ``nan_request`` chaos point
        fires here — a poisoned submission must be caught by validation on
        the step thread, not crash the batch.  Backpressure fires here
        too: beyond ``queue_limit`` (or while draining) the request
        finalizes immediately as ``rejected`` instead of queueing."""
        if chaos.fire("nan_request"):
            request.src_ids = list(request.src_ids) + [float("nan")]
        request.t_submit = self._clock()
        if request.deadline_s is None:
            # per-class default first (serving_class_deadline_s), then
            # the global serving_default_deadline_s fallback
            cls_dl = self.class_deadline_s.get(
                int(getattr(request, "priority", 1))
            )
            if cls_dl is not None and cls_dl > 0:
                request.deadline_s = cls_dl
            elif self.default_deadline_s > 0:
                request.deadline_s = self.default_deadline_s
        if request.deadline_s is not None and request.deadline_s > 0:
            request.t_deadline = request.t_submit + float(request.deadline_s)
        # AFTER deadline defaulting: the timeline must show the EFFECTIVE
        # deadline the shed/timeout decisions below will be judged against
        _obs.instant(
            "serving/submit", cat="serving", req=request.req_id,
            src_tokens=len(request.src_ids), deadline_s=request.deadline_s,
        )
        refuse = None
        # the put rides INSIDE the closed-check critical section so close()
        # (which sets _closed under this lock, then stops and drains) can
        # never miss a request that passed the check — an unbounded
        # queue.Queue.put never blocks, so nothing sleeps under the lock
        with self._lock:
            if self._closed:
                raise protocol_error(
                    "P509",
                    f"submit({request.req_id}) on a closed scheduler — "
                    "close() already finalized every outstanding request",
                    source="serving/scheduler.py",
                    hint="submit before close(); a closed scheduler must "
                    "be re-constructed, not reused",
                )
            if self._draining.is_set():
                refuse = "rejected: scheduler draining"
            elif self.queue_limit and self._depth >= self.queue_limit:
                refuse = (
                    f"rejected: queue full ({self._depth} >= "
                    f"queue_limit {self.queue_limit})"
                )
            else:
                self._depth += 1
                self._q.put(request)  # lock: allow[C304] UNBOUNDED queue — put never blocks; the hold closes the submit-vs-close race (close sets _closed and drains under the same lock ordering)
        self._stats.incr("serving/submitted")
        if refuse is not None:
            self._finalize(request, error=refuse, status="rejected")
        return request

    def generate(self, src_ids, max_new_tokens: Optional[int] = None,
                 timeout: float = 60.0,
                 deadline_s: Optional[float] = None) -> List[int]:
        """Submit-and-wait convenience: tokens, or raises on
        reject/shed/timeout.  A timed-out wait CANCELS the in-flight
        request — its slot and pages free immediately instead of decoding
        to ``max_new_tokens`` for a client that already gave up."""
        r = self.submit(Request(src_ids, max_new_tokens,
                                deadline_s=deadline_s))
        if not r.wait(timeout):
            self.cancel(r, reason=f"timeout: client gave up after {timeout}s")
            # bounded grace: the step loop processes the cancel on its next
            # iteration and finalizes the request (frees slot + pages)
            r.wait(10.0)
            raise TimeoutError(f"request {r.req_id} not served in {timeout}s")
        return r.result()

    def cancel(self, request: Union[Request, str],
               reason: str = "timeout: canceled") -> None:
        """Cancel a submitted request by object or ``req_id`` (any
        thread).  The step thread frees its slot/pages and finalizes it
        with ``timeout`` status on its next iteration; already-finished
        requests are untouched."""
        req_id = request.req_id if isinstance(request, Request) else request
        self._cancel_q.put((req_id, reason))

    def export_stats(self) -> dict:
        """One plain-dict snapshot of the SLO gauges — the engine side of
        the fleet router's single typed stats RPC (serving/router.py).
        Same quantities the Prometheus gauges expose, but shipped as one
        wire-codec payload (the ``write_stats_json`` record shape), so the
        router never scrapes text.  Advisory reads of step-thread state,
        exactly like the gauge callbacks: stale by at most one poll."""
        eng = self._engine
        with self._lock:
            depth = self._depth
        return {
            "queue_depth": int(depth),
            "pages_in_use": int(eng.pages.n_used),
            "predicted_wait_s": float(self._predicted_wait_s(depth) or 0.0),
            "est_service_s": float(self._est_service_s() or 0.0),
            "prefix_cache_hits": int(eng.prefix_hits),
            "prefix_cache_misses": int(eng.prefix_misses),
            "pages_shared": int(eng.pages.n_shared),
            "spec_accept_rate": float(eng.spec_accept_rate()),
            "n_live": int(eng.n_live),
            "n_prefilling": int(getattr(eng, "n_prefilling", 0)),
            "n_free_slots": int(eng.n_free_slots),
            "max_slots": int(eng.max_slots),
            "draining": bool(self._draining.is_set()),
            # per-class queue depths + the per-rung service model — the
            # router's dispatch scores stay on the scalar fields above;
            # these ride along for dashboards and the scenario gates
            "class_waiting": dict(self._class_waiting),
            "rung_token_s": {
                str(k): float(v) for k, v in self._rung_token_s.items()
            },
        }

    def drain(self, timeout: float = 60.0) -> bool:
        """Graceful shutdown: stop admitting (further submits are
        rejected), let every already-submitted request finish, then
        close.  Returns True when everything in flight completed within
        ``timeout`` (the ``python -m paddle_tpu_torch serve`` SIGTERM contract: drain clean
        -> exit 0); on False the close path finalized the stragglers with
        errors."""
        self._draining.set()
        deadline = self._clock() + timeout
        clean = False
        while self._clock() < deadline:
            with self._lock:
                depth = self._depth
            if (depth == 0 and self._engine.n_live == 0
                    and getattr(self._engine, "n_prefilling", 0) == 0
                    and self._deliver_q.empty()):
                clean = True
                break
            if self._stop.is_set():  # crashed loop: close() reports the rest
                break
            self._sleep(0.02)
        self.close()
        return clean

    def close(self, timeout: float = 10.0) -> None:
        """Stop both threads; outstanding requests finalize with an error so
        no client waits forever.  Safe to call repeatedly."""
        from paddle_tpu_torch.obs.metrics import unregister_gauge

        for name, (fn, _help) in self._gauges.items():
            unregister_gauge(name, fn)
        for label, (depth_fn, wait_fn) in self._class_gauges.items():
            unregister_gauge(
                "paddle_tpu_serving_class_queue_depth", depth_fn,
                labels={"class": label},
            )
            unregister_gauge(
                "paddle_tpu_serving_class_predicted_wait_seconds",
                wait_fn, labels={"class": label},
            )
        with self._lock:
            self._closed = True
        self._stop.set()
        self._step_thread.join(timeout)
        self._deliver_thread.join(timeout)
        # a submit that raced past the closed check lands here: finalize it
        # (callback inline — the delivery thread is gone) so no client hangs
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r._event.is_set():
                continue
            r.error = "scheduler closed"
            r.status = "closed"
            r.tokens = []
            r.t_done = self._clock()
            r._event.set()
            if r.callback is not None:
                try:
                    r.callback(r)
                except Exception:
                    self._stats.incr("serving/callback_errors")

    def __enter__(self) -> "ServingScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- validation ------------------------------------------------------
    def _validate(self, r: Request) -> Optional[str]:
        """Admission-time request validation: a malformed/poisoned request
        is rejected (error result) instead of poisoning the shared batch."""
        eng = self._engine
        if not r.src_ids:
            return "empty source"
        if len(r.src_ids) > eng.max_src_tokens():
            return (
                f"source length {len(r.src_ids)} exceeds the page budget "
                f"({eng.max_src_tokens()} tokens)"
            )
        for t in r.src_ids:
            f = float(t) if isinstance(t, (int, float, np.floating, np.integer)) else None
            if f is None or not np.isfinite(f) or f != int(f):
                return f"non-integral source token {t!r}"
            if not 0 <= int(f) < eng.src_vocab:
                return f"source token {int(f)} outside vocab [0, {eng.src_vocab})"
        if r.max_new_tokens is not None:
            m = r.max_new_tokens
            f = (
                float(m)
                if isinstance(m, (int, float, np.floating, np.integer))
                else None
            )
            if f is None or not np.isfinite(f) or f != int(f) or int(f) < 1:
                return f"max_new_tokens must be a positive integer, got {m!r}"
        p = getattr(r, "priority", 1)
        f = (
            float(p)
            if isinstance(p, (int, float, np.floating, np.integer))
            else None
        )
        if f is None or not np.isfinite(f) or f != int(f) or int(f) < 0:
            return f"priority must be a non-negative integer, got {p!r}"
        if r.beam_size is not None:
            b = r.beam_size
            f = (
                float(b)
                if isinstance(b, (int, float, np.floating, np.integer))
                else None
            )
            if f is None or not np.isfinite(f) or f != int(f) or int(f) < 1:
                return f"beam_size must be a positive integer, got {b!r}"
            if int(f) > eng.trg_vocab:
                return (
                    f"beam_size {int(f)} exceeds the target vocab "
                    f"({eng.trg_vocab} candidates per step)"
                )
        return None

    # -- SLO predictor (step thread only) --------------------------------
    def _token_s_at(self, rung: int) -> Optional[float]:
        """Per-token step time at a concurrency rung: the rung's own
        EWMA, else the NEAREST calibrated rung (log-distance) — a cold
        rung borrows its neighbor's estimate instead of predicting
        blind.  None until any rung calibrates."""
        if not self._rung_token_s:
            return None
        got = self._rung_token_s.get(rung)
        if got is not None:
            return got
        nearest = min(
            self._rung_token_s,
            key=lambda k: (abs(k.bit_length() - rung.bit_length()), k),
        )
        return self._rung_token_s[nearest]

    def _est_service_s(self, rung: Optional[int] = None) -> Optional[float]:
        """Expected wall service time of one request once admitted: EWMA
        generated-token count x the per-token step time AT the rung the
        request will decode in (default: the full house — under queueing
        pressure admission happens into a saturated batch).  None until
        the first decode dispatch calibrates the model (no shedding
        blind)."""
        if rung is None:
            rung = _rung_of(self._engine.max_slots)
        token_s = self._token_s_at(rung)
        if token_s is None:
            return None
        est_tokens = (
            self._ewma_tokens if self._ewma_tokens is not None
            else float(self._engine.default_max_new_tokens)
        )
        return max(est_tokens, 1.0) * token_s

    def _predicted_wait_s(self, n_ahead: int) -> Optional[float]:
        """Predicted queue wait for a request with ``n_ahead`` requests
        queued before it: the backlog drains one admission per service
        completion, ``max_slots`` of which run concurrently."""
        per_req = self._est_service_s()
        if per_req is None:
            return None
        backlog = n_ahead
        if self._engine.n_free_slots == 0:
            # a full house drains first — including slots still held by
            # chunked prefills (occupied but not yet decoding)
            backlog += self._engine.n_live + self._engine.n_prefilling
        return per_req * backlog / max(1, self._engine.max_slots)

    def _eff_priority(self, r: Request, now: float) -> float:
        """Effective priority under aging: every ``priority_aging_s``
        seconds of queue wait promote one level (smaller = served
        sooner).  0 disables aging — pure strict priority."""
        p = float(getattr(r, "priority", 1))
        if self.priority_aging_s > 0 and r.t_submit is not None:
            p -= (now - r.t_submit) / self.priority_aging_s
        return p

    def _n_ahead_of(self, r: Request, waiting: List[Request],
                    now: float) -> int:
        """How many waiting requests dequeue BEFORE ``r`` under the
        priority-with-aging order — the per-class replacement for the
        FIFO queue position the shed predictor used to read."""
        pr = self._eff_priority(r, now)
        n = 0
        for w in waiting:
            wp = self._eff_priority(w, now)
            if wp < pr or (wp == pr and (w.t_submit or 0.0)
                           <= (r.t_submit or 0.0)):
                n += 1
        return n

    def _shed_verdict(self, r: Request, n_ahead: int,
                      now: float) -> Optional[str]:
        """The deadline-aware admission decision: shed when the predicted
        queue wait plus the request's own expected service already lands
        past its deadline.  ``n_ahead`` counts only the requests that
        would dequeue before this one, so a high-priority arrival is
        judged against ITS queue, not the whole backlog — at 2x
        saturation the low classes shed first, by construction."""
        if r.t_deadline is None:
            return None
        wait = self._predicted_wait_s(n_ahead)
        if wait is None:
            return None
        slack = self.class_shed_slack.get(
            int(getattr(r, "priority", 1)), 1.0
        )
        per_req = (self._est_service_s() or 0.0) * _SERVICE_SAFETY * slack
        eta = now + wait + per_req
        if eta > r.t_deadline:
            # the predictor's INPUTS ride the shed instant: a merged
            # timeline answers "why was this request shed" without a repro
            _obs.instant(
                "serving/shed", cat="serving", req=r.req_id,
                predicted_wait_s=round(wait, 6),
                est_service_s=round(per_req, 6),
                n_ahead=n_ahead,
                rung_token_s={
                    str(k): round(v, 6)
                    for k, v in self._rung_token_s.items()
                },
                ewma_tokens=self._ewma_tokens,
                deadline_s=r.deadline_s,
                priority=getattr(r, "priority", 1),
            )
            return (
                f"shed: predicted completion {eta - r.t_submit:.3f}s after "
                f"submit blows the {r.deadline_s:.3f}s deadline "
                f"(queue wait ~{wait * 1e3:.0f} ms ahead of "
                f"{n_ahead} queued)"
            )
        return None

    # -- step thread -----------------------------------------------------
    def _class_wait_s(self, priority: int) -> float:
        """Advisory per-class predicted wait: the backlog a NEW arrival
        of this class would dequeue behind (classes at or above its
        urgency), through the same rung-model predictor — the per-class
        Prometheus gauge callback."""
        ahead = 0
        for label, n in dict(self._class_waiting).items():
            try:
                p = int(label[1:])
            except (ValueError, IndexError):
                continue
            if p <= priority:
                ahead += int(n)
        return float(self._predicted_wait_s(ahead) or 0.0)

    def _snapshot_classes(self, waiting: List[Request]) -> None:
        """Publish the per-class waiting depths (fresh dict per
        iteration — advisory reads see one consistent snapshot) and
        lazily register the per-class labeled gauges the first time a
        class appears (unregistered by close)."""
        snap: dict = {}
        for r in waiting:
            label = getattr(r, "class_label", "p1")
            snap[label] = snap.get(label, 0) + 1
        self._class_waiting = snap
        from paddle_tpu_torch.obs.metrics import register_gauge

        for label in snap:
            if label in self._class_gauges:
                continue
            try:
                prio = int(label[1:])
            except ValueError:
                continue
            depth_fn = (
                lambda lbl=label: int(self._class_waiting.get(lbl, 0))
            )
            wait_fn = (lambda p=prio: self._class_wait_s(p))
            register_gauge(
                "paddle_tpu_serving_class_queue_depth", depth_fn,
                "requests queued ahead of admission, by priority class",
                labels={"class": label},
            )
            register_gauge(
                "paddle_tpu_serving_class_predicted_wait_seconds",
                wait_fn,
                "predicted queue wait of a new arrival, by priority "
                "class (the per-class shed predictor's own estimate)",
                labels={"class": label},
            )
            self._class_gauges[label] = (depth_fn, wait_fn)

    def _finalize(self, r: Request, error: Optional[str] = None,
                  status: Optional[str] = None) -> None:
        # idempotent: a crash between engine registration and the waiting-
        # list trim can surface one request on BOTH shutdown paths — it
        # must finalize (and deliver its callback) exactly once
        if r._event.is_set():
            return
        r.t_done = self._clock()
        if error is not None:
            r.error = error
        r.status = status if status is not None else (
            "served" if r.error is None else "rejected"
        )
        if r.status != "served":
            self._stats.incr("serving/" + r.status)
        # the per-class ledger: serving/class/<label>/<status> counters
        # (EVERY status including served) feed the class-labeled
        # paddle_tpu_serving_requests_total series (obs/metrics.py)
        self._stats.incr(
            f"serving/class/{getattr(r, 'class_label', 'p1')}/{r.status}"
        )
        if r.tokens is None:
            r.tokens = []
        _obs.instant(
            "serving/" + ("done" if r.status == "served" else r.status),
            cat="serving", req=r.req_id, status=r.status,
            tokens=len(r.tokens), error=r.error,
        )
        r._event.set()  # wait() unblocks NOW, before any callback runs
        if r.callback is not None:
            self._deliver_q.put(r)

    def _dec_depth(self, n: int = 1) -> None:
        with self._lock:
            self._depth -= n

    def _drain_submissions(self, waiting: List[Request],
                           block_s: float = 0.0) -> None:
        try:
            got = self._q.get(timeout=block_s) if block_s > 0 else (
                self._q.get_nowait()
            )
        except queue.Empty:
            return
        now = self._clock()
        while True:
            err = self._validate(got)
            shed = None if err is not None else self._shed_verdict(
                got, self._n_ahead_of(got, waiting, now), now
            )
            if err is not None:
                self._finalize(got, error=err, status="rejected")
                self._dec_depth()
            elif shed is not None:
                self._finalize(got, error=shed, status="shed")
                self._dec_depth()
            else:
                got.src_ids = [int(t) for t in got.src_ids]
                if got.max_new_tokens is not None:
                    got.max_new_tokens = int(got.max_new_tokens)
                _obs.instant(
                    "serving/queued", cat="serving", req=got.req_id,
                    n_ahead=len(waiting),
                )
                waiting.append(got)
            try:
                got = self._q.get_nowait()
            except queue.Empty:
                return

    def _process_cancels(self, waiting: List[Request]) -> None:
        """Resolve queued cancellations (step thread): waiting requests
        finalize in place; live/prefilling ones release their slot and
        pages through the engine.  A cancel racing its own submit retries
        for a bounded number of iterations."""
        while True:
            try:
                req_id, reason = self._cancel_q.get_nowait()
            except queue.Empty:
                break
            self._pending_cancels[req_id] = (reason, 200)
        if not self._pending_cancels:
            return
        resolved = []
        for req_id, (reason, ttl) in self._pending_cancels.items():
            hit = None
            for r in waiting:
                if r.req_id == req_id:
                    hit = r
                    waiting.remove(r)
                    self._dec_depth()
                    break
            if hit is None:
                hit = self._engine.cancel_by_id(req_id)
            if hit is not None:
                self._finalize(hit, error=reason, status="timeout")
                resolved.append(req_id)
            elif ttl <= 1:
                resolved.append(req_id)  # unknown/finished id: drop
            else:
                self._pending_cancels[req_id] = (reason, ttl - 1)
        for req_id in resolved:
            self._pending_cancels.pop(req_id, None)

    def _sweep_deadlines(self, waiting: List[Request]) -> None:
        """Expire deadlines: a QUEUED request whose remaining budget can no
        longer cover its expected service is shed before it burns a slot
        (the arrival-time prediction re-checked against reality — queues
        drain slower than predicted under overload); a LIVE request past
        its deadline is canceled — slot and pages free for feasible
        work."""
        now = self._clock()
        floor = (self._est_service_s() or 0.0) * _SERVICE_SAFETY
        expired = [
            r for r in waiting
            if r.t_deadline is not None and now + floor > r.t_deadline
        ]
        for r in expired:
            waiting.remove(r)
            self._dec_depth()
            _obs.instant(
                "serving/shed", cat="serving", req=r.req_id,
                est_service_s=round(floor, 6),
                remaining_budget_s=round(r.t_deadline - now, 6),
                deadline_s=r.deadline_s,
            )
            self._finalize(
                r, error=(
                    "shed: remaining deadline budget "
                    f"{max(0.0, (r.t_deadline - now)) * 1e3:.0f} ms below "
                    "the expected service time"
                    if now <= r.t_deadline
                    else "shed: deadline expired while queued"
                ),
                status="shed",
            )
        for r in list(self._engine.outstanding_requests()):
            if r.t_deadline is not None and now > r.t_deadline:
                if self._engine.cancel(r):
                    self._finalize(
                        r, error="timeout: deadline exceeded mid-decode",
                        status="timeout",
                    )

    def _observe_step(self, dt: float, n_live: int, finished) -> None:
        """Feed the SLO predictor: per-token step time from this dispatch
        folded into ITS concurrency rung's EWMA, generated-token counts
        from the requests it finished."""
        per_token = dt / max(1, getattr(self._engine, "block_steps", 1))
        rung = _rung_of(n_live)
        prev = self._rung_token_s.get(rung)
        self._rung_token_s[rung] = per_token if prev is None else (
            _EWMA_DECAY * prev + (1 - _EWMA_DECAY) * per_token
        )
        for r in finished:
            n = float(len(r.tokens or [])) or 1.0
            self._ewma_tokens = n if self._ewma_tokens is None else (
                _EWMA_DECAY * self._ewma_tokens + (1 - _EWMA_DECAY) * n
            )

    def _loop(self) -> None:
        waiting: List[Request] = []  # validated, awaiting slot/pages
        crash: Optional[str] = None
        try:
            while not self._stop.is_set():
                # idle (nothing live, nothing waiting): block briefly on
                # the queue instead of spinning
                idle = (
                    not waiting and self._engine.n_live == 0
                    and self._engine.n_prefilling == 0
                    and self._cancel_q.empty()
                    and not self._pending_cancels
                )
                self._drain_submissions(
                    waiting, block_s=self._idle_poll_s if idle else 0.0
                )
                self._process_cancels(waiting)
                self._sweep_deadlines(waiting)
                self._snapshot_classes(waiting)
                if waiting:
                    # strict-priority-with-aging dequeue: the engine
                    # admits a strict prefix, so ORDERING the waiting
                    # list IS the dequeue policy (sort is stable —
                    # submit order breaks ties within a class)
                    now = self._clock()
                    waiting.sort(key=lambda r: self._eff_priority(r, now))
                    admitted = self._engine.admit(waiting)
                    if admitted:
                        for r in admitted:
                            _obs.instant(
                                "serving/admit", cat="serving",
                                req=r.req_id,
                                priority=getattr(r, "priority", 1),
                            )
                        del waiting[: len(admitted)]
                        self._dec_depth(len(admitted))
                if self._engine.n_live or self._engine.n_prefilling:
                    variants0 = self._engine.shape_variants
                    # a step that advanced a chunked-prefill dispatch, or
                    # ran a new shape (its first-run warm-up), spent its
                    # wall time on something other than decode — feeding it
                    # to the EWMA would poison the shed predictor into
                    # shedding feasible requests until the outlier washes out
                    clean_sample = self._engine.n_prefilling == 0
                    n_live0 = self._engine.n_live
                    t0 = self._clock()
                    with _obs.span(
                        "decode_step", cat="serving",
                        live=n_live0,
                        prefilling=self._engine.n_prefilling,
                    ):
                        finished = self._engine.step()
                    dt = self._clock() - t0
                    if clean_sample and self._engine.shape_variants == variants0:
                        self._observe_step(dt, n_live0, finished)
                    for r in finished:
                        self._finalize(r)
        except Exception as e:  # engine bug: fail loudly, strand NO client
            _log.exception("serving step loop crashed; scheduler closes")
            # postmortem BEFORE the teardown below mutates anything: the
            # last N events show what the step loop was doing when it died
            _obs.flight_dump(f"serving-crash-guard: {e!r}")
            crash = f"serving loop crashed: {e!r}"
            self.crashed = crash
            with self._lock:
                self._closed = True  # further submits raise, not hang
            self._stop.set()
            self._stats.incr("serving/loop_crashes")
        # shutdown: nothing new executes; unblock every outstanding client
        error = crash or "scheduler closed"
        status = "closed"
        self._drain_submissions(waiting)
        for r in waiting:
            self._finalize(r, error=error, status=status)
        try:
            while self._engine.n_live:
                r = self._engine.preempt()
                if r is None:
                    break
                r._resume = None
                self._finalize(r, error=error, status=status)
            for r in list(self._engine.outstanding_requests()):
                self._engine.cancel(r)
                self._finalize(r, error=error, status=status)
        except Exception:  # a corrupted engine can't block the unblocking
            _log.exception("engine teardown failed; finalizing live slots")
            for r in list(self._engine.outstanding_requests()):
                self._finalize(r, error=error, status=status)

    # -- delivery thread -------------------------------------------------
    def _delivery_loop(self) -> None:
        while not (self._stop.is_set() and self._deliver_q.empty()):
            try:
                r = self._deliver_q.get(timeout=0.05)
            except queue.Empty:
                continue
            if chaos.fire("serve_slow_client"):
                chaos.hang()  # the slow-consumer drill: only callbacks stall
            with _obs.span("deliver", cat="serving", req=r.req_id):
                try:
                    r.callback(r)
                except Exception:  # client bug must not kill delivery
                    self._stats.incr("serving/callback_errors")
