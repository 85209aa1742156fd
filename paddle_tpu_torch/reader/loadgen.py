"""Open-loop load generator — the counterpart of ``paddle_tpu/reader/loadgen.py``
(numpy only, no torch): arrival-clock request injection.

Closed-loop load tests (submit, wait, submit) measure the server's best
case: the client throttles itself to the service rate and queueing delay
never appears.  The serving comparison methodology (arXiv:2605.25645)
uses OPEN-LOOP load instead: arrivals follow a fixed stochastic process
independent of completions, so an overloaded server shows up as growing
queueing delay in the latency percentiles rather than as a silently
reduced offered rate.  This module is that
arrival clock for the serving plane's drills (``python -m paddle_tpu_torch
serve`` and chip_smoke.py's phase 24).  One seed gives the JAX package's
schedule and sources exactly.

Determinism: inter-arrival gaps precompute from a seeded RNG at
construction, so a drill replays the identical arrival schedule; ``clock``
and ``sleep`` are injectable (the C306 discipline — tests drive virtual
time, production uses the wall clock).
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional

import numpy as np

__all__ = ["OpenLoopLoadGen", "PrefixMixer"]


class PrefixMixer:
    """Seeded shared-prefix traffic shaper for synthetic sources — the
    workload half of the copy-on-write prefix cache (serving/engine.py):
    production request streams repeat system prompts and conversation
    heads, so synthetic traffic must too, or the cache's hit
    path never executes under load.

    A pool of ``pool_size`` prefixes (each ``prefix_tokens`` long) is
    drawn once from ``seed``; :meth:`source` then makes the i-th request's
    source ids — with probability ``prefix_frac`` a pool prefix (chosen
    round-robin so every pool entry warms) followed by a fresh random
    tail, otherwise a fully fresh source.  FULL-duplicate prompts (tail
    length 0) arise with ``dup_frac``, exercising the exact-prompt hit
    path; everything is deterministic in (seed, i).

    Vocab ids draw from [2, vocab) — 0/1 stay reserved for BOS/EOS,
    matching the serving CLI's synthetic sources."""

    def __init__(
        self,
        vocab: int,
        *,
        pool_size: int = 4,
        prefix_frac: float = 0.5,
        prefix_tokens: int = 12,
        tail_tokens: int = 8,
        dup_frac: float = 0.25,
        seed: int = 0,
        sessions: int = 0,
    ):
        if not 0.0 <= prefix_frac <= 1.0:
            raise ValueError("prefix_frac must be in [0, 1]")
        if not 0.0 <= dup_frac <= 1.0:
            raise ValueError("dup_frac must be in [0, 1]")
        if pool_size < 1:
            raise ValueError("pool_size must be >= 1")
        self.vocab = int(vocab)
        self.pool_size = int(pool_size)
        self.prefix_frac = float(prefix_frac)
        self.dup_frac = float(dup_frac)
        rng = np.random.RandomState(seed)
        self.pool: List[List[int]] = [
            rng.randint(2, vocab, size=prefix_tokens).tolist()
            for _ in range(self.pool_size)
        ]
        self._tail_tokens = int(tail_tokens)
        self._seed = int(seed)
        self.sessions = int(sessions)

    def source(self, i: int) -> List[int]:
        """Source ids of the i-th request — deterministic in (seed, i),
        independent of call order (each request derives its own RNG), so
        a replayed drill offers the identical prompt stream."""
        rng = np.random.RandomState((self._seed * 1_000_003 + i) & 0x7FFFFFFF)
        if rng.random_sample() >= self.prefix_frac:
            n = 1 + rng.randint(
                self._tail_tokens + len(self.pool[0])
            )
            return rng.randint(2, self.vocab, size=n).tolist()
        prefix = self.pool[i % self.pool_size]
        if rng.random_sample() < self.dup_frac:
            return list(prefix)  # exact repeat: the full-prompt hit path
        tail = rng.randint(
            2, self.vocab, size=1 + rng.randint(self._tail_tokens)
        ).tolist()
        return list(prefix) + tail

    def session_of(self, i: int) -> Optional[str]:
        """Session id of the i-th request — deterministic in (seed, i),
        or None when ``sessions`` is 0 (the default: session-less
        traffic).  A prefix-bearing request's session follows its POOL
        entry, so every request sharing a prompt head shares a session —
        exactly the correlation the fleet router's session-affinity
        routing keys on (shared-prefix traffic concentrates on the
        engine whose cache already holds the blocks); fresh-source
        requests spread round-robin over the session space."""
        if self.sessions <= 0:
            return None
        rng = np.random.RandomState((self._seed * 1_000_003 + i) & 0x7FFFFFFF)
        if rng.random_sample() >= self.prefix_frac:
            return f"sess{i % self.sessions}"
        return f"sess{(i % self.pool_size) % self.sessions}"


class OpenLoopLoadGen:
    """Submit ``n_requests`` at ``rate_rps`` on an open-loop arrival clock.

    ``make_request(i)`` builds the i-th request object;
    :meth:`run`\\ ``(submit)`` blocks the calling thread, sleeping until
    each precomputed arrival time and then calling ``submit(request)``
    regardless of how many earlier requests have completed.

    ``process``: ``"poisson"`` (exponential gaps — bursty, the realistic
    default), ``"uniform"`` (evenly spaced — the reproducible floor), or
    ``"burst"`` (Poisson bursts riding a quiet base rate — the two-state
    modulated Poisson process that makes tail-latency SLOs earn their
    keep: long-run mean stays ``rate_rps``, but ``burst_factor``-times
    that rate arrives during burst episodes covering ``burst_fraction``
    of the schedule's span).

    ``deadline_s``: when set, every built request is stamped with this
    per-request end-to-end deadline (``request.deadline_s``) before
    submission — the SLO input the scheduler's admission shedding reads.

    ``session_of``: optional ``i -> session id`` callable (e.g.
    :meth:`PrefixMixer.session_of`); a non-None id is stamped on the
    built request (``request.session_id``) before submission — the
    fleet router's affinity-routing key.

    ``priority_of``: optional ``i -> priority class`` callable; a
    non-None value is stamped (``request.priority``) before submission
    — the per-class admission input (serving/scheduler.py).

    Stamping never CLOBBERS a value the built request already carries:
    a request whose deadline/session/priority was derived from a
    recorded trace (robustness/traces.py replay) keeps the recorded
    values — the replayed day must reproduce the recorded affinity
    keys, not re-derive them from a live RNG.
    """

    def __init__(
        self,
        rate_rps: float,
        n_requests: int,
        make_request: Callable[[int], Any],
        *,
        process: str = "poisson",
        seed: int = 0,
        deadline_s: Optional[float] = None,
        session_of: Optional[Callable[[int], Optional[str]]] = None,
        priority_of: Optional[Callable[[int], Optional[int]]] = None,
        burst_factor: float = 3.0,
        burst_fraction: float = 0.2,
        clock=time.perf_counter,
        sleep=time.sleep,
    ):
        if rate_rps <= 0:
            raise ValueError("rate_rps must be > 0")
        if process not in ("poisson", "uniform", "burst"):
            raise ValueError(f"unknown arrival process {process!r}")
        self.rate_rps = float(rate_rps)
        self.n_requests = int(n_requests)
        self.make_request = make_request
        self.deadline_s = deadline_s
        self.session_of = session_of
        self.priority_of = priority_of
        self._clock = clock
        self._sleep = sleep
        rng = np.random.RandomState(seed)
        if process == "poisson":
            gaps = rng.exponential(1.0 / rate_rps, size=self.n_requests)
        elif process == "uniform":
            gaps = np.full(self.n_requests, 1.0 / rate_rps)
        else:
            gaps = self._burst_gaps(rng, burst_factor, burst_fraction)
        # arrival offsets from t0; the first request arrives after one gap
        self.arrivals: List[float] = list(np.cumsum(gaps))

    def _burst_gaps(self, rng, burst_factor: float, burst_fraction: float):
        """Two-state modulated Poisson gaps: each arrival draws its gap at
        the burst rate (``burst_factor * rate_rps``) or the quiet rate,
        with state residency exponential in TIME so bursts cover
        ``burst_fraction`` of the span and the long-run mean rate solves
        back to ``rate_rps`` exactly."""
        if burst_factor <= 1.0:
            raise ValueError("burst_factor must be > 1")
        if not 0.0 < burst_fraction < 1.0:
            raise ValueError("burst_fraction must be in (0, 1)")
        burst_rate = burst_factor * self.rate_rps
        # mean = f*burst + (1-f)*quiet  =>  quiet carries the remainder
        quiet_rate = (
            self.rate_rps * (1.0 - burst_fraction * burst_factor)
            / (1.0 - burst_fraction)
        )
        if quiet_rate <= 0:
            raise ValueError(
                f"burst_factor {burst_factor} x burst_fraction "
                f"{burst_fraction} leaves no quiet-rate remainder; lower one"
            )
        # state episodes long enough to hold several arrivals each (the
        # point of a burst is queue build-up, not a lone early packet)
        mean_quiet_s = 8.0 / quiet_rate
        mean_burst_s = mean_quiet_s * burst_fraction / (1.0 - burst_fraction)
        gaps = np.empty(self.n_requests)
        in_burst = False
        state_left = rng.exponential(mean_quiet_s)
        for i in range(self.n_requests):
            g = rng.exponential(
                1.0 / (burst_rate if in_burst else quiet_rate)
            )
            gaps[i] = g
            state_left -= g
            if state_left <= 0:
                in_burst = not in_burst
                state_left = rng.exponential(
                    mean_burst_s if in_burst else mean_quiet_s
                )
        return gaps

    @property
    def offered_duration_s(self) -> float:
        """Span of the arrival schedule (last arrival offset)."""
        return self.arrivals[-1] if self.arrivals else 0.0

    def run(
        self,
        submit: Callable[[Any], Any],
        stop: Optional[Callable[[], bool]] = None,
    ) -> List[Any]:
        """Blocking open-loop injection; returns the submitted requests.
        ``stop()`` is polled before each arrival — a graceful drain (the
        ``serve`` SIGTERM path) truncates the schedule instead of
        offering load to a server that stopped admitting."""
        submitted: List[Any] = []
        t0 = self._clock()
        for i, at in enumerate(self.arrivals):
            # bounded-poll sleep toward the arrival time: stays responsive
            # if a virtual clock jumps, never parks unbounded (C306)
            while True:
                if stop is not None and stop():
                    return submitted
                delay = (t0 + at) - self._clock()
                if delay <= 0:
                    break
                self._sleep(min(delay, 0.05))
            req = self.make_request(i)
            # stamp-if-absent: a request already carrying a deadline/
            # session/priority (a trace-replay factory derived them from
            # the RECORD) keeps it — the live RNG must not re-derive
            # affinity keys a recorded day already fixed
            if (self.deadline_s is not None
                    and getattr(req, "deadline_s", None) is None):
                req.deadline_s = self.deadline_s
            if (self.session_of is not None
                    and getattr(req, "session_id", None) is None):
                sid = self.session_of(i)
                if sid is not None:
                    req.session_id = sid
            if self.priority_of is not None:
                pri = self.priority_of(i)
                if pri is not None:
                    req.priority = int(pri)
            submitted.append(submit(req))
        return submitted
