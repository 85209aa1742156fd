"""Scoped wall-clock and count stats — a copy of ``paddle_tpu/utils/timers.py``
(the reference's REGISTER_TIMER: paddle/utils/Stat.h:63,114,230
Stat/StatSet/REGISTER_TIMER).  They cover the host side (feed, dispatch,
blocking waits) and the serving plane's counters; device time comes from
``torch.profiler``."""

from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Dict, Iterator


class _Stat:
    __slots__ = ("total", "count", "max", "nonfinite")

    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0
        self.max = 0.0
        self.nonfinite = 0

    def add(self, dt: float) -> None:
        self.total += dt
        self.count += 1
        if dt > self.max:
            self.max = dt

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0


class StatSet:
    """Thread-safe: every mutation (timer/incr/observe) and every read
    (count/summary) takes ``_lock``, so concurrent counters never lose an
    increment (stress-tested in test_lock_sanitizer.py).  The lock stays a
    RAW ``threading.Lock`` deliberately: the lock sanitizer
    (analysis/lock_sanitizer.py in the JAX package) reports held-time stats
    into this class on every release — a sanitized StatSet lock would recurse."""

    def __init__(self) -> None:
        self._stats: Dict[str, _Stat] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._stats.setdefault(name, _Stat()).add(dt)

    def incr(self, name: str, n: int = 1) -> None:
        """Count-only stat (no wall time) — e.g. the compile-cache hit/miss
        counters (core/compiler.py CompileShapeCache).  Shares the summary /
        print surface with the timers: `count` is the signal, times stay 0."""
        with self._lock:
            self._stats.setdefault(name, _Stat()).count += n

    def observe(self, name: str, value: float) -> None:
        """Value stat: fold a measured scalar (gradient norm, loss EMA)
        into the same summary surface — `total`/`avg`/`max` are over the
        observed values instead of wall seconds.  A non-finite value is
        counted in the stat's own `nonfinite` bucket instead of folding:
        one NaN must not poison the avg/max column the chaos drills (and
        the numerics sanitizer's `num/<eqn>` range stats) assert on."""
        v = float(value)
        with self._lock:
            s = self._stats.setdefault(name, _Stat())
            if math.isfinite(v):
                s.add(v)
            else:
                s.nonfinite += 1

    def count(self, name: str) -> int:
        with self._lock:
            s = self._stats.get(name)
            return s.count if s else 0

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                k: {"total": s.total, "count": s.count, "avg": s.avg,
                    "max": s.max, "nonfinite": s.nonfinite}
                for k, s in self._stats.items()
            }

    def print_all_status(self) -> str:
        """globalStat.printAllStatus() equivalent.  The name column widens
        to the longest stat name (floor 24): names past 24 chars — the
        lock sanitizer's ``lock_held/<name>`` rows, the serving counters —
        used to shear the numeric columns out of alignment."""
        rows = sorted(self.summary().items())
        w = max([24] + [len(k) for k, _ in rows]) + 1
        lines = [
            f"{'name':<{w}}{'count':>8}{'total_s':>12}{'avg_ms':>10}"
            f"{'max_ms':>10}"
        ]
        for k, s in rows:
            lines.append(
                f"{k:<{w}}{s['count']:>8}{s['total']:>12.3f}"
                f"{s['avg'] * 1e3:>10.3f}{s['max'] * 1e3:>10.3f}"
            )
        out = "\n".join(lines)
        print(out)
        return out


global_stats = StatSet()


def stat_timer(name: str):
    return global_stats.timer(name)
