"""Runtime lock-order sanitizer — the dynamic leg of the concurrency plane.

The JAX package's static concurrency lint infers lock discipline from the
source; this module *watches* it at runtime.  With
``PADDLE_TPU_TORCH_LOCK_SANITIZER=1`` in the environment, every lock the package
constructs through :func:`make_lock` / :func:`make_rlock` is instrumented:

  * a per-thread held-lock stack (reentrant acquisitions counted, never
    double-pushed — an RLock re-enter is NOT an ordering event);
  * a global acquisition-order edge set: first time any thread acquires
    lock B while holding lock A, the edge ``A -> B`` is recorded together
    with the acquiring stack.  Before blocking on B, the sanitizer checks
    whether a ``B -> ... -> A`` path already exists — a cycle means two
    threads can interleave into a deadlock, and :class:`DeadlockReport`
    raises *immediately* (at the acquisition that would close the cycle,
    not after the drill wedges) carrying BOTH acquisition stacks: the one
    that recorded the conflicting order and the one attempting it now;
  * held-time value stats ride the existing StatSet plane
    (``utils.timers.global_stats`` keys ``lock_held/<name>``), so the
    chaos drills' stat dumps show which locks are contended and for how
    long.

With the env flag unset the factories return plain ``threading`` primitives
— zero overhead, zero import cost (this module imports neither torch nor
the port's device modules, so the master process can use it).

Exporting the flag in a failover or kill-one-of-N fleet drill turns it
into a lock-order race detector run; :func:`thread_report` lists the
alive ``paddle-*`` worker threads after a teardown.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "DeadlockReport",
    "SanitizedLock",
    "edges",
    "held_report",
    "make_lock",
    "make_rlock",
    "reset",
    "sanitizer_enabled",
    "thread_report",
]

ENV_FLAG = "PADDLE_TPU_TORCH_LOCK_SANITIZER"

# every thread the package spawns is named with this prefix so leak checks
# (and humans reading `py-spy dump`) can attribute it
THREAD_PREFIX = "paddle-"


def sanitizer_enabled() -> bool:
    """True when the environment arms the sanitizer (``=1``/anything truthy;
    ``0``/``false``/``off``/empty disarm)."""
    return os.environ.get(ENV_FLAG, "").lower() not in ("", "0", "false", "off")


class DeadlockReport(RuntimeError):
    """A lock acquisition would close a cycle in the acquisition-order
    graph.  ``cycle`` is the lock-name path ``[B, ..., A, B]``;
    ``this_stack`` is where the offending acquisition is happening,
    ``other_stack`` where the conflicting order was first recorded."""

    def __init__(self, cycle: List[str], this_stack: str, other_stack: str):
        self.cycle = cycle
        self.this_stack = this_stack
        self.other_stack = other_stack
        super().__init__(
            "lock-order cycle: " + " -> ".join(cycle)
            + "\n--- acquisition closing the cycle (this thread) ---\n"
            + this_stack
            + "--- first acquisition of the conflicting order ---\n"
            + other_stack
        )


def _stack() -> str:
    # drop the two sanitizer frames so the report starts at the caller
    return "".join(traceback.format_stack()[:-2])


class _Registry:
    """Global acquisition-order graph + per-thread held stacks.

    Guarded by a RAW ``threading.Lock`` (never a SanitizedLock: the
    registry must not observe itself) with short, non-blocking critical
    sections — the registry lock is always innermost and never held across
    a user lock acquisition, so it cannot participate in any cycle it
    reports."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # (holder_name, acquired_name) -> stack of the acquisition that
        # first recorded this order
        self._edges: Dict[Tuple[str, str], str] = {}
        self._graph: Dict[str, Set[str]] = {}
        # thread ident -> [ [lock, reenter_count, t_acquired], ... ]
        self._held: Dict[int, List[List]] = {}

    # -- per-thread stack ------------------------------------------------
    def _stack_of(self, ident: int) -> List[List]:
        with self._mu:
            return list(self._held.get(ident, ()))

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """A path src -> ... -> dst in the edge graph (DFS), or None.
        Caller holds ``_mu``."""
        seen = {src}
        trail = [(src, [src])]
        while trail:
            node, path = trail.pop()
            if node == dst:
                return path
            for nxt in self._graph.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    trail.append((nxt, path + [nxt]))
        return None

    def before_acquire(self, lock: "SanitizedLock") -> None:
        """Record ordering edges held -> lock; raise DeadlockReport when an
        inverse path already exists.  Runs BEFORE the blocking acquire so a
        true deadlock is reported instead of wedging the drill."""
        ident = threading.get_ident()
        with self._mu:
            held = self._held.get(ident, ())
            for entry in held:
                holder = entry[0]
                if holder is lock:
                    return  # reentrant re-acquire: not an ordering event
            for entry in held:
                holder = entry[0]
                if holder.name == lock.name:
                    # a DIFFERENT lock object under the same name (two
                    # instances of one class): the name-keyed graph cannot
                    # order them — skip rather than fabricate a self-edge
                    # (instance-level ABBA between same-named siblings is
                    # the static lint's C303 territory)
                    continue
                key = (holder.name, lock.name)
                if key in self._edges:
                    continue
                inverse = self._path(lock.name, holder.name)
                if inverse is not None:
                    other = self._edges.get(
                        (inverse[0], inverse[1]), "<unrecorded>\n"
                    )
                    raise DeadlockReport(
                        [holder.name] + inverse, _stack(), other
                    )
                self._edges[key] = _stack()
                self._graph.setdefault(holder.name, set()).add(lock.name)

    def on_acquired(self, lock: "SanitizedLock") -> None:
        ident = threading.get_ident()
        with self._mu:
            held = self._held.setdefault(ident, [])
            for entry in held:
                if entry[0] is lock:
                    entry[1] += 1
                    return
            held.append([lock, 1, time.perf_counter()])

    def on_released(self, lock: "SanitizedLock") -> Optional[float]:
        """Pop (or decrement) the entry; returns held seconds on the final
        release, None on a reentrant pop."""
        ident = threading.get_ident()
        with self._mu:
            held = self._held.get(ident, [])
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] is lock:
                    held[i][1] -= 1
                    if held[i][1] == 0:
                        _, _, t0 = held.pop(i)
                        if not held:
                            self._held.pop(ident, None)
                        return time.perf_counter() - t0
                    return None
        return None

    def held_report(self) -> Dict[str, List[str]]:
        """Currently held sanitized locks per live thread (name -> lock
        names, innermost last) — the drill-teardown leak check."""
        by_ident = {t.ident: t.name for t in threading.enumerate()}
        with self._mu:
            return {
                by_ident.get(ident, f"thread-{ident}"): [e[0].name for e in held]
                for ident, held in self._held.items()
                if held
            }

    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._mu:
            return dict(self._edges)

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._graph.clear()
            self._held.clear()


_registry = _Registry()


class SanitizedLock:
    """Instrumented Lock/RLock: ordering edges + held-time stats.  Same
    acquire/release/context-manager surface as the wrapped primitive."""

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._lk = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _registry.before_acquire(self)
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            _registry.on_acquired(self)
        return ok

    def release(self) -> None:
        self._lk.release()  # raises on misuse BEFORE the registry pops
        dt = _registry.on_released(self)
        if dt is not None:
            # lazy: utils.timers is stdlib-only, but keep the import off
            # the module path so a half-initialized package can still lock
            from paddle_tpu_torch.utils.timers import global_stats

            global_stats.observe(f"lock_held/{self.name}", dt)

    def __enter__(self) -> "SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lk.locked() if not self.reentrant else False

    def __repr__(self) -> str:
        return f"<SanitizedLock {self.name!r} reentrant={self.reentrant}>"


def make_lock(name: str):
    """A ``threading.Lock`` — instrumented when the sanitizer env flag is
    armed.  ``name`` is the stable identity in cycle reports and held-time
    stats (convention: ``Module.Class.attr``)."""
    if sanitizer_enabled():
        return SanitizedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock`` — instrumented when armed; reentrant
    re-acquisition is recognized and never reported as an ordering event."""
    if sanitizer_enabled():
        return SanitizedLock(name, reentrant=True)
    return threading.RLock()


def held_report() -> Dict[str, List[str]]:
    """Sanitized locks currently held, per thread — empty after a clean
    teardown."""
    return _registry.held_report()


def edges() -> Dict[Tuple[str, str], str]:
    """The observed acquisition-order edge set (for tests/debugging)."""
    return _registry.edges()


def reset() -> None:
    """Clear the global graph + held stacks (test isolation)."""
    _registry.reset()


def thread_report(prefix: str = THREAD_PREFIX) -> List[str]:
    """Names of alive package worker threads (``paddle-*`` by the naming
    convention) — the reader/prefetcher teardown leak check: after every
    close/stop this must come up empty."""
    return sorted(
        t.name for t in threading.enumerate()
        if t.is_alive() and t.name.startswith(prefix)
    )
