"""Chaos harness: named fault points for fault-injection tests — the
counterpart of ``paddle_tpu/robustness/chaos.py``.

Production code consults cheap, normally inert fault points; a test (or an
operator's drill) arms them through one spec string, the ``chaos`` flag or
the environment variable ``PADDLE_TPU_TORCH_CHAOS``::

    point[@occurrence][,point[@occurrence]...]

    nan_batch@5        poison the 5th staged training batch with NaN
                       (SGD.train's feed)
    torn_checkpoint@2  truncate the 2nd checkpoint's data file after its
                       write (checkpoint.py, single and sharded)
    kill@12            SIGKILL the process right after train step 12
                       (SGD.train)

    stale_lease        the master (master.py) treats every worker lease as
                       expired at its next check
    kill_master@8      SIGKILL the master inside its 8th task_finished
    kill_worker@3      SIGKILL an elastic worker holding its 3rd lease
                       (trainer/elastic.py)
    worker_hang        freeze an elastic worker, heartbeats included,
                       until its leases expire
    net_*              faults on the master's wire (robustness/netem.py)
    nan_request        poison an incoming serving request with NaN at
                       submit (serving/scheduler.py: validation rejects it)
    serve_slow_client  freeze the serving scheduler's delivery thread
                       before a callback (only delivery stalls)

A firing point dumps the obs flight recorder once per arming, as the JAX
package's does.  This module imports
torch only where ``poison_batch`` meets a tensor, so the master plane
consults it without torch.

``@occurrence`` counts consultations of that point (1-based); without it
the point fires every time.  ``fire()`` matches exactly, so ``kill@12``
fires at the 12th consultation only, and a resumed process (whose count
starts again) can be armed otherwise through its environment.  An unarmed
point costs one dict lookup.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np

__all__ = [
    "arm",
    "disarm",
    "fire",
    "active_spec",
    "armed_points",
    "consult_report",
    "write_report",
    "poison_batch",
    "tear_file",
    "kill_self",
    "hang",
    "KNOWN_POINTS",
]

_log = logging.getLogger("paddle_tpu_torch.robustness.chaos")

_ENV = "PADDLE_TPU_TORCH_CHAOS"

# the documented fault surface; arming an unknown point raises, so a
# misspelt drill never silently tests nothing
KNOWN_POINTS = frozenset(
    {"nan_batch", "torn_checkpoint", "kill", "stale_lease",
     "kill_worker", "worker_hang", "kill_master",
     "nan_request", "serve_slow_client",
     "net_delay", "net_drop", "net_dup", "net_reorder", "net_corrupt",
     "net_drip", "net_partition"}
)

_armed: Dict[str, Optional[int]] = {}  # point -> occurrence (None: every time)
_counts: Dict[str, int] = {}  # point -> consultations
_fired: Dict[str, int] = {}  # point -> fires (the arming audit)
# points that already dumped the flight recorder (one postmortem per arming)
_flight_dumped: set = set()
_env_loaded = False
_atexit_hooked = False

# a drill parent reads its child's consultation report from this file: a
# SIGKILL skips atexit, so a report that exists proves a normal exit
_REPORT_ENV = "PADDLE_TPU_TORCH_CHAOS_REPORT"


def _parse(spec: str) -> Dict[str, Optional[int]]:
    out: Dict[str, Optional[int]] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, occ = part.partition("@")
        if name not in KNOWN_POINTS:
            raise ValueError(f"unknown chaos point {name!r}; known: {sorted(KNOWN_POINTS)}")
        out[name] = int(occ) if occ else None
    return out


def _clear() -> None:
    _flight_dumped.clear()
    _armed.clear()
    _counts.clear()
    _fired.clear()


def arm(spec: str) -> None:
    """Arm fault points from a spec string (replacing any earlier arming);
    an unknown point name raises here."""
    global _env_loaded
    _env_loaded = True  # an explicit arm overrides the environment
    _clear()
    _armed.update(_parse(spec))
    if _armed:
        _log.warning("chaos armed: %s", spec)
        _hook_exit_report()


def disarm() -> None:
    global _env_loaded
    _clear()
    _env_loaded = True  # stay disarmed even if the environment arms


def active_spec() -> str:
    _load_env()
    return ",".join(f"{k}@{v}" if v is not None else k for k, v in sorted(_armed.items()))


def armed_points() -> frozenset:
    _load_env()
    return frozenset(_armed)


def _load_env() -> None:
    """Read the ``chaos`` flag once (the flags plane resolves the
    environment variable), so a subprocess test arms its child through its
    environment."""
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    from paddle_tpu_torch.utils import flags as _flags

    spec = _flags.get_flag("chaos") or os.environ.get(_ENV, "")
    if spec:
        _armed.update(_parse(spec))
        _log.warning("chaos armed from %s: %s", _ENV, spec)
        _hook_exit_report()


def fire(point: str) -> bool:
    """Consult a fault point: True when it injects its fault at this
    consultation.  The first firing of an arming dumps the obs flight
    recorder before the fault lands (a SIGKILL follows at once, so the
    dump is the only record the process leaves)."""
    _load_env()
    if point not in _armed:
        return False
    _counts[point] = _counts.get(point, 0) + 1
    occ = _armed[point]
    hit = occ is None or _counts[point] == occ
    if hit:
        _fired[point] = _fired.get(point, 0) + 1
        _log.warning("chaos point %r firing (consultation %d)", point, _counts[point])
        if point not in _flight_dumped:
            _flight_dumped.add(point)
            from paddle_tpu_torch import obs as _obs

            _obs.flight_dump(f"chaos:{point}@{_counts[point]}")
    return hit


# ---------------------------------------------------------------------------
# the arming audit: every armed point accounts for itself at process exit
# ---------------------------------------------------------------------------


def consult_report() -> Dict[str, dict]:
    """``{point: {occurrence, consultations, fired}}`` of every armed point;
    ``consultations == 0`` means the faulted code path never ran."""
    _load_env()
    return {
        point: {"occurrence": occ, "consultations": _counts.get(point, 0),
                "fired": _fired.get(point, 0)}
        for point, occ in sorted(_armed.items())
    }


def write_report(path: str) -> Dict[str, dict]:
    """:func:`consult_report` as one JSON document, replaced atomically."""
    import json

    report = consult_report()
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(report, sort_keys=True) + "\n")
    os.replace(tmp, path)
    return report


def _exit_report() -> None:
    """atexit: count fired and unfired armed points (``chaos/fired``,
    ``chaos/unfired`` and per point), log one audit line and write the
    report file ``PADDLE_TPU_TORCH_CHAOS_REPORT`` names."""
    if not _armed:
        return
    report = consult_report()
    from paddle_tpu_torch.utils.timers import global_stats

    for point, rec in report.items():
        kind = "fired" if rec["fired"] else "unfired"
        global_stats.incr(f"chaos/{kind}")
        global_stats.incr(f"chaos/{kind}/{point}")
    unfired = sorted(p for p, rec in report.items() if not rec["fired"])
    _log.warning(
        "chaos exit report: %s%s",
        ",".join(f"{p}:consulted={r['consultations']}:fired={r['fired']}"
                 for p, r in report.items()),
        f" UNFIRED={unfired}" if unfired else "")
    path = os.environ.get(_REPORT_ENV)
    if path:
        try:
            write_report(path)
        except OSError:
            _log.exception("chaos report %s unwritable", path)


def _hook_exit_report() -> None:
    global _atexit_hooked
    if _atexit_hooked:
        return
    _atexit_hooked = True
    import atexit

    atexit.register(_exit_report)


# ---------------------------------------------------------------------------
# what each point does when it fires
# ---------------------------------------------------------------------------


def poison_batch(batch):
    """NaN into the first element of the batch's first floating-point slot:
    the slot is cloned first, so a tensor the reader, a cache or another
    batch holds is never written.  Returns the batch."""
    import torch

    for key in batch:
        t = batch[key]
        data = t.data if hasattr(t, "data") else t
        if torch.is_tensor(data):
            if not data.is_floating_point():
                continue
            data = data.clone()
            data.reshape(-1)[0] = float("nan")
        else:
            arr = np.asarray(data)
            if not np.issubdtype(arr.dtype, np.floating):
                continue
            data = arr.copy()
            data.reshape(-1)[0] = np.nan
        if hasattr(t, "data"):
            batch[key] = type(t)(data, t.lengths, t.sub_lengths, sparse_ids=t.sparse_ids)
        else:
            batch[key] = data
        _log.warning("chaos: poisoned batch slot %r with NaN", key)
        return batch
    _log.warning("chaos: nan_batch fired but the batch has no float slot")
    return batch


def tear_file(path: str, keep_fraction: float = 0.5) -> None:
    """Truncate a file in place: the torn write a crash leaves."""
    size = os.path.getsize(path)
    keep = max(int(size * keep_fraction), 1)
    with open(path, "r+b") as f:
        f.truncate(keep)
    _log.warning("chaos: tore %s to %d/%d bytes", path, keep, size)


def kill_self() -> None:
    """SIGKILL this process: no handlers, no atexit, no flush."""
    import signal

    _log.warning("chaos: SIGKILL self (pid %d)", os.getpid())
    os.kill(os.getpid(), signal.SIGKILL)


def hang(seconds: Optional[float] = None) -> None:
    """Freeze the caller (a stalled but live worker); the duration comes
    from ``PADDLE_TPU_TORCH_CHAOS_HANG_SECS`` (default 20) unless given."""
    import time

    if seconds is None:
        seconds = float(os.environ.get("PADDLE_TPU_TORCH_CHAOS_HANG_SECS", "20"))
    _log.warning("chaos: hanging pid %d for %.1fs", os.getpid(), seconds)
    time.sleep(seconds)
