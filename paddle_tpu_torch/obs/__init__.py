"""Unified observability plane — tracing, flight recorder,
metrics export.

Three faces over the four concurrent planes (trainer / elastic fleet /
HA master / serving scheduler):

* :mod:`~paddle_tpu_torch.obs.tracer` — low-overhead span tracer: per-thread
  bounded rings of begin/end/instant events (monotonic clock,
  injectable), Chrome-trace-event JSON export that opens directly in
  Perfetto, process trace context (trace id + pid + role) and explicit
  correlation ids (``req``/``task``/``rpc``) so one request's lifecycle
  lines up across processes.  The ring doubles as an always-on flight
  recorder: SIGUSR1, firing chaos points, the divergence sentinel, and
  the serving crash guard dump ``flight-<pid>.json`` postmortems.
* :mod:`~paddle_tpu_torch.obs.merge` — ``python -m paddle_tpu_torch trace merge``: zip the
  per-process trace files of a launcher/scenario run into ONE timeline,
  clock-skew aligned via the RPC plane's request/response pairs.
* :mod:`~paddle_tpu_torch.obs.metrics` — periodic StatSet→Prometheus-text
  snapshots (file and/or localhost HTTP) with first-class gauges for
  the serving SLO variables (queue depth, pages in use, EWMA predicted
  wait, served/shed/rejected/timeout ledger).

This package imports neither torch nor the port's device modules:
master.py and the numpy elastic plane instrument through it.  The span
and flight-recorder files have the JAX package's schema, so
``obs.merge`` zips either package's files into one timeline.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any

from paddle_tpu_torch.obs.tracer import (  # noqa: F401
    Tracer,
    flight_dump,
    instant,
    next_rpc_id,
    span,
    tracer,
)

__all__ = [
    "Tracer",
    "tracer",
    "span",
    "instant",
    "flight_dump",
    "next_rpc_id",
    "write_stats_json",
    "merge",
    "metrics",
]

_log = logging.getLogger("paddle_tpu_torch.obs")

_LAZY = {"merge", "metrics"}


def __getattr__(name: str):  # PEP 562: keep the http/glob machinery lazy
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f"paddle_tpu_torch.obs.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'paddle_tpu_torch.obs' has no attribute {name!r}")


def write_stats_json(path: str, record: Any, append: bool = False) -> bool:
    """The ONE ``--stats-out`` writer every CLI face shares (previously
    three divergent copies in cli.py x2 and trainer/elastic.py).

    ``append=False`` writes one JSON document atomically (tmp + replace —
    a reader never sees a torn file); ``append=True`` appends one JSON
    line (the per-leadership-assumption log of ``python -m paddle_tpu_torch master``).
    The stats line is ADVISORY everywhere: an unwritable path logs one
    uniform warning and returns False instead of crashing the process
    that just finished real work (a fleet sharing one bad ``--stats-out``
    argv must not crash-loop)."""
    try:
        line = json.dumps(record)
        if append:
            with open(path, "a") as f:
                f.write(line + "\n")
        else:
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(line + "\n")
            os.replace(tmp, path)
        return True
    except (OSError, TypeError, ValueError) as exc:
        _log.warning("stats-out %s unwritable: %s", path, exc)
        print(f"stats-out {path} unwritable: {exc}", flush=True)
        return False
