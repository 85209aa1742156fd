"""Preemption-safe shutdown and resume — the counterpart of
``paddle_tpu/robustness/preemption.py``.

A scheduler preempts with SIGTERM and a grace window:

  signal -> finish the step in flight -> synchronous full-state checkpoint
  (parameters, optimizer state, generator, pass and batch position) ->
  ``PREEMPTED`` marker -> return (``trainer/sgd.py`` polls the guard once
  per batch)

  restart with ``resume=True`` -> restore the latest good checkpoint ->
  skip the interrupted pass's consumed batches -> the trajectory goes on
  where it stopped, bit for bit against an uninterrupted run when the
  reader is deterministic.

``PreemptionGuard`` installs chained handlers: the first signal sets a flag
the loop polls (no interruption mid-step); a second one falls through to
the previous handler, so a stuck run still dies on a second Ctrl-C.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
from typing import Any, Dict, Optional

__all__ = [
    "PreemptionGuard",
    "MARKER_NAME",
    "write_marker",
    "read_marker",
    "clear_marker",
]

_log = logging.getLogger("paddle_tpu_torch.robustness")

MARKER_NAME = "PREEMPTED"


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._prev: Dict[int, Any] = {}
        self._installed = False
        self.signum: Optional[int] = None

    # ------------------------------------------------------------------
    def _handler(self, signum, frame):
        if self._event.is_set():
            # second signal: the operator means it — chain to the previous
            # handler (default SIGTERM terminates; SIGINT raises
            # KeyboardInterrupt) instead of absorbing it
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
                return
            signal.signal(signum, prev or signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self.signum = signum
        self._event.set()
        _log.warning(
            "signal %d: preemption requested — will checkpoint after the "
            "in-flight step and exit (repeat the signal to force)", signum,
        )

    def __enter__(self) -> "PreemptionGuard":
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handler)
            self._installed = True
        except ValueError:
            # signal.signal only works on the main thread; a trainer driven
            # from a worker thread keeps running without preemption capture
            _log.debug("not on main thread; preemption guard inactive")
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._installed = False
        return None

    @property
    def triggered(self) -> bool:
        return self._event.is_set()


# ---------------------------------------------------------------------------
# PREEMPTED marker (lives beside the checkpoints)
# ---------------------------------------------------------------------------

def _marker_path(directory: str) -> str:
    return os.path.join(directory, MARKER_NAME)


def write_marker(directory: str, info: Dict[str, Any]) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = _marker_path(directory) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f)
    os.replace(tmp, _marker_path(directory))
    return _marker_path(directory)


def read_marker(directory: str) -> Optional[Dict[str, Any]]:
    try:
        with open(_marker_path(directory)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def clear_marker(directory: str) -> None:
    try:
        os.remove(_marker_path(directory))
    except OSError:
        pass
