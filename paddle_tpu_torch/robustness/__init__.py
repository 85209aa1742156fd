"""Fault-tolerant training: the divergence sentinel, rollback, preemption
and chaos — the counterpart of ``paddle_tpu/robustness/``.

* :mod:`~paddle_tpu_torch.robustness.sentinel` — the host-side judge of
  the step's fused health flag (skip streaks, EMA loss spikes).
* :mod:`~paddle_tpu_torch.robustness.recovery` — rollback to last-good
  full-state checkpoints with ``failure_max`` retry and quarantine of data
  windows.
* :mod:`~paddle_tpu_torch.robustness.preemption` — SIGTERM/SIGINT to a
  synchronous final checkpoint and a ``PREEMPTED`` marker; ``resume``
  restores mid-pass.
* :mod:`~paddle_tpu_torch.robustness.chaos` — named fault points armed by
  flag or environment.
* :mod:`~paddle_tpu_torch.robustness.netem` — the ``net_*`` points' faults
  on the master's wire.
* :mod:`~paddle_tpu_torch.robustness.traces` — ``.ptt`` serving-traffic
  record and replay.
* :mod:`~paddle_tpu_torch.robustness.scenarios` — the mixed-traffic SLO
  and chaos scenario harness over the serving, training and fleet planes.
* :mod:`~paddle_tpu_torch.robustness.fuzz` — the chaos-composition fuzzer
  with ddmin shrinking and replayable specs.

As in the JAX package, the last three are imported by module path (the
package binds none of their names).
"""

from paddle_tpu_torch.robustness import chaos  # noqa: F401
from paddle_tpu_torch.robustness.preemption import (  # noqa: F401
    MARKER_NAME,
    PreemptionGuard,
    clear_marker,
    read_marker,
    write_marker,
)
from paddle_tpu_torch.robustness.recovery import RecoveryCoordinator  # noqa: F401
from paddle_tpu_torch.robustness.sentinel import DivergenceSentinel  # noqa: F401

__all__ = [
    "chaos",
    "DivergenceSentinel",
    "RecoveryCoordinator",
    "PreemptionGuard",
    "MARKER_NAME",
    "write_marker",
    "read_marker",
    "clear_marker",
]
