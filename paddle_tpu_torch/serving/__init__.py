"""The serving plane of the port — the counterpart of ``paddle_tpu/serving/``:
continuous batching over a block-paged decode-state cache.

* :mod:`~paddle_tpu_torch.serving.pages` — fixed-size blocks and the page
  table under an explicit budget (a copy of the JAX package's module);
* :mod:`~paddle_tpu_torch.serving.engine` — prefill and the page-table
  gather decode of the greedy core;
* :mod:`~paddle_tpu_torch.serving.scheduler` — the ``Request`` record.

Not ported yet: the scheduler (``ServingScheduler``), the fleet router
(``Router``, ``EngineAgent``, ``FleetClient``, ``affinity_key``,
``rendezvous_pick``), the latency helpers (``percentile``,
``status_counts``) and the open-loop load generator (``reader/loadgen.py``);
asking for one of them raises ``NotImplementedError`` naming it.
"""

from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.pages import BlockPagedCache
from paddle_tpu_torch.serving.scheduler import Request

__all__ = ["BlockPagedCache", "Request", "ServingEngine"]

_NOT_PORTED = frozenset({
    "ServingScheduler", "Router", "EngineAgent", "FleetClient", "affinity_key",
    "rendezvous_pick", "percentile", "status_counts", "OpenLoopLoadGen",
})


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"paddle_tpu_torch.serving.{name} is not ported yet (ROADMAP.md Queue 1 item 4)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
