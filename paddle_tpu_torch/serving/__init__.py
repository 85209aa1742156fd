"""The serving plane of the port — the counterpart of ``paddle_tpu/serving/``:
continuous batching over a block-paged decode-state cache, on the card.

* :mod:`~paddle_tpu_torch.serving.pages` — fixed-size blocks and the page
  table under an explicit budget (a copy of the JAX package's module);
* :mod:`~paddle_tpu_torch.serving.engine` — prefill and the page-table
  gather decode, with chunked prefill, the copy-on-write prefix cache,
  speculative decoding, beam serving and int8 weights;
* :mod:`~paddle_tpu_torch.serving.scheduler` — the request queue, the step
  and delivery threads and the SLO plane (deadlines, bounded queue,
  shedding, priority classes, ``cancel``/``drain``);
* :mod:`~paddle_tpu_torch.serving.router` — the fleet tier: an SLO-aware,
  affinity-routing frontend over N engine processes on heartbeat leases,
  over the master's typed wire, with a journal-backed request ledger.
"""

from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.pages import BlockPagedCache
from paddle_tpu_torch.serving.router import (
    EngineAgent,
    FleetClient,
    Router,
    affinity_key,
    rendezvous_pick,
)
from paddle_tpu_torch.serving.scheduler import (
    Request,
    ServingScheduler,
    percentile,
    status_counts,
)

__all__ = [
    "BlockPagedCache",
    "EngineAgent",
    "FleetClient",
    "Request",
    "Router",
    "ServingEngine",
    "ServingScheduler",
    "affinity_key",
    "percentile",
    "rendezvous_pick",
    "status_counts",
]
