"""Model save/load — the ``paddle.v2.model`` surface (reference:
python/paddle/v2/model.py); the counterpart of ``paddle_tpu/model.py``.

Without a master, ``save_model`` writes a plain parameter tar (the
single-trainer path), as the JAX package does; with one, the master
arbitrates which trainer of a fleet writes (``master.Client
.request_save_model``)."""

from __future__ import annotations

import os
import uuid
from typing import Optional

__all__ = ["save_model", "load_model"]

# one id per process, like the reference's module-level uuid trainer_id
trainer_id = str(uuid.uuid4())


def save_model(
    parameters, path: str, master=None, block_secs: float = 60.0
) -> Optional[str]:
    """Write ``parameters`` as a tar at ``path``.

    ``master`` (a ``paddle_tpu_torch.master.Service``, ``Client``, or a
    ``(host, port)`` Server address) enables the distributed arbitration:
    the master grants the save to one trainer per window and the rest skip
    (returns None).  Returns the path written, or None when another trainer
    holds the grant."""
    if master is not None:
        from paddle_tpu_torch.master import Client

        client = master if isinstance(master, Client) else Client(master, trainer_id=trainer_id)
        if not client.request_save_model(block_secs):
            return None  # another trainer saves this window
        # per-trainer subdirectory, keyed by the identity that won the grant
        path = os.path.join(path, client.trainer_id, "model.tar")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        parameters.to_tar(f)
    return path


def load_model(parameters, path: str) -> None:
    with open(path, "rb") as f:
        parameters.from_tar(f)
