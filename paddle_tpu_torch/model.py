"""Model save/load — the ``paddle.v2.model`` surface (reference:
python/paddle/v2/model.py); the counterpart of ``paddle_tpu/model.py``.

Without a master, ``save_model`` writes a plain parameter tar (the
single-trainer path), as the JAX package does.  The master's save
arbitration (one trainer of a fleet writes) comes with the master plane,
which is not ported yet: passing a master raises."""

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
    """Write ``parameters`` as a tar at ``path``; returns the path written.
    ``master`` (the distributed save arbitration) is not ported yet and
    raises."""
    if master is not None:
        raise NotImplementedError(
            "save_model(master=...) (the master's save arbitration) is not ported "
            "yet (ROADMAP Queue 1 item 7); without a master it writes a plain tar")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        parameters.to_tar(f)
    return path


def load_model(parameters, path: str) -> None:
    with open(path, "rb") as f:
        parameters.from_tar(f)
