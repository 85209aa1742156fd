"""Stop-aware bounded queue puts — the one definition of the teardown
contract every background producer in the package follows: never park
forever on a full queue; poll with a timeout and re-check the stop signal,
so close()/abandon can always wake and join the thread."""

from __future__ import annotations

import queue as _queue
from typing import Callable

__all__ = ["bounded_put"]


def bounded_put(q: "_queue.Queue", item, stopped: Callable[[], bool],
                timeout: float = 0.1) -> bool:
    """Put ``item`` unless ``stopped()`` turns true first; returns False
    when the producer should exit instead."""
    while not stopped():
        try:
            q.put(item, timeout=timeout)
            return True
        except _queue.Full:
            continue
    return False
