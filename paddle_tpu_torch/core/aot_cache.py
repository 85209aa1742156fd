"""Program identity — ``topology_fingerprint`` of
``paddle_tpu/core/aot_cache.py`` (:77-82), which the serving engine's prefix
cache seeds its keys with.

The JAX package's persistent cache of serialized executables
(``AOTCache``, the engine's ``aot_cache_dir``) waits for ROADMAP Queue 1
item 7, where the port gets its analog or a stated "not applicable"."""

from __future__ import annotations

import hashlib

__all__ = ["topology_fingerprint"]


def topology_fingerprint(network) -> str:
    """Identity of a compiled network's graph: the serialized topology
    (types, sizes, attributes) plus the compute dtype it runs at, named as
    numpy names it ("float32"), so one topology gives the JAX package's
    fingerprint."""
    dtype = str(network.compute_dtype).replace("torch.", "")
    text = network.topology.serialize() + f"|compute={dtype}"
    return hashlib.sha256(text.encode()).hexdigest()[:16]
