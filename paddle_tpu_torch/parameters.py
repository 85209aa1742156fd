"""Parameters — the counterpart of ``paddle_tpu/parameters.py`` for what
inference and training need: the parameter tree and the non-trainable layer
state (batch norm's moving statistics), :func:`create` from a network and a
seed, and :func:`from_numpy`, which carries the JAX package's parameters and
state (``{layer: {key: ndarray}}`` trees) into the port so both compute the
same function (its network-less trees are adopted by ``trainer.SGD``).  Tar
checkpoints are not ported yet."""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.compiler import CompiledNetwork, NetState, Params
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.topology import Topology


class Parameters:
    """The parameter tree ``{layer: {key: tensor}}`` of a network and its
    layer state, a tree of the same form."""

    def __init__(self, network: Optional[CompiledNetwork], params: Params,
                 state: Optional[NetState] = None):
        self.network = network
        self.params = params
        self.state = state if state is not None else {}

    def names(self):
        """Dotted parameter names, "<layer>.<key>" (the JAX package's form)."""
        return [f"{layer}.{key}" for layer, p in self.params.items() for key in p]

    def get(self, key: str) -> np.ndarray:
        layer, leaf = key.rsplit(".", 1)
        return self.params[layer][leaf].detach().float().cpu().numpy()

    __getitem__ = get


def create(cost_or_topology, seed: int = 0, dtype=None, device=None) -> Parameters:
    """paddle.parameters.create(cost) equivalent, on `device` (the card
    unless the caller asks for the CPU)."""
    topo = (
        cost_or_topology
        if isinstance(cost_or_topology, Topology)
        else Topology(cost_or_topology)
    )
    network = CompiledNetwork(topo, dtype=dtype) if dtype else CompiledNetwork(topo)
    return create_from_network(network, seed, device)


def create_from_network(network: CompiledNetwork, seed: int = 0, device=None) -> Parameters:
    return Parameters(network, *network.init(seed, resolve_device(device)))


def _tensor_tree(tree: Mapping[str, Mapping[str, np.ndarray]], dev) -> Dict[str, Dict[str, torch.Tensor]]:
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for layer, p in tree.items():
        if not isinstance(p, Mapping):
            raise TypeError(f"{layer!r}: expected a {{key: array}} dict, got {type(p).__name__}")
        out[layer] = {
            k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev) for k, v in p.items()
        }
    return out


def from_numpy(tree: Mapping[str, Mapping[str, np.ndarray]],
               state_tree: Optional[Mapping[str, Mapping[str, np.ndarray]]] = None,
               device=None) -> Parameters:
    """Parameters from ``{layer: {key: array}}`` trees of numpy arrays (the
    JAX package's ``Parameters.params`` and ``Parameters.state`` passed
    through ``np.asarray``), as float32 tensors on `device`.  Layouts are the
    JAX package's, which the port keeps (conv kernels HWIO)."""
    dev = resolve_device(device)
    return Parameters(None, _tensor_tree(tree, dev), _tensor_tree(state_tree or {}, dev))
