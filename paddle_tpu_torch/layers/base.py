"""Layer implementation registry — the counterpart of
``paddle_tpu/layers/base.py``.  A layer is a pair of plain functions:

  * ``init(conf, in_confs, gen, device) -> params`` builds its tensors from a
    ``torch.Generator``;
  * ``apply(conf, params, inputs, ctx) -> SeqTensor`` runs its forward;

and a layer with non-trainable state (batch norm's moving statistics) also
has ``init_state(conf, in_confs, device) -> state``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, List, Optional

import torch

from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.core.topology import LayerConf


@dataclasses.dataclass
class ApplyContext:
    """Context threaded through layer application."""

    train: bool
    outputs: Dict[str, SeqTensor] = dataclasses.field(default_factory=dict)
    # non-trainable per-layer state (batch-norm moving stats): read from
    # `state`, write updates into `new_state` (the inputs are not mutated)
    state: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    new_state: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    dtype: Any = torch.float32


def stable_hash(name: str) -> int:
    """Process-stable 31-bit hash of a layer name (per-layer init streams)."""
    return zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF


InitFn = Callable[[LayerConf, List[LayerConf], torch.Generator, Any], Dict[str, Any]]
ApplyFn = Callable[[LayerConf, Dict[str, Any], List[SeqTensor], ApplyContext], SeqTensor]
StateInitFn = Callable[[LayerConf, List[LayerConf], Any], Dict[str, Any]]


@dataclasses.dataclass(frozen=True)
class LayerImpl:
    type: str
    init: InitFn
    apply: ApplyFn
    # builds the initial non-trainable state; None = stateless
    init_state: Optional[StateInitFn] = None
    # the compiler applies conf.act after `apply` when True
    auto_activation: bool = True
    # the compiler hands this layer f32 inputs under mixed precision
    full_precision: bool = False


_LAYERS: Dict[str, LayerImpl] = {}


def no_params(conf, in_confs, gen, device) -> Dict[str, Any]:
    return {}


def register_layer(
    type_name: str,
    init: Optional[InitFn] = None,
    *,
    init_state: Optional[StateInitFn] = None,
    auto_activation: bool = True,
    full_precision: bool = False,
):
    """Decorator over the apply function."""

    def deco(apply: ApplyFn) -> ApplyFn:
        if type_name in _LAYERS:
            raise ValueError(f"duplicate layer type {type_name!r}")
        _LAYERS[type_name] = LayerImpl(
            type=type_name,
            init=init or no_params,
            apply=apply,
            init_state=init_state,
            auto_activation=auto_activation,
            full_precision=full_precision,
        )
        return apply

    return deco


def get_layer_impl(type_name: str) -> LayerImpl:
    try:
        return _LAYERS[type_name]
    except KeyError:
        raise NotImplementedError(
            f"layer type {type_name!r} has no impl in paddle_tpu_torch yet; "
            f"ported: {sorted(_LAYERS)}"
        ) from None


def registered_layer_types() -> List[str]:
    return sorted(_LAYERS)


def take_rows_or_zero(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row lookup where ids outside [0, rows) give a zero row (the
    reference's table-kernel contract, as in the JAX package)."""
    valid = (idx >= 0) & (idx < w.shape[0])
    out = w[torch.where(valid, idx, torch.zeros_like(idx)).long()]
    return out * valid[..., None].to(out.dtype)
