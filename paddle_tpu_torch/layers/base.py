"""Layer implementation registry — the counterpart of
``paddle_tpu/layers/base.py``.  A layer is a pair of plain functions:

  * ``init(conf, in_confs, gen, device) -> params`` builds its tensors from a
    ``torch.Generator``;
  * ``apply(conf, params, inputs, ctx) -> SeqTensor`` runs its forward;

a layer that compiles something of its own once (a recurrent group's
sub-network) has ``build(conf, compute_dtype) -> plan``, and a layer with
non-trainable state (batch norm's moving statistics) also
has ``init_state(conf, in_confs, device) -> state``.  Random draws in the
forward (dropout) come from :meth:`ApplyContext.layer_rng`: a generator
seeded from the step's seed and the layer's name, as the JAX package folds
the name into the step's key.
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
    # the step's seed (an int): per-layer generators derive from it; None
    # draws nothing (dropout is then off)
    rng: Optional[int] = None
    outputs: Dict[str, SeqTensor] = dataclasses.field(default_factory=dict)
    # non-trainable per-layer state (batch-norm moving stats): read from
    # `state`, write updates into `new_state` (the inputs are not mutated)
    state: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    new_state: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    dtype: Any = torch.float32
    # {layer: plan} the compiler made once from the impls' build hooks
    plans: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def layer_rng(self, name: str, device) -> Optional[torch.Generator]:
        """A generator on `device` seeded from the step's seed and `name`
        (a CUDA tensor's ``bernoulli_`` needs a CUDA generator)."""
        if self.rng is None:
            return None
        return torch.Generator(device=device).manual_seed(mix_seed(self.rng, name))


def mix_seed(seed: int, name: str) -> int:
    """A 63-bit seed from `seed` and a stable hash of `name`."""
    return (int(seed) * 0x9E3779B1 + stable_hash(name)) & 0x7FFFFFFFFFFFFFFF


def stable_hash(name: str) -> int:
    """Process-stable 31-bit hash of a layer name (per-layer init streams)."""
    return zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF


InitFn = Callable[[LayerConf, List[LayerConf], torch.Generator, Any], Dict[str, Any]]
ApplyFn = Callable[[LayerConf, Dict[str, Any], List[SeqTensor], ApplyContext], SeqTensor]
StateInitFn = Callable[[LayerConf, List[LayerConf], Any], Dict[str, Any]]
BuildFn = Callable[[LayerConf, Any], Any]


@dataclasses.dataclass(frozen=True)
class LayerImpl:
    type: str
    init: InitFn
    apply: ApplyFn
    # builds the initial non-trainable state; None = stateless
    init_state: Optional[StateInitFn] = None
    # the compiler applies conf.act after `apply` when True
    auto_activation: bool = True
    # the compiler applies dropout (conf.drop_rate) after the activation
    auto_dropout: bool = True
    # the compiler hands this layer f32 inputs under mixed precision
    full_precision: bool = False
    # build(conf, compute_dtype) -> plan, made once when a network is
    # compiled and handed to apply in ctx.plans[conf.name]; None = no plan
    build: Optional[BuildFn] = None


_LAYERS: Dict[str, LayerImpl] = {}


def no_params(conf, in_confs, gen, device) -> Dict[str, Any]:
    return {}


def register_layer(
    type_name: str,
    init: Optional[InitFn] = None,
    *,
    init_state: Optional[StateInitFn] = None,
    auto_activation: bool = True,
    auto_dropout: bool = True,
    full_precision: bool = False,
    build: Optional[BuildFn] = None,
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
            auto_dropout=auto_dropout,
            full_precision=full_precision,
            build=build,
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
