"""Topology → forward function — the counterpart of
``paddle_tpu/core/compiler.py``.

:meth:`CompiledNetwork.apply` walks the topology in order and runs each
layer's torch impl eagerly (the JAX package traces the same loop under
``jax.jit``).  Master parameters stay float32; under a bfloat16 compute
dtype each layer that is not full-precision gets its parameters and inputs
cast to bf16 and its output cast back to bf16, exactly as in the JAX loop.

:meth:`CompiledNetwork.cost` is the differentiable quantity of training
(the mean of the first output); the train step takes its gradient with
autograd.  Non-trainable layer state (batch norm's moving statistics) is
threaded functionally as in the JAX package: ``apply`` reads ``state`` and
returns ``{**state, **updates}``, leaving its inputs untouched.

Not ported yet: name-shared parameters (``param_name``/``param_names``
ParamAttr sharing) and dynamic widths (these raise at build), dropout and
error clipping in training (these raise in ``apply(train=True)``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from paddle_tpu_torch.core.batch import Batch, SeqTensor
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.layers.base import ApplyContext, get_layer_impl, stable_hash
from paddle_tpu_torch.ops.activations import apply_activation

Params = Dict[str, Dict[str, Any]]
NetState = Dict[str, Dict[str, Any]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# default compute dtype for newly built networks (None = float32)
_default_compute_dtype: Optional[torch.dtype] = None


def as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; known: {sorted(_DTYPES)}") from None


def set_default_compute_dtype(dtype) -> None:
    global _default_compute_dtype
    _default_compute_dtype = None if dtype is None else as_dtype(dtype)


def get_default_compute_dtype() -> Optional[torch.dtype]:
    return _default_compute_dtype


def _cast_floats(x, dtype):
    """Cast the floating tensors of a SeqTensor or a param dict to `dtype`
    (integer lengths and ids pass)."""
    if isinstance(x, SeqTensor):
        return SeqTensor(_cast_floats(x.data, dtype), x.lengths, x.sub_lengths)
    if isinstance(x, dict):
        return {k: _cast_floats(v, dtype) for k, v in x.items()}
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(dtype)
    return x


def _feed_transform(conf, t: SeqTensor) -> SeqTensor:
    """A DENSE slot fed at an integer dtype is cast to float32 and scaled by
    the data layer's feed_scale/feed_shift (JAX compiler :79)."""
    from paddle_tpu_torch.core.data_types import SlotKind

    it = conf.input_type
    if it is None or it.kind != SlotKind.DENSE or t.data.is_floating_point():
        return t
    x = t.data.float()
    scale = conf.attr("feed_scale") or 0.0
    shift = conf.attr("feed_shift") or 0.0
    if scale:
        x = x * scale
    if shift:
        x = x + shift
    return SeqTensor(x, t.lengths, t.sub_lengths)


class CompiledNetwork:
    """init/apply view over a Topology."""

    def __init__(self, topology: Topology, dtype=torch.float32, compute_dtype=None):
        self.topology = topology
        self.dtype = as_dtype(dtype)
        if compute_dtype is None:
            compute_dtype = _default_compute_dtype or self.dtype
        self.compute_dtype = as_dtype(compute_dtype)
        # resolve impls now, so a type the port lacks fails at build
        self._impls = {
            name: get_layer_impl(conf.type) for name, conf in topology.layers.items()
        }
        for name, conf in topology.layers.items():
            if conf.attr("param_name") or conf.attr("param_names"):
                raise NotImplementedError(
                    f"layer {name!r}: name-shared parameters are not ported yet"
                )
            if conf.attr("_sub_topology") is not None:
                raise NotImplementedError(
                    f"layer {name!r}: recurrent_group sub-topologies are not ported yet"
                )

    # ------------------------------------------------------------------
    def init_params(self, seed: int = 0, device=None) -> Params:
        """Each layer draws from its own generator, seeded from `seed` and a
        stable hash of its name (the JAX package folds the name into its
        key the same way).  On `device`: the card unless the caller asks
        for the CPU."""
        device = resolve_device(device)
        params: Params = {}
        for name in self.topology.order:
            conf = self.topology.layers[name]
            in_confs = [self.topology.layers[i] for i in conf.inputs]
            gen = torch.Generator().manual_seed(
                (int(seed) * 0x9E3779B1 + stable_hash(name)) & 0x7FFFFFFFFFFFFFFF
            )
            p = self._impls[name].init(conf, in_confs, gen, device)
            if p:
                params[name] = p
        return params

    def init_state(self, device=None) -> NetState:
        """Each stateful layer's initial state (batch norm: mean 0, var 1),
        on `device`: the card unless the caller asks for the CPU."""
        device = resolve_device(device)
        state: NetState = {}
        for name in self.topology.order:
            conf = self.topology.layers[name]
            impl = self._impls[name]
            if impl.init_state is not None:
                in_confs = [self.topology.layers[i] for i in conf.inputs]
                s = impl.init_state(conf, in_confs, device)
                if s:
                    state[name] = s
        return state

    def init(self, seed: int = 0, device=None) -> Tuple[Params, NetState]:
        return self.init_params(seed, device), self.init_state(device)

    def named_parameters(self) -> Dict[str, str]:
        """Global parameter table {declared name: dotted storage path}; empty
        while name-shared parameters are not ported."""
        return {}

    def resolve_layer_call(self, name: str, params: Params, ins):
        """(layer params, inputs) as the apply loop hands them to the impl:
        the mixed-precision casts included."""
        impl = self._impls[name]
        p = params.get(name, {})
        if self.compute_dtype != torch.float32:
            if impl.full_precision:
                ins = [_cast_floats(x, torch.float32) for x in ins]
            else:
                p = _cast_floats(p, self.compute_dtype)
                ins = [_cast_floats(x, self.compute_dtype) for x in ins]
        return p, ins

    # ------------------------------------------------------------------
    def apply(
        self, params: Params, batch: Batch, *, state: Optional[NetState] = None,
        train: bool = True,
    ) -> Tuple[Dict[str, SeqTensor], NetState]:
        """Run the whole graph; returns every layer's output by name and the
        updated state."""
        mixed = self.compute_dtype != torch.float32
        ctx = ApplyContext(train=train, state=state or {}, dtype=self.compute_dtype)
        for name in self.topology.order:
            conf = self.topology.layers[name]
            impl = self._impls[name]
            if conf.type == "data":
                if name not in batch:
                    raise KeyError(f"batch is missing data slot {name!r}")
                ctx.outputs[name] = _feed_transform(conf, batch[name])
                continue
            ins = [ctx.outputs[i] for i in conf.inputs]
            p, ins = self.resolve_layer_call(name, params, ins)
            try:
                out = impl.apply(conf, p, ins, ctx)
            except Exception as e:
                shapes = [tuple(t.data.shape) for t in ins]
                e.add_note(
                    f"error[T100] layer {name!r}: failed while applying this "
                    f"layer (type={conf.type}, size={conf.size}, inputs="
                    f"{list(conf.inputs)} with shapes {shapes})"
                )
                raise
            if mixed and not impl.full_precision:
                out = _cast_floats(out, self.compute_dtype)
            if impl.auto_activation and conf.act not in ("identity", "linear", ""):
                if conf.act == "softmax":
                    # pre-activation logits for a fused log-softmax cost
                    ctx.outputs[name + "@logits"] = out
                mask = out.mask() if (out.is_seq and conf.act == "sequence_softmax") else None
                out = out.with_data(apply_activation(conf.act, out.data, mask))
            if train and conf.drop_rate > 0.0:
                raise NotImplementedError(f"layer {name!r}: dropout is not ported yet")
            if train and conf.attr("error_clip"):
                raise NotImplementedError(f"layer {name!r}: error clipping is not ported yet")
            ctx.outputs[name] = out
        return ctx.outputs, {**ctx.state, **ctx.new_state}

    def forward(
        self, params: Params, batch: Batch, *, state: Optional[NetState] = None,
        train: bool = True,
    ) -> Tuple[SeqTensor, Dict[str, SeqTensor], NetState]:
        """The first declared output, the full output dict and the updated
        state."""
        outs, new_state = self.apply(params, batch, state=state, train=train)
        return outs[self.topology.output_names[0]], outs, new_state

    def cost(
        self, params: Params, batch: Batch, *, state: Optional[NetState] = None,
        train: bool = True,
    ) -> Tuple[torch.Tensor, Tuple[Dict[str, SeqTensor], NetState]]:
        """(scalar mean cost, (outputs, new state)): the mean of the first
        output, the quantity the train step differentiates."""
        out, outs, new_state = self.forward(params, batch, state=state, train=train)
        return out.data.mean(), (outs, new_state)
