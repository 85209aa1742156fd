"""Topology → forward function — the counterpart of
``paddle_tpu/core/compiler.py``.

:meth:`CompiledNetwork.apply` walks the topology in order and runs each
layer's torch impl eagerly (the JAX package traces the same loop under
``jax.jit``).  Master parameters stay float32; under a bfloat16 compute
dtype each layer that is not full-precision gets its parameters and inputs
cast to bf16 and its output cast back to bf16, exactly as in the JAX loop.
After the activation, training applies the layer's dropout (drawn from a
generator seeded by the step's ``rng`` and the layer's name) and its error
clipping (the backward clamps the output's gradient).

Parameters shared by name (``ParamAttr(name=...)``, whole-layer
``param_name`` or per-key ``param_names``, intra-layer duplicates included)
live once, at the first declarer in topology order; every later declarer
reads the owner's tensor, so autograd sums the gradients of every use.

:meth:`CompiledNetwork.cost` is the differentiable quantity of training
(the mean of the first output); the train step takes its gradient with
autograd.  Non-trainable layer state (batch norm's moving statistics) is
threaded functionally as in the JAX package: ``apply`` reads ``state`` and
returns ``{**state, **updates}``, leaving its inputs untouched.

Not ported yet: recurrent_group sub-topologies (these raise at build) and
dynamic widths (``resolve_dynamic_widths``; no layer of the port's DSL makes
them).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, DiagnosticError, Severity
from paddle_tpu_torch.core.batch import Batch, SeqTensor
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.layers.base import ApplyContext, get_layer_impl, mix_seed
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


class _ErrorClip(torch.autograd.Function):
    """Identity forward; the backward clamps the layer output's gradient to
    [-t, t] in its dtype (reference ExtraLayerAttribute
    .error_clipping_threshold; JAX ``_error_clip``)."""

    @staticmethod
    def forward(ctx, x, t):
        ctx.t = t
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-ctx.t, ctx.t), None


def error_clip(x: torch.Tensor, t: float) -> torch.Tensor:
    return _ErrorClip.apply(x, float(t))


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """Keep each value with probability 1 - rate and divide the kept ones by
    it (the JAX package's ``where(mask, x / keep, 0)``, in x's dtype)."""
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(keep, generator=gen)
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def _share_conflict_error(message: str, layer: str) -> DiagnosticError:
    """A parameter-sharing conflict as rule G006, the id the JAX package
    gives it."""
    return DiagnosticError(Diagnostic(
        rule="G006", severity=Severity.ERROR, layer=layer, message=message,
        hint="give the parameters distinct ParamAttr names, or align the "
        "declaring layers' shapes/forms",
    ))


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
            if conf.attr("_sub_topology") is not None:
                raise NotImplementedError(
                    f"layer {name!r}: recurrent_group sub-topologies are not ported yet"
                )
        # name-shared parameters: the first declarer in topology order owns
        # them.  _param_owner: whole-layer sharer -> owner layer;
        # _shared_keys: sharer -> {key: (owner layer, owner key)};
        # _named_params: declared name -> (owner layer, key or None)
        self._param_owner: Dict[str, str] = {}
        self._shared_keys: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self._named_params: Dict[str, Tuple[str, Optional[str]]] = {}
        owners: Dict[str, str] = {}
        key_owners: Dict[str, Tuple[str, str]] = {}
        for name in topology.order:
            conf = topology.layers[name]
            pmap = conf.attr("param_names") or {}
            pname = conf.attr("param_name")
            if pname and not pmap:
                if pname in key_owners:
                    ol, ok = key_owners[pname]
                    raise _share_conflict_error(
                        f"parameter name {pname!r} is declared whole-layer by {name!r} "
                        f"but per-key by {ol!r}.{ok!r}; sharing across the two forms "
                        "is not supported — use distinct names", name)
                if pname in owners:
                    self._param_owner[name] = owners[pname]
                else:
                    owners[pname] = name
                    self._named_params[pname] = (name, None)
            for key, gname in pmap.items():
                if not gname:
                    continue
                if gname in owners:
                    raise _share_conflict_error(
                        f"parameter name {gname!r} is declared per-key by {name!r}.{key!r} "
                        f"but whole-layer by {owners[gname]!r}; sharing across the two "
                        "layer kinds is not supported — use distinct names", name)
                if gname in key_owners:
                    self._shared_keys.setdefault(name, {})[key] = key_owners[gname]
                else:
                    key_owners[gname] = (name, key)
                    self._named_params[gname] = (name, key)

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
            gen = torch.Generator().manual_seed(mix_seed(seed, name))
            p = self._impls[name].init(conf, in_confs, gen, device)
            owner = self._param_owner.get(name)
            if owner is not None:
                # storage lives at the owner: the shapes must agree now, so a
                # name collision fails at build and not inside a matmul
                want = {k: tuple(v.shape) for k, v in p.items()}
                have = {k: tuple(v.shape) for k, v in params.get(owner, {}).items()}
                if want != have:
                    raise _share_conflict_error(
                        f"shares parameter {conf.attr('param_name')!r} with {owner!r} but "
                        f"expects shapes {want} != owner's {have}", name)
                continue
            for key, (ol, okey) in self._shared_keys.get(name, {}).items():
                src = p[okey] if ol == name else params[ol][okey]
                if p[key].shape != src.shape:
                    raise _share_conflict_error(
                        f"parameter {key!r} shares storage with {ol!r}.{okey!r} but "
                        f"expects shape {tuple(p[key].shape)} != owner's "
                        f"{tuple(src.shape)}", name)
                del p[key]
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

    def layer_params(self, params: Params, name: str) -> Dict[str, Any]:
        """This layer's param dict: the owner's for a whole-layer sharer, with
        each shared key grafted from its owner (a copy: the canonical tree
        is never mutated)."""
        p = params.get(self._param_owner.get(name, name), {})
        shared = self._shared_keys.get(name)
        if shared:
            p = dict(p)
            for key, (ol, okey) in shared.items():
                p[key] = p[okey] if ol == name else params[ol][okey]
        return p

    def named_parameters(self) -> Dict[str, str]:
        """Global parameter table: {declared parameter name: dotted storage
        path into the params tree}."""
        return {
            gname: top if key is None else f"{top}.{key}"
            for gname, (top, key) in self._named_params.items()
        }

    def materialize_shared(self, params: Params) -> Params:
        """Params with every shared key grafted back in place, per layer
        (for a sub-network compiled without this network's sharing maps)."""
        out: Params = {}
        for name in self.topology.order:
            p = self.layer_params(params, name)
            if p:
                out[name] = p
        return out

    def resolve_layer_call(self, name: str, params: Params, ins):
        """(layer params, inputs) as the apply loop hands them to the impl:
        the shared-parameter lookup and the mixed-precision casts included."""
        impl = self._impls[name]
        p = self.layer_params(params, name)
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
        train: bool = True, rng: Optional[int] = None,
    ) -> Tuple[Dict[str, SeqTensor], NetState]:
        """Run the whole graph; returns every layer's output by name and the
        updated state.  `rng` (the step's seed) enables dropout in
        training."""
        mixed = self.compute_dtype != torch.float32
        ctx = ApplyContext(train=train, rng=rng, state=state or {}, dtype=self.compute_dtype)
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
            if impl.auto_dropout and conf.drop_rate > 0.0 and train:
                gen = ctx.layer_rng(name + "/dropout", out.data.device)
                if gen is not None:
                    out = out.with_data(dropout(out.data, conf.drop_rate, gen))
            eclip = conf.attr("error_clip", 0.0)
            if eclip and train:
                out = out.with_data(error_clip(out.data, eclip))
            ctx.outputs[name] = out
        return ctx.outputs, {**ctx.state, **ctx.new_state}

    def forward(
        self, params: Params, batch: Batch, *, state: Optional[NetState] = None,
        train: bool = True, rng: Optional[int] = None,
    ) -> Tuple[SeqTensor, Dict[str, SeqTensor], NetState]:
        """The first declared output, the full output dict and the updated
        state."""
        outs, new_state = self.apply(params, batch, state=state, train=train, rng=rng)
        return outs[self.topology.output_names[0]], outs, new_state

    def cost(
        self, params: Params, batch: Batch, *, state: Optional[NetState] = None,
        train: bool = True, rng: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Tuple[Dict[str, SeqTensor], NetState]]:
        """(scalar mean cost, (outputs, new state)): the mean of the first
        output, the quantity the train step differentiates."""
        out, outs, new_state = self.forward(params, batch, state=state, train=train, rng=rng)
        return out.data.mean(), (outs, new_state)
