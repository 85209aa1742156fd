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
live once, at the first declarer in topology order, recurrent-group
sub-topologies included; every later declarer reads the owner's tensor, so
autograd sums the gradients of every use.

A recurrent group's sub-network (``layers/recurrent_group.py``) is compiled
once, when this network is built: a layer impl with a ``build`` hook gets its
plan made here and finds it in ``ApplyContext.plans`` at every call.

:meth:`CompiledNetwork.cost` is the differentiable quantity of training
(the mean of the first output); the train step takes its gradient with
autograd.  Non-trainable layer state (batch norm's moving statistics) is
threaded functionally as in the JAX package: ``apply`` reads ``state`` and
returns ``{**state, **updates}``, leaving its inputs untouched.

Not ported yet: dynamic widths (``resolve_dynamic_widths``; no layer of the
port's DSL makes them) and layers sharded over a device mesh (a layer with
a ``shard_axis`` raises when the network is built).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, DiagnosticError, Severity
from paddle_tpu_torch.core.batch import Batch, SeqTensor, batch_shape_key
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.layers.base import ApplyContext, get_layer_impl, mix_seed
from paddle_tpu_torch.ops.activations import apply_activation
from paddle_tpu_torch.utils.profiler import active_trap
from paddle_tpu_torch.utils.tree import get_path, leaves, map_leaves

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


def _mixed_forms_error(key_owners, g, path, decl) -> DiagnosticError:
    """Mixed whole-layer/per-key declaration of one global parameter name."""
    ol, ok, owhole = key_owners[g]
    kind = "whole-layer inside a recurrent_group" if owhole else "per-key"
    return _share_conflict_error(
        f"parameter name {g!r} is declared {decl} by {'.'.join(path)!r} but "
        f"{kind} by {ol!r}.{'.'.join(ok)!r}; sharing across the two forms "
        "is not supported — use distinct names", ".".join(path))


def _walk_layers(topology, prefix=()):
    """(path, conf) over a topology and its recurrent-group sub-topologies
    (path = (top layer, inner..., layer)): named parameters share storage
    wherever they live."""
    for name in topology.order:
        conf = topology.layers[name]
        yield prefix + (name,), conf
        sub = conf.attrs.get("_sub_topology")
        if sub is not None:
            yield from _walk_layers(sub, prefix + (name,))


def _graft(d, path, v) -> None:
    """d[path] = v, copying every intermediate dict (the caller has copied
    `d`), so grafting a shared value never mutates the canonical tree."""
    for k in path[:-1]:
        d[k] = dict(d.get(k, {}))
        d = d[k]
    d[path[-1]] = v


def _del_path(d, path) -> None:
    """Delete d[path], pruning the dicts the deletion empties."""
    stack = []
    for k in path[:-1]:
        stack.append((d, k))
        d = d[k]
    del d[path[-1]]
    for parent, k in reversed(stack):
        if not parent[k]:
            del parent[k]


def _shapes(tree):
    return map_leaves(lambda v: tuple(v.shape), tree) if isinstance(tree, dict) else tuple(tree.shape)


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


class CompileShapeCache:
    """Dispatch accounting per batch shape — the counterpart of the JAX
    package's ``CompileShapeCache``, which mirrors jit's executable cache.
    The port runs eagerly and compiles nothing per shape, but the same
    counters say what a variable-length feed does: every observed batch
    counts a hit or a miss (``<name>/compile_hit`` / ``compile_miss`` in
    ``utils.timers.global_stats``) by its shape signature
    (``core.batch.batch_shape_key``), and ``n_shapes`` holds the shape-
    ladder contract (a laddered feed realises one shape per rung
    combination, never one per batch)."""

    def __init__(self, name: str = "train_step", stats=None):
        from paddle_tpu_torch.utils.timers import global_stats

        self.name = name
        self._stats = stats if stats is not None else global_stats
        self.shapes: Dict[tuple, int] = {}  # shape key -> dispatch count

    def observe(self, batch: Batch) -> bool:
        """Record one dispatch; True when its shape is new."""
        key = batch_shape_key(batch)
        miss = key not in self.shapes
        self.shapes[key] = self.shapes.get(key, 0) + 1
        self._stats.incr(f"{self.name}/compile_{'miss' if miss else 'hit'}")
        return miss

    @property
    def n_shapes(self) -> int:
        return len(self.shapes)

    @property
    def misses(self) -> int:
        # every distinct shape missed exactly once
        return self.n_shapes

    @property
    def hits(self) -> int:
        return sum(self.shapes.values()) - len(self.shapes)

    def summary(self) -> Dict[str, int]:
        return {"shapes": self.n_shapes, "hits": self.hits, "misses": self.misses}


class CompiledNetwork:
    """init/apply view over a Topology."""

    def __init__(self, topology: Topology, dtype=torch.float32, compute_dtype=None):
        self.topology = topology
        self.dtype = as_dtype(dtype)
        if compute_dtype is None:
            compute_dtype = _default_compute_dtype or self.dtype
        self.compute_dtype = as_dtype(compute_dtype)
        # a moe layer's shard_axis only places its experts on a mesh (the
        # JAX package runs it unsharded without one): it runs here on one
        # device; any other layer sharded over a mesh is not ported
        sharded = [(n, c.shard_axis) for n, c in topology.layers.items()
                   if c.shard_axis and c.type != "moe"]
        if sharded:
            raise NotImplementedError(
                f"layer {sharded[0][0]!r}: shard_axis={sharded[0][1]!r} (a layer sharded over a "
                "device mesh) is not ported yet")
        # resolve impls now, so a type the port lacks fails at build
        self._impls = {
            name: get_layer_impl(conf.type) for name, conf in topology.layers.items()
        }
        # per-layer plans made once (a recurrent group's compiled sub-network)
        self._plans = {
            name: impl.build(topology.layers[name], self.compute_dtype)
            for name, impl in self._impls.items() if impl.build is not None
        }
        # name-shared parameters: the first declarer in topology order owns
        # them, recurrent-group sub-topologies included.  _param_owner:
        # whole-layer sharer -> owner layer; _shared_keys: sharer top layer ->
        # {relpath: (owner top layer, owner relpath)}, a relpath being the
        # keys into the layer's param subtree (longer inside a group);
        # _named_params: declared name -> (owner top layer, relpath).
        # Sharing within one group's subtree is its sub-network's own.
        self._param_owner: Dict[str, str] = {}
        self._shared_keys: Dict[str, Dict[tuple, tuple]] = {}
        self._named_params: Dict[str, tuple] = {}
        owners: Dict[str, str] = {}
        key_owners: Dict[str, tuple] = {}
        inner_seen: set = set()  # (global name, top layer) with an inner declaration
        for path, conf in _walk_layers(topology):
            name, rel = path[0], tuple(path[1:])
            pmap = conf.attr("param_names") or {}
            pname = conf.attr("param_name")
            if pname and not pmap:
                if not rel:
                    if pname in key_owners:
                        raise _mixed_forms_error(key_owners, pname, path, "whole-layer")
                    if pname in owners:
                        self._param_owner[name] = owners[pname]
                    else:
                        owners[pname] = name
                        self._named_params[pname] = (name, ())
                else:
                    # a one-parameter layer inside a group: share its whole
                    # inner dict at `rel`
                    if pname in owners:
                        raise _share_conflict_error(
                            f"parameter name {pname!r} is declared whole-layer both at top "
                            f"level ({owners[pname]!r}) and inside a recurrent_group "
                            f"({'.'.join(path)!r}); use distinct names", ".".join(path))
                    if pname in key_owners and not key_owners[pname][2]:
                        raise _mixed_forms_error(
                            key_owners, pname, path, "whole-layer inside a recurrent_group")
                    owner = self._inner_key_owner(
                        key_owners, inner_seen, pname, name, rel, inner=True, whole=True)
                    if owner is not None:
                        self._shared_keys.setdefault(name, {})[rel] = owner
                    else:
                        self._named_params.setdefault(pname, (name, rel))
            for key, gname in pmap.items():
                if not gname:
                    continue
                if gname in owners:
                    raise _share_conflict_error(
                        f"parameter name {gname!r} is declared per-key by "
                        f"{'.'.join(path)!r}.{key!r} but whole-layer by {owners[gname]!r}; "
                        "sharing across the two layer kinds is not supported — use "
                        "distinct names", ".".join(path))
                if gname in key_owners and key_owners[gname][2]:
                    raise _mixed_forms_error(key_owners, gname, path, "per-key")
                kp = rel + (key,)
                owner = self._inner_key_owner(
                    key_owners, inner_seen, gname, name, kp, inner=bool(rel), whole=False)
                if owner is not None:
                    self._shared_keys.setdefault(name, {})[kp] = owner
                else:
                    self._named_params.setdefault(gname, (name, kp))

    @staticmethod
    def _inner_key_owner(key_owners, inner_seen, gname, top, relpath, inner, whole):
        """The first declarer of `gname` owns it; a later declarer gets the
        owner's address back, except a second declaration inside the same
        top layer's subtree, which that group's sub-network chains to the
        subtree's first declarer (None avoids handling it twice)."""
        if inner:
            if (gname, top) in inner_seen:
                return None
            inner_seen.add((gname, top))
        if gname not in key_owners:
            key_owners[gname] = (top, relpath, whole)
            return None
        otop, orel, _ = key_owners[gname]
        return (otop, orel)

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
                want, have = _shapes(p), _shapes(params.get(owner, {}))
                if want != have:
                    raise _share_conflict_error(
                        f"shares parameter {conf.attr('param_name')!r} with {owner!r} but "
                        f"expects shapes {want} != owner's {have}", name)
                continue
            for relpath, (ol, orel) in self._shared_keys.get(name, {}).items():
                src = get_path(p if ol == name else params[ol], orel)
                mine = get_path(p, relpath)
                if _shapes(mine) != _shapes(src):
                    raise _share_conflict_error(
                        f"parameter {'.'.join(relpath)!r} shares storage with "
                        f"{ol!r}.{'.'.join(orel)!r} but expects shapes {_shapes(mine)} != "
                        f"owner's {_shapes(src)}", name)
                _del_path(p, relpath)
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
        each shared key grafted from its owner (copy-on-write: the canonical
        tree is never mutated)."""
        p = params.get(self._param_owner.get(name, name), {})
        shared = self._shared_keys.get(name)
        if shared:
            p = dict(p)
            for relpath, (ol, orel) in shared.items():
                _graft(p, relpath, get_path(p if ol == name else params[ol], orel))
        return p

    def named_parameters(self) -> Dict[str, str]:
        """Global parameter table: {declared parameter name: dotted storage
        path into the params tree}."""
        return {
            gname: ".".join((top,) + tuple(rel))
            for gname, (top, rel) in self._named_params.items()
        }

    def adopt_named(self, params: Params, source: "CompiledNetwork") -> Params:
        """`params` of the network `source` with every parameter shared by
        name also stored where this network's owner of that name reads it:
        an inference topology holding only ``crf_decoding`` owns ``crfw`` at
        the decoding layer, the training topology at the ``crf`` layer.  The
        input tree is not mutated."""
        out = dict(params)
        src = source._named_params
        for gname, (top, rel) in self._named_params.items():
            if gname not in src or src[gname] == (top, rel):
                continue
            stop, srel = src[gname]
            if stop not in params:
                continue
            value = get_path(params[stop], srel) if srel else params[stop]
            if rel:
                _graft(out, (top,) + tuple(rel), value)
            else:
                out[top] = value
        return out

    def materialize_shared(self, params: Params) -> Params:
        """Params with every shared key grafted back in place, per layer
        (for a sub-network compiled without this network's sharing maps)."""
        out: Params = {}
        for name in self.topology.order:
            p = self.layer_params(params, name)
            if p:
                out[name] = p
        return out

    def make_context(self, *, train: bool, rng: Optional[int] = None,
                     state: Optional[NetState] = None) -> ApplyContext:
        """The ApplyContext exactly as apply() builds it (utils.debug times
        each layer under the same one)."""
        return ApplyContext(train=train, rng=rng, state=state or {}, dtype=self.compute_dtype,
                            plans=self._plans)

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
        train: bool = True, rng: Optional[int] = None, only: Optional[set] = None,
        preset: Optional[Dict[str, SeqTensor]] = None,
    ) -> Tuple[Dict[str, SeqTensor], NetState]:
        """Run the whole graph; returns every layer's output by name and the
        updated state.  `rng` (the step's seed) enables dropout in
        training.  `only` restricts the run to the named layers, `preset`
        seeds layer outputs (a recurrent group runs its step, its hoisted
        prologue and its hoisted epilogue through these)."""
        mixed = self.compute_dtype != torch.float32
        ctx = self.make_context(train=train, rng=rng, state=state)
        if preset:
            ctx.outputs.update(preset)
        # the armed NaN trap names the layer it finds a NaN in
        trap = active_trap()
        outer_layer = trap.forward_layer if trap is not None else None
        for name in self.topology.order:
            if (preset and name in preset) or (only is not None and name not in only):
                continue
            conf = self.topology.layers[name]
            impl = self._impls[name]
            if conf.type in ("data", "step_input", "memory"):
                # data: the user's slots; step_input / memory: placeholders
                # an enclosing recurrent group feeds per step
                if name not in batch:
                    raise KeyError(f"batch is missing data slot {name!r}")
                ctx.outputs[name] = _feed_transform(conf, batch[name])
                continue
            ins = [ctx.outputs[i] for i in conf.inputs]
            n_before = len(ctx.outputs)
            p, ins = self.resolve_layer_call(name, params, ins)
            if trap is not None:
                trap.forward_layer = name
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
                # side outputs the layer left in ctx.outputs (a group's
                # "<name>@logits"; the dict keeps insertion order) get the
                # compute dtype too
                if len(ctx.outputs) > n_before:
                    for k in list(ctx.outputs)[n_before:]:
                        ctx.outputs[k] = _cast_floats(ctx.outputs[k], self.compute_dtype)
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
            if trap is not None and out.data.requires_grad:
                out.data.register_hook(trap.backward_hook(name))
        if trap is not None:
            trap.forward_layer = outer_layer
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


def count_params(params: Params) -> int:
    """The number of elements over every leaf of a parameter tree."""
    return sum(v.numel() for v in leaves(params))
