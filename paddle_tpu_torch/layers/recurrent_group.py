"""recurrent_group — the counterpart of ``paddle_tpu/layers/recurrent_group.py``
(the reference's RecurrentGradientMachine: a user step function of ordinary
layers runs per timestep; ``memory(name=X)`` reads layer X's output of the
previous step; sequence inputs are scanned; ``StaticInput`` values are seen
whole by every step).

The step function is traced once, when the DSL builds the group, into a
sub-topology.  The sub-network is compiled once, with the enclosing network
(the ``build`` hook: :class:`GroupPlan`), not per call.  At apply time it runs
as the body of a Python loop over the padded time axis; memories are carries
with carry-through masking of padding, and autograd takes the gradient
through the loop.  Around the loop:

* prologue hoisting: rowwise layers fed only by scanned or static inputs
  run once on the time-flattened inputs;
* epilogue hoisting: the rowwise suffix no memory depends on (the NMT
  decoder's vocab projection) runs once on the stacked [T*B] rows, and its
  softmax's pre-activation is exposed as ``<group>@logits``, so the cost
  takes the fused log-softmax path;
* the fused attention-GRU lowering: a step that matches the v1 attention
  decoder (``layers/attention.py`` ``match_attention_gru_step``) runs on
  ``ops/rnn.py``'s ``attention_gru_scan`` instead of the generic loop (the
  ``fused_attention_gru`` flag), with the target-side input projection
  outside the loop;
* early exit (``scan_early_exit``): the loop runs only the steps at which
  some row is live, a range read from the host copy of the lengths.

``counters`` counts the runs of each path and the steps the generic loop
ran and skipped.

Not ported yet: ``SubsequenceInput`` (nested input) and sequence-valued
memories (``memory(is_seq=True)``); both raise ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Optional, Sequence, Union

import torch

from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.core.topology import LayerConf, LayerOutput, Topology, auto_name
from paddle_tpu_torch.layers.base import (
    ApplyContext, get_layer_impl, mix_seed, register_layer)
from paddle_tpu_torch.ops.rnn import attention_gru_scan, live_range
from paddle_tpu_torch.utils.flags import get_flag

# runs of each lowering ("fused", "generic") and the generic loop's steps
# ("steps", "skipped"), since the last clear()
counters: collections.Counter = collections.Counter()


class StaticInput:
    """Marks an outer layer as seen whole by every step instead of scanned
    (reference StaticInput).  `size` is checked against the input's."""

    def __init__(self, input: LayerOutput, is_seq: bool = False, size: int = 0):
        self.input = input
        self.is_seq = is_seq
        if size and size != input.size:
            raise ValueError(f"StaticInput size {size} != input layer size {input.size}")


class SubsequenceInput:
    """A nested outer layer whose subsequences are the scan unit (reference
    SubsequenceInput).  Not ported yet: a group given one raises."""

    def __init__(self, input: LayerOutput):
        self.input = input


class _GroupBuild:
    """Build-time state of a step-function trace: its memory placeholders
    and their outer boot layers."""

    def __init__(self) -> None:
        self.memories: List[LayerConf] = []
        self.boot_layers: Dict[str, LayerOutput] = {}


_current_build: Optional[_GroupBuild] = None


@contextlib.contextmanager
def _group_build():
    global _current_build
    prev = _current_build
    _current_build = _GroupBuild()
    try:
        yield _current_build
    finally:
        _current_build = prev


class _MemoryOutput(LayerOutput):
    """memory() handle with the reference's deferred link:
    ``m = memory(name=None, size=...); ...; m.set_input(layer)``."""

    def set_input(self, layer: LayerOutput) -> None:
        self.conf.attrs["link"] = layer.name


def memory(
    name: Optional[str],
    size: int,
    boot_layer: Optional[LayerOutput] = None,
    boot_with_const_id: Optional[int] = None,
    is_seq: bool = False,
    memory_name: Optional[str] = None,
) -> LayerOutput:
    """The previous step's output of the in-group layer called `name`
    (reference memory()); `boot_layer` gives the first step's value ([B,
    size]), else it is zeros.  name=None defers the link to
    ``.set_input(layer)``."""
    if _current_build is None:
        raise RuntimeError("memory() must be called inside a recurrent_group step")
    conf_name = auto_name(f"memory_{name or memory_name or 'deferred'}")
    if is_seq:
        raise NotImplementedError(
            f"memory {conf_name!r}: sequence-valued memories (is_seq=True) are not ported yet")
    conf = LayerConf(
        name=conf_name,
        type="memory",
        size=size,
        bias=False,
        attrs={
            "link": name,
            "boot": boot_layer.name if boot_layer is not None else None,
            "boot_const_id": boot_with_const_id,
        },
    )
    _current_build.memories.append(conf)
    if boot_layer is not None:
        _current_build.boot_layers[conf.name] = boot_layer
    return _MemoryOutput(conf)


@register_layer("memory")
def memory_apply(conf, params, inputs, ctx):  # pragma: no cover - fed by the loop
    raise RuntimeError("memory placeholders are fed by the recurrent_group loop")


@register_layer("step_input")
def step_input_apply(conf, params, inputs, ctx):  # pragma: no cover - fed by the loop
    raise RuntimeError("step inputs are fed by the recurrent_group loop")


def recurrent_group(
    step,
    input: Union[LayerOutput, StaticInput, Sequence[Union[LayerOutput, StaticInput]]],
    reverse: bool = False,
    name: Optional[str] = None,
) -> LayerOutput:
    """Run `step` over the time axis of the sequence inputs; returns the
    step's (first) output as a sequence layer."""
    ins = input if isinstance(input, (list, tuple)) else [input]
    gname = name or auto_name("recurrent_group")
    scanned: List[LayerOutput] = []
    statics: List[StaticInput] = []
    for i in ins:
        if isinstance(i, SubsequenceInput):
            raise NotImplementedError(
                f"recurrent_group {gname!r}: SubsequenceInput (nested input) is not ported yet")
        if isinstance(i, StaticInput):
            statics.append(i)
        else:
            scanned.append(i)
    if not scanned:
        raise ValueError("recurrent_group needs at least one sequence input to scan")
    step_args, scan_placeholders, static_placeholders = _make_placeholders(
        gname, scanned, statics)
    with _trace_capture() as (gb, created):
        out = step(*step_args)
    step_outputs = list(out) if isinstance(out, (list, tuple)) else [out]
    return _finalize_group(gname, scanned, statics, scan_placeholders, static_placeholders,
                           gb, created, step_outputs, reverse)


@contextlib.contextmanager
def _trace_capture():
    """Opens a _GroupBuild for memory declarations and captures every
    LayerOutput built inside (chaining an outer layer sink), restoring both
    on exit, the error path included."""
    from paddle_tpu_torch.core.topology import set_layer_sink

    created: Dict[str, LayerOutput] = {}

    def _capture(lo: LayerOutput) -> None:
        created[lo.conf.name] = lo
        if prev_sink is not None:
            prev_sink(lo)

    with _group_build() as gb:
        prev_sink = set_layer_sink(_capture)
        try:
            yield gb, created
        finally:
            set_layer_sink(prev_sink)


def _make_placeholders(gname, scanned, statics):
    """The scanned and static step-input placeholders of a group."""
    step_args: List[LayerOutput] = []
    scan_placeholders: List[LayerConf] = []
    static_placeholders: List[LayerConf] = []
    for k, lo in enumerate(scanned):
        conf = LayerConf(name=f"{gname}@in{k}", type="step_input", size=lo.size, bias=False,
                         attrs={"step_seq": False})
        scan_placeholders.append(conf)
        step_args.append(LayerOutput(conf))
    for k, st in enumerate(statics):
        conf = LayerConf(name=f"{gname}@static{k}", type="step_input", size=st.input.size,
                         bias=False, attrs={"static_seq": st.is_seq})
        static_placeholders.append(conf)
        step_args.append(LayerOutput(conf))
    return step_args, scan_placeholders, static_placeholders


def _finalize_group(gname, scanned, statics, scan_placeholders, static_placeholders, gb,
                    created, step_outputs, reverse) -> LayerOutput:
    """The recurrent_group LayerConf of a traced step body."""
    unset = [m.name for m in gb.memories if m.attrs["link"] is None]
    if unset:
        raise ValueError(
            f"memories {unset} in recurrent_group {gname!r} have no link: pass name= or "
            "call .set_input(layer) inside the step")
    # a memory may link a layer off the path to the step output: it joins
    # the sub-topology as an extra root
    sub_topo = Topology(list(step_outputs))
    link_bases = list(dict.fromkeys(m.attrs["link"].split("@")[0] for m in gb.memories))
    extra_roots = [created[b] for b in link_bases if b not in sub_topo.layers and b in created]
    if extra_roots:
        sub_topo = Topology(list(step_outputs) + extra_roots)
    missing = [m.attrs["link"] for m in gb.memories
               if m.attrs["link"].split("@")[0] not in sub_topo.layers]
    if missing:
        raise ValueError(
            f"memory links {missing} not found in recurrent_group {gname!r} step outputs' graph")
    # boot layers are outer layers: group parents, so their values exist
    outer_inputs = list(scanned) + [s.input for s in statics] + list(gb.boot_layers.values())
    conf = LayerConf(
        name=gname,
        type="recurrent_group",
        size=step_outputs[0].size,
        inputs=tuple(o.name for o in outer_inputs),
        bias=False,
        attrs={
            "_sub_topology": sub_topo,
            "_memories": tuple(gb.memories),
            "_scan_placeholders": tuple(c.name for c in scan_placeholders),
            "_sub_scanned": (False,) * len(scanned),
            "_static_placeholders": tuple(
                (c.name, c.attrs.get("static_seq", False)) for c in static_placeholders),
            "_output": step_outputs[0].name,
            "n_scanned": len(scanned),
            "reverse": reverse,
        },
    )
    return LayerOutput(conf, outer_inputs)


# ---------------------------------------------------------------------------
# the plan, made once per compiled network
# ---------------------------------------------------------------------------

# layer types whose rows are independent (time can fold into batch)
_HOIST_ROWWISE = frozenset({"fc", "addto", "slope_intercept", "mixed", "embedding"})


def _producer_resolver(layers):
    """Map an input reference to its producing layer: "layer@side" keys
    resolve to the layer, but only when it names one (the placeholders
    "group@in0" contain '@' too)."""

    def producer(i):
        if i in layers:
            return i
        b = i.split("@")[0]
        return b if b in layers else i

    return producer


def _hoist_eligible(c, impl):
    return (
        c.type in _HOIST_ROWWISE
        and c.drop_rate == 0.0
        and impl.init_state is None
        and c.act != "sequence_softmax"
        and not c.attr("error_clip", 0.0)
    )


def _split_prologue(sub_topo, scan_names, static_info, epilogue):
    """Rowwise layers whose inputs are only scanned or non-sequence static
    placeholders (never a memory): the same at every step offset, so they
    run once on the time-flattened inputs before the loop."""
    layers = sub_topo.layers
    producer = _producer_resolver(layers)
    scanned = set(scan_names)
    static_ok = {p for (p, is_seq) in static_info if not is_seq}
    prologue = set()
    for name in sub_topo.order:
        c = layers[name]
        if c.type in ("data", "step_input", "memory") or name in epilogue:
            continue
        if not _hoist_eligible(c, get_layer_impl(c.type)):
            continue
        deps = [producer(i) for i in c.inputs]
        if not all(d in scanned or d in static_ok or d in prologue for d in deps):
            continue
        if not any(d in scanned or d in prologue for d in deps):
            continue  # step-invariant: nothing to batch over
        prologue.add(name)
    return prologue


# layer types whose output is a [B, D] row when every input is one, and the
# sequence reducers, whose output is a row
_ROW_PRESERVING = _HOIST_ROWWISE | {"concat", "scaling", "gru_step", "layer_norm"}
_ROW_REDUCERS = frozenset({"seqpool", "seqlastins"})


def _step_shapes(sub_topo, static_seq) -> Dict[str, Optional[str]]:
    """What each step value is, read from the step's layer types (the JAX
    package asks ``jax.eval_shape`` at every call): "row" for a plain [B, D]
    row, "seq" for a sequence (an expand over a static sequence, and what
    is computed from one), None where the type does not tell."""
    layers = sub_topo.layers
    producer = _producer_resolver(layers)
    shape: Dict[str, Optional[str]] = {}
    for name in sub_topo.order:
        c = layers[name]
        ins = [shape.get(producer(i)) for i in c.inputs]
        if c.type in ("memory", "step_input"):
            shape[name] = "seq" if name in static_seq else "row"
        elif c.type in _ROW_REDUCERS:
            shape[name] = "row"
        elif c.type == "expand" or "seq" in ins:
            shape[name] = "seq"
        elif c.type in _ROW_PRESERVING and all(x == "row" for x in ins):
            shape[name] = "row"
        else:
            shape[name] = None
    return shape


def _split_epilogue(sub_topo, memories, out_name, static_seq):
    """(epilogue, frontier): the maximal rowwise, stateless, dropout-free
    suffix reaching `out_name` that no memory link depends on, and every
    non-epilogue name it reads (the loop emits exactly these).  (None,
    (out_name,)) when nothing hoists."""
    layers = sub_topo.layers
    producer = _producer_resolver(layers)
    loop_needed = set()
    stack = [producer(m.attrs["link"]) for m in memories]
    while stack:
        n = stack.pop()
        if n in loop_needed:
            continue
        loop_needed.add(n)
        if n in layers:
            stack.extend(producer(i) for i in layers[n].inputs)
    consumers: Dict[str, set] = {}
    for n in sub_topo.order:
        for i in layers[n].inputs:
            consumers.setdefault(producer(i), set()).add(n)
    epilogue = set()
    for name in reversed(sub_topo.order):
        cons = consumers.get(name, set())
        if not (name == out_name or cons) or name in loop_needed:
            continue
        if not all(c in epilogue for c in cons):
            continue  # a consumer stays in the loop: so does this layer
        c = layers[name]
        if c.type in ("data", "step_input", "memory"):
            continue
        if not _hoist_eligible(c, get_layer_impl(c.type)):
            loop_needed.add(name)
            continue
        epilogue.add(name)
    if out_name not in epilogue:
        return None, (out_name,)
    order_ix = {n: i for i, n in enumerate(sub_topo.order)}
    frontier = []
    for e in sorted(epilogue, key=order_ix.__getitem__):
        for i in layers[e].inputs:
            if producer(i) not in epilogue and i not in frontier:
                if i in static_seq:
                    return None, (out_name,)  # a sequence-valued static is no row
                frontier.append(i)
    return epilogue, tuple(frontier)


class GroupPlan:
    """What a recurrent group compiles once: its sub-network (at the
    enclosing network's compute dtype), the hoisted prologue and epilogue,
    and the fused attention-GRU match."""

    def __init__(self, conf: LayerConf, compute_dtype):
        from paddle_tpu_torch.core.compiler import CompiledNetwork
        from paddle_tpu_torch.layers.attention import match_attention_gru_step

        a = conf.attrs
        if any(a.get("_sub_scanned", ())):
            raise NotImplementedError(
                f"recurrent_group {conf.name!r}: SubsequenceInput is not ported yet")
        self.memories: Sequence[LayerConf] = a["_memories"]
        for m in self.memories:
            if m.attrs.get("is_seq"):
                raise NotImplementedError(
                    f"recurrent_group {conf.name!r}: sequence-valued memory {m.name!r} is "
                    "not ported yet")
        self.sub_topo: Topology = a["_sub_topology"]
        self.subnet = CompiledNetwork(self.sub_topo, compute_dtype=compute_dtype)
        self.scan_names: Sequence[str] = a["_scan_placeholders"]
        self.static_info = a["_static_placeholders"]
        self.static_names = {p for (p, _s) in self.static_info}
        self.out_name: str = a["_output"]
        self.reverse: bool = a["reverse"]
        self.producer = _producer_resolver(self.sub_topo.layers)
        static_seq = {p for (p, is_seq) in self.static_info if is_seq}
        shape = _step_shapes(self.sub_topo, static_seq)
        if shape.get(self.producer(self.out_name)) == "seq":
            raise NotImplementedError(
                f"recurrent_group {conf.name!r}: a step that emits a sequence (nested "
                "output) is not ported yet")
        self.epilogue, self.frontier = _split_epilogue(
            self.sub_topo, self.memories, self.out_name, static_seq)
        # the epilogue folds time into the rows of each value the loop
        # emits: every one must be a plain [B, D] row
        if self.epilogue is not None and not all(
                shape.get(self.producer(n)) == "row" for n in self.frontier):
            self.epilogue, self.frontier = None, (self.out_name,)
        epi = self.epilogue or set()
        self.prologue = _split_prologue(self.sub_topo, self.scan_names, self.static_info, epi)
        self.body_only = set(self.sub_topo.order) - epi - self.prologue
        self.loop_only = None if self.epilogue is None and not self.prologue else self.body_only
        self.frontier_scan = tuple(
            n for n in self.frontier
            if self.epilogue is None or (
                n not in self.static_names and n not in self.scan_names
                and self.producer(n) not in self.prologue))
        self.match = None
        if len(self.memories) == 1:
            self.match = match_attention_gru_step(
                self.sub_topo.layers, self.memories[0], set(self.scan_names), static_seq)

    def fusable(self) -> bool:
        """The matched attention-GRU step IS the whole loop: the loop emits
        only the GRU state and runs no layer outside the pattern."""
        mt = self.match
        if mt is None or tuple(self.frontier_scan) != (mt.gru,):
            return False
        loop_layers = {
            n for n in self.body_only
            if self.sub_topo.layers[n].type not in ("data", "step_input", "memory")}
        return loop_layers == set(mt.matched)


def _rg_init(conf, in_confs, gen, device):
    from paddle_tpu_torch.core.compiler import CompiledNetwork

    seed = int(torch.randint(0, 2**62, (1,), generator=gen))
    return CompiledNetwork(conf.attrs["_sub_topology"]).init_params(seed, device)


def _rg_init_state(conf, in_confs, device):
    from paddle_tpu_torch.core.compiler import CompiledNetwork

    return CompiledNetwork(conf.attrs["_sub_topology"]).init_state(device)


def _tile_rows(d: torch.Tensor, t: int) -> torch.Tensor:
    """A step-invariant [B, ...] value as the time-flattened [t*B, ...]
    rows of the hoisted prologue or epilogue."""
    return d[None].expand((t,) + tuple(d.shape)).reshape((t * d.shape[0],) + tuple(d.shape[1:]))


def mask_like(ys: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, T] validity mask shaped to broadcast against ys's rank."""
    t = torch.arange(ys.shape[1], device=ys.device)
    m = (t[None, :] < lengths[:, None]).to(ys.dtype)
    return m.reshape(tuple(m.shape) + (1,) * (ys.dim() - 2))


def _flat(d: torch.Tensor) -> torch.Tensor:
    """[T, B, ...] -> [T*B, ...]."""
    return d.reshape((d.shape[0] * d.shape[1],) + tuple(d.shape[2:]))


@register_layer("recurrent_group", init=_rg_init, init_state=_rg_init_state,
                auto_activation=False, build=GroupPlan)
def recurrent_group_apply(conf, params, inputs, ctx: ApplyContext) -> SeqTensor:
    plan: GroupPlan = ctx.plans[conf.name]
    subnet = plan.subnet
    memories, scan_names, static_info = plan.memories, plan.scan_names, plan.static_info
    n_scan = len(scan_names)
    scanned = inputs[:n_scan]
    statics = inputs[n_scan:n_scan + len(static_info)]  # the rest are boot layers
    lengths = scanned[0].lengths
    if lengths is None:
        raise ValueError(f"{conf.name}: recurrent_group inputs must be sequences")
    t_max, b = scanned[0].max_len, scanned[0].data.shape[0]
    reverse = plan.reverse

    xs = []  # time-major scanned inputs, flipped for a reverse group
    for s_in in scanned:
        if s_in.is_nested:
            raise NotImplementedError(f"{conf.name}: nested scanned inputs are not ported yet")
        x = s_in.data.transpose(0, 1)
        xs.append(x.flip(0) if reverse else x)
    static_batch = {
        pname: (st if is_seq else SeqTensor(st.data))
        for (pname, is_seq), st in zip(static_info, statics)
    }
    sub_state0 = ctx.state.get(conf.name, {})

    init_carry = {}
    for m in memories:
        boot, boot_const = m.attrs.get("boot"), m.attrs.get("boot_const_id")
        if boot is not None:
            init_carry[m.name] = ctx.outputs[boot].data
        elif boot_const is not None:
            init_carry[m.name] = torch.full((b, m.size), boot_const, dtype=scanned[0].data.dtype,
                                            device=scanned[0].data.device)
        else:
            init_carry[m.name] = torch.zeros((b, m.size), dtype=ctx.dtype,
                                             device=scanned[0].data.device)

    def step_batch(t: int, carry) -> Dict[str, SeqTensor]:
        sub_batch = dict(static_batch)
        for pname, x in zip(scan_names, xs):
            sub_batch[pname] = SeqTensor(x[t])
        for m in memories:
            sub_batch[m.name] = SeqTensor(carry[m.name])
        return sub_batch

    prologue, frontier, frontier_scan = plan.prologue, plan.frontier, plan.frontier_scan

    pro_outs, pro_sliced = {}, ()
    if prologue:
        pre_preset = {pname: SeqTensor(_flat(x)) for pname, x in zip(scan_names, xs)}
        for pname, is_seq in static_info:
            if not is_seq:
                pre_preset[pname] = SeqTensor(_tile_rows(static_batch[pname].data, t_max))
        pro_outs, _ = subnet.apply(params, {}, state=sub_state0, train=ctx.train, rng=None,
                                   only=prologue, preset=pre_preset)
        pro_sliced = tuple(n for n in pro_outs if plan.producer(n) in prologue)
    pro_stacked = tuple(
        pro_outs[n].data.reshape((t_max, b) + tuple(pro_outs[n].data.shape[1:]))
        for n in pro_sliced)

    fused_hs = None
    if (plan.fusable() and not sub_state0 and get_flag("fused_attention_gru")):
        fused_hs = _try_fused_attention_gru(plan, params, scanned, static_batch, init_carry,
                                            ctx)
    if fused_hs is not None:
        counters["fused"] += 1
        # time-major, in loop order, as the generic loop stacks its steps
        fused_hs = fused_hs.transpose(0, 1)
        ys_stacked = (fused_hs.flip(0) if reverse else fused_hs,)
    else:
        counters["generic"] += 1
        tpos = torch.arange(t_max, device=lengths.device)[:, None]
        valid = tpos >= (t_max - lengths[None, :]) if reverse else tpos < lengths[None, :]
        mask_seq = valid[..., None]  # [T, B, 1] bool
        lo, hi = live_range(lengths, t_max, reverse)
        if hi == lo:  # no live step: run them all (every row carries through)
            lo, hi = 0, t_max
        counters["steps"] += hi - lo
        counters["skipped"] += t_max - (hi - lo)
        carry, sub_state = dict(init_carry), sub_state0
        ys_steps = []
        for t in range(lo, hi):
            rng_t = None if ctx.rng is None else mix_seed(ctx.rng, f"{conf.name}@{t}")
            preset = {n: SeqTensor(p[t]) for n, p in zip(pro_sliced, pro_stacked)}
            outs, sub_state = subnet.apply(
                params, step_batch(t, carry), state=sub_state, train=ctx.train, rng=rng_t,
                only=plan.loop_only, preset=preset or None)
            for m in memories:
                upd = outs[m.attrs["link"]].data
                carry[m.name] = torch.where(mask_seq[t], upd, carry[m.name].to(upd.dtype))
            ys_steps.append(tuple(outs[n].data for n in frontier_scan))
        if sub_state0:
            ctx.new_state[conf.name] = sub_state
        # dead steps emit zeros, as the JAX package's early exit does
        ys_stacked = []
        for k in range(len(frontier_scan)):
            live = torch.stack([y[k] for y in ys_steps])
            pad = lambda n: live.new_zeros((n,) + tuple(live.shape[1:]))  # noqa: E731
            parts = ([pad(lo)] if lo else []) + [live] + ([pad(t_max - hi)] if hi < t_max else [])
            ys_stacked.append(torch.cat(parts) if len(parts) > 1 else live)

    group_logits = None
    if plan.epilogue is not None:
        # the hoisted suffix, once over the stacked sequence with time
        # folded into the rows
        preset = {n: SeqTensor(_flat(d)) for n, d in zip(frontier_scan, ys_stacked)}
        for n in frontier:
            if n in preset:
                continue
            if plan.producer(n) in prologue:
                preset[n] = pro_outs[n]
            elif n in scan_names:
                preset[n] = SeqTensor(_flat(xs[scan_names.index(n)]))
            else:
                preset[n] = SeqTensor(_tile_rows(static_batch[n].data, t_max))
        epi_outs, _ = subnet.apply(params, {}, state=sub_state0, train=ctx.train, rng=None,
                                   only=plan.epilogue, preset=preset)
        eo = epi_outs[plan.out_name].data
        ys = eo.reshape((t_max, b) + tuple(eo.shape[1:]))
        lg = epi_outs.get(plan.out_name + "@logits")
        if lg is not None:
            group_logits = lg.data.reshape((t_max, b) + tuple(lg.data.shape[1:]))
    else:
        ys = ys_stacked[0]
    if reverse:
        ys = ys.flip(0)
    ys = ys.transpose(0, 1)  # [B, T, D]
    ys = ys * mask_like(ys, lengths)
    if group_logits is not None:
        # the hoisted softmax's pre-activation at group level: a downstream
        # cross_entropy fuses into log-softmax CE
        if reverse:
            group_logits = group_logits.flip(0)
        ctx.outputs[conf.name + "@logits"] = SeqTensor(group_logits.transpose(0, 1), lengths)
    return SeqTensor(ys, lengths)


def _try_fused_attention_gru(plan: GroupPlan, params, scanned, static_batch, init_carry, ctx):
    """The [B, T, H] state sequence of a matched attention-GRU step from
    ``ops/rnn.py``'s ``attention_gru_scan``, or None when a runtime
    precondition fails (the caller then runs the generic loop)."""
    from paddle_tpu_torch.core.compiler import _cast_floats

    mt = plan.match
    enc_t, ep_t = static_batch[mt.enc_name], static_batch[mt.ep_name]
    if enc_t.data.dim() != 3 or ep_t.data.dim() != 3:
        return None
    # the unfused step masks the score softmax by enc_proj's lengths and the
    # context sum by enc's: one mask serves both only when they are the same
    # lengths (enc_proj is a rowwise projection of enc, which passes the
    # lengths object on)
    if enc_t.lengths is not ep_t.lengths:
        return None
    scan_idx = {n: i for i, n in enumerate(plan.scan_names)}
    for _slot, pname in mt.scan_slots:
        x = scanned[scan_idx[pname]].data
        if x.dim() != 3 or not x.is_floating_point():
            return None
    mixed = ctx.dtype != torch.float32

    def layer_p(name):
        p = plan.subnet.layer_params(params, name)
        return _cast_floats(p, ctx.dtype) if mixed else p

    p_sp, p_sc, p_in, p_gru = (layer_p(n) for n in (mt.state_proj, mt.scores, mt.in_proj, mt.gru))
    if "w_h" not in p_gru or "w_c" not in p_gru:
        return None
    # one [H, P + 2H] GEMM per step: the attention state projection and the
    # GRU update / reset gates
    w1 = torch.cat([p_sp["w0"], p_gru["w_h"]], dim=1)
    v = p_sc["w0"][:, 0]
    # the target-side gate projections for the whole sequence, outside the loop
    xg = None
    for slot, pname in mt.scan_slots:
        term = scanned[scan_idx[pname]].data @ p_in[f"w{slot}"]
        xg = term if xg is None else xg + term
    for p in (p_in, p_gru):
        if "b" in p:
            xg = xg + p["b"]
    ep = ep_t.data + p_sp["b"] if "b" in p_sp else ep_t.data
    hs, _h_last = attention_gru_scan(
        xg, enc_t.data, ep, w1, v, p_in[f"w{mt.ctx_slot}"], p_gru["w_c"],
        enc_lengths=enc_t.lengths, lengths=scanned[0].lengths, gate_act=mt.gate_act,
        act=mt.act, att_act=mt.att_act, reverse=plan.reverse, h0=init_carry[mt.mem],
        early_exit=True)
    return hs
