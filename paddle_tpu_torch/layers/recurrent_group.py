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

Nested sequences (the reference's hasSubseq frames): a ``SubsequenceInput``
scans the outer S axis of a [B, S, T, ...] block, and each step sees the
[B, T, ...] subsequence with its lengths (their host column attached, so an
inner scan reads no device value), so a step may hold sequence layers or a
recurrent group of its own (the hierarchical RNN).  ``memory(is_seq=True)``
carries a whole [B, W, size] sequence between steps.  A step that emits a
sequence gives a nested [B, S, T, ...] output whose padding subsequences are
zero.  Hoisting and the fused lowering stay off for a group with a nested
input or a sequence memory; the plan decides this once.

``counters`` counts the runs of each lowering, the steps the generic loops
ran and skipped, and of these the steps of loops over subsequences
(``outer_*``) and of loops inside another group's step (``inner_*``).
"""

from __future__ import annotations

import collections
import contextlib
import warnings
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.core.batch import (
    SeqTensor, host_lengths, set_host_lengths, sub_length_columns)
from paddle_tpu_torch.core.topology import LayerConf, LayerOutput, Topology, auto_name
from paddle_tpu_torch.layers.base import (
    ApplyContext, get_layer_impl, mix_seed, register_layer)
from paddle_tpu_torch.ops.rnn import attention_gru_scan, live_range
from paddle_tpu_torch.utils.flags import get_flag

# runs of each lowering ("fused", "generic") and the generic loops' steps
# ("steps", "skipped"; of these "outer_steps", "outer_skipped" over
# subsequences and "inner_steps", "inner_skipped" inside another group's
# step), since the last clear()
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
    SubsequenceInput): the group scans the outer S axis, and each step sees
    an ordinary [B, T, ...] sequence."""

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
    ``.set_input(layer)``.

    is_seq=True carries the linked layer's whole [B, W, size] sequence (and
    its lengths) between steps (the reference's sequence-memory frames); it
    boots from a sequence layer (a non-sequence boot is a length-1
    sequence) or as an empty sequence, never from a constant id."""
    if _current_build is None:
        raise RuntimeError("memory() must be called inside a recurrent_group step")
    if is_seq and boot_with_const_id is not None:
        raise ValueError(
            "memory(is_seq=True) cannot boot with a constant id: a sequence memory boots "
            "from a sequence boot_layer or as an empty sequence")
    conf = LayerConf(
        name=auto_name(f"memory_{name or memory_name or 'deferred'}"),
        type="memory",
        size=size,
        bias=False,
        attrs={
            "link": name,
            "boot": boot_layer.name if boot_layer is not None else None,
            "boot_const_id": boot_with_const_id,
            **({"is_seq": True} if is_seq else {}),
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
    sub_scanned: List[bool] = []  # parallel: the scan unit is a subsequence
    statics: List[StaticInput] = []
    for i in ins:
        if isinstance(i, StaticInput):
            statics.append(i)
        elif isinstance(i, SubsequenceInput):
            scanned.append(i.input)
            sub_scanned.append(True)
        else:
            scanned.append(i)
            sub_scanned.append(False)
    if not scanned:
        raise ValueError("recurrent_group needs at least one sequence input to scan")
    step_args, scan_placeholders, static_placeholders = _make_placeholders(
        gname, scanned, sub_scanned, statics)
    with _trace_capture() as (gb, created):
        out = step(*step_args)
    step_outputs = list(out) if isinstance(out, (list, tuple)) else [out]
    return _finalize_group(gname, scanned, sub_scanned, statics, scan_placeholders,
                           static_placeholders, gb, created, step_outputs, reverse)


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


def _make_placeholders(gname, scanned, sub_scanned, statics):
    """The scanned and static step-input placeholders of a group."""
    step_args: List[LayerOutput] = []
    scan_placeholders: List[LayerConf] = []
    static_placeholders: List[LayerConf] = []
    for k, lo in enumerate(scanned):
        conf = LayerConf(name=f"{gname}@in{k}", type="step_input", size=lo.size, bias=False,
                         attrs={"step_seq": sub_scanned[k]})
        scan_placeholders.append(conf)
        step_args.append(LayerOutput(conf))
    for k, st in enumerate(statics):
        conf = LayerConf(name=f"{gname}@static{k}", type="step_input", size=st.input.size,
                         bias=False, attrs={"static_seq": st.is_seq})
        static_placeholders.append(conf)
        step_args.append(LayerOutput(conf))
    return step_args, scan_placeholders, static_placeholders


def _finalize_group(gname, scanned, sub_scanned, statics, scan_placeholders,
                    static_placeholders, gb, created, step_outputs, reverse) -> LayerOutput:
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
            "_sub_scanned": tuple(sub_scanned),
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
    and the fused attention-GRU match.  A group with a nested input or a
    sequence memory hoists nothing and fuses nothing: its step values are
    no plain [B, D] rows (the JAX package's ``rows_hoistable``)."""

    def __init__(self, conf: LayerConf, compute_dtype):
        from paddle_tpu_torch.core.compiler import CompiledNetwork
        from paddle_tpu_torch.layers.attention import match_attention_gru_step

        a = conf.attrs
        self.memories: Sequence[LayerConf] = a["_memories"]
        self.sub_topo: Topology = a["_sub_topology"]
        self.subnet = CompiledNetwork(self.sub_topo, compute_dtype=compute_dtype)
        self.scan_names: Sequence[str] = a["_scan_placeholders"]
        self.sub_scanned = tuple(a.get("_sub_scanned", (False,) * len(self.scan_names)))
        self.static_info = a["_static_placeholders"]
        self.static_names = {p for (p, _s) in self.static_info}
        self.out_name: str = a["_output"]
        self.reverse: bool = a["reverse"]
        self.producer = _producer_resolver(self.sub_topo.layers)
        self.seq_memories = [m for m in self.memories if m.attrs.get("is_seq")]
        self.rows = not any(self.sub_scanned) and not self.seq_memories
        self._nest(0)
        self.epilogue, self.frontier = None, (self.out_name,)
        self.prologue: set = set()
        self.match = None
        static_seq = {p for (p, is_seq) in self.static_info if is_seq}
        if self.rows:
            shape = _step_shapes(self.sub_topo, static_seq)
            self.epilogue, self.frontier = _split_epilogue(
                self.sub_topo, self.memories, self.out_name, static_seq)
            # the epilogue folds time into the rows of each value the loop
            # emits: every one must be a plain [B, D] row (a step that emits
            # a sequence gives a nested output instead)
            if self.epilogue is not None and not all(
                    shape.get(self.producer(n)) == "row" for n in self.frontier):
                self.epilogue, self.frontier = None, (self.out_name,)
            self.prologue = _split_prologue(
                self.sub_topo, self.scan_names, self.static_info, self.epilogue or set())
            if len(self.memories) == 1:
                self.match = match_attention_gru_step(
                    self.sub_topo.layers, self.memories[0], set(self.scan_names), static_seq)
        epi = self.epilogue or set()
        self.body_only = set(self.sub_topo.order) - epi - self.prologue
        self.loop_only = None if self.epilogue is None and not self.prologue else self.body_only
        self.frontier_scan = tuple(
            n for n in self.frontier
            if self.epilogue is None or (
                n not in self.static_names and n not in self.scan_names
                and self.producer(n) not in self.prologue))

    def _nest(self, depth: int) -> None:
        """Record how deep this group sits inside other groups' steps (its
        own sub-network's groups sit one deeper)."""
        self.depth = depth
        for p in self.subnet._plans.values():
            if isinstance(p, GroupPlan):
                p._nest(depth + 1)

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
    t_max, b = scanned[0].max_len, scanned[0].data.shape[0]  # t_max: T, or S when nested
    reverse = plan.reverse

    # outer-axis-major scanned inputs, flipped for a reverse group; a
    # SubsequenceInput keeps its [S, B, T, ...] block beside the sub-lengths
    # of each outer step (host columns attached)
    xs, sub_cols = [], []
    for s_in, is_sub in zip(scanned, plan.sub_scanned):
        x = s_in.data.transpose(0, 1)
        xs.append(x.flip(0) if reverse else x)
        if is_sub and not s_in.is_nested:
            raise ValueError(f"{conf.name}: SubsequenceInput requires a nested input")
        sub_cols.append(sub_length_columns(s_in.sub_lengths, reverse) if is_sub else None)
    static_batch = {
        pname: (st if is_seq else SeqTensor(st.data))
        for (pname, is_seq), st in zip(static_info, statics)
    }
    sub_state0 = ctx.state.get(conf.name, {})

    def step_inputs(t: int) -> Dict[str, SeqTensor]:
        return {pname: SeqTensor(x[t], None if cols is None else cols[t])
                for pname, x, cols in zip(scan_names, xs, sub_cols)}

    device = scanned[0].data.device
    seq_widths = _seq_memory_widths(conf, plan, params, static_batch, step_inputs(0), ctx,
                                    sub_state0, b)
    init_carry = {}
    for m in memories:
        boot, boot_const = m.attrs.get("boot"), m.attrs.get("boot_const_id")
        if m.attrs.get("is_seq"):
            init_carry[m.name] = _seq_memory_boot(m, ctx.outputs.get(boot), seq_widths[m.name],
                                                  b, ctx.dtype, device)
        elif boot is not None:
            init_carry[m.name] = ctx.outputs[boot].data
        elif boot_const is not None:
            init_carry[m.name] = torch.full((b, m.size), boot_const, dtype=scanned[0].data.dtype,
                                            device=device)
        else:
            init_carry[m.name] = torch.zeros((b, m.size), dtype=ctx.dtype, device=device)

    def step_batch(t: int, carry) -> Dict[str, SeqTensor]:
        sub_batch = dict(static_batch)
        sub_batch.update(step_inputs(t))
        for m in memories:
            c = carry[m.name]
            sub_batch[m.name] = c if isinstance(c, SeqTensor) else SeqTensor(c)
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
    ys_lengths = None  # [T, B] lengths of a step that emits a sequence
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
        _count_steps(plan, hi - lo, t_max - (hi - lo))
        valid_host = _host_valid(lengths, t_max, reverse) if plan.seq_memories else None
        carry, sub_state = dict(init_carry), sub_state0
        ys_steps = []
        for t in range(lo, hi):
            rng_t = None if ctx.rng is None else mix_seed(ctx.rng, f"{conf.name}@{t}")
            preset = {n: SeqTensor(p[t]) for n, p in zip(pro_sliced, pro_stacked)}
            outs, sub_state = subnet.apply(
                params, step_batch(t, carry), state=sub_state, train=ctx.train, rng=rng_t,
                only=plan.loop_only, preset=preset or None)
            for m in memories:
                upd = outs[m.attrs["link"]]
                if m.attrs.get("is_seq"):
                    carry[m.name] = _seq_carry(conf, m, upd, carry[m.name], mask_seq[t],
                                               valid_host[t])
                else:
                    carry[m.name] = torch.where(mask_seq[t], upd.data,
                                                carry[m.name].to(upd.data.dtype))
            ys_steps.append(tuple(outs[n] for n in frontier_scan))
        if sub_state0:
            ctx.new_state[conf.name] = sub_state
        # dead steps emit zeros (and empty sequences), as the JAX package's
        # early exit does
        ys_stacked = []
        for k in range(len(frontier_scan)):
            ys_stacked.append(_pad_steps([y[k].data for y in ys_steps], lo, t_max))
        if ys_steps and ys_steps[0][0].lengths is not None and plan.epilogue is None:
            ys_lengths = _pad_steps([y[0].lengths for y in ys_steps], lo, t_max)

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
    if ys_lengths is not None:
        return _nested_output(ys, ys_lengths, lengths, reverse)
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


def _count_steps(plan: GroupPlan, run: int, skipped: int) -> None:
    counters["steps"] += run
    counters["skipped"] += skipped
    for kind, on in (("outer", any(plan.sub_scanned)), ("inner", plan.depth > 0)):
        if on:
            counters[f"{kind}_steps"] += run
            counters[f"{kind}_skipped"] += skipped


def _pad_steps(live: List[torch.Tensor], lo: int, t_max: int) -> torch.Tensor:
    """The [T, ...] stack of the steps [lo, lo + len(live)) with zeros at
    the dead steps."""
    x = torch.stack(live)
    hi = lo + x.shape[0]
    pad = lambda n: x.new_zeros((n,) + tuple(x.shape[1:]))  # noqa: E731
    parts = ([pad(lo)] if lo else []) + [x] + ([pad(t_max - hi)] if hi < t_max else [])
    return torch.cat(parts) if len(parts) > 1 else x


def _nested_output(ys, ys_lengths, lengths, reverse) -> SeqTensor:
    """The [B, S, T, ...] output of a step that emits sequences: the group's
    lengths outside, each step's lengths inside, padding zeroed (the
    padding subsequences whole)."""
    if reverse:
        ys, ys_lengths = ys.flip(0), ys_lengths.flip(0)
    out = SeqTensor(ys.transpose(0, 1), lengths, ys_lengths.transpose(0, 1))
    return out.with_data(out.masked_data())


def _host_valid(lengths, t_max: int, reverse: bool) -> np.ndarray:
    """[T, B] host validity of each row at each loop step, from the host
    copy of the outer lengths."""
    h = host_lengths(lengths)
    t = np.arange(t_max)[:, None]
    return t >= (t_max - h[None, :]) if reverse else t < h[None, :]


def _seq_carry(conf, m, upd: SeqTensor, old: SeqTensor, valid, valid_host) -> SeqTensor:
    """A sequence memory's next carry: the linked sequence where the row is
    live, the old one where it is not; its lengths' host copy follows when
    both sides have one."""
    if upd.lengths is None:
        raise ValueError(f"{conf.name}: seq memory {m.name} links {m.attrs['link']!r}, which is "
                         "not a sequence")
    if upd.data.shape != old.data.shape:
        raise ValueError(f"{conf.name}: seq memory {m.name} carries {tuple(old.data.shape)} but "
                         f"its link {m.attrs['link']!r} gives {tuple(upd.data.shape)}")
    data = torch.where(valid[..., None], upd.data, old.data.to(upd.data.dtype))
    new_len = torch.where(valid[:, 0], upd.lengths, old.lengths)
    hu = getattr(upd.lengths, "_host_lengths", None)
    ho = getattr(old.lengths, "_host_lengths", None)
    if hu is not None and ho is not None:
        set_host_lengths(new_len, np.where(valid_host, hu, ho).astype(np.int32))
    return SeqTensor(data, new_len)


def _seq_memory_boot(m, bt: Optional[SeqTensor], w: int, b: int, dtype, device) -> SeqTensor:
    """A sequence memory's first carry at width `w`: the boot layer's
    sequence (cut or padded to w), a non-sequence boot as a length-1
    sequence, or an empty sequence."""
    if bt is None:
        lens = torch.zeros((b,), dtype=torch.int32, device=device)
        return SeqTensor(torch.zeros((b, w, m.size), dtype=dtype, device=device),
                         set_host_lengths(lens, np.zeros((b,), np.int32)))
    if not bt.is_seq:
        d = torch.cat([bt.data[:, None], bt.data.new_zeros((b, w - 1) + tuple(bt.data.shape[1:]))],
                      dim=1)
        lens = torch.ones((b,), dtype=torch.int32, device=device)
        return SeqTensor(d, set_host_lengths(lens, np.ones((b,), np.int32)))
    if bt.data.shape[1] > w:
        # lengths are data: whether real steps (not padding) are cut cannot
        # be told without reading them, so say so with both widths
        warnings.warn(
            f"seq memory '{m.name}': boot layer '{m.attrs['boot']}' is padded to "
            f"{bt.data.shape[1]} steps but the linked layer's fixed-point width is {w}; boot "
            f"sequences longer than {w} steps will be truncated before the first outer step",
            stacklevel=3)
    d = bt.data[:, :w]
    if d.shape[1] < w:
        d = torch.cat([d, d.new_zeros((b, w - d.shape[1]) + tuple(d.shape[2:]))], dim=1)
    lens = torch.clamp(bt.lengths, max=w).to(torch.int32)
    host = getattr(bt.lengths, "_host_lengths", None)
    if host is not None:
        set_host_lengths(lens, np.minimum(host, w).astype(np.int32))
    return SeqTensor(d, lens)


def _to_meta(t: SeqTensor) -> SeqTensor:
    """A SeqTensor of meta tensors of the same shapes; lengths keep (or
    take, by one read) their host copy, which the scans' live range reads."""

    def meta(x):
        return None if x is None else torch.empty_like(x, device="meta")

    def meta_len(x):
        return None if x is None else set_host_lengths(meta(x), host_lengths(x))

    return SeqTensor(meta(t.data), meta_len(t.lengths), meta_len(t.sub_lengths),
                     sparse_ids=t.sparse_ids)


def _seq_memory_widths(conf, plan: GroupPlan, params, static_batch, first_inputs, ctx,
                       sub_state0, b) -> Dict[str, int]:
    """The padded width of each sequence memory: the linked layer's padded
    width at a step.  The JAX package finds it by abstract evaluation
    (``jax.eval_shape``); here the step body runs once on
    ``torch.device("meta")`` (shapes only, no arithmetic, no device
    value read), seeded as the JAX package seeds it (the boot sequence's
    width, else the nested input's T) and iterated to a fixed point, since
    a link's width may follow the memory's own."""
    if not plan.seq_memories:
        return {}
    from paddle_tpu_torch.ops import rnn as rnn_ops
    from paddle_tpu_torch.utils.tree import map_leaves

    nested_w = next((x.data.shape[1] for x in first_inputs.values() if x.lengths is not None), 1)
    widths: Dict[str, int] = {}
    for m in plan.seq_memories:
        bt = ctx.outputs.get(m.attrs.get("boot"))
        widths[m.name] = bt.max_len if bt is not None and bt.is_seq else nested_w
    meta_params = map_leaves(lambda v: torch.empty_like(v, device="meta"), params)
    meta_state = map_leaves(lambda v: torch.empty_like(v, device="meta"), sub_state0)
    fixed = {n: _to_meta(t) for n, t in {**static_batch, **first_inputs}.items()}
    saved = (counters.copy(), rnn_ops.counters.copy())
    try:
        for _ in range(3):
            pb = dict(fixed)
            for m in plan.memories:
                if m.attrs.get("is_seq"):
                    pb[m.name] = SeqTensor(
                        torch.empty((b, widths[m.name], m.size), device="meta"),
                        set_host_lengths(torch.empty((b,), dtype=torch.int32, device="meta"),
                                         np.zeros((b,), np.int32)))
                else:
                    pb[m.name] = SeqTensor(torch.empty((b, m.size), device="meta"))
            with torch.no_grad():
                outs, _ = plan.subnet.apply(meta_params, pb, state=meta_state, train=ctx.train,
                                            rng=None)
            new_widths: Dict[str, int] = {}
            for m in plan.seq_memories:
                out = outs[m.attrs["link"]]
                if out.lengths is None:
                    raise ValueError(
                        f"{conf.name}: memory(is_seq=True) {m.name} links {m.attrs['link']!r}, "
                        "which is not a sequence layer")
                new_widths[m.name] = out.data.shape[1]
            if new_widths == widths:
                return widths
            widths = new_widths
    finally:
        for c, old in zip((counters, rnn_ops.counters), saved):
            c.clear()
            c.update(old)
    raise ValueError(
        f"{conf.name}: sequence-memory padded width did not reach a fixed point (last "
        f"{widths}); a step whose linked sequence grows every iteration cannot be carried")


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
