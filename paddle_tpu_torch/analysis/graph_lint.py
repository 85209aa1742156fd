"""Config-time graph lint — abstract shape/dtype/arity propagation over the
``Topology`` dataclass graph, before anything runs; a copy of
``paddle_tpu/analysis/graph_lint.py`` over the port's IR.

The reference's ``config_parser.py`` runs hundreds of per-layer
``config_assert`` checks while building the ModelConfig proto, so a bad
config dies at parse time with layer provenance instead of mid-training
inside the gserver interpreter.  Our graph is a typed dataclass IR that
exists *before* execution (the TensorFlow/Julia-to-TPU ahead-of-time
observation from PAPERS.md), which makes every check here pure host-side
analysis with zero device cost.

Rules (``G###``; each maps to a reference ``config_assert`` family — see
IMPLEMENTATION_MAP.md "Static analysis"):

  G001 unknown-layer-type        layer type not in the impl registry
  G002 dangling-input            input name resolves to no layer in scope
  G003 arity-mismatch            wrong input count for the layer type
  G004 width-mismatch            input widths incompatible with the type's
                                 contract (addto/concat/gru_step/...)
  G005 dead-layer                created during config build but reachable
                                 from no output/evaluator (cost-unreachable)
  G006 param-share-conflict      shared parameter names with conflicting
                                 shapes / mixed declaration forms
  G007 unknown-attr              attrs key that no code in paddle_tpu_torch ever
                                 reads or writes (typo'd option — silently
                                 ignored at runtime)
  G008 shard-axis-unknown        shard_axis/seq_parallel_axis names an axis
                                 absent from the mesh
  G009 dynamic-width-bucketing   batch-wide trans feeding a weight while
                                 length bucketing is enabled (batch size
                                 varies per bucket; the resolved width
                                 cannot)
  G010 fused-pattern-defeated    a decoder step that would lower onto the
                                 fused attention-GRU core except for
                                 dropout/error-clip inside the pattern
  G011 data-slot-unresolved      v1 data layer whose provider types could
                                 not be resolved (feeding will fail)
  G013 unknown-activation        act name not in the activation registry
  G014 drop-rate-range           drop_rate outside [0, 1)
  G015 data-type-dim-mismatch    data layer size != its InputType dim
  G017 label-dim-mismatch        cost-layer label vocab != prediction width

``G016 duplicate-layer-name`` lives in ``core.topology`` (the graph cannot
even be built, so the constructor raises it as a DiagnosticError).

The port has no device mesh (ROADMAP Queue 1 item 6): G008 checks shard
axes against the JAX package's default axis names ('data', 'model'), and a
``mesh=`` argument raises.  G006's probe builds the network's parameters
with ``CompiledNetwork.init_params(device="meta")``: the port's initializers
draw on a CPU ``torch.Generator`` (and read seeds back with ``tolist``,
which a meta tensor cannot give), so each layer is drawn on the CPU at its
real shape and moved to the meta device, which holds no memory — where the
JAX package's ``jax.eval_shape`` draws nothing.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from paddle_tpu_torch.core.data_types import SlotKind
from paddle_tpu_torch.core.topology import LayerConf, Topology

# ---------------------------------------------------------------------------
# per-type contracts (only constraints the impls genuinely enforce)
# ---------------------------------------------------------------------------

# exact input count
_EXACT_ARITY: Dict[str, int] = {
    "gru_step": 2,        # (gates [B,3H], prev_h)
    "lstm_step": 3,       # (gates [B,4H], prev_h, prev_c)
    "scaling": 2,         # (weight [B,1], x)
    "interpolation": 3,   # (lambda [B,1], x1, x2)
    "expand": 2,          # (x, pattern)
    "trans": 1,
    "maxid": 1,
    "embedding": 1,
    "seqpool": 1,
    "seqlastins": 1,
    "sum_cost": 1,
    "out_prod": 2,
    "cos": 2,
    "dotmul": 2,
    "rank_cost": 3,       # (left, right, label)
}

# minimum input count
_MIN_ARITY: Dict[str, int] = {
    "fc": 1,
    "addto": 1,
    "concat": 1,
    "cross_entropy": 2,
    "square_error": 2,
    "smooth_l1": 2,
    "multi_binary_label_cross_entropy": 2,
    "soft_binary_class_cross_entropy": 2,
    "huber_regression": 2,
    "huber_classification": 2,
}

_CE_COST_TYPES = frozenset({
    "cross_entropy",
    "multi_binary_label_cross_entropy",
})


def _width(conf: Optional[LayerConf]) -> int:
    """Declared last-axis width, or 0 when unknowable (placeholder sizes)."""
    if conf is None or conf.attrs.get("_v1_size_only"):
        return 0
    return int(conf.size or 0)


def _has_dynamic_width(conf: LayerConf) -> bool:
    if conf.attr("dynamic_width_in"):
        return True
    return any(
        s.get("dynamic_width") for s in conf.attrs.get("projections", ())
    )


# ---------------------------------------------------------------------------
# attr-key universe (rule G007)
# ---------------------------------------------------------------------------

_ATTR_UNIVERSE: Optional[Set[str]] = None


def _scan_attr_keys(tree: ast.AST, keys: Set[str]) -> None:
    """Collect every attrs key the code READS (``.attr("k")``,
    ``.attrs.get("k")``, ``.attrs["k"]``, ``"k" in x.attrs``) or WRITES
    (string keys of a dict literal passed as ``attrs=...`` / stored into
    ``.attrs``)."""

    def lit(node) -> Optional[str]:
        return node.value if (
            isinstance(node, ast.Constant) and isinstance(node.value, str)
        ) else None

    # names aliased to an attrs dict (`a = conf.attrs`) — reads through the
    # alias count as reads of attrs keys
    aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Attribute
        ) and node.value.attr == "attrs":
            for t in node.targets:
                if isinstance(t, ast.Name):
                    aliases.add(t.id)

    def is_attrs_expr(node) -> bool:
        if isinstance(node, ast.Attribute) and node.attr == "attrs":
            return True
        return isinstance(node, ast.Name) and node.id in aliases

    def dict_keys(node) -> Iterable[str]:
        if isinstance(node, ast.Dict):
            for k in node.keys:
                s = lit(k) if k is not None else None
                if s is not None:
                    yield s
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "dict"
        ):
            for kw in node.keywords:
                if kw.arg:
                    yield kw.arg

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            # x.attr("k", ...) / x.attrs.get("k", ...)
            if isinstance(f, ast.Attribute) and node.args:
                s = lit(node.args[0])
                if s is not None and (
                    f.attr == "attr"
                    or (f.attr == "get" and is_attrs_expr(f.value))
                ):
                    keys.add(s)
            # attrs={...} / attrs=dict(...) keyword anywhere
            for kw in node.keywords:
                if kw.arg == "attrs":
                    keys.update(dict_keys(kw.value))
        elif isinstance(node, ast.Subscript) and is_attrs_expr(node.value):
            s = lit(node.slice)
            if s is not None:
                keys.add(s)
        elif isinstance(node, ast.Compare) and len(node.ops) == 1 and isinstance(
            node.ops[0], (ast.In, ast.NotIn)
        ):
            if is_attrs_expr(node.comparators[0]):
                s = lit(node.left)
                if s is not None:
                    keys.add(s)
        elif isinstance(node, ast.Assign):
            # conf.attrs = {...} or attrs: ... = {...} assignments
            for t in node.targets:
                if (is_attrs_expr(t) or (
                    isinstance(t, ast.Name) and t.id == "attrs"
                )):
                    keys.update(dict_keys(node.value))


def attr_key_universe(refresh: bool = False) -> Set[str]:
    """Every attrs key read or written anywhere in ``paddle_tpu_torch`` — the
    set a LayerConf attrs key must belong to, or nothing will ever consume
    it.  Built once per process by AST-scanning the package source."""
    global _ATTR_UNIVERSE
    if _ATTR_UNIVERSE is not None and not refresh:
        return _ATTR_UNIVERSE
    import paddle_tpu_torch

    keys: Set[str] = set()
    root = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    tree = ast.parse(f.read(), filename=path)
            except (SyntaxError, OSError):  # pragma: no cover
                continue
            _scan_attr_keys(tree, keys)
    _ATTR_UNIVERSE = keys
    return keys


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------


# the JAX package's default mesh axes (parallel/mesh.py DATA_AXIS, MODEL_AXIS)
_AXIS_NAMES = ("data", "model")


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "graph lint against a device mesh is not ported yet (ROADMAP Queue 1 item 6): "
            "the port has no mesh; call without mesh=")


@dataclasses.dataclass
class _LintCtx:
    diags: List[Diagnostic]
    source: Optional[str]
    axis_names: Tuple[str, ...]
    attr_universe: Set[str]
    activations: Set[str]
    layer_types: Set[str]

    def emit(self, rule, severity, message, layer=None, hint=None) -> None:
        self.diags.append(
            Diagnostic(
                rule=rule,
                severity=severity,
                message=message,
                layer=layer,
                source=self.source,
                hint=hint,
            )
        )


def _lint_one(ctx: _LintCtx, path: Tuple[str, ...], conf: LayerConf,
              layers: Dict[str, LayerConf], visible: Set[str]) -> None:
    name = ".".join(path)
    E, W = Severity.ERROR, Severity.WARNING

    # G001 unknown layer type
    if conf.type not in ctx.layer_types:
        ctx.emit(
            "G001", E,
            f"unknown layer type {conf.type!r}",
            layer=name,
            hint="use one of the registered types "
            "(paddle_tpu_torch.layers.base.registered_layer_types())",
        )
        return  # nothing below is meaningful for an unknown type

    # G002 dangling inputs (auxiliary "<layer>@out" addresses resolve by base)
    dangling = [
        i for i in conf.inputs
        if i not in layers and i.split("@")[0] not in visible
    ]
    if dangling:
        ctx.emit(
            "G002", E,
            f"inputs {dangling} name no layer in the graph",
            layer=name,
            hint="the input layer was never built, or its name is typo'd; "
            f"layers in scope: {sorted(visible)[:8]}...",
        )
        return  # arity/width below would double-report

    # memory link resolution + width
    if conf.type == "memory":
        link = conf.attrs.get("link")
        if link and link.split("@")[0] not in visible:
            ctx.emit(
                "G002", E,
                f"memory link {link!r} names no layer in the step graph",
                layer=name,
                hint="link the memory to a layer built inside the step "
                "(memory(name=...) or .set_input(layer))",
            )
        elif link:
            tgt = layers.get(link.split("@")[0])
            # "@"-addressed auxiliary outputs (lstm_step's "<name>@cell")
            # have their own widths — only plain links are checkable
            if tgt is not None and _width(tgt) and _width(conf) and \
                    "@" not in link and _width(tgt) != _width(conf):
                ctx.emit(
                    "G004", E,
                    f"memory size {conf.size} != linked layer "
                    f"{link!r} size {tgt.size}",
                    layer=name,
                    hint="a memory carries its link's previous output; "
                    "declare memory(size=) equal to the linked layer's size",
                )

    # G003 arity
    want = _EXACT_ARITY.get(conf.type)
    n = len(conf.inputs)
    if want is not None and n != want:
        ctx.emit(
            "G003", E,
            f"{conf.type} takes exactly {want} input(s), got {n} "
            f"({list(conf.inputs)})",
            layer=name,
            hint=f"see the {conf.type!r} layer contract in paddle_tpu_torch.layers",
        )
        return
    want_min = _MIN_ARITY.get(conf.type)
    if want_min is not None and n < want_min:
        ctx.emit(
            "G003", E,
            f"{conf.type} needs at least {want_min} input(s), got {n}",
            layer=name,
            hint=f"see the {conf.type!r} layer contract in paddle_tpu_torch.layers",
        )
        return

    ins = [layers.get(i.split("@")[0], layers.get(i)) for i in conf.inputs]

    # G004 width contracts (0 = unknown ⇒ skip; dynamic widths are runtime)
    if not _has_dynamic_width(conf) and not any(
        c is not None and _has_dynamic_width(c) for c in ins
    ):
        _lint_widths(ctx, name, conf, ins)

    # G013 unknown activation
    if conf.act and conf.act not in ctx.activations:
        ctx.emit(
            "G013", E,
            f"unknown activation {conf.act!r}",
            layer=name,
            hint=f"known activations: {sorted(ctx.activations)}",
        )

    # G014 drop_rate range
    if not (0.0 <= conf.drop_rate < 1.0):
        ctx.emit(
            "G014", E,
            f"drop_rate {conf.drop_rate} outside [0, 1)",
            layer=name,
            hint="dropout keeps each unit with probability 1-drop_rate; "
            "1.0 would zero the whole layer",
        )

    # G007 unknown attrs keys ('_'-prefixed keys are build artifacts)
    unknown = [
        k for k in conf.attrs
        if not k.startswith("_") and k not in ctx.attr_universe
    ]
    if unknown:
        ctx.emit(
            "G007", W,
            f"attrs keys {sorted(unknown)} are read by no paddle_tpu_torch code "
            "and will be silently ignored",
            layer=name,
            hint="probably a typo'd layer option; compare with the layer's "
            "documented attrs",
        )

    # G008 shard axes
    for axis in (conf.shard_axis, conf.attr("seq_parallel_axis")):
        if axis and axis not in ctx.axis_names:
            ctx.emit(
                "G008", W,
                f"shard axis {axis!r} is not a mesh axis "
                f"{list(ctx.axis_names)}",
                layer=name,
                hint="use one of the mesh's named axes ('data'/'model', the "
                "JAX package's parallel.mesh)",
            )

    # G011 unresolved v1 data slots
    why = conf.attrs.get("_v1_unresolved")
    if why:
        ctx.emit(
            "G011", W,
            f"data slot types unresolved: {why} — feeding this graph will "
            "fail at the DataFeeder boundary",
            layer=name,
            hint="declare input_types on the @provider, make its init_hook "
            "runnable, or feed through an explicit DataFeeder",
        )

    # G015 data layer size vs declared InputType dim
    if conf.type == "data" and conf.input_type is not None:
        it = conf.input_type
        if it.kind in (SlotKind.DENSE, SlotKind.INDEX) and _width(conf) and \
                it.dim != conf.size:
            ctx.emit(
                "G015", E,
                f"data layer size {conf.size} != its "
                f"{it.kind.value} input_type dim {it.dim}",
                layer=name,
                hint="data_layer(size=...) must equal the provider slot's "
                "declared dimension",
            )

    # G017 cost-label dimension
    if conf.type in _CE_COST_TYPES and len(conf.inputs) >= 2:
        pred, label = ins[0], ins[1]
        if (
            label is not None
            and label.type == "data"
            and label.input_type is not None
            and label.input_type.kind == SlotKind.INDEX
            and pred is not None
            and _width(pred)
            and label.input_type.dim != _width(pred)
        ):
            ctx.emit(
                "G017", E,
                f"label {label.name!r} has {label.input_type.dim} classes "
                f"but the prediction {pred.name!r} is {pred.size} wide",
                layer=name,
                hint="integer_value(n) must match the classifier width n",
            )


def _lint_widths(ctx: _LintCtx, name: str, conf: LayerConf,
                 ins: Sequence[Optional[LayerConf]]) -> None:
    E = Severity.ERROR
    t = conf.type
    w = _width(conf)
    iw = [_width(c) for c in ins]

    def bad(msg: str, hint: str) -> None:
        ctx.emit("G004", E, msg, layer=name, hint=hint)

    if t == "addto":
        sizes = {x for x in iw if x}
        if w:
            sizes |= {w}
        if len(sizes) > 1:
            bad(
                f"addto inputs must all match the output width; got "
                f"{iw} -> {w}",
                "addto sums its inputs elementwise — every input needs the "
                "same size",
            )
    elif t == "concat":
        if w and all(iw) and sum(iw) != w:
            bad(
                f"concat of widths {iw} gives {sum(iw)}, but size={w} "
                "declared",
                "declare size as the sum of the input widths (or omit it)",
            )
    elif t == "gru_step":
        if iw[0] and w and iw[0] != 3 * w:
            bad(
                f"gru_step gate input is {iw[0]} wide; needs 3*size "
                f"= {3 * w}",
                "the gate input stacks update/reset/candidate projections: "
                "project the step input to 3*size first",
            )
        elif len(iw) > 1 and iw[1] and w and iw[1] != w:
            bad(
                f"gru_step state input is {iw[1]} wide; needs size = {w}",
                "the previous-state memory must carry `size` features",
            )
    elif t == "lstm_step":
        if iw[0] and w and iw[0] != 4 * w:
            bad(
                f"lstm_step gate input is {iw[0]} wide; needs 4*size "
                f"= {4 * w}",
                "the gate input stacks input/forget/output/candidate "
                "projections: project the step input to 4*size first",
            )
        else:
            for slot, x in enumerate(iw[1:], 1):
                if x and w and x != w:
                    bad(
                        f"lstm_step state input {slot} is {x} wide; needs "
                        f"size = {w}",
                        "prev_h and prev_c must both carry `size` features",
                    )
                    break
    elif t in ("scaling", "interpolation"):
        if iw[0] and iw[0] != 1:
            bad(
                f"{t} weight input must be width 1, got {iw[0]}",
                "the first input is a per-sample scalar weight",
            )
        elif t == "interpolation" and iw[1] and iw[2] and iw[1] != iw[2]:
            bad(
                f"interpolation endpoints differ in width: {iw[1]} vs "
                f"{iw[2]}",
                "both interpolated inputs need the same size",
            )


def _iter_layers(topology: Topology, prefix: Tuple[str, ...] = ()):
    """(dotted-path, conf) over a topology INCLUDING recurrent_group
    sub-topologies."""
    for n, c in topology.layers.items():
        yield prefix + (n,), c
        sub = c.attrs.get("_sub_topology")
        if sub is not None:
            yield from _iter_layers(sub, prefix + (n,))


def _reachable(topology: Topology) -> Set[str]:
    """All layer names in this topology and its sub-topologies."""
    out: Set[str] = set()

    def visit(t: Topology) -> None:
        for n, c in t.layers.items():
            out.add(n)
            sub = c.attrs.get("_sub_topology")
            if sub is not None:
                visit(sub)

    visit(topology)
    return out


def _lint_fused_pattern(ctx: _LintCtx, path: Tuple[str, ...],
                        conf: LayerConf) -> None:
    """G010: the PR-2 fused attention-GRU matcher is structural — dropout or
    error-clip on any layer inside the pattern silently defeats it and the
    decoder falls back to the generic per-layer scan.  Re-run the matcher
    with those attributes stripped; if it matches only then, the config
    gave up the fused core without knowing."""
    from paddle_tpu_torch.layers.attention import match_attention_gru_step

    sub: Topology = conf.attrs["_sub_topology"]
    scan_names = set(conf.attrs.get("_scan_placeholders", ()))
    static_seq = {
        p for (p, is_seq) in conf.attrs.get("_static_placeholders", ())
        if is_seq
    }
    for mem in conf.attrs.get("_memories", ()):
        if match_attention_gru_step(sub.layers, mem, scan_names, static_seq):
            continue  # fuses as-is
        cleaned = {}
        dirty: List[str] = []
        for n, c in sub.layers.items():
            if c.drop_rate or c.attr("error_clip", 0.0):
                dirty.append(n)
                attrs = {k: v for k, v in c.attrs.items() if k != "error_clip"}
                c = dataclasses.replace(c, drop_rate=0.0, attrs=attrs)
            cleaned[n] = c
        if dirty and match_attention_gru_step(
            cleaned, mem, scan_names, static_seq
        ):
            ctx.emit(
                "G010", Severity.WARNING,
                "this decoder step matches the fused attention-GRU core "
                f"except for dropout/error-clip on {sorted(dirty)}; the "
                "group falls back to the generic (slower) scan",
                layer=".".join(path),
                hint="move dropout outside the matched pattern (e.g. onto "
                "the group output) or drop error_clip inside the step to "
                "regain the fused lowering",
            )


def _compile_probe(ctx: _LintCtx, topology: Topology) -> None:
    """G006: build the CompiledNetwork parameter-sharing maps and its
    parameters on the meta device (shape-only storage; see the module
    docstring) so name-collision and shared-shape conflicts surface here
    with provenance instead of deep inside a matmul."""
    from paddle_tpu_torch.analysis.diagnostics import DiagnosticError
    from paddle_tpu_torch.core.compiler import CompiledNetwork

    try:
        net = CompiledNetwork(topology)
        net.init_params(0, device="meta")
    except DiagnosticError as e:
        # the compiler already speaks the diagnostic format (G006 family);
        # re-home its findings under this lint run's source
        for d in e.diagnostics:
            ctx.diags.append(dataclasses.replace(d, source=ctx.source))
    except NotImplementedError:
        # a part the port has not built yet (a shard_axis needs the device
        # mesh, ROADMAP Queue 1 item 6) says nothing about the config
        pass
    except ValueError as e:
        msg = str(e).splitlines()[0]
        ctx.emit(
            "G006", Severity.ERROR,
            f"parameter build conflict: {msg}",
            hint="two layers share a parameter name with incompatible "
            "shapes/forms; use distinct ParamAttr names or align the sizes",
        )
    except Exception as e:  # init-time failure of any layer
        ctx.emit(
            "G006", Severity.ERROR,
            f"parameter init fails: {type(e).__name__}: "
            f"{str(e).splitlines()[0] if str(e) else e!r}",
            hint="shape-only parameter init failed — the layer sizes/attrs "
            "are inconsistent even before anything runs",
        )


def lint_topology(
    topology: Topology,
    *,
    mesh=None,
    created: Optional[Iterable[str]] = None,
    evaluator_layers: Optional[Iterable[str]] = None,
    source: Optional[str] = None,
    bucketing: Optional[bool] = None,
) -> List[Diagnostic]:
    """Lint one Topology.  ``created`` is the full set of layer names built
    during config construction (for dead-layer detection);
    ``evaluator_layers`` are extra liveness roots (evaluator/extra-layer
    inputs).  ``bucketing=None`` reads the ``use_bucketing`` flag.  A
    ``mesh`` raises (ROADMAP Queue 1 item 6)."""
    _no_mesh(mesh)
    import paddle_tpu_torch.layers  # noqa: F401 — populates the impl registry
    from paddle_tpu_torch.layers.base import registered_layer_types
    from paddle_tpu_torch.ops.activations import registered_activations
    from paddle_tpu_torch.utils.flags import get_flag

    ctx = _LintCtx(
        diags=[],
        source=source,
        axis_names=_AXIS_NAMES,
        attr_universe=attr_key_universe(),
        activations=set(registered_activations()) | {"", "identity", "linear"},
        layer_types=set(registered_layer_types()),
    )

    def walk(t: Topology, prefix: Tuple[str, ...], inherited: Set[str]) -> None:
        visible = inherited | set(t.layers)
        for n in t.order:
            conf = t.layers[n]
            _lint_one(ctx, prefix + (n,), conf, t.layers, visible)
            sub = conf.attrs.get("_sub_topology")
            if sub is not None:
                if conf.type == "recurrent_group":
                    _lint_fused_pattern(ctx, prefix + (n,), conf)
                walk(sub, prefix + (n,), visible)

    walk(topology, (), set())

    # G009 dynamic width x bucketing
    if bucketing is None:
        bucketing = bool(get_flag("use_bucketing"))
    if bucketing:
        dyn = [
            ".".join(path) for path, c in _iter_layers(topology)
            if _has_dynamic_width(c)
        ]
        if dyn:
            ctx.emit(
                "G009", Severity.ERROR,
                f"layers {dyn} consume a batch-wide transpose (dynamic "
                "weight width = batch size) but length bucketing is "
                "enabled — bucketed batch sizes vary per rung, so the "
                "resolved weights cannot fit every bucket",
                hint="disable use_bucketing for this config, or restructure "
                "away from whole-minibatch trans feeding a projection",
            )

    # G005 dead layers
    if created is not None:
        live = _reachable(topology)
        roots = set(evaluator_layers or ())
        dead = sorted(
            n for n in set(created) - live - roots
            if not n.startswith("__memory_")  # deferred-link handles
        )
        if dead:
            ctx.emit(
                "G005", Severity.WARNING,
                f"layers {dead} were built but are reachable from no "
                "output or evaluator — they will never execute",
                hint="remove them, add them to outputs()/Outputs(), or "
                "attach them to an evaluator/extra_layers",
            )

    # G006 compile probe — only when the graph is structurally sound
    if not any(
        d.rule in ("G001", "G002", "G003") and d.severity == Severity.ERROR
        for d in ctx.diags
    ):
        _compile_probe(ctx, topology)

    return ctx.diags


def lint_parsed(parsed, *, mesh=None, bucketing: Optional[bool] = None
                ) -> List[Diagnostic]:
    """Lint a v1 ``ParsedConfig`` (the ``parse_config`` result): the built
    topology plus parse-level context — every layer the config file created
    (dead-layer analysis) and the evaluator inputs (liveness roots), with
    the config path as provenance.  A ``mesh`` raises (ROADMAP Queue 1
    item 6)."""
    _no_mesh(mesh)
    eval_roots: Set[str] = set()
    for ev in getattr(parsed, "evaluators", ()) or ():
        for lo in getattr(ev, "layers", ()) or ():
            eval_roots.add(lo.name)
            eval_roots.update(_ancestors(lo))
    return lint_topology(
        parsed.topology,
        mesh=mesh,
        created=getattr(parsed, "all_layer_names", None),
        evaluator_layers=eval_roots,
        source=getattr(parsed, "source_file", None),
        bucketing=bucketing,
    )


def _ancestors(lo) -> Set[str]:
    out: Set[str] = set()
    stack = list(lo.parents)
    while stack:
        p = stack.pop()
        if p.name in out:
            continue
        out.add(p.name)
        stack.extend(p.parents)
    return out
