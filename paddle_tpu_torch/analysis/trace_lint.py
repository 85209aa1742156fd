"""Trace-hygiene analyzer — FX-graph hazard checks on the port's train
step; the counterpart of ``paddle_tpu/analysis/trace_lint.py``.

The graph linter (``analysis.graph_lint``) sees the model *description*;
this pass sees what the step actually runs.  :func:`trace_step` records one
call of a step with ``torch.fx.experimental.proxy_tensor.make_fx`` in
``"real"`` mode: every aten op the dispatcher runs (the forward, the
backward ``torch.autograd.grad`` takes, the optimizer's in-place update)
becomes one node of a ``torch.fx`` graph, and the flash-attention custom
operators (ops/flash_attention.py) stay one opaque node per launch.  Each
node carries the layer that issued it (``meta["layer"]``, the
``"<type>:<name>"`` label ``CompiledNetwork.apply`` keeps on the thread)
and its source line (``meta["site"]``: the innermost frame outside
torch and this package's tracers); a backward op takes both from the
forward op whose autograd node runs it.  The numerics lint
(``analysis.numerics_lint``) and the numerics sanitizer
(``analysis.num_sanitizer``) run over the same trace.

Rules (``T###``), with their torch subjects:

  T101 f64-leak              float64 node values or casts to float64 (the
                             card runs f64 at a small fraction of its f32
                             rate)
  T102 const-captured-array  a ``get_attr`` tensor constant of
                             DEFAULT_CONST_ELEMS or more elements: a
                             weight captured by closure instead of passed
  T103 host-sync             ``aten._local_scalar_dense`` (``.item()``,
                             ``bool()``), a copy from the card to the host,
                             ``aten.nonzero`` and the other ops whose
                             output size depends on the data; the finding
                             counts them per step
  T104 off-ladder-shape      an observed batch extent off the bucketing
                             ladder (pure shape logic, as in the JAX
                             package)
  T105 shape-explosion       more distinct batch shapes than the ladder
                             budget
  T106 undonated-carry       a large input leaf whose updated value leaves
                             the step as a fresh tensor instead of by an
                             in-place op on the input, or that the step
                             clones and writes back: the port's donation
                             is an update in place, and a fresh or cloned
                             carry holds twice the state

A justified ``# trace: allow[T10x] <why>`` pragma (analysis/pragmas.py) on
the line that issues an op exempts that op; an empty one is T107.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import re
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from paddle_tpu_torch.analysis import pragmas as _pragmas
from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from paddle_tpu_torch.core.batch import (
    DEFAULT_LADDER,
    DEFAULT_SUB_LADDER,
    SeqTensor,
    batch_shape_key,
)
from paddle_tpu_torch.ops import flash_attention

__all__ = [
    "DEFAULT_CONST_ELEMS",
    "TracedStep",
    "donation_audit",
    "lint_graph",
    "lint_jaxpr",
    "lint_step",
    "node_layer",
    "node_site",
    "recompile_audit",
    "trace_step",
]

# elements; 64 KiB of f32 — parameters are (much) bigger, batch literals too
DEFAULT_CONST_ELEMS = 16384

# ops whose output size or value the host must read: one sync each
_SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
    "aten.unique", "aten._unique", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive", "aten.bincount", "aten.equal",
    "aten.is_nonzero", "aten.repeat_interleave",
})

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
_TORCH_ROOT = os.path.dirname(os.path.abspath(torch.__file__))
_STDLIB_ROOT = os.path.dirname(os.path.abspath(os.__file__))
_TRACERS = frozenset(
    os.path.join(_PKG_ROOT, "analysis", f)
    for f in ("trace_lint.py", "numerics_lint.py", "num_sanitizer.py")
)


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------


_skip_cache: Dict[str, bool] = {}


def _skip_file(path: str) -> bool:
    """Frames the site skips: torch itself, the standard library, and the
    tracers of this package."""
    got = _skip_cache.get(path)
    if got is None:
        apath = os.path.abspath(path) if not path.startswith("<") else path
        got = (
            path.startswith("<frozen") or apath.startswith(_TORCH_ROOT)
            or apath in _TRACERS
            or (apath.startswith(_STDLIB_ROOT) and "site-packages" not in apath)
        )
        _skip_cache[path] = got
    return got


def _relpath(path: Optional[str]) -> Optional[str]:
    """``paddle_tpu_torch/...`` for a file of the package (the pragma
    filter's key), else the path as given."""
    if not path:
        return path
    marker = "paddle_tpu_torch" + os.sep
    idx = path.rfind(marker)
    return path[idx:] if idx >= 0 else path


def _python_site() -> Optional[Tuple[str, int]]:
    f = sys._getframe(2)
    while f is not None:
        if not _skip_file(f.f_code.co_filename):
            return _relpath(f.f_code.co_filename), f.f_lineno
        f = f.f_back
    return None


class _Provenance:
    """Layer and site of each traced node.  A forward node takes the
    thread's current layer and the issuing frame; the autograd node its op
    created (the sequence number autograd handed out just before the op
    reached the tracer) maps to that provenance, so a backward op — run
    while that autograd node executes, on whatever thread — takes the
    layer and the forward line it is the gradient of."""

    def __init__(self) -> None:
        self.by_seq: Dict[int, Tuple[Optional[str], Optional[Tuple[str, int]]]] = {}

    def annotate(self, node) -> None:
        from paddle_tpu_torch.core.compiler import provenance

        anode = torch._C._current_autograd_node()
        if anode is None:
            layer, site = getattr(provenance, "layer", None), _python_site()
            # first writer wins: an op that creates no autograd node leaves
            # the counter where the last creating op put it
            self.by_seq.setdefault(torch.autograd._get_sequence_nr() - 1, (layer, site))
        else:
            layer, site = self.by_seq.get(anode._sequence_nr(), (None, None))
            node.meta["backward"] = True
        node.meta["layer"] = layer
        node.meta["site"] = site


_LAYER_RE = re.compile(r"([A-Za-z_][\w.]*):([\w./@-]+)")


def node_layer(node) -> Optional[str]:
    """The layer name a node was issued by (the ``type:name`` label's name,
    as the JAX package's ``_eqn_layer`` reads its named scope)."""
    label = node.meta.get("layer")
    if not label:
        return None
    m = _LAYER_RE.search(label)
    return m.group(2) if m else None


def node_site(node) -> Tuple[Optional[str], Optional[int]]:
    """(file, line) of the source that issued a node: the pragma anchor."""
    site = node.meta.get("site")
    return (site[0], site[1]) if site else (None, None)


def op_name(node) -> str:
    """``aten.mm``-style name of a call_function node's target."""
    t = node.target
    ns = getattr(t, "namespace", None)
    if ns is not None:
        return f"{ns}.{t._opname}"
    return getattr(t, "__name__", str(t))


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------


def _flatten(x, label: str, leaves: List[torch.Tensor], labels: List[str]) -> Callable:
    """Append `x`'s tensor leaves (dicts, lists, tuples, SeqTensor fields)
    with their labels; returns a function rebuilding `x` from an iterator
    over replacement leaves.  Other values ride as constants."""
    if torch.is_tensor(x):
        leaves.append(x)
        labels.append(label)
        return lambda it: next(it)
    if isinstance(x, SeqTensor):
        fns = [_flatten(getattr(x, f), f"{label}.{f}", leaves, labels)
               for f in ("data", "lengths", "sub_lengths")]
        sparse = x.sparse_ids
        return lambda it: SeqTensor(*(fn(it) for fn in fns), sparse_ids=sparse)
    if isinstance(x, dict):
        keys = list(x)
        fns = [_flatten(x[k], f"{label}[{k!r}]", leaves, labels) for k in keys]
        return lambda it: {k: fn(it) for k, fn in zip(keys, fns)}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        typ = type(x)
        fns = [_flatten(v, f"{label}[{i}]", leaves, labels) for i, v in enumerate(x)]
        return lambda it: typ(fn(it) for fn in fns)
    return lambda it: x


def _clone_leaf(t: torch.Tensor) -> torch.Tensor:
    c = t.detach().clone()
    host = getattr(t, "_host_lengths", None)
    if host is not None:
        c._host_lengths = host
    return c


def _make_fx_kwargs() -> Dict[str, Any]:
    """make_fx's private switch that records ``.item()``/``bool()`` as a
    node instead of raising, where this torch has it."""
    from torch.fx.experimental.proxy_tensor import make_fx

    params = inspect.signature(make_fx).parameters
    kw: Dict[str, Any] = {"tracing_mode": "real"}
    if "_error_on_data_dependent_ops" in params:
        kw["_error_on_data_dependent_ops"] = False
    return kw


def _meta_val(val):
    """A meta tensor of `val`'s dtype, shape and strides (lists and tuples
    element by element): what make_fx may read of a node's value while it
    traces, at no copy."""
    if torch.is_tensor(val):
        if val.layout != torch.strided:
            return None
        return torch.empty_strided(val.shape, val.stride(), dtype=val.dtype, device="meta")
    if isinstance(val, (list, tuple)):
        return type(val)([_meta_val(v) for v in val])
    return val


def _tensor_metas(val) -> List[Optional[Tuple[torch.dtype, Tuple[int, ...], torch.device]]]:
    vals = val if isinstance(val, (list, tuple)) else [val]
    return [(v.dtype, tuple(v.shape), v.device) if torch.is_tensor(v) else None for v in vals]


def _light_set_meta(proxy, val):
    proxy.node.meta["val"] = _meta_val(val)
    proxy.node.meta["tensors"] = _tensor_metas(val)
    return proxy


_TRACE_LOCK = threading.Lock()


@contextlib.contextmanager
def _light_meta():
    """make_fx records each node's value as a fake-tensor snapshot (a fresh
    FakeTensorMode per value in real mode), most of a trace's
    host time; the lints keep only dtype, shape and device.  While a trace
    is taken, make_fx's ``set_meta`` records a meta tensor and those three
    instead (``_TRACE_LOCK`` keeps traces one at a time)."""
    from torch.fx.experimental import proxy_tensor

    orig = proxy_tensor.set_meta
    proxy_tensor.set_meta = _light_set_meta
    try:
        yield
    finally:
        proxy_tensor.set_meta = orig


@dataclasses.dataclass
class TracedStep:
    """One traced call: the graph, its inputs' and outputs' labels (the
    JAX package's ``arg0['fc']['w0']`` spelling), the trace's wall seconds
    and the reduced-precision switch as it read during the trace."""

    graph_module: Any
    in_labels: List[str]
    in_argnums: List[int]
    out_labels: List[str]
    out_argnums: List[int]
    seconds: float
    reduced_precision: bool

    @property
    def graph(self):
        return self.graph_module.graph

    def placeholders(self) -> List[Any]:
        return [n for n in self.graph.nodes if n.op == "placeholder"]

    def output_values(self) -> List[Any]:
        out = next(n for n in reversed(self.graph.nodes) if n.op == "output")
        vals = out.args[0]
        return list(vals) if isinstance(vals, (list, tuple)) else [vals]


def _compact_meta(gm) -> None:
    """Keep dtype, shape and device of each node's value and drop the
    value itself (a full-width step's intermediates)."""
    for n in gm.graph.nodes:
        val = n.meta.pop("val", None)
        n.meta.pop("tensor_meta", None)
        n.meta.pop("stack_trace", None)
        metas = n.meta.get("tensors")
        if n.op == "get_attr":
            metas = _tensor_metas(getattr(gm, n.target, None))
        elif metas is None:
            metas = _tensor_metas(val)
        n.meta["tensors"] = metas
        first = metas[0] if metas else None
        n.meta["dtype"] = first[0] if first else None
        n.meta["shape"] = first[1] if first else None
        n.meta["device"] = first[2] if first else None


def trace_step(fn, *example_args, **example_kwargs) -> TracedStep:
    """Run ``fn`` once on the example arguments under ``make_fx`` (real
    mode) and return its graph.  Tensor leaves of dicts, lists, tuples and
    SeqTensors are the graph's inputs (their clones: an in-place step
    leaves the caller's tensors as they were); other values (ints, seeds,
    generators) are constants of the trace.  ``reduced_precision`` records
    whether cuBLAS may reduce bf16/f16 GEMMs in the operand type (the
    switches N401 reads; ops/__init__.py pins them False for sub-f32
    compute)."""
    from torch.fx.experimental.proxy_tensor import get_proxy_mode, make_fx

    leaves: List[torch.Tensor] = []
    labels: List[str] = []
    argnums: List[int] = []
    rebuilds = []
    for i, a in enumerate(example_args):
        n0 = len(leaves)
        rebuilds.append(_flatten(a, f"arg{i}", leaves, labels))
        argnums.extend([i] * (len(leaves) - n0))
    inputs = [_clone_leaf(t) for t in leaves]
    out_labels: List[str] = []
    out_argnums: List[int] = []
    m = torch.backends.cuda.matmul
    reduced = bool(m.allow_bf16_reduced_precision_reduction
                   or m.allow_fp16_reduced_precision_reduction)

    prov = _Provenance()

    def flat_fn(*flat):
        tracer = get_proxy_mode().tracer
        create = tracer.create_node

        def create_node(*a, **kw):
            node = create(*a, **kw)
            if node.op in ("call_function", "get_attr"):
                prov.annotate(node)
            return node

        tracer.create_node = create_node
        make_arg = tracer.create_arg
        held: Dict[int, Any] = {}

        def create_arg(a):
            # a host generator a step draws its seeds from (the epoch
            # program's carry) rides the graph as an attribute
            if isinstance(a, torch.Generator):
                if id(a) not in held:
                    name = f"_generator_constant{len(held)}"
                    setattr(tracer.root, name, a)
                    held[id(a)] = tracer.create_node("get_attr", name, (), {})
                return held[id(a)]
            return make_arg(a)

        tracer.create_arg = create_arg
        it = iter(flat)
        out = fn(*(r(it) for r in rebuilds), **example_kwargs)
        parts = out if isinstance(out, tuple) else (out,)
        o_leaves: List[torch.Tensor] = []
        for k, part in enumerate(parts):
            n0 = len(o_leaves)
            _flatten(part, f"out{k}", o_leaves, out_labels)
            out_argnums.extend([k] * (len(o_leaves) - n0))
        return o_leaves

    t0 = time.perf_counter()
    with _TRACE_LOCK, _light_meta(), flash_attention.as_graph_ops():
        gm = make_fx(flat_fn, **_make_fx_kwargs())(*inputs)
    secs = time.perf_counter() - t0
    _compact_meta(gm)
    return TracedStep(gm, labels, argnums, out_labels, out_argnums, secs, reduced)


# ---------------------------------------------------------------------------
# pragmas
# ---------------------------------------------------------------------------


class SitePragmaFilter:
    """Suppress findings whose issuing source line carries a justified
    ``# <plane>: allow[<rule>]`` pragma; tracks per-file usage so stale
    pragmas report like every other plane's."""

    def __init__(self, plane: str, root: Optional[str] = None) -> None:
        self.plane = plane
        self.root = root or _REPO_ROOT  # where ``paddle_tpu_torch/...`` paths resolve
        self._tables: Dict[str, Dict[int, _pragmas.Pragma]] = {}
        self.used: Dict[str, Set[int]] = {}
        self.pragma_diags: List[Diagnostic] = []

    def _table(self, relpath: str) -> Dict[int, _pragmas.Pragma]:
        got = self._tables.get(relpath)
        if got is not None:
            return got
        table: Dict[int, _pragmas.Pragma] = {}
        path = relpath if os.path.isabs(relpath) else os.path.join(self.root, relpath)
        if os.path.exists(path):
            try:
                with open(path, "r", encoding="utf-8") as f:
                    table = _pragmas.collect(f.read(), self.plane, relpath, self.pragma_diags)
            except OSError:
                table = {}
        self._tables[relpath] = table
        return table

    def suppresses(self, rule: str, source: Optional[str], line: Optional[int]) -> bool:
        if not (source and line):
            return False
        pragma = self._table(source).get(line)
        if pragma is not None and pragma.suppresses(rule):
            self.used.setdefault(source, set()).add(line)
            return True
        return False

    def filter(self, diags: List[Diagnostic]) -> List[Diagnostic]:
        return [d for d in diags if not self.suppresses(d.rule, d.source, d.line)]

    def load_package(self) -> None:
        """Read every package file's pragmas, so stale reporting covers
        files the traces never reached."""
        for dirpath, dirnames, filenames in os.walk(_PKG_ROOT):
            dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_build")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    self._table(_relpath(os.path.join(dirpath, fn)))

    def stale(self) -> List[Diagnostic]:
        out: List[Diagnostic] = []
        for relpath, table in sorted(self._tables.items()):
            out.extend(_pragmas.stale_findings(
                table, self.used.get(relpath, ()), self.plane, relpath))
        return out


# ---------------------------------------------------------------------------
# T101-T103
# ---------------------------------------------------------------------------


def _site_str(node) -> str:
    src, line = node_site(node)
    return f"{src}:{line}" if src else "?"


def _is_d2h_copy(node) -> bool:
    if op_name(node) not in ("aten._to_copy", "aten.copy_", "aten.copy"):
        return False
    src = node.args[1] if op_name(node) != "aten._to_copy" else node.args[0]
    if op_name(node) == "aten.copy_":
        dst_dev = node.args[0].meta.get("device") if hasattr(node.args[0], "meta") else None
    else:
        dst_dev = node.meta.get("device")
    src_dev = src.meta.get("device") if hasattr(src, "meta") else None
    return (src_dev is not None and dst_dev is not None
            and src_dev.type == "cuda" and dst_dev.type == "cpu")


def _is_sync(node) -> bool:
    name = op_name(node)
    if name in _SYNC_OPS:
        return True
    if name == "aten.index" and any(
            hasattr(i, "meta") and i.meta.get("dtype") == torch.bool
            for i in (node.args[1] if len(node.args) > 1 else ()) if i is not None):
        return True  # a boolean mask index: nonzero inside
    return _is_d2h_copy(node)


def _first_site(nodes) -> Tuple[Optional[str], Optional[int]]:
    for n in nodes:
        src, line = node_site(n)
        if src:
            return src, line
    return None, None


def lint_graph(
    traced: TracedStep,
    *,
    const_elem_threshold: int = DEFAULT_CONST_ELEMS,
    source: Optional[str] = None,
    apply_pragmas: bool = True,
    _filter: Optional[SitePragmaFilter] = None,
) -> List[Diagnostic]:
    """Hazard-scan a traced step: T101 f64 values, T102 closure-captured
    tensor constants, T103 host syncs (counted per step).  An op whose
    issuing line carries a ``# trace: allow[...]`` pragma is exempt."""
    f = (_filter or SitePragmaFilter("trace")) if apply_pragmas else None

    def kept(rule, nodes):
        if f is None:
            return list(nodes)
        return [n for n in nodes if not f.suppresses(rule, *node_site(n))]

    gm = traced.graph_module
    f64_nodes, const_nodes, sync_nodes = [], [], []
    for n in traced.graph.nodes:
        if n.op == "get_attr":
            c = getattr(gm, n.target, None)
            if torch.is_tensor(c):
                if c.numel() >= const_elem_threshold:
                    const_nodes.append(n)
                if c.dtype == torch.float64:
                    f64_nodes.append(n)
        elif n.op == "call_function":
            if any(m is not None and m[0] == torch.float64 for m in n.meta.get("tensors", ())):
                f64_nodes.append(n)
            if _is_sync(n):
                sync_nodes.append(n)

    diags: List[Diagnostic] = []
    f64_nodes = kept("T101", f64_nodes)
    if f64_nodes:
        sites = []
        for n in f64_nodes:
            if n.op == "get_attr":
                sites.append(f"constant {n.meta.get('shape')}")
            elif op_name(n) == "aten._to_copy":
                sites.append(f"_to_copy -> float64 at {_site_str(n)}")
            else:
                sites.append(f"{op_name(n)} output at {_site_str(n)}")
        uniq = sorted(set(sites))
        src, line = (source, None) if source else _first_site(f64_nodes)
        diags.append(Diagnostic(
            rule="T101", severity=Severity.ERROR, source=src, line=line,
            message=f"float64 values in the traced step: {uniq[:6]}"
            + (f" (+{len(uniq) - 6} more)" if len(uniq) > 6 else ""),
            hint="the card runs f64 at a small fraction of its f32 rate; find "
            "the float64 tensor or cast, or justify it with "
            "`# trace: allow[T101] <why>` on its line",
        ))
    const_nodes = kept("T102", const_nodes)
    if const_nodes:
        big = [f"{tuple(getattr(gm, n.target).shape)} {getattr(gm, n.target).dtype} "
               f"({getattr(gm, n.target).numel()} elems)" for n in const_nodes]
        src, line = (source, None) if source else _first_site(const_nodes)
        diags.append(Diagnostic(
            rule="T102", severity=Severity.WARNING, source=src, line=line,
            message="large tensors are baked into the traced step as constants "
            f"instead of arguments: {big[:4]}"
            + (f" (+{len(big) - 4} more)" if len(big) > 4 else ""),
            hint="a closure captured weights or batch data — pass them as "
            "arguments of the step",
        ))
    sync_nodes = kept("T103", sync_nodes)
    if sync_nodes:
        counts: Dict[str, int] = {}
        for n in sync_nodes:
            what = "d2h copy" if _is_d2h_copy(n) else op_name(n)
            key = f"{what} at {_site_str(n)}"
            counts[key] = counts.get(key, 0) + 1
        src, line = (source, None) if source else _first_site(sync_nodes)
        diags.append(Diagnostic(
            rule="T103", severity=Severity.WARNING, source=src, line=line,
            message=f"{len(sync_nodes)} host sync(s) per step inside the traced "
            f"step: {dict(sorted(counts.items()))}",
            hint="each is a device->host round trip per step; keep decisions "
            "on the device (torch.where) or fetch once per step",
        ))
    return diags


# the JAX package's name for the graph scan
lint_jaxpr = lint_graph


def lint_step(
    fn,
    *example_args,
    const_elem_threshold: int = DEFAULT_CONST_ELEMS,
    source: Optional[str] = None,
    apply_pragmas: bool = True,
    _filter: Optional[SitePragmaFilter] = None,
    **example_kwargs,
) -> List[Diagnostic]:
    """Trace ``fn`` on example args and hazard-scan the result."""
    return lint_graph(
        trace_step(fn, *example_args, **example_kwargs),
        const_elem_threshold=const_elem_threshold, source=source,
        apply_pragmas=apply_pragmas, _filter=_filter,
    )


# ---------------------------------------------------------------------------
# buffer-donation audit (T106)
# ---------------------------------------------------------------------------


def _schema(node):
    return getattr(node.target, "_schema", None)


def _written_args(node) -> List[Any]:
    """The argument values an op writes in place (its ``a!`` arguments)."""
    sch = _schema(node)
    if sch is None:
        return []
    out = []
    for i, arg in enumerate(sch.arguments):
        ai = arg.alias_info
        if ai is None or not ai.is_write:
            continue
        val = node.args[i] if i < len(node.args) else node.kwargs.get(arg.name)
        out.extend(val if isinstance(val, (list, tuple)) else [val])
    return [v for v in out if hasattr(v, "op")]


def _aliases_first_arg(node) -> bool:
    sch = _schema(node)
    return bool(sch is not None and sch.returns and sch.returns[0].alias_info is not None
                and node.args and hasattr(node.args[0], "op"))


def _storage_roots(traced: TracedStep) -> Dict[Any, Any]:
    """node -> the placeholder whose storage it is (through views and
    in-place ops), for the nodes that are one."""
    roots: Dict[Any, Any] = {}
    for n in traced.graph.nodes:
        if n.op == "placeholder":
            roots[n] = n
        elif n.op == "call_function" and _aliases_first_arg(n):
            r = roots.get(n.args[0])
            if r is not None:
                roots[n] = r
    return roots


def _is_clone(node) -> bool:
    """A same-dtype, same-device copy of its first argument."""
    name = op_name(node)
    if name not in ("aten.clone", "aten._to_copy", "aten.copy") or not node.args:
        return False
    src = node.args[0]
    return (hasattr(src, "meta") and src.meta.get("dtype") == node.meta.get("dtype")
            and src.meta.get("device") == node.meta.get("device"))


def donation_audit(
    fn,
    *example_args,
    donate_argnums: Optional[Sequence[int]] = None,
    carry_elem_threshold: int = DEFAULT_CONST_ELEMS,
    source: Optional[str] = None,
    apply_pragmas: bool = True,
    _filter: Optional[SitePragmaFilter] = None,
) -> List[Diagnostic]:
    """T106: flag large carried buffers that are not updated in place.

    The port's donation is an update in place: the step writes its new
    parameters and optimizer slots into the input tensors, so one
    generation is held.  Two patterns hold two:

    * an input leaf of ``carry_elem_threshold``+ elements that is not
      written in place while a fresh output of its (shape, dtype) leaves
      the step (the JAX package's aliasing heuristic) — unless its argnum
      is in ``donate_argnums``, the caller's promise to drop its reference
      to the old value;
    * an input leaf the step clones and then writes in place (a snapshot
      kept beside the carry for the length of the step).

    A clone whose line carries ``# trace: allow[T106] <why>`` is exempt."""
    traced = trace_step(fn, *example_args)
    f = (_filter or SitePragmaFilter("trace")) if apply_pragmas else None
    phs = traced.placeholders()
    roots = _storage_roots(traced)
    written: Set[Any] = set()
    clones: Dict[Any, List[Any]] = {}
    for n in traced.graph.nodes:
        if n.op != "call_function":
            continue
        for w in _written_args(n):
            r = roots.get(w)
            if r is not None:
                written.add(r)
        if _is_clone(n) and roots.get(n.args[0]) is not None:
            clones.setdefault(roots[n.args[0]], []).append(n)

    fresh_sigs: Set[tuple] = set()
    for v in traced.output_values():
        if hasattr(v, "op") and roots.get(v) is None and v.meta.get("shape") is not None:
            fresh_sigs.add((v.meta["shape"], v.meta["dtype"]))
    donated = set(donate_argnums or ())

    fresh: Dict[int, List[Tuple[str, int]]] = {}
    cloned: Dict[int, List[Tuple[str, int]]] = {}
    for ph, argnum in zip(phs, traced.in_argnums):
        shape, dtype = ph.meta.get("shape"), ph.meta.get("dtype")
        if shape is None or not shape:
            continue
        size = 1
        for d in shape:
            size *= int(d)
        if size < carry_elem_threshold:
            continue
        nbytes = size * dtype.itemsize
        sig = f"{shape} {str(dtype).replace('torch.', '')}"
        if ph in written:
            snaps = [c for c in clones.get(ph, ())
                     if f is None or not f.suppresses("T106", *node_site(c))]
            if snaps:
                cloned.setdefault(argnum, []).append((sig, nbytes, snaps[0]))
        elif argnum not in donated and (shape, dtype) in fresh_sigs:
            fresh.setdefault(argnum, []).append((sig, nbytes, None))

    diags: List[Diagnostic] = []
    for argnum in sorted(set(fresh) | set(cloned)):
        for kind, items in (("fresh", fresh.get(argnum)), ("clone", cloned.get(argnum))):
            if not items:
                continue
            shapes = [s for s, _, _ in items]
            mb = sum(b for _, b, _ in items) / 1e6
            more = f" (+{len(shapes) - 4} more)" if len(shapes) > 4 else ""
            if kind == "fresh":
                msg = (f"argument {argnum} carries {len(shapes)} large buffer(s) ({mb:.1f} MB) "
                       f"returned updated but NOT donated (not written in place): "
                       f"{shapes[:4]}{more}")
                src, line = source, None
            else:
                msg = (f"argument {argnum} carries {len(shapes)} large buffer(s) ({mb:.1f} MB) "
                       f"that the step clones and writes back in place (2x held): "
                       f"{shapes[:4]}{more}")
                src, line = (source, None) if source else node_site(items[0][2])
            diags.append(Diagnostic(
                rule="T106", severity=Severity.WARNING, source=src, line=line, message=msg,
                hint="update carried state (params/opt-state/carry) in place, the "
                "port's donation — a fresh or cloned carry holds 2x the state and "
                "copies it every step",
            ))
    return diags


# ---------------------------------------------------------------------------
# recompile-churn audit (T104/T105)
# ---------------------------------------------------------------------------


def recompile_audit(
    observed,
    *,
    ladder: Sequence[int] = DEFAULT_LADDER,
    sub_ladder: Sequence[int] = DEFAULT_SUB_LADDER,
    max_shapes: Optional[int] = None,
    source: Optional[str] = None,
) -> List[Diagnostic]:
    """Replay observed batch shapes against the shape-ladder contract.

    ``observed`` is a ``CompileShapeCache`` (its ``.shapes`` keys), an
    iterable of feeder batches, or an iterable of ``batch_shape_key``
    results.  Each distinct key is one shape the step sees (the cache's
    miss accounting, core/compiler.py); a laddered feed keeps them bounded
    by rung combinations, so off-ladder extents and key explosion are the
    two churn signatures worth flagging.

    T104 flags only axes whose extent VARIES across the observed keys: a
    static extent (a dense feature width, a fixed batch size) is one shape
    no matter what it is, while a varying axis off the ladder means one
    shape per distinct length — the churn signature."""
    keys = _as_shape_keys(observed)
    rungs = set(ladder) | set(sub_ladder)
    diags: List[Diagnostic] = []

    # per (slot, axis>=1): the set of extents observed across keys
    extents: Dict[Tuple[str, int], set] = {}
    for key in keys:
        for name, shape, _dtype in key:
            for axis, ext in enumerate(shape):
                if axis >= 1:
                    extents.setdefault((name, axis), set()).add(int(ext))

    off: List[str] = []
    for (name, axis), vals in sorted(extents.items()):
        if len(vals) <= 1:
            continue  # static axis: one shape regardless of value
        bad = sorted(
            v for v in vals
            if v > 1 and v not in rungs and not _is_rung_multiple(v, ladder)
        )
        if bad:
            off.append(f"{name} axis {axis}: {bad}")
    if off:
        uniq = sorted(set(off))
        diags.append(Diagnostic(
            rule="T104", severity=Severity.WARNING, source=source,
            message=f"batch shapes pad off the bucketing ladder: {uniq[:5]}"
            + (f" (+{len(uniq) - 5} more)" if len(uniq) > 5 else ""),
            hint="route the feed through reader.bucketing + "
            "DataFeeder(ladder=...) (use_bucketing flag) so every padded "
            "extent is a 16*2^k rung and compiles stay bounded",
        ))

    budget = max_shapes if max_shapes is not None else max(8, 2 * len(ladder))
    if len(keys) > budget:
        diags.append(Diagnostic(
            rule="T105", severity=Severity.WARNING, source=source,
            message=f"{len(keys)} distinct batch shapes observed (budget "
            f"{budget}) — the step recompiles per batch, not per rung",
            hint="enable bucketing, pin drop_last=True, or tie the "
            "token-budget batcher to the dominant sequence slot so rung "
            "combinations collapse",
        ))
    return diags


def _is_rung_multiple(ext: int, ladder: Sequence[int]) -> bool:
    """Past the top rung, ladder_len canonicalizes to multiples of it."""
    top = ladder[-1] if ladder else 0
    return bool(top) and ext > top and ext % top == 0


def _as_shape_keys(observed) -> List[tuple]:
    shapes = getattr(observed, "shapes", None)
    if isinstance(shapes, dict):  # CompileShapeCache
        return list(shapes)
    keys = []
    for item in observed:
        if isinstance(item, tuple) and item and isinstance(item[0], tuple):
            keys.append(item)  # already a shape key
        else:
            keys.append(batch_shape_key(item))
    return list(dict.fromkeys(keys))
