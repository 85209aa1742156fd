"""Precision-flow lint — dtype/numerics dataflow over the traced train step;
the counterpart of ``paddle_tpu/analysis/numerics_lint.py``.

The trace linter (``analysis.trace_lint``) finds structural hazards (f64,
captured weights, host syncs); this pass reasons about PRECISION: where a
low-precision value accumulates, escapes into master state, or walks into
an op whose domain it cannot survive.  It walks the FX graph of one traced
step (``trace_lint.trace_step``: forward, backward and the in-place update)
node by node, with the JAX package's abstract values: each node's dtype,
its statically known scalar constant and the producing op, over which the
guard analysis runs.  aten ops are read under the JAX primitive they
compute (``aten.where`` is ``select_n``, ``aten.clamp(min=)`` is ``max``,
``aten.amax`` is ``reduce_max``, ``aten.mm`` is ``dot_general`` ...), so
the rules below are the JAX package's, line for line, where their subjects
agree.

Rules (``N###``) and their torch subjects:

  N401 low-precision-accumulation   a bf16/f16 mm/bmm/addmm/baddbmm/
                                    convolution while cuBLAS may reduce in
                                    the operand type (the
                                    ``allow_bf16/fp16_reduced_precision_
                                    reduction`` switches read True when the
                                    trace is taken; ops/__init__.py pins
                                    them False for sub-f32 compute); a long
                                    sub-f32 ``cumsum``; a chain of more
                                    than ACCUM_EXTENT_THRESHOLD sub-f32
                                    adds, each over the previous sum, that
                                    a Python-loop recurrence carries (the
                                    JAX package's scan-carry accumulator,
                                    unrolled).  Differs by design: a torch
                                    ``sum``/``mean`` over bf16 accumulates
                                    in f32 inside the kernel, so it never
                                    fires, and the flash-attention custom
                                    op declares f32 accumulation
  N402 master-precision-escape      a params/opt-state leaf that leaves
                                    the step at another dtype than the
                                    master, or whose in-place update
                                    writes an upcast sub-f32 value
  N403 unguarded-domain-hazard      exp/log/rsqrt/div whose input is not
                                    range-guarded (the masked-softmax
                                    max-subtraction, an epsilon idiom, a
                                    clamp), as in the JAX package
  N404 sentinel-literal-overflow    a finite fill literal (``where``,
                                    ``masked_fill``, ``full``, a cast of a
                                    constant) out of range for the target
                                    dtype: the ``-1e9`` idiom under f16
  N405 low-precision-psum           no torch subject: the port has no
                                    collective until a device mesh is
                                    ported (ROADMAP Queue 1 item 6); the
                                    rule id is kept and the rule finds
                                    nothing
  N406 dtype-roundtrip-churn        cast chains f32→bf16→f32

Allowlist pragma (shared grammar, analysis.pragmas), anchored on the
source line that ISSUES the op (``meta["site"]`` of the node; for a
backward op, the forward line that created it)::

    alpha = torch.exp(score)  # num: allow[N403] scores are clipped upstream

``certify_precision_plan(topology, plan)`` statically verifies a proposed
compute-dtype/master-dtype split over the real train step and renders a
per-layer precision certificate.

Run via ``python -m paddle_tpu_torch lint --numerics [--config ...
--compute-dtype ...]``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from paddle_tpu_torch.analysis.trace_lint import (
    SitePragmaFilter,
    TracedStep,
    node_layer,
    node_site,
    op_name,
    trace_step,
)

__all__ = [
    "PrecisionCertificate",
    "certify_precision_plan",
    "lint_numerics_graph",
    "lint_numerics_jaxpr",
    "lint_numerics_step",
    "lint_numerics_config",
    "lint_numerics_package",
]

# sub-f32 floating dtypes ("low precision" throughout)
_LOW_FLOATS = frozenset({torch.float16, torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2})
# reductions under this extent are numerically safe even in bf16 (the
# partial-sum count is too small to lose mantissa); longer ones need an f32
# accumulator
ACCUM_EXTENT_THRESHOLD = 32

# ops a guard/constant fact flows through unchanged
# (the aten views, detach and same-dtype copies all read as "reshape" and
# "copy": see _translate)
_TRANSPARENT = frozenset({"convert_element_type", "reshape", "copy"})
# ops with intrinsically bounded outputs (exp of them cannot overflow)
_BOUNDED_PRIMS = frozenset({
    "logistic", "tanh", "erf", "sin", "cos", "sign", "clamp",
    "softmax", "log_softmax",
})
# ops with non-negative outputs (log/div/rsqrt of them + eps is safe)
_POSITIVE_PRIMS = frozenset({"exp", "abs", "square", "logistic", "softmax"})

_GEMMS = frozenset({"dot_general", "conv_general_dilated"})


def _is_low(dtype) -> bool:
    return dtype is not None and dtype in _LOW_FLOATS


def _is_float(dtype) -> bool:
    return isinstance(dtype, torch.dtype) and dtype.is_floating_point


def _short(dtype) -> str:
    return str(dtype).replace("torch.", "")


def as_dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype from a name or dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    got = getattr(torch, str(dtype), None)
    if not isinstance(got, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return got


# ---------------------------------------------------------------------------
# abstract values + the node walk
# ---------------------------------------------------------------------------


class _Val:
    """One dataflow value: producing primitive, input links, optionally a
    statically-known scalar constant."""

    __slots__ = ("kind", "prim", "node", "ins", "const", "dtype", "shape", "params")

    def __init__(self, kind, dtype, prim="", node=None, ins=(), const=None, shape=None,
                 params=None):
        self.kind = kind          # "input" | "const" | "op" | "opaque"
        self.dtype = dtype
        self.prim = prim
        self.node = node
        self.ins = tuple(ins)
        self.const = const        # known scalar float, else None
        self.shape = shape
        self.params = params or {}


@dataclasses.dataclass
class _Visit:
    """One analyzed node with resolved operand values."""

    node: Any
    prim: str
    invals: Tuple[_Val, ...]
    outvals: Tuple[_Val, ...]
    params: Dict[str, Any]


def _scalar_of(t) -> Optional[float]:
    try:
        if torch.is_tensor(t):
            if t.numel() != 1:
                return None
            return float(t.detach().reshape(()).to("cpu", torch.float64))
        if isinstance(t, bool):
            return float(t)
        if isinstance(t, (int, float)):
            return float(t)
    except Exception:  # noqa: BLE001 — exotic consts just lose const-ness
        return None
    return None


def _lit(x) -> _Val:
    """A Python scalar argument: a constant with no dtype of its own."""
    return _Val("const", None, const=_scalar_of(x))


_VIEWS = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "permute", "t", "transpose",
    "squeeze", "unsqueeze", "slice", "select", "alias", "clone", "contiguous",
    "detach", "lift_fresh_copy", "as_strided", "unfold", "narrow", "split",
    "split_with_sizes", "chunk", "unbind", "expand_as", "view_as", "flatten",
})
_UNARY = {
    "exp": "exp", "log": "log", "log1p": "log1p", "rsqrt": "rsqrt", "sqrt": "sqrt",
    "tanh": "tanh", "sigmoid": "logistic", "erf": "erf", "sin": "sin", "cos": "cos",
    "sign": "sign", "abs": "abs", "neg": "neg", "square": "square",
    "_softmax": "softmax", "_log_softmax": "log_softmax",
}
_BINARY = {"add": "add", "sub": "sub", "mul": "mul", "div": "div", "maximum": "max",
           "minimum": "min", "eq": "eq", "ne": "ne", "ge": "ge", "le": "le", "gt": "gt",
           "lt": "lt", "clamp_min": "max", "clamp_max": "min", "true_divide": "div"}
# the GEMMs as the dispatcher sees them (matmul and linear decompose into
# these): operand positions
_GEMM_ARGS = {"mm": (0, 1), "bmm": (0, 1), "dot": (0, 1), "mv": (0, 1),
              "addmm": (1, 2), "baddbmm": (1, 2), "addbmm": (1, 2), "addmv": (1, 2)}
_CONVS = frozenset({"convolution", "_convolution", "convolution_backward"})
_FILLS = frozenset({"full", "full_like", "new_full", "scalar_tensor", "fill"})


def _base(node) -> Tuple[str, str]:
    """(namespace-free op name without an in-place underscore, overload)."""
    t = node.target
    name = getattr(t, "_opname", None) or getattr(t, "__name__", str(t))
    if name.endswith("_") and not name.startswith("_"):
        name = name[:-1]
    return name, getattr(t, "_overloadname", "")


def _translate(node, arg):
    """(prim, operand values, params) of one call_function node, under the
    JAX primitive it computes."""
    name, ovl = _base(node)
    a = node.args
    ns = getattr(node.target, "namespace", None)
    if ns == "paddle_tpu_torch":
        # the flash-attention custom ops: opaque, f32-accumulating
        return ("flash_attention" if "fwd" in name else "flash_attention_bwd",
                [arg(x) for x in a if hasattr(x, "op")], {})
    if name == "getitem":
        return "getitem", [], {}
    if name in _UNARY:
        return _UNARY[name], [arg(a[0])], {}
    if name == "relu":
        return "max", [arg(a[0]), _lit(0.0)], {}
    if name in ("max", "min") and ovl in ("other",):
        return name, [arg(a[0]), arg(a[1])], {}
    if name in ("amax", "max"):
        return "reduce_max", [arg(a[0])], {}
    if name in ("amin", "min"):
        return "reduce_min", [arg(a[0])], {}
    if name in _BINARY and len(a) >= 2:
        return _BINARY[name], [arg(a[0]), arg(a[1])], {}
    if name == "rsub":
        return "sub", [arg(a[1]), arg(a[0])], {}
    if name == "reciprocal":
        return "div", [_lit(1.0), arg(a[0])], {}
    if name == "clamp":
        lo = a[1] if len(a) > 1 else node.kwargs.get("min")
        hi = a[2] if len(a) > 2 else node.kwargs.get("max")
        if lo is not None and hi is None:
            return "max", [arg(a[0]), arg(lo)], {}
        if hi is not None and lo is None:
            return "min", [arg(a[0]), arg(hi)], {}
        return "clamp", [arg(a[0])], {}
    if name in ("sum", "mean", "nansum"):
        return "reduce_sum", [arg(a[0])], {"torch_sum": True}
    if name == "cumsum":
        return "cumsum", [arg(a[0])], {"axis": a[1] if len(a) > 1 else node.kwargs.get("dim")}
    if name == "_to_copy":
        src = a[0]
        changes = hasattr(src, "meta") and src.meta.get("dtype") != node.meta.get("dtype")
        return ("convert_element_type" if changes else "copy"), [arg(src)], {}
    if name == "copy":
        # copy(self, src) / copy_(self, src): the value written is src's
        return "copy", [arg(a[1])], {}
    if name in _VIEWS:
        return "reshape", [arg(a[0])], {}
    if name == "where":
        if ovl == "self":
            return "select_n", [arg(a[0]), arg(a[2]), arg(a[1])], {}
        if ovl in ("ScalarOther", "Scalar", "ScalarSelf"):
            return "select_n", [arg(a[0]), arg(a[2]), arg(a[1])], {}
    if name == "masked_fill":
        return "select_n", [arg(a[1]), arg(a[0]), arg(a[2])], {}
    if name == "pow" and ovl == "Tensor_Scalar":
        e = _scalar_of(a[1])
        if e is not None and e == int(e) and int(e) % 2 == 0 and e > 0:
            return "integer_pow", [arg(a[0])], {"y": int(e)}
        if e == 1.0:
            return "copy", [arg(a[0])], {}
        if e == 0.5:
            return "sqrt", [arg(a[0])], {}
        if e == -0.5:
            return "rsqrt", [arg(a[0])], {}
        if e == -1.0:
            return "div", [_lit(1.0), arg(a[0])], {}
        return "pow", [arg(a[0])], {}
    if name in _GEMM_ARGS:
        i, j = _GEMM_ARGS[name]
        return "dot_general", [arg(a[i]), arg(a[j])], {}
    if name in _CONVS:
        return "conv_general_dilated", [arg(a[0]), arg(a[1])], {}
    if name in _FILLS:
        value = a[-1] if name in ("fill", "full", "new_full", "full_like") else a[0]
        return "full", [_lit(value)], {}
    ops = []
    for x in a:
        for y in (x if isinstance(x, (list, tuple)) else (x,)):
            if hasattr(y, "op"):
                ops.append(arg(y))
    return op_name(node), ops, {}


class _Walker:
    """Walk a traced step's nodes in order into `_Visit`s, with the input
    values labelled and scalar constants propagated."""

    def __init__(self) -> None:
        self.visits: List[_Visit] = []
        self.loop_carries: List[Tuple[_Visit, int]] = []
        self._chain: Dict[int, int] = {}

    def walk(self, traced: TracedStep) -> List[_Val]:
        gm = traced.graph_module
        env: Dict[Any, Any] = {p: _Val("input", p.meta.get("dtype"), shape=p.meta.get("shape"))
                               for p in traced.placeholders()}

        def arg(x):
            if hasattr(x, "op"):
                got = env.get(x)
                if isinstance(got, list):
                    got = got[0] if got else None
                return got if got is not None else _Val("opaque", x.meta.get("dtype"))
            return _lit(x)

        out_vals: List[_Val] = []
        for n in traced.graph.nodes:
            if n.op == "get_attr":
                c = getattr(gm, n.target, None)
                env[n] = _Val("const", getattr(c, "dtype", None), const=_scalar_of(c),
                              shape=n.meta.get("shape"))
            elif n.op == "call_function":
                env[n] = self._node(n, arg, env)
            elif n.op == "output":
                out_vals = [arg(v) for v in traced.output_values()]
        return out_vals

    def _node(self, n, arg, env):
        prim, ins, params = _translate(n, arg)
        if prim == "getitem":
            src = env.get(n.args[0])
            idx = n.args[1]
            if isinstance(src, list) and isinstance(idx, int) and idx < len(src):
                return src[idx]
            return _Val("opaque", n.meta.get("dtype"), shape=n.meta.get("shape"))
        metas = n.meta.get("tensors") or [None]
        outs = []
        for m in metas:
            dtype, shape = (m[0], m[1]) if m else (None, None)
            outs.append(_Val("op", dtype, prim=prim, node=n, ins=ins,
                             const=_const_out(prim, ins), shape=shape, params=params))
        visit = _Visit(node=n, prim=prim, invals=tuple(ins), outvals=tuple(outs), params=params)
        self.visits.append(visit)
        if prim == "add" and _is_low(outs[0].dtype):
            depth = 1 + max((self._chain.get(id(src), 0) for x in ins
                             for src in (_through_transparent(x),)), default=0)
            self._chain[id(outs[0])] = depth
            if depth == ACCUM_EXTENT_THRESHOLD + 1:
                self.loop_carries.append((visit, depth))
        return outs if len(outs) > 1 else outs[0]


def _through_transparent(v: _Val, depth: int = 0) -> _Val:
    while v.kind == "op" and v.prim in _TRANSPARENT and v.ins and depth < 6:
        v, depth = v.ins[0], depth + 1
    return v


def _const_out(prim, invals) -> Optional[float]:
    """Propagate known scalar constants through shape-transparent ops and
    casts — the -1e9 literal must still be known when its cast happens."""
    if prim in _TRANSPARENT and invals and invals[0].const is not None:
        return invals[0].const
    if prim == "neg" and invals and invals[0].const is not None:
        return -invals[0].const
    if prim == "full" and invals:
        return invals[0].const
    return None


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------


def _diag(rule, severity, message, node, hint=None) -> Diagnostic:
    src, line = node_site(node) if node is not None else (None, None)
    return Diagnostic(rule=rule, severity=severity, message=message,
                      layer=node_layer(node) if node is not None else None,
                      source=src, line=line, hint=hint)


# ---------------------------------------------------------------------------
# guard analysis (N403), as in the JAX package
# ---------------------------------------------------------------------------


def _bounded_above(val: _Val, depth: int = 0) -> bool:
    """Conservatively true when ``val`` cannot grow without bound upward —
    exp of it cannot overflow.  The masked-softmax idiom (subtract the
    running max) is the canonical positive pattern."""
    if depth > 12:
        return False
    if val.const is not None:
        return math.isfinite(val.const)
    if val.kind != "op":
        return False
    p = val.prim
    if p in _BOUNDED_PRIMS:
        return True
    if p in _TRANSPARENT or p in ("reduce_max", "reduce_min", "max", "min"):
        # min/max against a bounded operand bounds the result
        if p in ("max", "min"):
            return any(_bounded_above(x, depth + 1) for x in val.ins)
        return bool(val.ins) and _bounded_above(val.ins[0], depth + 1)
    if p == "sub":
        # x - max(x): subtracting a value derived from a running max of the
        # same tensor bounds above at 0
        return len(val.ins) == 2 and _contains_prim(val.ins[1], "reduce_max", depth + 1)
    if p == "neg":
        return bool(val.ins) and _non_negative(val.ins[0], depth + 1)
    if p == "mul":
        # scaling by a finite constant preserves boundedness
        return any(x.const is not None and math.isfinite(x.const) for x in val.ins) and any(
            _bounded_above(x, depth + 1) for x in val.ins)
    if p == "add":
        return all(_bounded_above(x, depth + 1) for x in val.ins)
    return False


def _contains_prim(val: _Val, prim: str, depth: int = 0) -> bool:
    if depth > 12 or val.kind != "op":
        return False
    if val.prim == prim:
        return True
    if val.prim in _TRANSPARENT or val.prim in ("max", "min", "mul", "add", "sub", "select_n"):
        return any(_contains_prim(x, prim, depth + 1) for x in val.ins)
    return False


def _non_negative(val: _Val, depth: int = 0) -> bool:
    if depth > 12:
        return False
    if val.const is not None:
        return val.const >= 0.0
    if val.kind != "op":
        return False
    p = val.prim
    if p in _POSITIVE_PRIMS:
        return True
    if p in _TRANSPARENT:
        return bool(val.ins) and _non_negative(val.ins[0], depth + 1)
    if p in ("reduce_sum", "reduce_max", "reduce_min", "cumsum"):
        return bool(val.ins) and _non_negative(val.ins[0], depth + 1)
    if p in ("add", "mul", "max", "min", "div"):
        if p == "max":
            return any(_non_negative(x, depth + 1) for x in val.ins)
        return all(_non_negative(x, depth + 1) for x in val.ins)
    if p == "integer_pow" and int(val.params.get("y", 0)) % 2 == 0:
        return True
    if p == "sqrt":
        return True
    return False


def _is_tie_count(val: _Val, depth: int = 0) -> bool:
    """``convert(eq(x, broadcast(reduce_max(x))))`` — the membership mask
    the max/min gradient divides its tie count by; at least one element
    equals its own running max, so the summed count is >= 1."""
    if depth > 12 or val.kind != "op":
        return False
    if val.prim in _TRANSPARENT:
        return bool(val.ins) and _is_tie_count(val.ins[0], depth + 1)
    if val.prim in ("eq", "ge", "le"):
        return any(_contains_prim(x, "reduce_max", depth + 1)
                   or _contains_prim(x, "reduce_min", depth + 1) for x in val.ins)
    return False


def _nonzero_rescale_of(val: _Val, t: _Val, depth: int = 0) -> bool:
    """True when ``val`` is ``t`` itself scaled only by finite nonzero
    constants (through shape-transparent ops)."""
    if depth > 8:
        return False
    if val is t:
        return True
    if val.kind != "op":
        return False
    if val.prim in _TRANSPARENT:
        return bool(val.ins) and _nonzero_rescale_of(val.ins[0], t, depth + 1)
    if val.prim in ("mul", "div"):
        hit = False
        for x in val.ins:
            if _nonzero_rescale_of(x, t, depth + 1):
                hit = True
            elif not (x.const is not None and math.isfinite(x.const) and x.const != 0.0):
                return False
        return hit
    return False


def _positive_guarded(val: _Val, depth: int = 0) -> bool:
    """True when ``val`` is bounded away from zero from below — an epsilon
    idiom (`x + 1e-6`, `clamp(x, min=eps)`), a nonzero constant, or a
    softmax denominator."""
    if depth > 12:
        return False
    if val.const is not None:
        return math.isfinite(val.const) and val.const != 0.0
    if val.kind != "op":
        return False
    p = val.prim
    if p in _TRANSPARENT:
        return bool(val.ins) and _positive_guarded(val.ins[0], depth + 1)
    if p == "add":
        # x + eps with eps a positive constant (the epsilon idiom), or a
        # sum of guarded terms
        if any(x.const is not None and x.const > 0.0 for x in val.ins):
            return True
        return all(_positive_guarded(x, depth + 1) for x in val.ins)
    if p == "max":
        return any((x.const is not None and x.const > 0.0) or _positive_guarded(x, depth + 1)
                   for x in val.ins)
    if p == "exp":
        # exp(x - max(x)): at least one term is exp(0) = 1
        return bool(val.ins) and _contains_prim(val.ins[0], "reduce_max", depth + 1)
    if p == "softmax":
        return True  # the fused softmax: its max term is exp(0) / sum >= 1 / n
    if p == "select_n":
        # every selectable branch guarded
        if len(val.ins) > 1 and all(_positive_guarded(x, depth + 1) for x in val.ins[1:]):
            return True
        # the zero-switch idiom `where(t == 0, c, t*s)`
        pred = val.ins[0] if val.ins else None
        if (len(val.ins) == 3 and pred is not None and pred.kind == "op"
                and pred.prim == "eq" and pred.ins):
            t = next((x for x in pred.ins if x.const is None), None)
            against_zero = any(x.const == 0.0 for x in pred.ins if x.const is not None)
            if (t is not None and against_zero and _positive_guarded(val.ins[2], depth + 1)
                    and _nonzero_rescale_of(val.ins[1], t)):
                return True
        return False
    if p in ("reduce_sum", "cumsum"):
        if bool(val.ins) and _is_tie_count(val.ins[0], depth + 1):
            return True
        return bool(val.ins) and _positive_guarded(val.ins[0], depth + 1)
    if p in ("mul", "div"):
        return all(_positive_guarded(x, depth + 1) for x in val.ins)
    if p in ("sqrt", "rsqrt"):
        return bool(val.ins) and _positive_guarded(val.ins[0], depth + 1)
    return False


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _contraction_extent(v: _Visit) -> int:
    a = v.invals[0] if v.invals else None
    shape = a.shape if a is not None else None
    if not shape:
        return ACCUM_EXTENT_THRESHOLD
    if v.prim == "conv_general_dilated":
        w = v.invals[1].shape if len(v.invals) > 1 else None
        if w and len(w) > 1:
            ext = 1
            for d in w[1:]:
                ext *= int(d)
            return ext
        return ACCUM_EXTENT_THRESHOLD
    return int(shape[-1])


def _rule_n401(visits, loop_carries, reduced: bool, diags) -> None:
    for v in visits:
        if v.prim in _GEMMS:
            opdt = [x.dtype for x in v.invals[:2]]
            if not (reduced and opdt and all(_is_low(d) for d in opdt)):
                continue
            ext = _contraction_extent(v)
            if v.prim == "dot_general" and ext < ACCUM_EXTENT_THRESHOLD:
                continue
            diags.append(_diag(
                "N401", Severity.ERROR,
                f"{op_name(v.node)} on {_short(opdt[0])} operands (contraction extent "
                f"{ext}) while cuBLAS may reduce in {_short(opdt[0])} "
                "(allow_bf16/fp16_reduced_precision_reduction is True) — partial "
                "sums truncate", v.node,
                hint="set torch.backends.cuda.matmul.allow_bf16_reduced_precision_"
                "reduction (and the fp16 switch) False — paddle_tpu_torch.init("
                "compute_dtype=...) and CompiledNetwork do (ops.pin_f32_accumulation)",
            ))
        elif v.prim == "cumsum":
            x = v.invals[0] if v.invals else None
            if x is None or not _is_low(x.dtype) or not _is_low(v.outvals[0].dtype):
                continue
            axis = v.params.get("axis")
            try:
                ext = int(x.shape[axis])
            except (TypeError, IndexError):
                ext = ACCUM_EXTENT_THRESHOLD
            if ext < ACCUM_EXTENT_THRESHOLD:
                continue
            diags.append(_diag(
                "N401", Severity.ERROR,
                f"cumsum over {ext} elements in {_short(x.dtype)} — a long "
                "low-precision running reduction loses mantissa with every partial",
                v.node,
                hint="reduce in f32: x.float().cumsum(...) and cast back (a torch "
                "sum/mean already accumulates in f32)",
            ))
    for v, depth in loop_carries:
        diags.append(_diag(
            "N401", Severity.ERROR,
            f"loop carry accumulates (a chain of more than {depth - 1} adds, each over "
            f"its own previous sum) in {_short(v.outvals[0].dtype)} — the running sum "
            "quantizes every step", v.node,
            hint="carry the accumulator in f32 (cast at the loop boundary); "
            "recurrent STATE that is overwritten each step may stay low-precision",
        ))


def _lowprec_update_source(val: _Val, depth: int = 0) -> Optional[_Val]:
    """The sub-f32 value a master-state output was upcast from, if its
    producing chain ends in convert(low→master).  Walks through the
    value an in-place copy writes and the per-leaf select (healthy ? new :
    old) only — anything else is the legitimate f32 math path."""
    if depth > 6 or val.kind != "op":
        return None
    if val.prim == "convert_element_type":
        src = val.ins[0] if val.ins else None
        if src is not None and _is_low(src.dtype) and src.kind == "op":
            return src
        return None
    if val.prim == "copy" and val.ins:
        return _lowprec_update_source(val.ins[0], depth + 1)
    if val.prim == "select_n":
        for cand in val.ins[1:]:
            hit = _lowprec_update_source(cand, depth + 1)
            if hit is not None:
                return hit
    return None


def _rule_n402(out_vals, out_labels, master, diags) -> None:
    for val, label in zip(out_vals, out_labels):
        if not _is_float(val.dtype):
            continue
        if val.dtype != master:
            d = Diagnostic(
                rule="N402", severity=Severity.ERROR,
                message=f"master-state leaf {label} leaves the train step at "
                f"{_short(val.dtype)}, not master {_short(master)} — repeated updates at "
                "low precision stall convergence (the update quantizes before it lands)",
                hint="keep params/opt-state at the master dtype; cast to the compute "
                "dtype only on the forward read (the layer-boundary cast site, "
                "core/compiler.py resolve_layer_call)",
            )
            if val.kind == "op" and val.node is not None:
                src, line = node_site(val.node)
                d = dataclasses.replace(d, layer=node_layer(val.node), source=src, line=line)
            diags.append(d)
            continue
        if val.kind != "op":
            continue
        low_src = _lowprec_update_source(val)
        if low_src is not None:
            diags.append(_diag(
                "N402", Severity.ERROR,
                f"master-state leaf {label} is written from an upcast "
                f"{_short(low_src.dtype)} value — the update math itself ran below "
                "master precision (outside the sanctioned forward-cast site)",
                low_src.node if low_src.node is not None else val.node,
                hint="compute the optimizer update on the f32 master values; only "
                "the forward pass reads the compute-dtype cast",
            ))


def _rule_n403(visits, diags) -> None:
    for v in visits:
        prim = v.prim
        if prim == "exp":
            x = v.invals[0]
            if not _is_float(x.dtype) or _bounded_above(x):
                continue
            diags.append(_diag(
                "N403", Severity.WARNING,
                f"exp of an unguarded {_short(x.dtype)} value — overflows to inf once "
                "the argument drifts past the dtype's exp ceiling (~88 at f32/bf16, "
                "~11 at f16)", v.node,
                hint="subtract the running max first (the masked-softmax idiom) or "
                "clamp the argument",
            ))
        elif prim == "log":
            x = v.invals[0]
            if not _is_float(x.dtype) or _positive_guarded(x):
                continue
            diags.append(_diag(
                "N403", Severity.WARNING,
                f"log of an unguarded {_short(x.dtype)} value — -inf at zero, nan "
                "below it", v.node,
                hint="add an epsilon (torch.log(x + 1e-6)) or route through the fused "
                "log-softmax path (cost layers already do)",
            ))
        elif prim == "rsqrt":
            x = v.invals[0]
            if not _is_float(x.dtype) or _positive_guarded(x):
                continue
            diags.append(_diag(
                "N403", Severity.WARNING,
                f"rsqrt of an unguarded {_short(x.dtype)} value — inf at zero", v.node,
                hint="rsqrt(x + eps), the Adam/LayerNorm epsilon idiom",
            ))
        elif prim == "div":
            if len(v.invals) < 2:
                continue
            den = v.invals[1]
            if den.dtype is not None and not _is_float(den.dtype):
                continue
            if den.dtype is None and den.kind == "const":
                continue  # a Python scalar divisor
            if _positive_guarded(den):
                continue
            diags.append(_diag(
                "N403", Severity.WARNING,
                f"division by an unguarded {_short(den.dtype)} value — inf/nan the "
                "moment the denominator underflows to zero", v.node,
                hint="guard the denominator: torch.clamp(d, min=eps) or d + eps",
            ))


def _finfo_max(dtype) -> Optional[float]:
    try:
        return float(torch.finfo(dtype).max)
    except TypeError:
        return None


def _rule_n404(visits, diags) -> None:
    for v in visits:
        out = v.outvals[0]
        if not _is_low(out.dtype):
            continue
        fmax = _finfo_max(out.dtype)
        if fmax is None:
            continue
        if v.prim == "convert_element_type":
            lits = [x for x in v.invals[:1] if x.const is not None]
        elif v.prim in ("select_n", "full"):
            lits = [x for x in v.invals if x.kind == "const" and x.const is not None]
        else:
            continue
        for x in lits:
            if math.isfinite(x.const) and abs(x.const) > fmax:
                diags.append(_diag(
                    "N404", Severity.ERROR,
                    f"sentinel literal {x.const:g} overflows {_short(out.dtype)} "
                    f"(finite max {fmax:g}) — the mask fill lands as ±inf and a "
                    "fully-masked row softmaxes to nan", v.node,
                    hint="derive the fill from the tensor dtype: "
                    "torch.finfo(x.dtype).min, or the dtype-aware mask helper",
                ))
                break


def _rule_n405(visits, diags) -> None:
    """No torch subject yet: the port issues no collective until a device
    mesh is ported (ROADMAP Queue 1 item 6), so there is no sub-f32 psum to
    find.  The rule id stays reserved for the quantized allreduce."""


def _rule_n406(visits, diags) -> None:
    for v in visits:
        if v.prim != "convert_element_type":
            continue
        x = v.invals[0] if v.invals else None
        out = v.outvals[0]
        if x is None or x.kind != "op" or x.prim != "convert_element_type":
            continue
        origin = x.ins[0] if x.ins else None
        if origin is None:
            continue
        if not (_is_float(origin.dtype) and _is_float(x.dtype) and _is_float(out.dtype)):
            continue
        if origin.dtype != out.dtype:
            continue
        if torch.finfo(x.dtype).eps <= torch.finfo(out.dtype).eps:
            continue  # the middle keeps at least as much mantissa
        diags.append(_diag(
            "N406", Severity.WARNING,
            f"dtype round-trip {_short(origin.dtype)}→{_short(x.dtype)}→"
            f"{_short(out.dtype)}: the value is quantized and immediately promoted "
            "back — bandwidth spent destroying mantissa", v.node,
            hint="keep the value at one dtype across the boundary (hoist the cast, "
            "or drop the intermediate narrow cast)",
        ))


def _run_rules(walker: _Walker, reduced: bool) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    _rule_n401(walker.visits, walker.loop_carries, reduced, diags)
    _rule_n403(walker.visits, diags)
    _rule_n404(walker.visits, diags)
    _rule_n405(walker.visits, diags)
    _rule_n406(walker.visits, diags)
    return diags


# ---------------------------------------------------------------------------
# pragma filtering
# ---------------------------------------------------------------------------


class _PragmaFilter(SitePragmaFilter):
    """Suppress findings whose issuing source line carries a justified
    ``# num: allow[<rule>]`` pragma; tracks per-file pragma usage so stale
    annotations report uniformly with the lock plane."""

    def __init__(self, root: Optional[str] = None) -> None:
        super().__init__("num", root)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lint_numerics_graph(
    traced: TracedStep,
    *,
    apply_pragmas: bool = True,
    _filter: Optional[_PragmaFilter] = None,
) -> List[Diagnostic]:
    """The structural N-rules (N401/N403/N404/N405/N406) over one traced
    step; N402 needs the step's argument/output mapping — use
    :func:`lint_numerics_step`."""
    walker = _Walker()
    walker.walk(traced)
    diags = _run_rules(walker, traced.reduced_precision)
    if apply_pragmas:
        diags = (_filter or _PragmaFilter()).filter(diags)
    return diags


# the JAX package's name for the graph pass
lint_numerics_jaxpr = lint_numerics_graph


def _trace_and_lint(fn, example_args, master_argnums: Sequence[int], master_dtype,
                    traced: Optional[TracedStep] = None):
    """The ONE trace+rules body behind :func:`lint_numerics_step` and
    :func:`certify_precision_plan`: trace ``fn``, walk its nodes, run every
    structural rule, and the N402 master-precision check over the inputs
    and outputs of the argnums that hold master state.  Returns the
    UNFILTERED diagnostics, the walker and the trace."""
    traced = traced if traced is not None else trace_step(fn, *example_args)
    walker = _Walker()
    out_vals = walker.walk(traced)
    diags = _run_rules(walker, traced.reduced_precision)
    master = as_dtype(master_dtype)
    masters = [(v, lbl) for v, lbl, k in zip(out_vals, traced.out_labels, traced.out_argnums)
               if k in master_argnums]
    # an in-place output's value is the op that wrote it (copy_'s source)
    _rule_n402([v for v, _ in masters], [lbl for _, lbl in masters], master, diags)
    return diags, walker, traced


def lint_numerics_step(
    fn,
    *example_args,
    master_argnums: Sequence[int] = (0, 2),
    master_dtype=torch.float32,
    apply_pragmas: bool = True,
    _filter: Optional[_PragmaFilter] = None,
) -> List[Diagnostic]:
    """Trace ``fn`` (a train-step body: ``(params, state, opt_state, batch,
    rng) -> (params, state, opt_state, metrics)``) on example args and run
    every N-rule, including the N402 master-precision check over the
    argnums that hold master state."""
    diags, _walker, _traced = _trace_and_lint(fn, example_args, master_argnums, master_dtype)
    if apply_pragmas:
        diags = (_filter or _PragmaFilter()).filter(diags)
    return diags


# -- probe construction ------------------------------------------------------


_LABEL_CONSUMERS = frozenset({
    "cross_entropy", "softmax_with_cost", "classification_cost",
    "multi_class_cross_entropy", "classification_error", "huber_cost",
    "crf", "crf_decoding", "ctc", "warp_ctc", "nce", "hsigmoid",
})


def _infer_probe_types(topology) -> Dict[str, Any]:
    """Probe-type overrides for v1 configs parsed WITHOUT a data provider:
    an embedding input is an id sequence, a cost layer's label input is
    integer ids (sequence-shaped when the prediction side is a
    recurrent_group's per-step output)."""
    from paddle_tpu_torch.core.data_types import integer_value, integer_value_sequence

    data_names = set(topology.data_layers())
    overrides: Dict[str, Any] = {}
    for _name, conf in topology.layers.items():
        ins = list(conf.inputs)
        if conf.type == "embedding" and ins and ins[0] in data_names:
            overrides[ins[0]] = integer_value_sequence(topology.layers[ins[0]].size)
        elif conf.type in _LABEL_CONSUMERS and len(ins) >= 2 and ins[1] in data_names:
            dim = topology.layers[ins[1]].size
            pred = topology.layers.get(ins[0])
            seqish = pred is not None and pred.type in ("recurrent_group", "gru_step",
                                                        "lstm_step")
            overrides[ins[1]] = integer_value_sequence(dim) if seqish else integer_value(dim)
    return overrides


def _probe_rows(topology, batch_size: int = 4, seq_len: int = 6,
                overrides: Optional[Dict[str, Any]] = None):
    """One deterministic feeder batch's rows for a topology from its
    declared data types — the lint needs real shapes and dtypes, not real
    data."""
    from paddle_tpu_torch.core.data_types import SeqLevel, SlotKind

    overrides = overrides or {}
    rows = []
    for r in range(batch_size):
        row = []
        for name, t in topology.data_types():
            t = overrides.get(name, t)
            if t.kind == SlotKind.DENSE:
                v = [0.25 + 0.01 * r] * t.dim
            elif t.kind == SlotKind.INDEX:
                v = r % max(t.dim, 1)
            else:  # sparse slots: a couple of active ids
                v = [0, min(1, t.dim - 1)]
            if t.seq == SeqLevel.SEQ:
                v = [v] * seq_len if t.kind != SlotKind.INDEX else [
                    (r + i) % max(t.dim, 1) for i in range(seq_len)]
            elif t.seq == SeqLevel.SUB_SEQ:
                inner = [v] * 2 if t.kind != SlotKind.INDEX else [r % max(t.dim, 1)] * 2
                v = [inner, inner]
            row.append(v)
        rows.append(tuple(row))
    return rows


def _probe_batch(topology, batch_size: int = 4, seq_len: int = 6,
                 overrides: Optional[Dict[str, Any]] = None, device=None):
    from paddle_tpu_torch.reader.feeder import DataFeeder, feed_dtypes_of

    overrides = overrides or {}
    types = [(name, overrides.get(name, t)) for name, t in topology.data_types()]
    feeder = DataFeeder(types, feed_dtypes=feed_dtypes_of(topology), device=device)
    return feeder(_probe_rows(topology, batch_size, seq_len, overrides))


def _step_parts(topology, optimizer=None, compute_dtype=None, master_dtype=None,
                batch_size: int = 4, seq_len: int = 6, infer_types: bool = False,
                device=None):
    """(step_body, example_args) for the REAL train step of a topology at
    the given precision plan — the step certify and lint trace."""
    from paddle_tpu_torch.core.compiler import CompiledNetwork
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.trainer.step import _train_step_body

    dev = resolve_device(device)
    if optimizer is None:
        import paddle_tpu_torch.optimizer as O

        optimizer = O.Adam(learning_rate=1e-3)
    kwargs: Dict[str, Any] = {}
    if master_dtype is not None:
        kwargs["dtype"] = as_dtype(master_dtype)
    if compute_dtype is not None:
        kwargs["compute_dtype"] = as_dtype(compute_dtype)
    net = CompiledNetwork(topology, **kwargs)
    overrides = _infer_probe_types(topology) if infer_types else None
    batch = _probe_batch(topology, batch_size, seq_len, overrides, device=dev)
    params, state = net.init(0, device=dev)
    if net.has_dynamic_widths:
        params, _chg = net.resolve_dynamic_widths(params, batch)
    opt_state = optimizer.init(params)
    step = _train_step_body(net, optimizer, sentinel=True)
    return step, (params, state, opt_state, batch, 1)


def _config_step_parts(config_path: str, config_args: str, compute_dtype, master_dtype,
                       device):
    from paddle_tpu_torch.v1_compat import make_optimizer, parse_config

    parsed = parse_config(os.path.abspath(config_path), config_args)
    try:
        optimizer = make_optimizer(parsed.settings)
    except Exception:  # noqa: BLE001 — exotic settings: probe with Adam
        optimizer = None
    return parsed, _step_parts(parsed.topology, optimizer, compute_dtype=compute_dtype,
                               master_dtype=master_dtype, infer_types=True, device=device)


def lint_numerics_config(
    config_path: str,
    config_args: str = "",
    compute_dtype=None,
    master_dtype=None,
    apply_pragmas: bool = True,
    _filter: Optional[_PragmaFilter] = None,
    device=None,
) -> List[Diagnostic]:
    """Parse a v1 config and precision-lint its REAL train step (the parsed
    settings' optimizer, a synthesized probe batch) at the given dtype plan
    — the ``lint --numerics --config`` body.  ``device`` as the entry
    points take it (the card unless "cpu")."""
    _parsed, (step, args) = _config_step_parts(config_path, config_args, compute_dtype,
                                               master_dtype, device)
    return lint_numerics_step(step, *args, master_dtype=as_dtype(master_dtype or torch.float32),
                              apply_pragmas=apply_pragmas, _filter=_filter)


def lint_numerics_package(
    compute_dtype=None,
    master_dtype=None,
    check_stale_pragmas: Optional[bool] = None,
    device=None,
) -> List[Diagnostic]:
    """The package leg of ``lint --numerics``: precision-lint the shipped
    step builder over probe topologies that exercise the planes the
    flagships use (dense MLP, LSTM sequence path, the attention-GRU
    decoder, a plain recurrent_group, the Transformer), plus ``# num:``
    pragma hygiene.
    Stale-pragma reporting defaults to ON for sub-f32 runs (the dtype
    context the pragmas exist for) and OFF at f32."""
    if check_stale_pragmas is None:
        check_stale_pragmas = _is_low(as_dtype(compute_dtype))
    f = _PragmaFilter()
    diags: List[Diagnostic] = []
    for topo in _probe_topologies():
        step, args = _step_parts(topo, None, compute_dtype=compute_dtype,
                                 master_dtype=master_dtype, device=device)
        diags.extend(lint_numerics_step(step, *args, _filter=f))
    if check_stale_pragmas:
        # load EVERY package file's pragmas first: the hygiene findings
        # (empty justifications) must land in pragma_diags before it is
        # folded into the result
        f.load_package()
        diags.extend(f.pragma_diags)
        diags.extend(f.stale())
    else:
        diags.extend(f.pragma_diags)
    return diags


def _probe_topologies():
    """Small topologies covering the numerics-relevant layer planes: the
    JAX package's four — the MLP (dense GEMM + softmax CE), the LSTM text
    path (embedding, the recurrence, pooling), the attention decoder
    (masked softmax, the fused GRU core) and a plain recurrent_group (the
    generic loop) — and the port's Transformer."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.topology import Topology, reset_auto_names
    from paddle_tpu_torch.models.seq2seq import seq2seq_cost
    from paddle_tpu_torch.models.transformer import transformer_cost

    L, A = paddle.layer, paddle.activation
    topos = []

    reset_auto_names()
    x = L.data("x", paddle.data_type.dense_vector(64))
    h = L.fc(x, size=64, act=A.Relu())
    pred = L.fc(h, size=10, act=A.Softmax())
    y = L.data("y", paddle.data_type.integer_value(10))
    topos.append(Topology([L.classification_cost(input=pred, label=y)]))

    reset_auto_names()
    w = L.data("w", paddle.data_type.integer_value_sequence(50))
    emb = L.embedding(w, size=32)
    lstm = paddle.networks.simple_lstm(input=emb, size=32)
    pooled = L.pooling(lstm, pooling_type=paddle.pooling.Max())
    out = L.fc(pooled, size=4, act=A.Softmax())
    lab = L.data("lab", paddle.data_type.integer_value(4))
    topos.append(Topology([L.classification_cost(input=out, label=lab)]))

    reset_auto_names()
    cost, _ = seq2seq_cost(40, 45, word_dim=16, hidden_dim=16)
    topos.append(Topology([cost]))

    reset_auto_names()
    w2 = L.data("w2", paddle.data_type.integer_value_sequence(30))
    emb2 = L.embedding(w2, size=16)

    def _step(x):
        prev = L.memory("h", 16)
        return L.fc([x, prev], size=16, act=A.Tanh(), name="h")

    rec = L.recurrent_group(step=_step, input=emb2)
    pooled2 = L.pooling(rec, pooling_type=paddle.pooling.Max())
    out2 = L.fc(pooled2, size=4, act=A.Softmax())
    lab2 = L.data("lab2", paddle.data_type.integer_value(4))
    topos.append(Topology([L.classification_cost(input=out2, label=lab2)]))

    # the port's flagship path (chip_smoke.py): the Transformer — layer
    # norm, multi-head attention, the FFN — at a probe width
    reset_auto_names()
    cost, _ = transformer_cost(30, 30, d_model=16, n_heads=2, n_layers=1, d_ff=32)
    topos.append(Topology(cost))
    return topos


# ---------------------------------------------------------------------------
# precision-plan certification
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PrecisionCertificate:
    """The static verdict on one compute/master dtype split: per-layer rows
    plus the N-rule findings the plan would ship with."""

    ok: bool
    compute_dtype: str
    master_dtype: str
    diagnostics: List[Diagnostic]
    rows: List[Dict[str, Any]]  # layer, type, dtype, dots, acc, hazards

    def format(self) -> str:
        from paddle_tpu_torch.analysis.diagnostics import format_diagnostics

        head = (f"precision certificate: compute={self.compute_dtype} "
                f"master={self.master_dtype} -> {'ACCEPT' if self.ok else 'REJECT'}")
        w = max([16] + [len(r["layer"]) for r in self.rows]) + 1
        lines = [head, f"{'layer':<{w}}{'type':<18}{'compute':<10}{'dots(acc)':<12}"
                 f"{'hazards':<8}"]
        for r in self.rows:
            lines.append(f"{r['layer']:<{w}}{r['type']:<18}{r['dtype']:<10}"
                         f"{str(r['dots']) + '(' + r['acc'] + ')':<12}{r['hazards']:<8}")
        if self.diagnostics:
            lines.append(format_diagnostics(self.diagnostics))
        return "\n".join(lines)


def certify_precision_plan(topology, plan: Dict[str, Any], optimizer=None,
                           device=None, _step=None,
                           _traced: Optional[TracedStep] = None) -> PrecisionCertificate:
    """Statically verify a precision plan over the REAL train step.

    ``plan``: ``{"compute_dtype": ..., "master_dtype": ...,
    "quantized_weights": bool}`` (names or dtypes; master defaults to
    float32).  ACCEPT iff no ERROR-severity N-rule fires — a plan whose
    master dtype is sub-f32 (params updated in bf16) is rejected by N402,
    while the sanctioned master-f32/compute-bf16 split passes.
    ``quantized_weights`` declares weight-ONLY int8 (the serving bundle):
    it leaves the traced train step untouched.  A NON-FLOAT master or
    compute dtype is rejected outright, without tracing: integer state
    cannot carry the update accumulation at all.  ``_step`` hands in a
    ready (step body, example args) instead of building the probe step,
    ``_traced`` a step already traced at the plan's compute dtype."""
    compute = as_dtype(plan.get("compute_dtype") or torch.float32)
    master = as_dtype(plan.get("master_dtype") or torch.float32)
    for role, dt in (("master", master), ("compute", compute)):
        if not _is_float(dt):
            d = Diagnostic(
                rule="N402", severity=Severity.ERROR,
                message=f"precision plan asks for {role} dtype {_short(dt)} — integer "
                "master params/optimizer state cannot accumulate updates (every step "
                "requantizes the whole trajectory); quantization must stay weight-only",
                hint="keep master/compute dtypes float; declare int8 serving weights "
                "via plan['quantized_weights']=True (ops.quantize.quantize_weight_bundle)",
            )
            return PrecisionCertificate(ok=False, compute_dtype=_short(compute),
                                        master_dtype=_short(master), diagnostics=[d], rows=[])

    f = _PragmaFilter()
    if _step is None and _traced is None:
        _step = _step_parts(topology, optimizer, compute_dtype=compute, master_dtype=master,
                            infer_types=True, device=device)
    step, args = _step or (None, None)
    # the SAME trace+rules body the lint runs — the gate can never be
    # weaker than `lint --numerics` on the same plan
    diags, walker, traced = _trace_and_lint(step, args, (0, 2), master, traced=_traced)
    diags = f.filter(diags)
    # malformed pragmas in the files this trace touched reject too
    diags = diags + f.pragma_diags

    per_layer: Dict[str, Dict[str, Any]] = {}
    layer_types = {name: conf.type for name, conf in topology.layers.items()}
    for v in walker.visits:
        layer = node_layer(v.node)
        if layer is None or layer not in layer_types:
            continue
        row = per_layer.setdefault(layer, {"layer": layer, "type": layer_types[layer],
                                           "dtype": "-", "dots": 0, "acc": "-", "hazards": 0})
        if v.prim in _GEMMS or v.prim == "flash_attention":
            row["dots"] += 1
            opdt = v.invals[0].dtype if v.invals else None
            # the LOWEST operand dtype seen is the layer's compute dtype
            # (backward GEMMs at f32 must not mask a bf16 forward)
            if opdt is not None and (row["dtype"] == "-" or _is_low(opdt)):
                row["dtype"] = _short(opdt)
                low_acc = traced.reduced_precision and v.prim in _GEMMS and _is_low(opdt)
                row["acc"] = _short(opdt) if low_acc else "float32"
    for layer, _rule in {(d.layer, d.rule) for d in diags if d.layer is not None}:
        if layer in per_layer:
            per_layer[layer]["hazards"] += 1
    rows = [per_layer[k] for k in topology.order if k in per_layer]

    from paddle_tpu_torch.analysis.diagnostics import errors

    return PrecisionCertificate(ok=not errors(diags), compute_dtype=_short(compute),
                                master_dtype=_short(master), diagnostics=diags, rows=rows)
