"""The RAW config_parser primitive face — ``Layer(...)``, ``Input(...)``,
``Memory``, ``RecurrentLayerGroupBegin/End``, ``Evaluator`` and friends
(reference: python/paddle/trainer/config_parser.py @config_func/@config_layer
registry, :163-184; RecurrentLayerGroupBegin/End :366-386).

The reference's oldest .conf files (paddle/trainer/tests/*.conf,
demo-era configs) build the model by calling these primitives directly —
no trainer_config_helpers import.  Here each call dispatches onto the
typed layer DSL, resolving input names against the layers built so far
(parse_config's layer sink) or the current raw recurrent-group scope.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from paddle_tpu_torch import activation as _A
from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.core.topology import LayerOutput
from paddle_tpu_torch import layers as L

# the MODULE (the package attribute of the same name is the DSL function)
from importlib import import_module

_rg = import_module("paddle_tpu_torch.layers.recurrent_group")

__all__ = [
    "model_type", "Layer", "Input", "Bias", "Memory", "Evaluator",
    "FullMatrixProjection", "TransposedFullMatrixProjection",
    "TableProjection", "IdentityProjection", "IdentityOffsetProjection",
    "DotMulProjection", "ContextProjection",
    "RecurrentLayerGroupBegin", "RecurrentLayerGroupEnd",
]


def _state():
    from paddle_tpu_torch.v1_compat import config_helpers as H

    return H._require_state()


# ---------------------------------------------------------------------------
# raw recurrent-group scope
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _RawGroup:
    name: str
    scanned: List[LayerOutput]
    placeholders: List[LayerOutput]
    reverse: bool
    out_links: List[str]
    gb: Any  # _GroupBuild
    created: Dict[str, LayerOutput]
    namespace: Dict[str, LayerOutput]  # in-group name -> layer
    _trace_cm: Any = None


_current_raw_group: Optional[_RawGroup] = None


def reset_raw_state() -> None:
    """Abort any open raw layer group (parse_config error path): exits the
    trace context and clears the module global so one malformed config
    cannot poison later parses in the same process."""
    global _current_raw_group
    g = _current_raw_group
    if g is None:
        return
    _current_raw_group = None
    if g._trace_cm is not None:
        g._trace_cm.__exit__(None, None, None)


def _resolve(name) -> LayerOutput:
    """Resolve a layer reference: in-group names first (incl. the scan
    placeholders standing in for in_links), then the global parse state."""
    if isinstance(name, LayerOutput):
        return name
    g = _current_raw_group
    if g is not None and name in g.namespace:
        return g.namespace[name]
    st = _state()
    if name in st.all_layers:
        return st.all_layers[name]
    raise KeyError(f"raw config references unknown layer {name!r}")


def _register(name: str, lo: LayerOutput) -> None:
    if _current_raw_group is not None:
        _current_raw_group.namespace[name] = lo
    # the global sink (parse_config) records every LayerOutput already


# ---------------------------------------------------------------------------
# input / projection / bias specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Ref:
    """A reference to another layer, optionally naming its parameter
    (reference Input(...) / projection config objects)."""

    kind: str
    input_layer_name: Any
    parameter_name: Optional[str] = None
    initial_std: Optional[float] = None
    sparse_update: bool = False
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def param_attr(self) -> Optional[ParamAttr]:
        if self.parameter_name is None and self.initial_std is None:
            return None
        return ParamAttr(
            name=self.parameter_name,
            initial_std=self.initial_std,
            sparse_update=self.sparse_update,
        )


def Input(input_layer_name, parameter_name=None, initial_std=None, **kw):
    return _Ref("input", input_layer_name, parameter_name, initial_std,
                extra=kw)


def FullMatrixProjection(input_layer_name, parameter_name=None,
                         initial_std=None, **kw):
    return _Ref("full_matrix", input_layer_name, parameter_name, initial_std,
                extra=kw)


def TransposedFullMatrixProjection(input_layer_name, parameter_name=None,
                                   initial_std=None, **kw):
    return _Ref("trans_full_matrix", input_layer_name, parameter_name,
                initial_std, extra=kw)


def TableProjection(input_layer_name, parameter_name=None, initial_std=None,
                    sparse_update=False, **kw):
    return _Ref("table", input_layer_name, parameter_name, initial_std,
                sparse_update=bool(sparse_update), extra=kw)


def IdentityProjection(input_layer_name, **kw):
    return _Ref("identity", input_layer_name, extra=kw)


def IdentityOffsetProjection(input_layer_name, offset=0, **kw):
    return _Ref("identity_offset", input_layer_name,
                extra={"offset": offset, **kw})


def DotMulProjection(input_layer_name, parameter_name=None, initial_std=None,
                     **kw):
    return _Ref("dotmul", input_layer_name, parameter_name, initial_std,
                extra=kw)


def ContextProjection(input_layer_name, context_length=3, context_start=None,
                      **kw):
    return _Ref("context", input_layer_name,
                extra={"context_length": context_length,
                       "context_start": context_start, **kw})


@dataclasses.dataclass
class _BiasSpec:
    parameter_name: Optional[str] = None
    initial_std: Optional[float] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def Bias(parameter_name=None, initial_std=None, **kw):
    return _BiasSpec(parameter_name, initial_std, extra=kw)


def _bias_attr(bias):
    """Raw `bias` values: True/False/Bias(...) -> DSL bias_attr."""
    if isinstance(bias, _BiasSpec):
        return ParamAttr(name=bias.parameter_name,
                         initial_std=bias.initial_std)
    return bias


def _act(active_type: str):
    if not active_type or active_type == "linear":
        return _A.Identity()
    return active_type  # act_name validates registry names


def _as_refs(inputs) -> List[_Ref]:
    items = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    out = []
    for it in items:
        if isinstance(it, _Ref):
            out.append(it)
        else:  # bare string / LayerOutput = plain input
            out.append(_Ref("input", it))
    return out


# ---------------------------------------------------------------------------
# config functions
# ---------------------------------------------------------------------------


def model_type(name: str) -> None:
    """reference config_parser.model_type — 'nn' / 'recurrent_nn'; the
    compiler builds both the same way, so this only records the intent."""
    _state().model_type_name = name


def Memory(name: str, size: int, boot_layer: Optional[str] = None,
           boot_with_const_id: Optional[int] = None,
           is_sequence: bool = False, **kw) -> str:
    """Declare a memory of in-group layer `name` (reference Memory config
    func); returns the handle name projections can reference.
    is_sequence=True carries the linked layer's WHOLE sequence between
    steps (reference sequence-memory frames — see layers/recurrent_group.py
    memory(is_seq=True))."""
    assert _current_raw_group is not None, "Memory() outside a layer group"
    if kw:
        raise TypeError(f"raw Memory() got unsupported arguments {sorted(kw)}")
    boot = _resolve(boot_layer) if boot_layer is not None else None
    mem = _rg.memory(
        name=name, size=size, boot_layer=boot,
        boot_with_const_id=boot_with_const_id,
        is_seq=bool(is_sequence),
    )
    handle = mem.conf.name
    _current_raw_group.namespace[handle] = mem
    return handle


def RecurrentLayerGroupBegin(name: str, in_links, out_links,
                             seq_reversed: bool = False,
                             generator=None) -> None:
    """reference config_parser.py:366 — open a recurrent layer group; the
    Layer() calls until End build the step body; in_links become scan
    placeholders under their own names."""
    global _current_raw_group
    assert _current_raw_group is None, "nested raw layer groups: use the DSL"
    assert generator is None, (
        "raw generator groups are not supported; use beam_search()"
    )
    in_names = list(in_links) if isinstance(in_links, (list, tuple)) else [in_links]
    scanned = [_resolve(n) for n in in_names]
    sub_scanned = [False] * len(scanned)
    step_args, scan_ph, _ = _rg._make_placeholders(name, scanned, sub_scanned, [])

    g = _RawGroup(
        name=name, scanned=scanned,
        placeholders=scan_ph, reverse=bool(seq_reversed),
        out_links=list(out_links) if isinstance(out_links, (list, tuple))
        else [out_links],
        gb=None, created={}, namespace={},
    )
    for n, arg in zip(in_names, step_args):
        g.namespace[n] = arg  # in-group references hit the placeholder

    g._trace_cm = _rg._trace_capture()
    g.gb, g.created = g._trace_cm.__enter__()
    _current_raw_group = g


def RecurrentLayerGroupEnd(name: str) -> None:
    """reference config_parser.py:386 — close the group, lower it to one
    recurrent_group layer, and publish the out_link under its name."""
    global _current_raw_group

    g = _current_raw_group
    assert g is not None and g.name == name, (
        f"RecurrentLayerGroupEnd({name!r}) without matching Begin"
    )
    g._trace_cm.__exit__(None, None, None)
    _current_raw_group = None

    assert len(g.out_links) == 1, "raw groups publish exactly one out_link"
    out_name = g.out_links[0]
    step_out = g.namespace.get(out_name)
    assert step_out is not None, (
        f"group {name!r} never built its out_link layer {out_name!r}"
    )
    group = _rg._finalize_group(
        name, g.scanned, [False] * len(g.scanned), [], g.placeholders, [], g.gb,
        g.created, [step_out], g.reverse,
    )
    # The outer network references the result by the OUT-LINK name
    # (reference publishes the scoped layer under it).
    _state().all_layers[out_name] = group


def Evaluator(name: str, type: str, inputs, **kw):
    """reference @config_func Evaluator — records a paddle_tpu evaluator
    bound to the named layers."""
    from paddle_tpu_torch import evaluator as E

    refs = [_resolve(getattr(r, "input_layer_name", r)) for r in _as_refs(inputs)]
    factory = {
        "sum": lambda: E.sum_evaluator(input=refs[0], name=name),
        "column_sum": lambda: E.column_sum_evaluator(input=refs[0], name=name),
        "classification_error": lambda: E.classification_error_evaluator(
            input=refs[0], label=refs[1], name=name
        ),
        "chunk": lambda: E.chunk_evaluator(
            input=refs[0], label=refs[1],
            chunk_scheme=kw.get("chunk_scheme", "IOB"),
            num_chunk_types=kw.get("num_chunk_types", 1), name=name,
        ),
        "value_printer": lambda: E.value_printer_evaluator(
            input=refs[0], name=name
        ),
        "max_id_printer": lambda: E.maxid_printer_evaluator(
            input=refs[0], name=name
        ),
        "max_frame_printer": lambda: E.maxframe_printer_evaluator(
            input=refs[0], name=name
        ),
        "classification_error_printer": (
            lambda: E.classification_error_printer_evaluator(
                input=refs[0], label=refs[1], name=name
            )
        ),
    }.get(type)
    if factory is None:
        raise KeyError(f"raw Evaluator type {type!r} not supported")
    ev = factory()
    _state().evaluators.append(ev)
    return ev


# layer-type dispatch ---------------------------------------------------------


def _build_mixed(name, size, refs, act, bias, **kw):
    projs = []
    for r in refs:
        lo = _resolve(r.input_layer_name)
        pa = r.param_attr()
        if r.kind == "full_matrix":
            projs.append(L.full_matrix_projection(lo, param_attr=pa))
        elif r.kind == "trans_full_matrix":
            projs.append(L.trans_full_matrix_projection(lo, param_attr=pa))
        elif r.kind == "table":
            projs.append(L.table_projection(lo, param_attr=pa))
        elif r.kind == "identity" or r.kind == "input":
            projs.append(L.identity_projection(lo))
        elif r.kind == "identity_offset":
            projs.append(
                L.identity_projection(lo, offset=r.extra["offset"], size=size)
            )
        elif r.kind == "dotmul":
            projs.append(L.dotmul_projection(lo, param_attr=pa))
        elif r.kind == "context":
            projs.append(
                L.context_projection(
                    lo, context_len=r.extra["context_length"],
                    context_start=r.extra.get("context_start"),
                )
            )
        else:
            raise KeyError(f"projection kind {r.kind!r} in raw mixed layer")
    return L.mixed(size=size, input=projs, name=name, act=act, bias_attr=bias)


def Layer(name: str, type: str, size: int = 0, active_type: str = "",
          bias=True, inputs=(), device=None, **kw) -> LayerOutput:
    """reference @config_layer dispatch: build layer `type` from named
    inputs.  Covers the types the reference's raw .conf fixtures use."""
    refs = _as_refs(inputs)
    act = _act(active_type)
    battr = _bias_attr(bias)

    if type == "data":
        from paddle_tpu_torch.v1_compat.config_helpers import data_layer

        lo = data_layer(name=name, size=size)
    elif type == "fc":
        ins = [_resolve(r.input_layer_name) for r in refs]
        pas = [r.param_attr() or ParamAttr() for r in refs]
        lo = L.fc(ins, size=size, act=act, bias_attr=battr, param_attr=pas,
                  name=name)
    elif type == "mixed":
        lo = _build_mixed(name, size, refs, act, battr, **kw)
    elif type == "embedding":
        lo = L.embedding(_resolve(refs[0].input_layer_name), size=size,
                         param_attr=refs[0].param_attr(), name=name)
    elif type == "seqlastins":
        lo = L.last_seq(input=_resolve(refs[0].input_layer_name), name=name)
    elif type == "seqfirstins":
        lo = L.first_seq(input=_resolve(refs[0].input_layer_name), name=name)
    elif type in ("average", "max"):
        from paddle_tpu_torch import pooling as P

        pt = P.Max() if type == "max" else P.Avg()
        lo = L.pooling(_resolve(refs[0].input_layer_name), pt, name=name)
    elif type == "recurrent":
        lo = L.recurrent(
            _resolve(refs[0].input_layer_name), act=act, bias_attr=battr,
            param_attr=refs[0].param_attr(),
            reverse=bool(kw.get("reversed", kw.get("seq_reversed", False))),
            name=name,
        )
    elif type == "rank-cost":
        ins = [_resolve(r.input_layer_name) for r in refs]
        lo = L.rank_cost(ins[0], ins[1], ins[2], name=name)
    elif type == "crf":
        lo = L.crf(
            _resolve(refs[0].input_layer_name),
            _resolve(refs[1].input_layer_name),
            size=size, param_attr=refs[0].param_attr(), name=name,
        )
    elif type == "crf_decoding":
        lo = L.crf_decoding(
            _resolve(refs[0].input_layer_name),
            size=size,
            label=_resolve(refs[1].input_layer_name) if len(refs) > 1 else None,
            param_attr=refs[0].param_attr(), name=name,
        )
    elif type == "multi-class-cross-entropy":
        lo = L.cross_entropy_cost(
            _resolve(refs[0].input_layer_name),
            _resolve(refs[1].input_layer_name), name=name,
        )
    elif type == "square_error":
        lo = L.square_error_cost(
            _resolve(refs[0].input_layer_name),
            _resolve(refs[1].input_layer_name), name=name,
        )
    else:
        raise KeyError(f"raw Layer type {type!r} not supported")
    _register(name, lo)
    return lo
