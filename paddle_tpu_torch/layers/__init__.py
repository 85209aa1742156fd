"""Layer DSL of the port — the part of ``paddle_tpu/layers/__init__.py`` that
Transformer-base uses: ``data`` (:178), ``fc`` (:215), ``embedding`` (:275),
``addto`` (:306), ``classification_cost`` (:1116),
``layer_norm`` (:2414), ``multi_head_attention`` (:2420) and
``pos_encoding`` (:2450).  Each function returns a :class:`LayerOutput`
handle; the graph is gathered by parent traversal when a Topology is built.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from paddle_tpu_torch import activation as _act_mod
from paddle_tpu_torch.activation import act_name
from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.core.data_types import InputType
from paddle_tpu_torch.core.topology import LayerConf, LayerOutput, auto_name

# register the layer impls
from paddle_tpu_torch.layers import base as _base  # noqa: F401
from paddle_tpu_torch.layers import basic as _basic  # noqa: F401
from paddle_tpu_torch.layers import attention as _attention  # noqa: F401
from paddle_tpu_torch.layers import cost as _cost  # noqa: F401

Inputish = Union[LayerOutput, Sequence[LayerOutput]]


def _as_list(x: Inputish) -> list:
    if isinstance(x, LayerOutput):
        return [x]
    return list(x)


def _extra(layer_attr: Optional[ExtraAttr]):
    drop = layer_attr.drop_rate if layer_attr else 0.0
    shard = layer_attr.shard_axis if layer_attr else None
    return drop, shard


def _set_error_clip(conf: LayerConf, layer_attr: Optional[ExtraAttr]) -> None:
    t = getattr(layer_attr, "error_clipping_threshold", 0.0) if layer_attr else 0.0
    if t:
        conf.attrs["error_clip"] = float(t)


def _param_std(param_attr: Optional[ParamAttr]):
    return param_attr.initial_std if param_attr else None


def _param_name(param_attr: Optional[ParamAttr]):
    return param_attr.name if param_attr else None


def _prune_ratio(param_attr: Optional[ParamAttr]):
    if param_attr is None or param_attr.update_hooks is None:
        return None
    hooks = param_attr.update_hooks
    if not isinstance(hooks, (list, tuple)):
        hooks = [hooks]
    for h in hooks:
        if getattr(h, "type", None) == "pruning":
            return float(h.sparsity_ratio)
    return None


def _param_attrs(param_attr: Optional[ParamAttr]) -> dict:
    return {
        "param_std": _param_std(param_attr),
        "param_name": _param_name(param_attr),
        "prune_sparsity": _prune_ratio(param_attr),
    }


def _img_passthrough(input: LayerOutput) -> dict:
    a = input.conf.attrs
    out = {}
    c = a.get("channels") or a.get("in_c")
    h = a.get("out_h") or a.get("in_h")
    w = a.get("out_w") or a.get("in_w")
    if c is not None and h is not None:
        out.update(in_c=c, in_h=h, in_w=w, channels=c, out_h=h, out_w=w)
    return out


def _unary(type_: str, input: LayerOutput, size=None, name=None, **attrs) -> LayerOutput:
    if size is None and input.conf.attr("dynamic_size"):
        attrs.setdefault("dynamic_size", True)
    conf = LayerConf(
        name=name or auto_name(type_),
        type=type_,
        size=size if size is not None else input.size,
        inputs=(input.name,),
        bias=False,
        attrs=attrs,
    )
    return LayerOutput(conf, [input])


def data(name: str, type: InputType, height: int = 0, width: int = 0,
         feed_dtype=None, feed_scale: float = 0.0,
         feed_shift: float = 0.0) -> LayerOutput:
    """Declare an input slot."""
    attrs = {}
    if height and width:
        attrs.update(in_h=height, in_w=width, in_c=max(type.dim // (height * width), 1))
    if feed_dtype is not None:
        attrs["feed_dtype"] = str(np.dtype(feed_dtype))
    if feed_scale:
        attrs["feed_scale"] = float(feed_scale)
    if feed_shift:
        attrs["feed_shift"] = float(feed_shift)
    conf = LayerConf(
        name=name, type="data", size=type.dim, input_type=type, attrs=attrs, bias=False
    )
    return LayerOutput(conf)


data_layer = data


def fc(
    input: Inputish,
    size: int,
    act=None,
    bias_attr: Union[bool, ParamAttr] = True,
    param_attr: Union[ParamAttr, Sequence[ParamAttr], None] = None,
    layer_attr: Optional[ExtraAttr] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    ins = _as_list(input)
    drop, shard = _extra(layer_attr)
    if isinstance(param_attr, (list, tuple)):
        if len(param_attr) != len(ins):
            raise ValueError(
                f"fc param_attr list length {len(param_attr)} != inputs {len(ins)}"
            )
        attrs = {
            "param_stds": tuple(_param_std(pa) for pa in param_attr),
            "prune_sparsity": _prune_ratio(param_attr[0]),
        }
        pnames = {
            f"w{i}": _param_name(pa)
            for i, pa in enumerate(param_attr)
            if _param_name(pa)
        }
    else:
        attrs = _param_attrs(param_attr)
        shared_name = attrs.pop("param_name", None)
        pnames = {f"w{i}": shared_name for i in range(len(ins))} if shared_name else {}
    if isinstance(bias_attr, ParamAttr) and bias_attr.name:
        pnames["b"] = bias_attr.name
    if pnames:
        attrs["param_names"] = pnames
    conf = LayerConf(
        name=name or auto_name("fc_layer"),
        type="fc",
        size=size,
        inputs=tuple(i.name for i in ins),
        act=act_name(act if act is not None else _act_mod.Tanh()),
        bias=bool(bias_attr),
        attrs=attrs,
        drop_rate=drop,
        shard_axis=shard,
    )
    _set_error_clip(conf, layer_attr)
    return LayerOutput(conf, ins)


fc_layer = fc


def embedding(
    input: LayerOutput,
    size: int,
    param_attr: Optional[ParamAttr] = None,
    layer_attr: Optional[ExtraAttr] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    drop, shard = _extra(layer_attr)
    conf = LayerConf(
        name=name or auto_name("embedding"),
        type="embedding",
        size=size,
        inputs=(input.name,),
        bias=False,
        attrs={
            **_param_attrs(param_attr),
            "sparse_update": bool(param_attr and param_attr.sparse_update),
        },
        drop_rate=drop,
        shard_axis=shard,
    )
    _set_error_clip(conf, layer_attr)
    return LayerOutput(conf, [input])


embedding_layer = embedding


def addto(
    input: Inputish,
    act=None,
    bias_attr: Union[bool, ParamAttr] = False,
    name: Optional[str] = None,
    layer_attr: Optional[ExtraAttr] = None,
) -> LayerOutput:
    ins = _as_list(input)
    drop, shard = _extra(layer_attr)
    conf = LayerConf(
        name=name or auto_name("addto"),
        type="addto",
        size=ins[0].size,
        inputs=tuple(i.name for i in ins),
        act=act_name(act),
        bias=bool(bias_attr),
        attrs=_img_passthrough(ins[0]),
        drop_rate=drop,
        shard_axis=shard,
    )
    _set_error_clip(conf, layer_attr)
    return LayerOutput(conf, ins)


addto_layer = addto


def _cost2(type_: str, input: LayerOutput, label: LayerOutput, name=None, **attrs):
    conf = LayerConf(
        name=name or auto_name(type_),
        type=type_,
        size=1,
        inputs=(input.name, label.name),
        bias=False,
        attrs=attrs,
    )
    return LayerOutput(conf, [input, label])


def classification_cost(
    input: LayerOutput, label: LayerOutput, weight=None, name=None, evaluator=None,
    layer_attr=None,
) -> LayerOutput:
    """Softmax output + cross-entropy (the cost fuses into log-softmax
    cross-entropy over the input's pre-activation when its act is
    softmax)."""
    if weight is not None:
        raise NotImplementedError("weighted classification_cost is not ported yet")
    return _cost2("cross_entropy", input, label, name=name)


def layer_norm(
    input: LayerOutput, epsilon: float = 1e-6, name: Optional[str] = None
) -> LayerOutput:
    return _unary("layer_norm", input, name=name, epsilon=epsilon)


def multi_head_attention(
    query: LayerOutput,
    key_value: Optional[LayerOutput] = None,
    size: Optional[int] = None,
    n_heads: int = 8,
    causal: bool = False,
    bias_attr: bool = True,
    seq_parallel_axis: Optional[str] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    """Multi-head attention; omit key_value for self-attention.  `causal`
    masks future positions (decoder self-attention)."""
    kv = key_value or query
    conf = LayerConf(
        name=name or auto_name("mha"),
        type="multi_head_attention",
        size=size or query.size,
        inputs=(query.name, kv.name),
        bias=bool(bias_attr),
        attrs={
            "n_heads": n_heads,
            "causal": causal,
            "seq_parallel_axis": seq_parallel_axis,
        },
    )
    return LayerOutput(conf, [query, kv])


def pos_encoding(
    input: LayerOutput, emb_scale: float = 1.0, name: Optional[str] = None
) -> LayerOutput:
    """Add sinusoidal position encodings (input scaled by emb_scale first)."""
    return _unary("pos_encoding", input, name=name, emb_scale=emb_scale)
