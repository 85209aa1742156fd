"""Layer DSL of the port — the part of ``paddle_tpu/layers/__init__.py`` that
Transformer-base, LeNet, the ResNet family and the attention NMT model use:
``data`` (:178), ``fc`` (:215), ``embedding`` (:275), ``addto`` (:306),
``concat`` (:333), ``dropout`` (:360), ``img_conv`` (:403), ``img_pool``
(:484), ``batch_norm`` (:535), ``scaling`` (:791), ``classification_cost``
(:1116), ``pooling`` (:1210), ``last_seq`` (:1247), ``first_seq`` (:1260),
``expand`` (:1273), ``grumemory`` (:1353), ``gru_step`` (:1495),
``lstmemory`` (:1314), ``recurrent`` (:1387), ``lstm_step`` (:1543),
``crf`` (:1888), ``crf_decoding`` (:1912), the projections
``full_matrix_projection`` (:2002), ``trans_full_matrix_projection``
(:2012), ``table_projection`` (:2022), ``identity_projection`` (:2031),
``slice_projection`` (:2037), ``scaling_projection`` (:2041) and
``dotmul_projection`` (:2045) with ``mixed`` (:2137, also as the
``with mixed() as m: m += ...`` builder),
``layer_norm`` (:2414), ``multi_head_attention`` (:2420),
``pos_encoding`` (:2450), ``get_output`` (:2512), ``memory``,
``recurrent_group`` and ``StaticInput`` (``layers/recurrent_group.py``), and
``beam_search`` and ``GeneratedInput`` (``layers/generation.py``).  Each function returns a :class:`LayerOutput`
handle; the graph is gathered by parent traversal when a Topology is built.
Output-size bookkeeping (conv arithmetic) mirrors the reference's
config_parser.py ``cnn_output_size``.  Not ported yet: ``context_projection``,
``conv_projection`` and ``conv_operator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np

from paddle_tpu_torch import activation as _act_mod
from paddle_tpu_torch.activation import act_name
from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.core.data_types import InputType
from paddle_tpu_torch.core.topology import LayerConf, LayerOutput, auto_name
from paddle_tpu_torch.pooling import pool_name

# register the layer impls
from paddle_tpu_torch.layers import base as _base  # noqa: F401
from paddle_tpu_torch.layers import basic as _basic  # noqa: F401
from paddle_tpu_torch.layers import conv as _conv  # noqa: F401
from paddle_tpu_torch.layers import attention as _attention  # noqa: F401
from paddle_tpu_torch.layers import cost as _cost  # noqa: F401
from paddle_tpu_torch.layers import mixed as _mixed  # noqa: F401
from paddle_tpu_torch.layers import sequence as _sequence  # noqa: F401
from paddle_tpu_torch.layers import structured as _structured  # noqa: F401
from paddle_tpu_torch.layers.generation import GeneratedInput, beam_search  # noqa: F401
from paddle_tpu_torch.layers.recurrent_group import (  # noqa: F401
    StaticInput,
    SubsequenceInput,
    memory,
    recurrent_group,
)


class AggregateLevel:
    """Which nesting level a pooling or selection layer collapses
    (reference layers.py:248); the port runs TO_NO_SEQUENCE."""

    TO_NO_SEQUENCE = 0
    TO_SEQUENCE = 1
    EACH_TIMESTEP = 0
    EACH_SEQUENCE = 1


class ExpandLevel:
    """How expand broadcasts (reference layers.py:1704); the port runs
    FROM_NO_SEQUENCE."""

    FROM_NO_SEQUENCE = 0
    FROM_SEQUENCE = 1
    FROM_TIMESTEP = 0


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


_IMG_ATTR_KEYS = ("out_h", "out_w", "in_h", "in_w", "in_c", "channels")


def _img_passthrough(input: LayerOutput) -> dict:
    """Image-geometry attrs carried through shape-preserving layers (addto,
    batch_norm) so conv chains keep their spatial metadata."""
    a = input.conf.attrs
    out = {}
    c = a.get("channels") or a.get("in_c")
    h = a.get("out_h") or a.get("in_h")
    w = a.get("out_w") or a.get("in_w")
    if c is not None and h is not None:
        out.update(in_c=c, in_h=h, in_w=w, channels=c, out_h=h, out_w=w)
    return out


def cnn_output_size(
    img_size: int, filter_size: int, padding: int, stride: int, caffe_mode: bool = True
) -> int:
    """reference: python/paddle/trainer/config_parser.py cnn_output_size."""
    output = (2 * padding + img_size - filter_size) / float(stride)
    if caffe_mode:
        return 1 + int(math.floor(output))
    return 1 + int(math.ceil(output))


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


def concat(input: Sequence[LayerOutput], name: Optional[str] = None, act=None,
           bias_attr=False, layer_attr=None) -> LayerOutput:
    """Feature-axis concat (reference concat_layer)."""
    ins = _as_list(input)
    conf = LayerConf(
        name=name or auto_name("concat"),
        type="concat",
        size=sum(i.size for i in ins),
        inputs=tuple(i.name for i in ins),
        act=act_name(act),
        bias=False,
    )
    return LayerOutput(conf, ins)


concat_layer = concat


def scaling(weight: LayerOutput, input: LayerOutput, name=None) -> LayerOutput:
    """y = w * x, one weight per row (reference scaling_layer)."""
    conf = LayerConf(
        name=name or auto_name("scaling"),
        type="scaling",
        size=input.size,
        inputs=(weight.name, input.name),
        bias=False,
    )
    return LayerOutput(conf, [weight, input])


scaling_layer = scaling


def dropout(input: LayerOutput, dropout_rate: float, name: Optional[str] = None) -> LayerOutput:
    """Standalone dropout: an addto of one input with a drop_rate (the
    reference's dropout_layer is sugar over ExtraAttr.drop_rate)."""
    conf = LayerConf(
        name=name or auto_name("dropout"),
        type="addto",
        size=input.size,
        inputs=(input.name,),
        bias=False,
        attrs=_img_passthrough(input),
        drop_rate=dropout_rate,
    )
    return LayerOutput(conf, [input])


dropout_layer = dropout


# ---------------------------------------------------------------------------
# image layers
# ---------------------------------------------------------------------------


def _img_attrs(input: LayerOutput, num_channels: Optional[int]):
    a = input.conf.attrs
    in_c = num_channels or a.get("channels") or a.get("in_c")
    in_h = a.get("out_h") or a.get("in_h")
    in_w = a.get("out_w") or a.get("in_w")
    if in_h is None:
        # flat input, CHW order: width = floor(sqrt(pixels)), height =
        # pixels // width (reference config_parser.get_img_size)
        if not in_c:
            raise ValueError(f"num_channels required for flat input {input.name}")
        hw = input.size // in_c
        in_w = int(math.isqrt(hw))
        in_h = hw // in_w
        if in_h * in_w != hw:
            raise ValueError(
                f"{input.name}: cannot factor {hw} pixels into height x width "
                f"(got {in_h}x{in_w})"
            )
    return int(in_c), int(in_h), int(in_w)


def img_conv(
    input: LayerOutput,
    filter_size: int,
    num_filters: int,
    stride: int = 1,
    padding: int = 0,
    groups: int = 1,
    num_channels: Optional[int] = None,
    act=None,
    bias_attr: Union[bool, ParamAttr] = True,
    param_attr: Optional[ParamAttr] = None,
    trans: bool = False,
    caffe_mode: bool = True,
    filter_size_y: Optional[int] = None,
    stride_y: Optional[int] = None,
    padding_y: Optional[int] = None,
    shared_biases: bool = True,  # v1 per-channel bias sharing: always true here
    layer_type: Optional[str] = None,  # 'exconv'/'cudnn_conv' backend hint: cuDNN runs both
    name: Optional[str] = None,
    layer_attr: Optional[ExtraAttr] = None,
) -> LayerOutput:
    """reference img_conv_layer (layers.py) -> ExpandConvLayer/CudnnConvLayer."""
    if trans:
        raise NotImplementedError("img_conv(trans=True) (convt) is not ported yet")
    in_c, in_h, in_w = _img_attrs(input, num_channels)
    # reference accepts (x, y) tuples for filter_size/stride/padding
    if isinstance(filter_size, (list, tuple)):
        filter_size, filter_size_y = filter_size
    if isinstance(stride, (list, tuple)):
        stride, stride_y = stride
    if isinstance(padding, (list, tuple)):
        padding, padding_y = padding
    fh = filter_size_y or filter_size
    fw = filter_size
    sh = stride_y or stride
    sw = stride
    ph = padding_y if padding_y is not None else padding
    pw = padding
    out_h = cnn_output_size(in_h, fh, ph, sh, caffe_mode)
    out_w = cnn_output_size(in_w, fw, pw, sw, caffe_mode)
    drop, shard = _extra(layer_attr)
    conf = LayerConf(
        name=name or auto_name("conv"),
        type="conv",
        size=out_h * out_w * num_filters,
        inputs=(input.name,),
        act=act_name(act if act is not None else _act_mod.Relu()),
        bias=bool(bias_attr),
        attrs={
            "in_c": in_c,
            "in_h": in_h,
            "in_w": in_w,
            "filter_h": fh,
            "filter_w": fw,
            "stride_h": sh,
            "stride_w": sw,
            "pad_h": ph,
            "pad_w": pw,
            "groups": groups,
            **_param_attrs(param_attr),
            "channels": num_filters,
            "out_h": out_h,
            "out_w": out_w,
        },
        drop_rate=drop,
        shard_axis=shard,
    )
    _set_error_clip(conf, layer_attr)
    return LayerOutput(conf, [input])


img_conv_layer = img_conv


def img_pool(
    input: LayerOutput,
    pool_size: int,
    stride: int = 1,
    padding: int = 0,
    pool_type=None,
    num_channels: Optional[int] = None,
    pool_size_y: Optional[int] = None,
    stride_y: Optional[int] = None,
    padding_y: Optional[int] = None,
    ceil_mode: bool = True,
    name: Optional[str] = None,
) -> LayerOutput:
    """reference img_pool_layer -> PoolLayer; v1 uses ceil output sizing."""
    in_c, in_h, in_w = _img_attrs(input, num_channels)
    kh = pool_size_y or pool_size
    kw = pool_size
    sh = stride_y or stride
    sw = stride
    ph = padding_y if padding_y is not None else padding
    pw = padding
    out_h = cnn_output_size(in_h, kh, ph, sh, caffe_mode=not ceil_mode)
    out_w = cnn_output_size(in_w, kw, pw, sw, caffe_mode=not ceil_mode)
    conf = LayerConf(
        name=name or auto_name("pool"),
        type="pool",
        size=out_h * out_w * in_c,
        inputs=(input.name,),
        bias=False,
        attrs={
            "in_c": in_c,
            "in_h": in_h,
            "in_w": in_w,
            "filter_h": kh,
            "filter_w": kw,
            "stride_h": sh,
            "stride_w": sw,
            "pad_h": ph,
            "pad_w": pw,
            "pool_type": pool_name(pool_type),
            "channels": in_c,
            "out_h": out_h,
            "out_w": out_w,
        },
    )
    return LayerOutput(conf, [input])


img_pool_layer = img_pool


def batch_norm(
    input: LayerOutput,
    act=None,
    num_channels: Optional[int] = None,
    epsilon: float = 1e-5,
    moving_average_fraction: float = 0.9,
    use_global_stats: Optional[bool] = None,
    bias_attr=True,
    param_attr: Optional[ParamAttr] = None,
    layer_attr: Optional[ExtraAttr] = None,
    batch_norm_type: Optional[str] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    """Batch norm over the channels of an image input (or the features of a
    flat one).  As in the JAX package, the layer is built without a shift
    whatever `bias_attr` says."""
    a = input.conf.attrs
    img = (a.get("out_h") or a.get("in_h")) is not None
    if img:
        in_c, in_h, in_w = _img_attrs(input, num_channels)
        attrs = {
            **_param_attrs(param_attr),
            "channels": in_c,
            "in_h": in_h,
            "in_w": in_w,
            "in_c": in_c,
            "out_h": in_h,
            "out_w": in_w,
        }
    else:
        attrs = {"channels": num_channels or input.size}
    attrs.update(
        epsilon=epsilon,
        moving_average_fraction=moving_average_fraction,
        use_global_stats=bool(use_global_stats),
    )
    conf = LayerConf(
        name=name or auto_name("batch_norm"),
        type="batch_norm",
        size=input.size,
        inputs=(input.name,),
        act=act_name(act),
        bias=False,
        attrs=attrs,
    )
    return LayerOutput(conf, [input])


batch_norm_layer = batch_norm


# ---------------------------------------------------------------------------
# sequence layers
# ---------------------------------------------------------------------------


def pooling(
    input: LayerOutput,
    pooling_type=None,
    agg_level: int = AggregateLevel.TO_NO_SEQUENCE,
    stride: int = -1,
    bias_attr=False,
    name: Optional[str] = None,
    layer_attr=None,
) -> LayerOutput:
    """Pool a sequence over time (reference pooling_layer)."""
    if stride > 0 and agg_level != AggregateLevel.TO_NO_SEQUENCE:
        raise ValueError("stride pooling is TO_NO_SEQUENCE only")
    conf = LayerConf(
        name=name or auto_name("seqpool"),
        type="seqpool",
        size=input.size,
        inputs=(input.name,),
        bias=False,
        attrs={
            "pool_type": pool_name(pooling_type),
            "agg_level": agg_level,
            "stride": stride,
            "output_max_index": bool(getattr(pooling_type, "output_max_index", False)),
        },
    )
    return LayerOutput(conf, [input])


pooling_layer = pooling


def last_seq(input: LayerOutput, agg_level: int = AggregateLevel.TO_NO_SEQUENCE,
             stride: int = -1, name: Optional[str] = None, layer_attr=None) -> LayerOutput:
    return _unary("seqlastins", input, name=name, select_first=False,
                  agg_level=agg_level, stride=stride)


def first_seq(input: LayerOutput, agg_level: int = AggregateLevel.TO_NO_SEQUENCE,
              stride: int = -1, name: Optional[str] = None, layer_attr=None) -> LayerOutput:
    return _unary("seqlastins", input, name=name, select_first=True,
                  agg_level=agg_level, stride=stride)


def expand(input: LayerOutput, expand_as: LayerOutput,
           expand_level: int = ExpandLevel.FROM_NO_SEQUENCE,
           name: Optional[str] = None) -> LayerOutput:
    conf = LayerConf(
        name=name or auto_name("expand"),
        type="expand",
        size=input.size,
        inputs=(input.name, expand_as.name),
        bias=False,
        attrs={"expand_level": expand_level},
    )
    return LayerOutput(conf, [input, expand_as])


expand_layer = expand


def grumemory(
    input: LayerOutput,
    size: Optional[int] = None,
    reverse: bool = False,
    act=None,
    gate_act=None,
    bias_attr=True,
    param_attr: Optional[ParamAttr] = None,
    layer_attr: Optional[ExtraAttr] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    """A GRU over a sequence pre-projected to 3 x size (reference
    grumemory)."""
    size = size or input.size // 3
    if input.size != 3 * size:
        raise ValueError(f"grumemory input size {input.size} != 3 x size {size}")
    drop, shard = _extra(layer_attr)
    conf = LayerConf(
        name=name or auto_name("gru"),
        type="gru",
        size=size,
        inputs=(input.name,),
        bias=bool(bias_attr),
        drop_rate=drop,
        shard_axis=shard,
        attrs={
            "reverse": reverse,
            "active_type": act_name(act if act is not None else _act_mod.Tanh()),
            "gate_act": act_name(gate_act if gate_act is not None else _act_mod.Sigmoid()),
            **_param_attrs(param_attr),
        },
    )
    _set_error_clip(conf, layer_attr)
    return LayerOutput(conf, [input])


def lstmemory(
    input: LayerOutput,
    size: Optional[int] = None,
    reverse: bool = False,
    act=None,
    gate_act=None,
    state_act=None,
    bias_attr=True,
    param_attr: Optional[ParamAttr] = None,
    layer_attr: Optional[ExtraAttr] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    """An LSTM over a sequence pre-projected to 4 x size (reference
    lstmemory); with a bias it has the three peepholes."""
    size = size or input.size // 4
    if input.size != 4 * size:
        raise ValueError(f"lstmemory input size {input.size} must be 4*size ({4 * size})")
    drop, shard = _extra(layer_attr)
    conf = LayerConf(
        name=name or auto_name("lstmemory"),
        type="lstmemory",
        size=size,
        inputs=(input.name,),
        bias=bool(bias_attr),
        drop_rate=drop,
        shard_axis=shard,
        attrs={
            "reverse": reverse,
            "active_type": act_name(act if act is not None else _act_mod.Tanh()),
            "gate_act": act_name(gate_act if gate_act is not None else _act_mod.Sigmoid()),
            "state_act": act_name(state_act if state_act is not None else _act_mod.Tanh()),
            **_param_attrs(param_attr),
        },
    )
    _set_error_clip(conf, layer_attr)
    return LayerOutput(conf, [input])


def recurrent(
    input: LayerOutput,
    act=None,
    reverse: bool = False,
    bias_attr=True,
    param_attr: Optional[ParamAttr] = None,
    layer_attr: Optional[ExtraAttr] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    """The simple recurrence h_t = act(x_t + h_p W) over a sequence of the
    layer's width (reference recurrent_layer).  A named param_attr shares
    the recurrent weight and a named bias_attr the bias, each under its own
    name."""
    drop, shard = _extra(layer_attr)
    pnames = {}
    pn = _param_name(param_attr)
    if pn:
        pnames["w_h"] = pn
    if isinstance(bias_attr, ParamAttr) and bias_attr.name:
        pnames["b"] = bias_attr.name
    conf = LayerConf(
        name=name or auto_name("recurrent"),
        type="recurrent",
        size=input.size,
        inputs=(input.name,),
        act=act_name(act if act is not None else _act_mod.Tanh()),
        bias=bool(bias_attr),
        drop_rate=drop,
        shard_axis=shard,
        attrs={
            "reverse": reverse,
            "param_std": _param_std(param_attr),
            "prune_sparsity": _prune_ratio(param_attr),
            **({"param_names": pnames} if pnames else {}),
        },
    )
    _set_error_clip(conf, layer_attr)
    return LayerOutput(conf, [input])


recurrent_layer = recurrent


def _step_param_names(param_attr, bias_attr, weight_keys) -> dict:
    """param_names of a step cell: one reference parameter name ties every
    recurrent weight key; a named bias attr ties the bias."""
    pnames = {}
    pn = _param_name(param_attr)
    if pn:
        for k in weight_keys:
            pnames[k] = f"{pn}#{k}"
    if isinstance(bias_attr, ParamAttr) and bias_attr.name:
        pnames["b"] = bias_attr.name
    return pnames


def gru_step(
    input: LayerOutput,
    output_mem: LayerOutput,
    size: Optional[int] = None,
    act=None,
    gate_act=None,
    bias_attr=True,
    param_attr: Optional[ParamAttr] = None,
    layer_attr=None,
    name: Optional[str] = None,
    naive: bool = False,
) -> LayerOutput:
    """One GRU step (reference gru_step_layer): input pre-projected to 3H,
    output_mem the previous state (usually a memory).  naive=True with a
    named param_attr ties the three recurrent blocks to one H x H matrix."""
    size = size or output_mem.size
    if input.size != 3 * size:
        raise ValueError(f"gru_step input size {input.size} != 3 x size {size}")
    tied = naive and _param_name(param_attr) is not None
    if tied:
        pnames = _step_param_names(param_attr, bias_attr, ("w",))
        pnames["w"] = _param_name(param_attr)
    else:
        pnames = _step_param_names(param_attr, bias_attr, ("w_h", "w_c"))
    conf = LayerConf(
        name=name or auto_name("gru_step"),
        type="gru_step",
        size=size,
        inputs=(input.name, output_mem.name),
        bias=bool(bias_attr),
        attrs={
            "active_type": act_name(act if act is not None else _act_mod.Tanh()),
            "gate_act": act_name(gate_act if gate_act is not None else _act_mod.Sigmoid()),
            "param_std": _param_std(param_attr),
            **({"naive": True} if naive else {}),
            **({"tied_weights": True} if tied else {}),
            **({"param_names": pnames} if pnames else {}),
        },
    )
    return LayerOutput(conf, [input, output_mem])


gru_step_layer = gru_step


def lstm_step(
    input: LayerOutput,
    output_mem: LayerOutput,
    state_mem: LayerOutput,
    size: Optional[int] = None,
    act=None,
    gate_act=None,
    state_act=None,
    bias_attr=True,
    recurrent_weight: bool = True,
    layer_attr=None,
    name: Optional[str] = None,
) -> LayerOutput:
    """One LSTM step (reference lstm_step_layer); the cell is the side output
    ``<name>@cell`` for a second memory link.  recurrent_weight=False is the
    reference's form (the recurrence enters through the input, as
    lstmemory_unit's mixed projection); True keeps W_h inside the step."""
    size = size or output_mem.size
    if input.size != 4 * size:
        raise ValueError(f"lstm_step input size {input.size} != 4 x size {size}")
    pnames = _step_param_names(None, bias_attr, ())
    conf = LayerConf(
        name=name or auto_name("lstm_step"),
        type="lstm_step",
        size=size,
        inputs=(input.name, output_mem.name, state_mem.name),
        bias=bool(bias_attr),
        attrs={
            "active_type": act_name(act if act is not None else _act_mod.Tanh()),
            "gate_act": act_name(gate_act if gate_act is not None else _act_mod.Sigmoid()),
            "state_act": act_name(state_act if state_act is not None else _act_mod.Tanh()),
            "recurrent_weight": recurrent_weight,
            **({"param_names": pnames} if pnames else {}),
        },
    )
    return LayerOutput(conf, [input, output_mem, state_mem])


lstm_step_layer = lstm_step


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


# ---------------------------------------------------------------------------
# structured prediction: crf / crf_decoding
# ---------------------------------------------------------------------------


def crf(
    input: LayerOutput,
    label: LayerOutput,
    size: Optional[int] = None,
    param_attr: Optional[ParamAttr] = None,
    layer_attr: Optional[ExtraAttr] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    """Linear-chain CRF cost (reference crf_layer)."""
    n = size or input.size
    conf = LayerConf(
        name=name or auto_name("crf"),
        type="crf",
        size=1,
        inputs=(input.name, label.name),
        bias=False,
        attrs={"num_classes": n, **_param_attrs(param_attr)},
    )
    return LayerOutput(conf, [input, label])


crf_layer = crf


def crf_decoding(
    input: LayerOutput,
    size: Optional[int] = None,
    label: Optional[LayerOutput] = None,
    param_attr: Optional[ParamAttr] = None,
    layer_attr: Optional[ExtraAttr] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    """Viterbi decoding (reference crf_decoding_layer); with `label`, the
    per-position mismatch map."""
    n = size or input.size
    parents = [input] + ([label] if label is not None else [])
    conf = LayerConf(
        name=name or auto_name("crf_decoding"),
        type="crf_decoding",
        size=n,
        inputs=tuple(p.name for p in parents),
        bias=False,
        attrs={"num_classes": n, **_param_attrs(param_attr)},
    )
    return LayerOutput(conf, parents)


crf_decoding_layer = crf_decoding


# ---------------------------------------------------------------------------
# mixed and its projections
# ---------------------------------------------------------------------------


class Projection:
    """One term of a mixed layer.  Not a graph node: the enclosing mixed
    layer owns its parameters (the reference's Projection objects live
    inside MixedLayer)."""

    def __init__(self, kind: str, input: LayerOutput, **attrs):
        self.kind = kind
        self.input = input
        self.attrs = attrs


def _weighted_projection(kind: str, input: LayerOutput, size: int = 0,
                         param_attr: Optional[ParamAttr] = None) -> Projection:
    return Projection(kind, input, size=size, param_std=_param_std(param_attr),
                      param_name=_param_name(param_attr))


def full_matrix_projection(input: LayerOutput, size: int = 0,
                           param_attr: Optional[ParamAttr] = None) -> Projection:
    return _weighted_projection("full_matrix", input, size, param_attr)


def trans_full_matrix_projection(input: LayerOutput, size: int = 0,
                                 param_attr: Optional[ParamAttr] = None) -> Projection:
    return _weighted_projection("trans_full_matrix", input, size, param_attr)


def table_projection(input: LayerOutput, size: int = 0,
                     param_attr: Optional[ParamAttr] = None) -> Projection:
    return _weighted_projection("table", input, size, param_attr)


def identity_projection(input: LayerOutput, offset: Optional[int] = None,
                        size: int = 0) -> Projection:
    if offset is None:
        return Projection("identity", input)
    return Projection("identity_offset", input, offset=offset, size=size)


def slice_projection(input: LayerOutput, slices: Sequence[tuple]) -> Projection:
    return Projection("slice", input, slices=tuple(tuple(s) for s in slices))


def scaling_projection(input: LayerOutput) -> Projection:
    return Projection("scaling", input)


def dotmul_projection(input: LayerOutput, param_attr: Optional[ParamAttr] = None) -> Projection:
    return Projection("dotmul", input, param_std=_param_std(param_attr),
                      param_name=_param_name(param_attr))


def mixed(
    size: int = 0,
    input=None,
    name: Optional[str] = None,
    act=None,
    bias_attr: Union[bool, ParamAttr, None] = False,
    layer_attr: Optional[ExtraAttr] = None,
) -> LayerOutput:
    """The sum of projections (reference mixed_layer); a plain layer given
    as input enters as an identity term.  Projection j's weight is
    ``p{j}_w``, shared by its param_attr's name.  With no input, returns
    the v1 builder::

        with mixed(size=...) as m:
            m += full_matrix_projection(x)
    """
    if input is None:
        return _MixedBuilder(size=size, name=name, act=act, bias_attr=bias_attr,
                             layer_attr=layer_attr)
    items = [input] if isinstance(input, (Projection, LayerOutput)) else list(input)
    parents: list = []
    specs: list = []
    for item in items:
        if isinstance(item, Projection):
            lo, kind, attrs = item.input, item.kind, dict(item.attrs)
        else:
            lo, kind, attrs = item, "identity", {}
        names = [p.name for p in parents]
        if lo.name not in names:
            parents.append(lo)
            names.append(lo.name)
        specs.append({"kind": kind, "in": names.index(lo.name), **attrs})
    if size == 0:
        inferred = [
            parents[s["in"]].size for s in specs
            if s["kind"] in ("identity", "dotmul", "scaling")
        ] + [s["size"] for s in specs if s.get("size")] + [
            sum(e - b for b, e in s["slices"]) for s in specs if s["kind"] == "slice"
        ]
        if not inferred:
            raise ValueError("mixed() needs an explicit size")
        size = inferred[0]
    pnames = {f"p{j}_w": s["param_name"] for j, s in enumerate(specs) if s.get("param_name")}
    if isinstance(bias_attr, ParamAttr) and bias_attr.name:
        pnames["b"] = bias_attr.name
    drop, shard = _extra(layer_attr)
    conf = LayerConf(
        name=name or auto_name("mixed"),
        type="mixed",
        size=size,
        inputs=tuple(p.name for p in parents),
        act=act_name(act),
        bias=bool(bias_attr),
        drop_rate=drop,
        shard_axis=shard,
        attrs={
            "projections": tuple(specs),
            **({"param_names": pnames} if pnames else {}),
        },
    )
    _set_error_clip(conf, layer_attr)
    return LayerOutput(conf, parents)


class _MixedBuilder(LayerOutput):
    """``with mixed() as m: m += projection`` (reference MixedLayerType):
    the object becomes the mixed layer's LayerOutput when the block exits."""

    def __init__(self, **kw):
        self._kw = kw
        self._terms: list = []
        self.conf = None  # set on __exit__
        self.parents = ()

    def __enter__(self):
        return self

    def __iadd__(self, term):
        self._terms.append(term)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        if not self._terms:
            raise ValueError("mixed() block added no projections")
        built = mixed(input=self._terms, **self._kw)
        self.conf = built.conf
        self.parents = built.parents
        return False


mixed_layer = mixed


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


def get_output(input: LayerOutput, arg_name: str, size: Optional[int] = None,
               name: Optional[str] = None) -> LayerOutput:
    """A named side output of a layer (reference get_output_layer), e.g.
    the beam scores ('scores') of a beam_search layer.  `size` overrides
    the declared width of a side output shaped unlike the main output."""
    if size is None:
        if input.conf.type == "beam_search" and arg_name == "scores":
            size = input.conf.attrs["beam_size"]
        else:
            size = input.size
    conf = LayerConf(name=name or auto_name("get_output"), type="get_output", size=size,
                     inputs=(input.name,), bias=False, attrs={"arg_name": arg_name})
    return LayerOutput(conf, [input])


get_output_layer = get_output
