"""Layer DSL of the port — a copy of ``paddle_tpu/layers/__init__.py``, the
user surface of ``paddle.trainer_config_helpers.layers`` and
``paddle.v2.layer`` (reference: python/paddle/trainer_config_helpers/
layers.py, python/paddle/v2/layer.py).  Every public callable of the JAX
package's DSL is here and builds the same Topology (``Topology.serialize()``
is byte-identical), and every layer type it builds has a torch impl.

Each function returns a :class:`LayerOutput` handle; the graph is gathered
by parent traversal when a Topology is built.  Output-size bookkeeping (conv
arithmetic, implicit flatten) mirrors the reference's config_parser.py
``cnn_output_size``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np

from paddle_tpu_torch import activation as _act_mod
from paddle_tpu_torch.activation import act_name
from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.core.data_types import InputType
from paddle_tpu_torch.core.topology import LayerConf, LayerOutput, Topology, auto_name
from paddle_tpu_torch.pooling import pool_name

# register the layer impls: all 95 of the JAX package's types
from paddle_tpu_torch.layers import base as _base  # noqa: F401
from paddle_tpu_torch.layers import basic as _basic  # noqa: F401
from paddle_tpu_torch.layers import conv as _conv  # noqa: F401
from paddle_tpu_torch.layers import cost as _cost  # noqa: F401
from paddle_tpu_torch.layers import mixed as _mixed_impl  # noqa: F401
from paddle_tpu_torch.layers import structured as _structured  # noqa: F401
from paddle_tpu_torch.layers import sequence as _sequence  # noqa: F401
from paddle_tpu_torch.layers import misc as _misc  # noqa: F401
from paddle_tpu_torch.layers import sampled as _sampled  # noqa: F401
from paddle_tpu_torch.layers import detection as _detection  # noqa: F401
from paddle_tpu_torch.layers import moe as _moe  # noqa: F401
from paddle_tpu_torch.layers import mdlstm as _mdlstm  # noqa: F401
from paddle_tpu_torch.layers.recurrent_group import (  # noqa: F401
    StaticInput,
    SubsequenceInput,
    memory,
    recurrent_group,
)
from paddle_tpu_torch.layers.generation import (  # noqa: F401
    GeneratedInput,
    beam_search,
)
from paddle_tpu_torch.layers import attention as _attention  # noqa: F401
from paddle_tpu_torch.layers import layer_math  # noqa: F401  (also patches LayerOutput operators)


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


def _dynamic_width(i: LayerOutput) -> bool:
    """A SIZE-CONSUMING layer (fc, mixed matrix projections) stacked on a
    dynamic-width input — e.g. trans(height=None), whose true width is the
    runtime batch size — cannot know its weight height at build time.  The
    conf gets tagged instead of warned: weights init at the declared static
    size for config parity (the reference keeps the static size too,
    TransLayer config_parser.py:2129, protostr dims 100x100 — and then can
    only RUN at batch == size), and the trainer resolves the true width from
    the first batch via CompiledNetwork.resolve_dynamic_widths."""
    return bool(i.conf.attr("dynamic_size"))


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


def _param_attrs(param_attr: Optional[ParamAttr]) -> dict:
    return {
        "param_std": _param_std(param_attr),
        "param_name": _param_name(param_attr),
        "prune_sparsity": _prune_ratio(param_attr),
    }


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


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# fc
# ---------------------------------------------------------------------------


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
    dyn_in = tuple(idx for idx, i in enumerate(ins) if _dynamic_width(i))
    drop, shard = _extra(layer_attr)
    if isinstance(param_attr, (list, tuple)):
        # per-input weight attrs (reference fc_layer param_attr list): each
        # input i gets weight w{i}; named attrs share storage by name —
        # including the same name twice within one layer (shared_fc.py)
        assert len(param_attr) == len(ins), (
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
        pnames = (
            {f"w{i}": shared_name for i in range(len(ins))}
            if shared_name
            else {}
        )
    if isinstance(bias_attr, ParamAttr) and bias_attr.name:
        pnames["b"] = bias_attr.name
    if pnames:
        attrs["param_names"] = pnames
    if dyn_in:
        attrs["dynamic_width_in"] = dyn_in
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
    ins = _as_list(input)
    if any(isinstance(i, Projection) for i in ins):
        # reference concat2 (ConcatenateLayer2.cpp): concat of PROJECTIONS —
        # each projection becomes a single-term mixed layer, then an
        # ordinary feature concat
        ins = [
            mixed(input=[i], name=auto_name((name or "concat") + "_proj"))
            if isinstance(i, Projection)
            else i
            for i in ins
        ]
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
    if trans:
        if num_filters % groups or in_c % groups:
            raise ValueError(
                f"transpose conv groups={groups} must divide both in_c "
                f"({in_c}) and num_filters ({num_filters})"
            )
        out_h = _conv.convt_output_size(in_h, fh, ph, sh)
        out_w = _conv.convt_output_size(in_w, fw, pw, sw)
    else:
        out_h = cnn_output_size(in_h, fh, ph, sh, caffe_mode)
        out_w = cnn_output_size(in_w, fw, pw, sw, caffe_mode)
    drop, shard = _extra(layer_attr)
    conf = LayerConf(
        name=name or auto_name("conv"),
        type="convt" if trans else "conv",
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


def maxout(
    input: LayerOutput,
    groups: int,
    num_channels: Optional[int] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    in_c, in_h, in_w = _img_attrs(input, num_channels)
    out_c = in_c // groups
    conf = LayerConf(
        name=name or auto_name("maxout"),
        type="maxout",
        size=in_h * in_w * out_c,
        inputs=(input.name,),
        bias=False,
        attrs={
            "in_c": in_c,
            "in_h": in_h,
            "in_w": in_w,
            "groups": groups,
            "channels": out_c,
            "out_h": in_h,
            "out_w": in_w,
        },
    )
    return LayerOutput(conf, [input])


maxout_layer = maxout


def spp(
    input: LayerOutput,
    pyramid_height: int = 3,
    pool_type=None,
    num_channels: Optional[int] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    in_c, in_h, in_w = _img_attrs(input, num_channels)
    size = in_c * sum((2**l) * (2**l) for l in range(pyramid_height))
    conf = LayerConf(
        name=name or auto_name("spp"),
        type="spp",
        size=size,
        inputs=(input.name,),
        bias=False,
        attrs={
            "in_c": in_c,
            "in_h": in_h,
            "in_w": in_w,
            "pyramid_height": pyramid_height,
            "pool_type": pool_name(pool_type),
        },
    )
    return LayerOutput(conf, [input])


spp_layer = spp


def bilinear_interp(
    input: LayerOutput,
    out_size_x: int,
    out_size_y: int,
    num_channels: Optional[int] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    in_c, in_h, in_w = _img_attrs(input, num_channels)
    conf = LayerConf(
        name=name or auto_name("bilinear_interp"),
        type="bilinear_interp",
        size=out_size_x * out_size_y * in_c,
        inputs=(input.name,),
        bias=False,
        attrs={
            "in_c": in_c,
            "in_h": in_h,
            "in_w": in_w,
            "out_h": out_size_y,
            "out_w": out_size_x,
            "channels": in_c,
        },
    )
    return LayerOutput(conf, [input])


bilinear_interp_layer = bilinear_interp


def img_pad(
    input: LayerOutput,
    pad_c=(0, 0),
    pad_h=(0, 0),
    pad_w=(0, 0),
    num_channels: Optional[int] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    in_c, in_h, in_w = _img_attrs(input, num_channels)
    out_c = in_c + sum(pad_c)
    out_h = in_h + sum(pad_h)
    out_w = in_w + sum(pad_w)
    conf = LayerConf(
        name=name or auto_name("pad"),
        type="pad",
        size=out_c * out_h * out_w,
        inputs=(input.name,),
        bias=False,
        attrs={
            "in_c": in_c,
            "in_h": in_h,
            "in_w": in_w,
            "pad_c": tuple(pad_c),
            "pad_h_pair": tuple(pad_h),
            "pad_w_pair": tuple(pad_w),
            "channels": out_c,
            "out_h": out_h,
            "out_w": out_w,
        },
    )
    return LayerOutput(conf, [input])


pad_layer = img_pad


def crop(
    input: Inputish,
    offset: Optional[Sequence[int]] = None,
    axis: int = 2,
    shape: Optional[Sequence[int]] = None,
    name: Optional[str] = None,
    layer_attr=None,
) -> LayerOutput:
    """reference crop_layer (layers.py:6044) → CropLayer.cpp: crop the image
    input to `shape` — or to a second reference input's geometry — starting
    at `axis` (1=C,H,W; 2=H,W; 3=W), at the given offsets (default 0)."""
    ins = _as_list(input)
    x = ins[0]
    in_c, in_h, in_w = _img_attrs(x, None)
    if len(ins) == 2:
        rc, rh, rw = _img_attrs(ins[1], None)
        target = (rc, rh, rw)
    else:
        assert shape is not None, "crop_layer needs a reference input or shape"
        s = list(shape)
        # shape names the cropped trailing dims starting at `axis` (NCHW)
        tail = {1: 3, 2: 2, 3: 1}[axis]
        assert len(s) >= tail, f"crop shape {shape} too short for axis {axis}"
        s = s[-tail:]
        target = (in_c, in_h, in_w)
        target = tuple(
            s[i - (3 - tail)] if i >= 3 - tail else target[i] for i in range(3)
        )
    out_c = target[0] if axis <= 1 else in_c
    out_h = target[1] if axis <= 2 else in_h
    out_w = target[2]
    # offset entries align to the cropped axes starting at `axis` (reference
    # crop_layer: axis=2, offset=[h, w]) — pad MISSING LEADING axes with 0
    offs = list(offset) if offset is not None else []
    offs = [0] * (3 - len(offs)) + offs
    conf = LayerConf(
        name=name or auto_name("crop"),
        type="crop",
        size=out_c * out_h * out_w,
        inputs=tuple(i.name for i in ins),
        bias=False,
        attrs={
            "in_c": in_c, "in_h": in_h, "in_w": in_w,
            "out_c": out_c, "out_h": out_h, "out_w": out_w,
            "offset_c": offs[0] if axis <= 1 else 0,
            "offset_h": offs[1] if axis <= 2 else 0,
            "offset_w": offs[2],
            "channels": out_c,
        },
    )
    return LayerOutput(conf, ins)


crop_layer = crop


# ---------------------------------------------------------------------------
# simple math layers
# ---------------------------------------------------------------------------


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


def slope_intercept(input, slope=1.0, intercept=0.0, name=None):
    return _unary("slope_intercept", input, name=name, slope=slope, intercept=intercept)


slope_intercept_layer = slope_intercept


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


def interpolation(
    weight: LayerOutput = None,
    input1: LayerOutput = None,
    input2: LayerOutput = None,
    input: Optional[Sequence[LayerOutput]] = None,
    name=None,
    layer_attr=None,
) -> LayerOutput:
    """y = w*x1 + (1-w)*x2.  Accepts either the positional (weight, x1, x2)
    form or the reference interpolation_layer(input=[x1, x2], weight=w)."""
    if input is not None:
        input1, input2 = input
    conf = LayerConf(
        name=name or auto_name("interpolation"),
        type="interpolation",
        size=input1.size,
        inputs=(weight.name, input1.name, input2.name),
        bias=False,
    )
    return LayerOutput(conf, [weight, input1, input2])


interpolation_layer = interpolation


def sum_to_one_norm(input, name=None):
    return _unary("sum_to_one_norm", input, name=name)


sum_to_one_norm_layer = sum_to_one_norm


def row_l2_norm(input, name=None):
    return _unary("row_l2_norm", input, name=name)


row_l2_norm_layer = row_l2_norm


def clip(input, min=-1.0, max=1.0, name=None):
    return _unary("clip", input, name=name, min=min, max=max)


clip_layer = clip


def maxid(input, name=None):
    return _unary("maxid", input, size=1, name=name)


maxid_layer = maxid


def trans(input, height: Optional[int] = None, name=None, layer_attr=None):
    """height=None: whole-minibatch transpose (reference trans_layer →
    TransLayer.cpp); height=H: per-sample [H, W] feature-block transpose
    (the rotate/trans feature-map variant).

    For height=None the output feature width is the RUNTIME batch size; the
    static conf size stays input.size for config parity with the reference
    parser (TransLayer, config_parser.py:2122-2129 keeps input size), but
    the conf is tagged dynamic_size so size-consuming consumers (fc) warn
    that their static weight shape only matches batch == input.size."""
    dyn = {"dynamic_size": True} if height is None else {}
    return _unary("trans", input, name=name, height=height, **dyn)


trans_layer = trans


def repeat(input, num_repeats: int, as_row_vector: bool = True, act=None,
           name=None, layer_attr=None):
    """reference repeat_layer (layers.py:1778): tile the feature vector
    num_repeats times (row-vector order) or repeat each element
    (column-vector order)."""
    ins = _as_list(input)
    conf = LayerConf(
        name=name or auto_name("repeat"),
        type="repeat",
        size=ins[0].size * num_repeats,
        inputs=(ins[0].name,),
        act=act_name(act),
        bias=False,
        attrs={"num_repeats": num_repeats, "as_row_vector": as_row_vector},
    )
    return LayerOutput(conf, ins)


repeat_layer = repeat


def featmap_expand(input, num_filters: int, as_row_vector: bool = True,
                   name=None):
    """reference featmap_expand_layer (FeatureMapExpandLayer.cpp): tile a
    feature map across num_filters channels, row- or column-vector order."""
    ins = _as_list(input)
    conf = LayerConf(
        name=name or auto_name("featmap_expand"),
        type="featmap_expand",
        size=ins[0].size * num_filters,
        inputs=(ins[0].name,),
        act="identity",
        bias=False,
        attrs={"num_filters": num_filters, "as_row_vector": as_row_vector},
    )
    return LayerOutput(conf, ins)


featmap_expand_layer = featmap_expand


def resize(input, size: int, name=None):
    return _unary("resize", input, size=size, name=name)


resize_layer = resize


def multiplex(input: Sequence[LayerOutput], name=None) -> LayerOutput:
    ins = _as_list(input)
    conf = LayerConf(
        name=name or auto_name("multiplex"),
        type="multiplex",
        size=ins[1].size,
        inputs=tuple(i.name for i in ins),
        bias=False,
    )
    return LayerOutput(conf, ins)


multiplex_layer = multiplex


def dotmul_operator(a: LayerOutput, b: LayerOutput, scale: float = 1.0, name=None):
    conf = LayerConf(
        name=name or auto_name("dotmul"),
        type="dotmul",
        size=a.size,
        inputs=(a.name, b.name),
        bias=False,
        attrs={"scale": scale},
    )
    return LayerOutput(conf, [a, b])


def moe(
    input: LayerOutput,
    expert_hidden: int,
    num_experts: int,
    size: Optional[int] = None,
    capacity_factor: float = 1.25,
    act=None,
    bias_attr: Union[bool, ParamAttr] = True,
    param_attr: Optional[ParamAttr] = None,
    layer_attr: Optional[ExtraAttr] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    """Mixture-of-experts FFN with top-1 capacity routing (layers/moe.py).
    ``layer_attr=ExtraAttr(shard_axis='model')`` shards the experts over the
    mesh model axis in the JAX package (expert parallelism); the port runs
    such a layer unsharded on one device, with the same values.  The router's load-balance term rides the aux output
    ``<name>@aux_loss`` (pick it up via get_output + sum_cost)."""
    drop, shard = _extra(layer_attr)
    conf = LayerConf(
        name=name or auto_name("moe"),
        type="moe",
        size=size or input.size,
        inputs=(input.name,),
        bias=bool(bias_attr),
        drop_rate=drop,
        shard_axis=shard,
        attrs={
            "num_experts": num_experts,
            "expert_hidden": expert_hidden,
            "capacity_factor": capacity_factor,
            "active_type": act_name(act if act is not None else _act_mod.Relu()),
            **_param_attrs(param_attr),
        },
    )
    _set_error_clip(conf, layer_attr)
    return LayerOutput(conf, [input])


moe_layer = moe


def gated_unit(
    input: LayerOutput,
    size: int,
    act=None,
    name: Optional[str] = None,
    gate_attr=None,
    gate_param_attr: Optional[ParamAttr] = None,
    gate_bias_attr=True,
    inproj_attr=None,
    inproj_param_attr: Optional[ParamAttr] = None,
    inproj_bias_attr=True,
    layer_attr=None,
) -> LayerOutput:
    """reference gated_unit_layer (layers.py): GLU — proj(input) ⊙
    σ(gate(input)) (Dauphin et al.; the conv_seq_to_seq building block)."""
    proj = fc(
        input, size=size,
        act=act if act is not None else _act_mod.Identity(),
        bias_attr=inproj_bias_attr,
        param_attr=inproj_param_attr, layer_attr=inproj_attr,
        name=(name + "_input_proj") if name else None,
    )
    gate = fc(
        input, size=size, act=_act_mod.Sigmoid(), bias_attr=gate_bias_attr,
        param_attr=gate_param_attr, layer_attr=gate_attr,
        name=(name + "_gate") if name else None,
    )
    return dotmul_operator(a=proj, b=gate, name=name)


gated_unit_layer = gated_unit


def out_prod(input1: LayerOutput, input2: LayerOutput, name=None) -> LayerOutput:
    conf = LayerConf(
        name=name or auto_name("out_prod"),
        type="out_prod",
        size=input1.size * input2.size,
        inputs=(input1.name, input2.name),
        bias=False,
    )
    return LayerOutput(conf, [input1, input2])


out_prod_layer = out_prod


def cos_sim(a: LayerOutput, b: LayerOutput, scale: float = 1.0, size: int = 1,
            name=None, layer_attr=None) -> LayerOutput:
    """size>1: b holds `size` concatenated vectors of a's width; one cosine
    per vector (reference cos_sim size param → CosSimLayer N similarities)."""
    if size > 1:
        assert b.size == a.size * size, (
            f"cos_sim size={size}: b.size {b.size} != a.size*{size}"
        )
    conf = LayerConf(
        name=name or auto_name("cos_sim"),
        type="cos",
        size=size,
        inputs=(a.name, b.name),
        bias=False,
        attrs={"scale": scale, "cos_n": size},
    )
    return LayerOutput(conf, [a, b])


def tensor(*args, **kwargs):
    """reference tensor_layer(a=..., b=..., size=...): bilinear
    y_k = a W_k b^T.  Accepts the (input1, input2, ...) positional form
    too."""
    if "a" in kwargs:
        kwargs["input1"] = kwargs.pop("a")
    if "b" in kwargs:
        kwargs["input2"] = kwargs.pop("b")
    kwargs.pop("layer_attr", None)
    return _tensor_impl(*args, **kwargs)


def _tensor_impl(
    input1: LayerOutput,
    input2: LayerOutput,
    size: int,
    act=None,
    bias_attr=True,
    name=None,
) -> LayerOutput:
    conf = LayerConf(
        name=name or auto_name("tensor"),
        type="tensor",
        size=size,
        inputs=(input1.name, input2.name),
        act=act_name(act),
        bias=bool(bias_attr),
    )
    return LayerOutput(conf, [input1, input2])


tensor_layer = tensor


# ---------------------------------------------------------------------------
# cost layers
# ---------------------------------------------------------------------------


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


def _weighted(cost: LayerOutput, weight, name=None) -> LayerOutput:
    """Per-sample weighted cost (reference CostLayer weight input): the [B,1]
    weight slot scales the [B,1] per-sample cost — exactly the scaling layer."""
    if weight is None:
        return cost
    return scaling(weight, cost, name=name)


def classification_cost(
    input: LayerOutput, label: LayerOutput, weight=None, name=None, evaluator=None,
    layer_attr=None,
) -> LayerOutput:
    """reference classification_cost: softmax output + cross-entropy (the
    compiler fuses into log-softmax CE when the input's act is softmax)."""
    inner = _cost2(
        "cross_entropy", input, label,
        name=(name + "_unweighted") if (name and weight is not None) else name,
    )
    return _weighted(inner, weight, name=name)


def cross_entropy_cost(input, label, name=None):
    return _cost2("cross_entropy", input, label, name=name)


def cross_entropy_with_selfnorm_cost(input, label, softmax_selfnorm_alpha=0.1, name=None):
    return _cost2(
        "cross_entropy_with_selfnorm",
        input,
        label,
        name=name,
        softmax_selfnorm_alpha=softmax_selfnorm_alpha,
    )


def multi_binary_label_cross_entropy_cost(input, label, name=None):
    return _cost2("multi_binary_label_cross_entropy", input, label, name=name)


def soft_binary_class_cross_entropy_cost(input, label, name=None):
    return _cost2("soft_binary_class_cross_entropy", input, label, name=name)


def square_error_cost(input, label, weight=None, name=None, layer_attr=None):
    inner = _cost2(
        "square_error", input, label,
        name=(name + "_unweighted") if (name and weight is not None) else name,
    )
    return _weighted(inner, weight, name=name)


mse_cost = square_error_cost
regression_cost = square_error_cost


def smooth_l1_cost(input, label, name=None):
    return _cost2("smooth_l1", input, label, name=name)


def huber_regression_cost(input, label, delta=1.0, name=None):
    return _cost2("huber_regression", input, label, name=name, delta=delta)


def huber_classification_cost(input, label, name=None):
    return _cost2("huber_classification", input, label, name=name)


# reference-era name: huber_cost was the binary-classification huber loss
huber_cost = huber_classification_cost


def rank_cost(left: LayerOutput, right: LayerOutput, label: LayerOutput, name=None):
    conf = LayerConf(
        name=name or auto_name("rank_cost"),
        type="rank_cost",
        size=1,
        inputs=(left.name, right.name, label.name),
        bias=False,
    )
    return LayerOutput(conf, [left, right, label])


def sum_cost(input: LayerOutput, name=None):
    return _unary("sum_cost", input, size=1, name=name)


# v1 cost-layer aliases without the _cost suffix (reference layers.py __all__)
cross_entropy = cross_entropy_cost
cross_entropy_with_selfnorm = cross_entropy_with_selfnorm_cost
multi_binary_label_cross_entropy = multi_binary_label_cross_entropy_cost
soft_binary_class_cross_entropy = soft_binary_class_cross_entropy_cost
square_error = square_error_cost
mse_cost = square_error_cost
regression_cost = square_error_cost
smooth_l1 = smooth_l1_cost


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


def seq_reshape(input: LayerOutput, reshape_size: int, name=None) -> LayerOutput:
    return _unary("seqreshape", input, size=reshape_size, name=name)


seq_reshape_layer = seq_reshape


def seq_concat(a: LayerOutput, b: LayerOutput, name=None) -> LayerOutput:
    conf = LayerConf(
        name=name or auto_name("seqconcat"),
        type="seqconcat",
        size=a.size,
        inputs=(a.name, b.name),
        bias=False,
    )
    return LayerOutput(conf, [a, b])


seq_concat_layer = seq_concat


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


def context_projection(
    input: LayerOutput,
    context_len: int,
    context_start: Optional[int] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    """reference context_projection (config_parser.py ContextProjection):
    default start centers the window."""
    start = context_start if context_start is not None else -(context_len // 2)
    conf = LayerConf(
        name=name or auto_name("context_projection"),
        type="context_projection",
        size=input.size * context_len,
        inputs=(input.name,),
        bias=False,
        attrs={"context_len": context_len, "context_start": start},
    )
    return LayerOutput(conf, [input])


def row_conv(
    input: LayerOutput, context_len: int, act=None, name: Optional[str] = None
) -> LayerOutput:
    conf = LayerConf(
        name=name or auto_name("row_conv"),
        type="row_conv",
        size=input.size,
        inputs=(input.name,),
        act=act_name(act),
        bias=False,
        attrs={"context_len": context_len},
    )
    return LayerOutput(conf, [input])


row_conv_layer = row_conv


def conv_shift(a: LayerOutput, b: LayerOutput, name=None) -> LayerOutput:
    conf = LayerConf(
        name=name or auto_name("conv_shift"),
        type="conv_shift",
        size=a.size,
        inputs=(a.name, b.name),
        bias=False,
    )
    return LayerOutput(conf, [a, b])


conv_shift_layer = conv_shift


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


def sampling_id(input: LayerOutput, name=None) -> LayerOutput:
    return _unary("sampling_id", input, size=1, name=name)


sampling_id_layer = sampling_id


def eos(input: LayerOutput, eos_id: int, name=None) -> LayerOutput:
    return _unary("eos_id", input, size=1, name=name, eos_id=eos_id)


eos_layer = eos


# ---------------------------------------------------------------------------
# misc inventory layers (layers/misc.py impls)
# ---------------------------------------------------------------------------


def prelu(input: LayerOutput, partial_sum: int = 1, name=None) -> LayerOutput:
    return _unary("prelu", input, name=name, partial_sum=partial_sum)


prelu_layer = prelu


def power(input: LayerOutput, weight: LayerOutput, name=None) -> LayerOutput:
    """reference power_layer: y = input ^ weight (weight [B,1])."""
    conf = LayerConf(
        name=name or auto_name("power"),
        type="power",
        size=input.size,
        inputs=(weight.name, input.name),
        bias=False,
    )
    return LayerOutput(conf, [weight, input])


power_layer = power


def data_norm(input: LayerOutput, strategy: str = "z-score", name=None) -> LayerOutput:
    return _unary("data_norm", input, name=name, strategy=strategy)


def block_expand(
    input: LayerOutput,
    block_x: int,
    block_y: int,
    stride_x: int = 1,
    stride_y: int = 1,
    padding_x: int = 0,
    padding_y: int = 0,
    num_channels: Optional[int] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    """reference block_expand_layer (BlockExpandLayer.cpp): im2col into a
    block sequence."""
    in_c, in_h, in_w = _img_attrs(input, num_channels)
    conf = LayerConf(
        name=name or auto_name("block_expand"),
        type="block_expand",
        size=in_c * block_x * block_y,
        inputs=(input.name,),
        bias=False,
        attrs={
            "in_h": in_h, "in_w": in_w, "in_c": in_c,
            "block_x": block_x, "block_y": block_y,
            "stride_x": stride_x, "stride_y": stride_y,
            "padding_x": padding_x, "padding_y": padding_y,
        },
    )
    return LayerOutput(conf, [input])


block_expand_layer = block_expand


def rotate(input: LayerOutput, height: Optional[int] = None,
           width: Optional[int] = None, name=None) -> LayerOutput:
    a = _img_passthrough(input)
    in_h = height or a.get("in_h")
    in_w = width or a.get("in_w")
    in_c = a.get("in_c", 1)
    conf = LayerConf(
        name=name or auto_name("rotate"),
        type="rotate",
        size=input.size,
        inputs=(input.name,),
        bias=False,
        attrs={"in_h": in_h, "in_w": in_w, "in_c": in_c,
               "out_h": in_w, "out_w": in_h, "channels": in_c},
    )
    return LayerOutput(conf, [input])


rotate_layer = rotate


def sub_seq(input: LayerOutput, offsets: LayerOutput, sizes: LayerOutput,
            name=None) -> LayerOutput:
    conf = LayerConf(
        name=name or auto_name("sub_seq"),
        type="sub_seq",
        size=input.size,
        inputs=(input.name, offsets.name, sizes.name),
        bias=False,
    )
    return LayerOutput(conf, [input, offsets, sizes])


sub_seq_layer = sub_seq


def linear_comb(weights: LayerOutput, vectors: LayerOutput,
                size: Optional[int] = None, name=None,
                layer_attr=None) -> LayerOutput:
    """reference linear_comb_layer / convex_comb_layer: vectors holds W
    groups of `size` features; weights [B, W] combines them.  size defaults
    to vectors.size // weights.size (the reference's implicit sizing)."""
    if size is None:
        assert vectors.size % weights.size == 0, (
            f"linear_comb: vectors.size {vectors.size} not a multiple of "
            f"weights.size {weights.size}"
        )
        size = vectors.size // weights.size
    conf = LayerConf(
        name=name or auto_name("linear_comb"),
        type="linear_comb",
        size=size,
        inputs=(weights.name, vectors.name),
        bias=False,
    )
    return LayerOutput(conf, [weights, vectors])


convex_comb = linear_comb
convex_comb_layer = linear_comb
linear_comb_layer = linear_comb


def cos_sim_vec_mat(vec: LayerOutput, mat: LayerOutput, size: int,
                    scale: float = 1.0, name=None) -> LayerOutput:
    """reference cos_vm (CosSimVecMatLayer.cpp)."""
    conf = LayerConf(
        name=name or auto_name("cos_vm"),
        type="cos_vm",
        size=size,
        inputs=(vec.name, mat.name),
        bias=False,
        attrs={"scale": scale},
    )
    return LayerOutput(conf, [vec, mat])


def print_layer(input: LayerOutput, format: str = "{name}: {val}", name=None) -> LayerOutput:
    return _unary("print", input, name=name, format=format)


def scale_shift(input: LayerOutput, bias_attr: Union[bool, ParamAttr] = True,
                name=None) -> LayerOutput:
    conf = LayerConf(
        name=name or auto_name("scale_shift"),
        type="scale_shift",
        size=input.size,
        inputs=(input.name,),
        bias=bool(bias_attr),
    )
    return LayerOutput(conf, [input])


scale_shift_layer = scale_shift


def kmax_seq_score(input: LayerOutput, beam_size: int = 1, name=None) -> LayerOutput:
    conf = LayerConf(
        name=name or auto_name("kmax_seq_score"),
        type="kmax_seq_score",
        size=beam_size,
        inputs=(input.name,),
        bias=False,
        attrs={"beam_size": beam_size},
    )
    return LayerOutput(conf, [input])


# ---------------------------------------------------------------------------
# large-vocab output layers: nce / hsigmoid / selective_fc / lambda_cost
# (reference layers.py nce_layer, hsigmoid, selective_fc_layer, lambda_cost)
# ---------------------------------------------------------------------------


def nce(
    input: Inputish,
    label: LayerOutput,
    num_classes: Optional[int] = None,
    num_neg_samples: int = 10,
    noise_dist: Optional[Sequence[float]] = None,
    neg_distribution: Optional[Sequence[float]] = None,  # reference name
    bias_attr: Union[bool, ParamAttr] = True,
    param_attr: Optional[ParamAttr] = None,
    weight: Optional[LayerOutput] = None,
    name: Optional[str] = None,
    layer_attr=None,
) -> LayerOutput:
    if noise_dist is None:
        noise_dist = neg_distribution
    feats = _as_list(input)
    c = num_classes or label.size
    conf = LayerConf(
        name=(
            (name + "_unweighted") if (name and weight is not None) else name
        ) or auto_name("nce"),
        type="nce",
        size=1,
        inputs=tuple(f.name for f in feats) + (label.name,),
        bias=bool(bias_attr),
        attrs={
            "num_classes": c,
            "num_neg_samples": num_neg_samples,
            "num_feat_inputs": len(feats),
            "noise_dist": tuple(noise_dist) if noise_dist is not None else None,
        },
    )
    return _weighted(LayerOutput(conf, feats + [label]), weight, name=name)


nce_layer = nce


def hsigmoid(
    input: Inputish,
    label: LayerOutput,
    num_classes: Optional[int] = None,
    bias_attr: Union[bool, ParamAttr] = True,
    param_attr: Optional[ParamAttr] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    feats = _as_list(input)
    c = num_classes or label.size
    conf = LayerConf(
        name=name or auto_name("hsigmoid"),
        type="hsigmoid",
        size=1,
        inputs=tuple(f.name for f in feats) + (label.name,),
        bias=bool(bias_attr),
        attrs={"num_classes": c},
    )
    return LayerOutput(conf, feats + [label])


def selective_fc(
    input: Inputish,
    select: Optional[LayerOutput],
    size: int,
    act=None,
    bias_attr: Union[bool, ParamAttr] = True,
    param_attr: Optional[ParamAttr] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    feats = _as_list(input)
    parents = feats + ([select] if select is not None else [])
    conf = LayerConf(
        name=name or auto_name("selective_fc"),
        type="selective_fc",
        size=size,
        inputs=tuple(p.name for p in parents),
        act=act_name(act),
        bias=bool(bias_attr),
        attrs={"has_selection": select is not None, **_param_attrs(param_attr)},
    )
    return LayerOutput(conf, parents)


selective_fc_layer = selective_fc


def lambda_cost(
    input: LayerOutput,
    score: LayerOutput,
    NDCG_num: int = 5,
    max_sort_size: int = -1,
    name: Optional[str] = None,
) -> LayerOutput:
    """reference lambda_cost (LambdaCost.cpp): `input` is the model score
    sequence, `score` the gold relevance sequence.  max_sort_size is accepted
    for API parity; this one always ranks the full (padded) list."""
    conf = LayerConf(
        name=name or auto_name("lambda_cost"),
        type="lambda_cost",
        size=1,
        inputs=(input.name, score.name),
        bias=False,
        attrs={"ndcg_num": NDCG_num},
    )
    return LayerOutput(conf, [input, score])


# ---------------------------------------------------------------------------
# structured prediction: crf / crf_decoding / ctc / warp_ctc
# (reference layers.py crf_layer, crf_decoding_layer, ctc_layer, warp_ctc_layer)
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


def ctc(
    input: LayerOutput,
    label: LayerOutput,
    size: Optional[int] = None,
    blank: Optional[int] = None,
    norm_by_times: bool = False,
    name: Optional[str] = None,
) -> LayerOutput:
    """CTC cost (reference ctc_layer → CTCLayer.cpp/LinearChainCTC.cpp).
    `size` = num_classes + 1 (incl. blank); blank defaults to size-1."""
    n = size or input.size
    conf = LayerConf(
        name=name or auto_name("ctc"),
        type="ctc",
        size=1,
        inputs=(input.name, label.name),
        bias=False,
        attrs={
            "blank": blank if blank is not None else n - 1,
            "norm_by_times": norm_by_times,
            "_num_classes": n,
        },
    )
    return LayerOutput(conf, [input, label])


ctc_layer = ctc


def warp_ctc(
    input: LayerOutput,
    label: LayerOutput,
    size: Optional[int] = None,
    blank: int = 0,
    norm_by_times: bool = False,
    name: Optional[str] = None,
) -> LayerOutput:
    """reference warp_ctc_layer (WarpCTCLayer.cpp): same loss, blank=0
    convention.  Both run the same scan DP."""
    return ctc(input, label, size=size, blank=blank,
               norm_by_times=norm_by_times, name=name or auto_name("warp_ctc"))


warp_ctc_layer = warp_ctc


# ---------------------------------------------------------------------------
# mixed layer + projections (reference: trainer_config_helpers mixed_layer +
# *_projection functions, config_parser.py:487-858; MixedLayer.cpp)
# ---------------------------------------------------------------------------


class Projection:
    """One term of a mixed layer.  Not a graph node: the enclosing mixed
    layer owns its parameters (the reference's Projection objects live
    inside MixedLayer)."""

    def __init__(self, kind: str, input: LayerOutput, **attrs):
        self.kind = kind
        self.input = input
        self.attrs = attrs


def full_matrix_projection(
    input: LayerOutput, size: int = 0, param_attr: Optional[ParamAttr] = None
) -> Projection:
    return Projection(
        "full_matrix", input, size=size,
        param_std=_param_std(param_attr), param_name=_param_name(param_attr),
        **({"dynamic_width": True} if _dynamic_width(input) else {}),
    )


def trans_full_matrix_projection(
    input: LayerOutput, size: int = 0, param_attr: Optional[ParamAttr] = None
) -> Projection:
    return Projection(
        "trans_full_matrix", input, size=size,
        param_std=_param_std(param_attr), param_name=_param_name(param_attr),
        **({"dynamic_width": True} if _dynamic_width(input) else {}),
    )


def table_projection(
    input: LayerOutput, size: int = 0, param_attr: Optional[ParamAttr] = None
) -> Projection:
    return Projection(
        "table", input, size=size,
        param_std=_param_std(param_attr), param_name=_param_name(param_attr),
    )


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


def conv_projection(
    input: LayerOutput,
    filter_size: int,
    num_filters: int,
    num_channels: Optional[int] = None,
    stride: int = 1,
    padding: int = 0,
    groups: int = 1,
    trans: bool = False,
    filter_size_y: Optional[int] = None,
    stride_y: Optional[int] = None,
    padding_y: Optional[int] = None,
    param_attr: Optional[ParamAttr] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    """reference conv_projection — here a bias-less conv layer the mixed
    layer consumes as an identity term (same math, reuses the conv impl)."""
    return img_conv(
        input,
        filter_size=filter_size,
        num_filters=num_filters,
        num_channels=num_channels,
        stride=stride,
        padding=padding,
        groups=groups,
        trans=trans,
        filter_size_y=filter_size_y,
        stride_y=stride_y,
        padding_y=padding_y,
        act=_act_mod.Identity(),
        bias_attr=False,
        param_attr=param_attr,
        name=name or auto_name("conv_proj"),
    )


def conv_operator(
    img: LayerOutput,
    filter: LayerOutput,
    filter_size: int,
    num_filters: int,
    num_channels: Optional[int] = None,
    stride: int = 1,
    padding: int = 0,
    filter_size_y: Optional[int] = None,
    stride_y: Optional[int] = None,
    padding_y: Optional[int] = None,
    trans: bool = False,
    name: Optional[str] = None,
) -> LayerOutput:
    """reference conv_operator (ConvOperator.cpp): convolve the image input
    with per-sample filters produced by another layer.  trans=True runs the
    transposed (fractionally-strided) form."""
    in_c, in_h, in_w = _img_attrs(img, num_channels)
    fh, fw = filter_size_y or filter_size, filter_size
    sh, sw = stride_y or stride, stride
    ph = padding_y if padding_y is not None else padding
    pw = padding
    if trans:
        out_h = _conv.convt_output_size(in_h, fh, ph, sh)
        out_w = _conv.convt_output_size(in_w, fw, pw, sw)
    else:
        out_h = cnn_output_size(in_h, fh, ph, sh)
        out_w = cnn_output_size(in_w, fw, pw, sw)
    conf = LayerConf(
        name=name or auto_name("conv_op"),
        type="conv_op",
        size=num_filters * out_h * out_w,
        inputs=(img.name, filter.name),
        bias=False,
        attrs={
            "in_h": in_h, "in_w": in_w, "in_c": in_c,
            "filter_h": fh, "filter_w": fw,
            "channels": num_filters,
            "stride_h": sh, "stride_w": sw,
            "pad_h": ph, "pad_w": pw,
            "trans": trans,
            "out_h": out_h, "out_w": out_w, "out_c": num_filters,
        },
    )
    return LayerOutput(conf, [img, filter])


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


# ---------------------------------------------------------------------------
# attention family (Transformer building blocks — layers/attention.py)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# detection suite (SSD) — layers/detection.py
# ---------------------------------------------------------------------------


def priorbox(
    input: LayerOutput,
    image: LayerOutput,
    aspect_ratio: Sequence[float],
    variance: Sequence[float],
    min_size: Sequence[float],
    max_size: Sequence[float] = (),
    name: Optional[str] = None,
) -> LayerOutput:
    """reference priorbox_layer (layers.py:1049) → PriorBox.cpp.  Emits
    [B, P, 8] (prior corners + variances); P is fixed by the input feature
    map's geometry, so the priors fold to a constant."""
    from paddle_tpu_torch.ops.detection import make_priors, priors_per_cell

    fa = input.conf.attrs
    h = fa.get("out_h") or fa.get("in_h")
    w = fa.get("out_w") or fa.get("in_w")
    assert h and w, f"priorbox input {input.name} has no image geometry attrs"
    ia = image.conf.attrs
    img_h = ia.get("in_h") or ia.get("out_h")
    img_w = ia.get("in_w") or ia.get("out_w")
    assert img_h and img_w, (
        f"priorbox image {image.name} has no geometry — declare the data "
        f"layer with height=/width= (min_size is in image pixels)"
    )
    priors = make_priors(
        int(h), int(w), list(min_size), list(max_size), list(aspect_ratio),
        int(img_h), int(img_w),
    )
    k = priors_per_cell(len(min_size), len(max_size), aspect_ratio)
    conf = LayerConf(
        name=name or auto_name("priorbox"),
        type="priorbox",
        size=priors.shape[0] * 8,
        inputs=(input.name, image.name),
        bias=False,
        attrs={
            "_priors": priors,
            "variance": tuple(variance),
            "num_priors": int(priors.shape[0]),
            "priors_per_cell": int(k),
        },
    )
    return LayerOutput(conf, [input, image])


priorbox_layer = priorbox


def multibox_loss(
    input_loc,
    input_conf,
    priorbox: LayerOutput,
    label: LayerOutput,
    num_classes: int,
    overlap_threshold: float = 0.5,
    neg_pos_ratio: float = 3.0,
    neg_overlap: float = 0.5,
    background_id: int = 0,
    name: Optional[str] = None,
) -> LayerOutput:
    """reference multibox_loss_layer (layers.py:1095) → MultiBoxLossLayer.cpp.
    `label` is a dense sequence slot of (label,xmin,ymin,xmax,ymax,difficult)
    rows per image."""
    locs = _as_list(input_loc)
    confs = _as_list(input_conf)
    assert len(locs) == len(confs), "loc/conf input counts must match"
    parents = [priorbox, label] + locs + confs
    conf = LayerConf(
        name=name or auto_name("multibox_loss"),
        type="multibox_loss",
        size=1,
        inputs=tuple(p.name for p in parents),
        bias=False,
        attrs={
            "input_num": len(locs),
            "num_classes": num_classes,
            "overlap_threshold": overlap_threshold,
            "neg_pos_ratio": neg_pos_ratio,
            "neg_overlap": neg_overlap,
            "background_id": background_id,
        },
    )
    return LayerOutput(conf, parents)


multibox_loss_layer = multibox_loss


def detection_output(
    input_loc,
    input_conf,
    priorbox: LayerOutput,
    num_classes: int,
    nms_threshold: float = 0.45,
    nms_top_k: int = 400,
    keep_top_k: int = 200,
    confidence_threshold: float = 0.01,
    background_id: int = 0,
    name: Optional[str] = None,
) -> LayerOutput:
    """reference detection_output_layer (layers.py:1170) →
    DetectionOutputLayer.cpp.  Emits a fixed [B, keep_top_k, 6] block."""
    locs = _as_list(input_loc)
    confs = _as_list(input_conf)
    assert len(locs) == len(confs)
    parents = [priorbox] + locs + confs
    conf = LayerConf(
        name=name or auto_name("detection_output"),
        type="detection_output",
        size=keep_top_k * 6,
        inputs=tuple(p.name for p in parents),
        bias=False,
        attrs={
            "input_num": len(locs),
            "num_classes": num_classes,
            "nms_threshold": nms_threshold,
            "nms_top_k": nms_top_k,
            "keep_top_k": keep_top_k,
            "confidence_threshold": confidence_threshold,
            "background_id": background_id,
        },
    )
    return LayerOutput(conf, parents)


detection_output_layer = detection_output


def img_cmrnorm(
    input: LayerOutput,
    size: int,
    scale: float = 0.0128,
    power: float = 0.75,
    num_channels: Optional[int] = None,
    layer_attr: Optional[ExtraAttr] = None,
    name: Optional[str] = None,
) -> LayerOutput:
    """Cross-map response normalization (reference img_cmrnorm_layer,
    layers.py:2706 — AlexNet LRN across `size` feature maps)."""
    in_c, in_h, in_w = _img_attrs(input, num_channels)
    drop, shard = _extra(layer_attr)
    conf = LayerConf(
        name=name or auto_name("crmnorm"),  # sic: the reference prefix
        type="norm",
        size=in_h * in_w * in_c,
        inputs=(input.name,),
        bias=False,
        drop_rate=drop,
        shard_axis=shard,
        attrs={
            "norm_size": size,
            "scale": scale,
            "power": power,
            "in_c": in_c, "in_h": in_h, "in_w": in_w,
            "channels": in_c, "out_h": in_h, "out_w": in_w,
        },
    )
    _set_error_clip(conf, layer_attr)
    return LayerOutput(conf, [input])


img_cmrnorm_layer = img_cmrnorm


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


def mdlstmemory(
    input: LayerOutput,
    size: Optional[int] = None,
    reverse_h: bool = False,
    reverse_w: bool = False,
    act=None,
    gate_act=None,
    state_act=None,
    bias_attr: bool = True,
    name: Optional[str] = None,
) -> LayerOutput:
    """2D multi-dimensional LSTM (reference MDLstmLayer.cpp); input must be
    an image-shaped layer pre-projected to 5*size channels (i, f_row, f_col,
    o, g gates).  reverse_h/reverse_w flip the scan direction per axis —
    compose four of these for the full multi-directional net."""
    a = input.conf.attrs
    in_c = a.get("channels") or a.get("in_c")
    in_h = a.get("out_h") or a.get("in_h")
    in_w = a.get("out_w") or a.get("in_w")
    assert in_c and in_h and in_w, (
        f"mdlstmemory input {input.name} needs image geometry attrs"
    )
    size = size or int(in_c) // 5
    assert int(in_c) == 5 * size, (
        f"mdlstmemory input channels {in_c} must be 5*size ({5 * size})"
    )
    conf = LayerConf(
        name=name or auto_name("mdlstmemory"),
        type="mdlstmemory",
        # image-layer convention: size is the flattened extent; the hidden
        # width rides the channels attr (like img_conv)
        size=int(in_h) * int(in_w) * size,
        inputs=(input.name,),
        bias=bool(bias_attr),
        attrs={
            "in_h": int(in_h),
            "in_w": int(in_w),
            "in_c": int(in_c),
            "out_h": int(in_h),
            "out_w": int(in_w),
            "channels": size,
            "reverse_h": reverse_h,
            "reverse_w": reverse_w,
            "active_type": act_name(act if act is not None else _act_mod.Tanh()),
            "gate_act": act_name(gate_act if gate_act is not None else _act_mod.Sigmoid()),
            "state_act": act_name(state_act if state_act is not None else _act_mod.Tanh()),
        },
    )
    return LayerOutput(conf, [input])


mdlstmemory_layer = mdlstmemory


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


def agent(input: LayerOutput, size: Optional[int] = None, name: Optional[str] = None) -> LayerOutput:
    """Identity view of another layer (reference AgentLayer — cross-frame
    wiring that the recurrent_group scan absorbs here)."""
    conf = LayerConf(
        name=name or auto_name("agent"),
        type="agent",
        size=size or input.size,
        inputs=(input.name,),
        bias=False,
    )
    return LayerOutput(conf, [input])


agent_layer = agent


def scatter_agent(input: LayerOutput, ids: LayerOutput, name: Optional[str] = None) -> LayerOutput:
    """Select rows of `input` by the integer ids (reference
    ScatterAgentLayer: distributes source rows to beam/frame slots)."""
    conf = LayerConf(
        name=name or auto_name("scatter_agent"),
        type="scatter_agent",
        size=input.size,
        inputs=(input.name, ids.name),
        bias=False,
    )
    return LayerOutput(conf, [input, ids])


scatter_agent_layer = scatter_agent


def gather_agent(input: Sequence[LayerOutput], name: Optional[str] = None) -> LayerOutput:
    """Concatenate sequences along time (reference GatherAgentLayer:
    collects scattered pieces back into one sequence)."""
    ins = _as_list(input)
    conf = LayerConf(
        name=name or auto_name("gather_agent"),
        type="gather_agent",
        size=ins[0].size,
        inputs=tuple(i.name for i in ins),
        bias=False,
    )
    return LayerOutput(conf, ins)


gather_agent_layer = gather_agent


__all__ = [n for n in dir() if not n.startswith("_")]
