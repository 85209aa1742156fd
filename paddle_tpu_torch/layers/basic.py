"""Core layer impls — the counterpart of ``paddle_tpu/layers/basic.py``:
data, fc, embedding, addto, concat and scaling, the elementwise and row
types (slope_intercept, interpolation, sum_to_one_norm, row_l2_norm, maxid,
multiplex, trans, repeat, resize, clip, dotmul, out_prod, cos, tensor) —
and get_output (``paddle_tpu/layers/misc.py:245-255``).  Weights keep the
JAX layout ([in, out] for fc, [vocab, size] for embedding, [K, d1, d2] for
tensor)."""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from paddle_tpu_torch.core import initializers as init
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.core.topology import LayerConf
from paddle_tpu_torch.layers.base import (
    ApplyContext,
    gather_sum_rows,
    is_sparse_ids,
    register_layer,
    take_rows_or_zero,
)
from paddle_tpu_torch.ops import acc_matmul


@register_layer("data")
def data_apply(conf, params, inputs, ctx):  # pragma: no cover - fed by the compiler
    raise RuntimeError("data layers are fed directly by the compiler")


def fc_init(conf: LayerConf, in_confs: List[LayerConf], gen, device) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    stds = conf.attr("param_stds")
    for i, ic in enumerate(in_confs):
        std = stds[i] if stds is not None else conf.attr("param_std")
        params[f"w{i}"] = init.normal(gen, (ic.size, conf.size), std, device)
    if conf.bias:
        params["b"] = init.zeros((conf.size,), device)
    return params


@register_layer("fc", init=fc_init)
def fc_apply(conf, params, inputs: List[SeqTensor], ctx: ApplyContext) -> SeqTensor:
    """One product per input plus the shared bias.  A nested input
    ([B, S, T, D]) keeps its shape and lengths; a big-vocabulary sparse slot
    in padded-id form is a gather-sum of the touched rows."""
    acc = None
    lengths = sub_lengths = None
    for i, t in enumerate(inputs):
        x = t.data
        w = params[f"w{i}"]
        if is_sparse_ids(t, int(w.shape[0])):
            if t.is_seq:
                lengths, sub_lengths = t.lengths, t.sub_lengths
            y = gather_sum_rows(w, x)
            acc = y if acc is None else acc + y
            continue
        if t.is_nested:
            lengths, sub_lengths = t.lengths, t.sub_lengths
        elif t.is_seq:
            lengths = t.lengths
            if x.dim() > 3:
                x = x.reshape(x.shape[0], x.shape[1], -1)
        elif x.dim() != 2:
            x = x.reshape(x.shape[0], -1)
        y = acc_matmul(x, w)
        acc = y if acc is None else acc + y
    if "b" in params:
        acc = acc + params["b"]
    return SeqTensor(acc, lengths, sub_lengths)


def embedding_init(conf, in_confs, gen, device):
    vocab = in_confs[0].size
    return {"w": init.normal(gen, (vocab, conf.size), conf.attr("param_std"), device)}


@register_layer("embedding", init=embedding_init)
def embedding_apply(conf, params, inputs, ctx):
    ids = inputs[0]
    idx = ids.data.to(torch.int64)
    if idx.dim() >= 2 and idx.shape[-1] == 1 and not ids.is_nested:
        idx = idx[..., 0]
    # out-of-range ids (the providers' OOV sentinel) give a zero row
    out = take_rows_or_zero(params["w"], idx)
    return SeqTensor(out, ids.lengths, ids.sub_lengths)


def addto_init(conf, in_confs, gen, device):
    return {"b": init.zeros((conf.size,), device)} if conf.bias else {}


@register_layer("addto", init=addto_init)
def addto_apply(conf, params, inputs, ctx):
    acc = inputs[0].data
    for t in inputs[1:]:
        acc = acc + t.data
    if "b" in params:
        acc = acc + params["b"]
    return inputs[0].with_data(acc)


@register_layer("concat")
def concat_apply(conf, params, inputs, ctx):
    """Feature-axis concat (ConcatenateLayer.cpp); a sequence input's
    lengths (and a nested input's sub-lengths) carry over."""
    datas, lengths, sub_lengths = [], None, None
    for t in inputs:
        x = t.data
        if t.is_seq:
            lengths, sub_lengths = t.lengths, t.sub_lengths
        elif x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        datas.append(x)
    return SeqTensor(torch.cat(datas, dim=-1), lengths, sub_lengths)


@register_layer("scaling")
def scaling_apply(conf, params, inputs, ctx):
    """y = w * x with one weight per row (ScalingLayer.cpp): w [..., 1]."""
    w, x = inputs
    return x.with_data(x.data * w.data)


@register_layer("get_output", auto_activation=False)
def get_output_apply(conf, params, inputs, ctx):
    """A named side output of a layer (GetOutputLayer.cpp); side outputs are
    stored as "<layer>@<arg>": beam_search's "@scores", a softmax's
    "@logits"."""
    arg = conf.attrs["arg_name"]
    src = conf.inputs[0]
    key = src if arg in ("", "default") else f"{src}@{arg}"
    if key not in ctx.outputs:
        raise KeyError(
            f"{conf.name}: layer {src!r} has no side output {arg!r} "
            f"(known: {[k for k in ctx.outputs if k.startswith(src)]})")
    return ctx.outputs[key]


@register_layer("slope_intercept")
def slope_intercept_apply(conf, params, inputs, ctx):
    """SlopeInterceptLayer: y = slope x + intercept."""
    x = inputs[0]
    return x.with_data(conf.attr("slope", 1.0) * x.data + conf.attr("intercept", 0.0))


@register_layer("interpolation")
def interpolation_apply(conf, params, inputs, ctx):
    """InterpolationLayer: y = w x1 + (1 - w) x2, w [B, 1]."""
    w, x1, x2 = inputs
    return x1.with_data(w.data * x1.data + (1.0 - w.data) * x2.data)


@register_layer("sum_to_one_norm")
def sum_to_one_norm_apply(conf, params, inputs, ctx):
    x = inputs[0]
    s = x.data.sum(dim=-1, keepdim=True)
    return x.with_data(x.data / torch.where(s == 0, torch.ones_like(s), s))


@register_layer("row_l2_norm")
def row_l2_norm_apply(conf, params, inputs, ctx):
    x = inputs[0]
    n = torch.linalg.vector_norm(x.data, dim=-1, keepdim=True)
    return x.with_data(x.data / torch.clamp(n, min=1e-12))


@register_layer("maxid")
def maxid_apply(conf, params, inputs, ctx):
    """MaxIdLayer: the argmax over the features as int32 ids (the first
    maximum on a tie)."""
    x = inputs[0]
    return SeqTensor(torch.argmax(x.data, dim=-1).to(torch.int32), x.lengths)


@register_layer("multiplex")
def multiplex_apply(conf, params, inputs, ctx):
    """MultiplexLayer: row b of the input the index input names (an index
    out of range takes the nearest input, as a JAX gather clamps)."""
    sel = inputs[0].data.to(torch.int64).reshape(-1)
    stacked = torch.stack([t.data for t in inputs[1:]], dim=0)  # [K, B, D]
    sel = torch.clamp(sel, 0, stacked.shape[0] - 1)
    rows = torch.arange(sel.shape[0], device=sel.device)
    return SeqTensor(stacked[sel, rows], inputs[1].lengths)


@register_layer("trans")
def trans_apply(conf, params, inputs, ctx):
    """TransLayer: with no height, the transpose of the whole [B, D] batch
    ([D, B], no lengths); with one, of each row as a [height, D / height]
    matrix."""
    x = inputs[0]
    h = conf.attr("height")
    if h is None:
        return SeqTensor(x.data.reshape(x.data.shape[0], -1).transpose(0, 1))
    b = x.data.shape[0]
    return SeqTensor(x.data.reshape(b, h, -1).transpose(1, 2).reshape(b, -1), x.lengths)


@register_layer("repeat")
def repeat_apply(conf, params, inputs, ctx):
    """The feature vector tiled num_repeats times: [x, x, ...] as a row
    vector, else each feature repeated in place."""
    x = inputs[0]
    n = conf.attr("num_repeats")
    if conf.attr("as_row_vector", True):
        return x.with_data(torch.cat([x.data] * n, dim=-1))
    return x.with_data(torch.repeat_interleave(x.data, n, dim=-1))


@register_layer("resize")
def resize_apply(conf, params, inputs, ctx):
    """ResizeLayer: the rows reshaped to width conf.size."""
    x = inputs[0]
    return SeqTensor(x.data.reshape(-1, conf.size), x.lengths)


@register_layer("clip")
def clip_apply(conf, params, inputs, ctx):
    x = inputs[0]
    return x.with_data(torch.clamp(x.data, conf.attr("min", -1.0), conf.attr("max", 1.0)))


def dotmul_init(conf, in_confs, gen, device):
    """A dotmul projection owns a [size] scale vector."""
    if conf.attr("projection", False):
        return {"w": init.normal(gen, (conf.size,), 1.0 / max(conf.size, 1), device)}
    return {}


@register_layer("dotmul", init=dotmul_init)
def dotmul_apply(conf, params, inputs, ctx):
    """The elementwise product of two inputs (DotMulOperator), or of one
    input and the scale vector (DotMulProjection)."""
    if "w" in params:
        x = inputs[0]
        return x.with_data(x.data * params["w"])
    a, b = inputs
    return a.with_data(a.data * b.data)


@register_layer("out_prod")
def out_prod_apply(conf, params, inputs, ctx):
    """OuterProdLayer: each row's outer product, flattened."""
    a, b = inputs
    out = a.data[:, :, None] * b.data[:, None, :]
    return SeqTensor(out.reshape(out.shape[0], -1), a.lengths)


@register_layer("cos")
def cos_apply(conf, params, inputs, ctx):
    """CosSimLayer: scale x the cosine of the two rows; with cos_n > 1 the
    second input holds cos_n vectors of the first's width, one cosine
    each ([B, cos_n])."""
    a, b = inputs
    n = conf.attr("cos_n", 1)
    bm = b.data.reshape(b.data.shape[0], n, -1) if n > 1 else b.data[:, None, :]
    av = a.data[:, None, :]
    num = (av * bm).sum(dim=-1)
    den = torch.linalg.vector_norm(av, dim=-1) * torch.linalg.vector_norm(bm, dim=-1)
    return SeqTensor(conf.attr("scale", 1.0) * num / torch.clamp(den, min=1e-12), a.lengths)


def tensor_init(conf, in_confs, gen, device):
    d1, d2 = in_confs[0].size, in_confs[1].size
    p = {"w": init.normal(gen, (conf.size, d1, d2), init.default_std(d1), device)}
    if conf.bias:
        p["b"] = init.zeros((conf.size,), device)
    return p


@register_layer("tensor", init=tensor_init)
def tensor_apply(conf, params, inputs, ctx):
    """TensorLayer: y_k = x1 W_k x2^T, one bilinear form per output."""
    a, b = inputs
    out = torch.einsum("bi,kij,bj->bk", a.data, params["w"], b.data)
    if "b" in params:
        out = out + params["b"]
    return SeqTensor(out, a.lengths)
