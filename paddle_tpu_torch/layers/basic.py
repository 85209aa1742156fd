"""Core layer impls: data, fc, embedding, addto, concat and scaling — the
counterpart of ``paddle_tpu/layers/basic.py:38-168`` — and get_output
(``paddle_tpu/layers/misc.py:245-255``).  Weights keep the JAX layout
([in, out] for fc, [vocab, size] for embedding)."""

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
