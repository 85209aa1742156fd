"""The ``mixed`` layer: a sum of projections over its inputs — the
counterpart of ``paddle_tpu/layers/mixed.py`` (reference MixedLayer.cpp and
the Projection family: FullMatrixProjection, TransposedFullMatrixProjection,
TableProjection, IdentityProjection (+offset), SliceProjection,
ScalingProjection, DotMulProjection).

The conf carries ``attrs["projections"]``: a tuple of plain dicts
``{"kind": ..., "in": input_index, ...}``; a plain layer given to mixed
enters as an ``identity`` term.  Projection j's weight is the parameter
``p{j}_w``, as the JAX package names it, so parameters carry over by path
and a named projection shares through ``param_names``.

A nested input ([B, S, T, D]) keeps its lengths and sub-lengths (the JAX
package's mixed drops the sub-lengths of its output); a big-vocabulary
sparse slot in padded-id form is a gather-sum of the touched rows in the
full-matrix and table projections.  ``conv_op`` (the conv operator) is a
layer of its own that mixed takes as an identity term: a conv of each
sample with its own filter.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

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
from paddle_tpu_torch.layers.conv import conv_transpose_nhwc, to_nhwc


def _proj_params(kind: str, spec: Dict[str, Any], in_size: int, out_size: int,
                 gen, device) -> Dict[str, Any]:
    std = spec.get("param_std")
    if kind == "full_matrix":
        return {"w": init.normal(gen, (in_size, out_size), std, device)}
    if kind == "trans_full_matrix":
        return {"w": init.normal(gen, (out_size, in_size), std, device)}
    if kind == "table":
        return {"w": init.normal(gen, (spec.get("vocab", in_size), out_size), std, device)}
    if kind == "scaling":
        return {"w": init.normal(gen, (1,), 1.0, device)}
    if kind == "dotmul":
        return {"w": init.normal(gen, (out_size,), 1.0 / max(out_size, 1), device)}
    return {}


def mixed_init(conf: LayerConf, in_confs: List[LayerConf], gen, device) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    for j, spec in enumerate(conf.attrs["projections"]):
        sub = _proj_params(spec["kind"], spec, in_confs[spec["in"]].size, conf.size, gen, device)
        for k, v in sub.items():
            params[f"p{j}_{k}"] = v
    if conf.bias:
        params["b"] = init.zeros((conf.size,), device)
    return params


def _apply_proj(spec: Dict[str, Any], p: Dict[str, Any], t: SeqTensor,
                out_size: int) -> torch.Tensor:
    kind = spec["kind"]
    x = t.data
    if kind == "full_matrix":
        if is_sparse_ids(t, int(p["w"].shape[0])):
            return gather_sum_rows(p["w"], x)
        if not t.is_seq and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        return x @ p["w"]
    if kind == "trans_full_matrix":
        return x @ p["w"].t()
    if kind == "table":
        if is_sparse_ids(t, int(p["w"].shape[0])) and x.shape[-1] != 1:
            # a multi-id slot: the bag-of-rows sum (TableProjection's
            # sparse-row path)
            return gather_sum_rows(p["w"], x)
        idx = x.to(torch.int64)
        if idx.dim() >= 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        # an id outside the table gives a zero row (KeMatrixAddRows)
        return take_rows_or_zero(p["w"], idx)
    if kind == "identity":
        return x
    if kind == "identity_offset":
        off = spec.get("offset", 0)
        return x[..., off:off + out_size]
    if kind == "slice":
        return torch.cat([x[..., b:e] for b, e in spec["slices"]], dim=-1)
    if kind == "scaling":
        return p["w"][0] * x
    if kind == "dotmul":
        return x * p["w"]
    raise KeyError(f"unknown projection kind {kind!r}")


@register_layer("mixed", init=mixed_init)
def mixed_apply(conf, params, inputs: List[SeqTensor], ctx: ApplyContext) -> SeqTensor:
    acc = None
    lengths = sub_lengths = None
    for j, spec in enumerate(conf.attrs["projections"]):
        t = inputs[spec["in"]]
        if t.is_seq:
            lengths, sub_lengths = t.lengths, t.sub_lengths
        prefix = f"p{j}_"
        p = {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
        y = _apply_proj(spec, p, t, conf.size)
        acc = y if acc is None else acc + y
    if "b" in params:
        b = params["b"]
        if acc.dim() == 4 and b.dim() == 1 and b.shape[0] == acc[0].numel():
            # a conv projection's sum stays NHWC; the full-width bias is
            # stored flat in CHW order, as the JAX package places it
            b = b.reshape(acc.shape[3], acc.shape[1], acc.shape[2]).permute(1, 2, 0)
        acc = acc + b
    return SeqTensor(acc, lengths, sub_lengths)


@register_layer("conv_op")
def conv_op_apply(conf, params, inputs, ctx):
    """ConvOperator: the image inputs[0] convolved with per-sample filters,
    inputs[1] as [B, cout, cin, kh, kw]; no parameters of its own.  One
    grouped conv with the batch folded into the channels (groups = B), the
    transposed form when `trans`, so no loop runs over the samples."""
    a = conf.attrs
    img = to_nhwc(inputs[0].data, a["in_h"], a["in_w"], a["in_c"])
    kh, kw, cin, cout = a["filter_h"], a["filter_w"], a["in_c"], a["channels"]
    b, h, w, _ = img.shape
    filt = inputs[1].data.reshape(b, cout, cin, kh, kw)
    strides = (a.get("stride_h", 1), a.get("stride_w", 1))
    ph, pw = a.get("pad_h", 0), a.get("pad_w", 0)
    x = img.permute(1, 2, 0, 3).reshape(1, h, w, b * cin)  # sample b's channels in group b
    if a.get("trans", False):
        # HWIO with group b's output channels at [b cout, (b + 1) cout)
        hwio = filt.permute(3, 4, 2, 0, 1).reshape(kh, kw, cin, b * cout)
        out = conv_transpose_nhwc(x, hwio, strides=strides, ph=ph, pw=pw, groups=b)
    else:
        out = F.conv2d(x.permute(0, 3, 1, 2), filt.reshape(b * cout, cin, kh, kw),
                       stride=strides, padding=(ph, pw), groups=b).permute(0, 2, 3, 1)
    oh, ow = out.shape[1], out.shape[2]
    out = out.reshape(oh, ow, b, cout).permute(2, 0, 1, 3).contiguous()
    return SeqTensor(out, inputs[0].lengths)
