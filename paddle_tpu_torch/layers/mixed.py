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
full-matrix and table projections.  Not ported yet: ``conv_op`` (the conv
operator; a network that uses it fails when it is compiled).
"""

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
        acc = acc + params["b"]
    return SeqTensor(acc, lengths, sub_lengths)
