"""The layers of ``paddle_tpu/layers/misc.py``: ``block_expand`` (:94),
``sub_seq`` (:139), ``kmax_seq_score`` (:225), the agents (``agent``,
``scatter_agent``, ``gather_agent``, :267-289), and ``prelu``, ``power``,
``data_norm``, ``rotate``, ``linear_comb``, ``cos_vm``, ``print`` and
``scale_shift``.  The reference's agents wire values across the frames of
its recurrent machine; here, as in the JAX package, they keep their data
semantics: an identity view, a row selection by ids and a concatenation of
sequences along time."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import initializers as init
from paddle_tpu_torch.core.batch import SeqTensor, set_host_lengths
from paddle_tpu_torch.layers.base import register_layer
from paddle_tpu_torch.layers.conv import to_nhwc
from paddle_tpu_torch.layers.sequence import _seqconcat
from paddle_tpu_torch.ops.beam import top_k


@register_layer("block_expand")
def block_expand_apply(conf, params, inputs, ctx):
    """BlockExpandLayer: the image as a sequence of its OH * OW blocks, row
    by row, each block's features channel-major (C, block_y, block_x), as
    ``F.unfold`` on NCHW orders them.  Every row is OH * OW steps long; the
    lengths carry their host copy, so a scan over the blocks finds its live
    range without reading the card."""
    a = conf.attrs
    x = to_nhwc(inputs[0].data, a["in_h"], a["in_w"], a["in_c"])
    cols = F.unfold(x.permute(0, 3, 1, 2), (a["block_y"], a["block_x"]),
                    padding=(a.get("padding_y", 0), a.get("padding_x", 0)),
                    stride=(a.get("stride_y", 1), a.get("stride_x", 1)))  # [B, F, OH*OW]
    b, n = cols.shape[0], cols.shape[2]
    lengths = torch.full((b,), n, dtype=torch.int32, device=x.device)
    host = np.full((b,), n, dtype=np.int32)
    return SeqTensor(cols.transpose(1, 2), set_host_lengths(lengths, host))


@register_layer("sub_seq")
def sub_seq_apply(conf, params, inputs, ctx):
    """SubSequenceLayer: steps [offset, offset + size) of each sequence."""
    x, off_t, size_t = inputs
    if not x.is_seq:
        raise ValueError(f"{conf.name}: sub_seq input must be a sequence")
    off = off_t.data.to(torch.int32).reshape(-1)
    size = size_t.data.to(torch.int32).reshape(-1)
    t = x.max_len
    idx = torch.clamp(off[:, None] + torch.arange(t, device=off.device)[None, :], 0, t - 1)
    rows = torch.arange(x.data.shape[0], device=x.data.device)[:, None]
    return SeqTensor(x.data[rows, idx.long()], torch.minimum(size, x.lengths - off))


@register_layer("kmax_seq_score", auto_activation=False)
def kmax_seq_score_apply(conf, params, inputs, ctx):
    """KmaxSeqScoreLayer: the steps of the k best scores of each sequence,
    best first, the lower step first among equal scores (``lax.top_k``'s
    order, kept by ``ops/beam.py``'s ``top_k``); slots beyond a sequence's
    length are -1."""
    x = inputs[0]
    if not x.is_seq:
        raise ValueError(f"{conf.name}: kmax_seq_score input must be a sequence")
    k = conf.attrs.get("beam_size", 1)
    scores = x.data[..., 0] if x.data.dim() == 3 else x.data
    masked = torch.where(x.mask(torch.bool), scores.float(),
                         torch.full_like(scores, float("-inf"), dtype=torch.float32))
    vals, idx = top_k(masked, k)
    return SeqTensor(torch.where(torch.isfinite(vals), idx, torch.full_like(idx, -1))
                     .to(torch.int32))


@register_layer("agent", auto_activation=False)
def agent_apply(conf, params, inputs, ctx):
    return inputs[0]


@register_layer("scatter_agent", auto_activation=False)
def scatter_agent_apply(conf, params, inputs, ctx):
    """The rows of the source picked by the integer ids (lengths along)."""
    src, ids_t = inputs
    ids = ids_t.data.to(torch.int64).reshape(-1)

    def pick(t):
        return None if t is None else t.index_select(0, ids)

    return SeqTensor(pick(src.data), pick(src.lengths), pick(src.sub_lengths))


@register_layer("gather_agent", auto_activation=False)
def gather_agent_apply(conf, params, inputs, ctx):
    """The input sequences concatenated along time, through seqconcat."""
    out = inputs[0]
    for nxt in inputs[1:]:
        out = _seqconcat(conf, out, nxt)
    return out



# ---------------------------------------------------------------------------
# the elementwise and misc types of paddle_tpu/layers/misc.py
# ---------------------------------------------------------------------------


def prelu_init(conf, in_confs, gen, device):
    """One negative slope (0.25) per group of partial_sum features."""
    partial = conf.attrs.get("partial_sum", 1)
    return {"a": torch.full((in_confs[0].size // partial,), 0.25, device=device)}


@register_layer("prelu", init=prelu_init)
def prelu_apply(conf, params, inputs, ctx):
    """ParameterReluLayer: x where x > 0, else a x, a shared over groups of
    partial_sum consecutive features."""
    x = inputs[0]
    slope = torch.repeat_interleave(params["a"], conf.attrs.get("partial_sum", 1))
    return x.with_data(torch.where(x.data > 0, x.data, slope * x.data))


@register_layer("power")
def power_apply(conf, params, inputs, ctx):
    """PowerLayer: y = x ^ w, w [B, 1] a per-sample exponent."""
    w, x = inputs
    return x.with_data(torch.pow(x.data, w.data))


def data_norm_state(conf, in_confs, device):
    """The fixed statistics, layer state and not parameters (the reference
    loads them precomputed): mean, std, min and max per feature."""
    d = in_confs[0].size
    return {"mean": init.zeros((d,), device), "std": init.ones((d,), device),
            "min": init.zeros((d,), device), "max": init.ones((d,), device)}


@register_layer("data_norm", init_state=data_norm_state)
def data_norm_apply(conf, params, inputs, ctx):
    """DataNormLayer: z-score, min-max or decimal-scaling normalisation by
    the layer's fixed statistics."""
    x = inputs[0]
    st = ctx.state.get(conf.name, {})
    strategy = conf.attrs.get("strategy", "z-score")
    if strategy == "z-score":
        out = (x.data - st["mean"]) / torch.clamp(st["std"], min=1e-12)
    elif strategy == "min-max":
        out = (x.data - st["min"]) / torch.clamp(st["max"] - st["min"], min=1e-12)
    else:  # decimal-scaling
        mag = torch.clamp(st["max"].abs(), min=1e-12)
        out = x.data / torch.pow(10.0, torch.ceil(torch.log10(mag)))
    return x.with_data(out)


@register_layer("rotate")
def rotate_apply(conf, params, inputs, ctx):
    """RotateLayer: each feature map turned 90 degrees counter-clockwise,
    NHWC [B, W, H, C] out."""
    a = conf.attrs
    x = to_nhwc(inputs[0].data, a["in_h"], a["in_w"], a["in_c"])
    return SeqTensor(torch.flip(x.transpose(1, 2), dims=(1,)), inputs[0].lengths)


@register_layer("linear_comb")
def linear_comb_apply(conf, params, inputs, ctx):
    """LinearCombinationLayer (convex_comb): y[d] = sum_m w[m] x[m, d], x
    given flat as [B, M*D]."""
    w, x = inputs
    mat = x.data.reshape(w.data.shape[0], w.data.shape[-1], -1)
    return SeqTensor(torch.einsum("bm,bmd->bd", w.data, mat), x.lengths)


@register_layer("cos_vm")
def cos_vm_apply(conf, params, inputs, ctx):
    """CosSimVecMatLayer: scale x the cosine of a vector [B, D] with each
    row of a matrix given flat as [B, M*D]."""
    v, m = inputs
    mat = m.data.reshape(v.data.shape[0], -1, v.data.shape[-1])
    num = torch.einsum("bd,bmd->bm", v.data, mat)
    den = (torch.linalg.vector_norm(v.data, dim=-1, keepdim=True)
           * torch.linalg.vector_norm(mat, dim=-1))
    return SeqTensor(conf.attrs.get("scale", 1.0) * num / torch.clamp(den, min=1e-12),
                     v.lengths)


@register_layer("print")
def print_apply(conf, params, inputs, ctx):
    """PrintLayer: prints its input on the host ("{name}: {val}") and passes
    it through.  On the card the print reads the device, so it never
    belongs inside a timed step."""
    x = inputs[0]
    print(conf.attrs.get("format", "{name}: {val}").format(
        name=conf.name, val=x.data.detach().cpu().numpy()), flush=True)
    return x


def scale_shift_init(conf, in_confs, gen, device):
    p = {"scale": init.ones((1,), device)}
    if conf.bias:
        p["shift"] = init.zeros((1,), device)
    return p


@register_layer("scale_shift", init=scale_shift_init)
def scale_shift_apply(conf, params, inputs, ctx):
    """ScaleShiftLayer: y = scale x + shift, two learned scalars."""
    x = inputs[0]
    out = params["scale"][0] * x.data
    if "shift" in params:
        out = out + params["shift"][0]
    return x.with_data(out)
