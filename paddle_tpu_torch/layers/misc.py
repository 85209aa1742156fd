"""Sequence-side layers of ``paddle_tpu/layers/misc.py``: ``sub_seq``
(:139), ``kmax_seq_score`` (:225) and the agents (``agent``,
``scatter_agent``, ``gather_agent``, :267-289).  The reference's agents wire
values across the frames of its recurrent machine; here, as in the JAX
package, they keep their data semantics: an identity view, a row selection
by ids and a concatenation of sequences along time."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.layers.base import register_layer
from paddle_tpu_torch.layers.sequence import _seqconcat
from paddle_tpu_torch.ops.beam import top_k


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

