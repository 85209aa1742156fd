"""Cost layers — the counterpart of ``paddle_tpu/layers/cost.py`` for the
cross-entropy pair Transformer-base trains with: ``cross_entropy`` (the
probability path, and the fused log-softmax path over ``<input>@logits``)
and ``softmax_with_cost``.

Every cost layer emits a per-sample cost column [B, 1]; sequence costs mask
padding and sum over valid timesteps, and the train step takes the batch
mean.  Autograd over that mean replaces each cost layer's backward.  The
other cost types are not ported yet.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.layers.base import register_layer

_EPS = 1e-10


def _fused_ce_from_logits(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """-log softmax(x)[ids] as logsumexp(x) - x[ids], reduced in f32 (or
    wider), without forming the [N, V] log-probabilities."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    m = xf.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.exp(xf - m).sum(dim=-1))
    picked = torch.gather(x, -1, ids[..., None].long())[..., 0]
    return lse - picked.to(acc)


def _per_sample(cost: torch.Tensor, tensor: SeqTensor) -> SeqTensor:
    """Reduce a per-timestep cost [B, T] to per-token-summed [B, 1] with
    masking, or pass [B] through as [B, 1]."""
    if tensor.is_seq and cost.dim() == 2:
        cost = (cost * tensor.mask(cost.dtype)).sum(dim=1)
    return SeqTensor(cost[:, None])


def _label_ids(label: SeqTensor) -> torch.Tensor:
    ids = label.data.to(torch.int32)
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    return ids


@register_layer("cross_entropy", auto_activation=False, full_precision=True)
def cross_entropy_apply(conf, params, inputs, ctx):
    """-log p[label] over a probability input (softmax output).  When the
    producing layer's activation was softmax, the compiler exposes its
    pre-activation as ``<name>@logits`` and the cost fuses into log-softmax
    cross-entropy instead."""
    prob, label = inputs[0], inputs[1]
    ids = _label_ids(label)
    logits = ctx.outputs.get(conf.inputs[0] + "@logits")
    if logits is not None:
        return _per_sample(_fused_ce_from_logits(logits.data, ids), prob)
    p = torch.gather(prob.data, -1, ids[..., None].long())[..., 0]
    cost = -torch.log(torch.clamp(p, min=_EPS))
    return _per_sample(cost, prob)


@register_layer("softmax_with_cost", auto_activation=False, full_precision=True)
def softmax_with_cost_apply(conf, params, inputs, ctx):
    """Fused log-softmax cross-entropy straight from logits."""
    logits, label = inputs[0], inputs[1]
    ids = _label_ids(label)
    return _per_sample(_fused_ce_from_logits(logits.data, ids), logits)
