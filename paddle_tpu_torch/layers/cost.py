"""Cost layers — the counterpart of ``paddle_tpu/layers/cost.py`` for the
cross-entropy pair Transformer-base trains with: ``cross_entropy`` (the
probability path, and the fused log-softmax path over ``<input>@logits``)
and ``softmax_with_cost``; and the two costs that take a label in any of
the feeder's forms (dense, integer ids, or the padded multi-id rows of a
big-vocabulary sparse slot): ``square_error`` and
``multi_binary_label_cross_entropy``.

Every cost layer emits a per-sample cost column [B, 1]; sequence costs mask
padding and sum over valid timesteps, and the train step takes the batch
mean.  Autograd over that mean replaces each cost layer's backward.  The
other cost types are not ported yet.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.layers.base import is_sparse_ids, register_layer

_EPS = 1e-10
# two-sided probability clip of the binary cross-entropy: representable in
# float32 (1 - 1e-10 rounds to 1.0)
_BCE_EPS = 1e-6


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


def _label_as_dense(label: SeqTensor, width: int) -> torch.Tensor:
    """A cost's label as a dense [.., width] block: a dense label passes
    through; integer ids one-hot against the prediction width; the padded
    multi-id rows of a sparse slot (sentinel == width) become a multi-hot
    row, duplicates clamped to 1 (the reference's sparse-label form,
    CostLayer.cpp)."""
    t = label.data
    if t.is_floating_point():
        return t
    if is_sparse_ids(label, width):
        hot = torch.nn.functional.one_hot(t.long(), width + 1)[..., :width]
        return hot.sum(dim=-2).clamp(max=1).to(torch.float32)
    return torch.nn.functional.one_hot(_label_ids(label).long(), width).to(torch.float32)


@register_layer("multi_binary_label_cross_entropy", auto_activation=False, full_precision=True)
def multi_binary_label_ce_apply(conf, params, inputs, ctx):
    """Binary cross-entropy against a multi-hot label
    (MultiBinaryLabelCrossEntropy)."""
    prob, label = inputs[0], inputs[1]
    p = torch.clamp(prob.data, _BCE_EPS, 1.0 - _BCE_EPS)
    t = _label_as_dense(label, prob.data.shape[-1])
    cost = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).sum(dim=-1)
    return _per_sample(cost, prob)


@register_layer("square_error", auto_activation=False, full_precision=True)
def square_error_apply(conf, params, inputs, ctx):
    """0.5 * sum((x - y)^2) per sample (SumOfSquaresCostLayer; an integer
    label acts as its one-hot row)."""
    x, y = inputs[0], inputs[1]
    d = x.data - _label_as_dense(y, x.data.shape[-1])
    return _per_sample(0.5 * (d * d).sum(dim=-1), x)
