"""Cost layers — the counterpart of ``paddle_tpu/layers/cost.py``: the
cross-entropy pair Transformer-base trains with, ``cross_entropy`` (the
probability path, and the fused log-softmax path over ``<input>@logits``)
and ``softmax_with_cost``; the two costs that take a label in any of the
feeder's forms (dense, integer ids, or the padded multi-id rows of a
big-vocabulary sparse slot), ``square_error`` and
``multi_binary_label_cross_entropy``; ``soft_binary_class_cross_entropy``,
``smooth_l1``, the two Huber costs, ``rank_cost`` (RankNet's pairwise
loss), ``sum_cost``, ``cross_entropy_with_selfnorm`` and
``multi_nn_cost``, the joint objective of a ``model_type('multi_nn')``
ensemble.

Every cost layer but ``multi_nn_cost`` emits a per-sample cost column
[B, 1]; sequence costs mask padding and sum over valid timesteps, and the
train step takes the batch mean.  Autograd over that mean replaces each
cost layer's backward.  Every cost runs in f32 under a bf16 compute dtype
(``full_precision``).
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


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)), stable at both ends (``jax.nn.softplus``)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


@register_layer("soft_binary_class_cross_entropy", auto_activation=False, full_precision=True)
def soft_bce_apply(conf, params, inputs, ctx):
    """Per-dim binary cross-entropy against soft targets
    (SoftBinaryClassCrossEntropy)."""
    prob, label = inputs[0], inputs[1]
    p = torch.clamp(prob.data, _BCE_EPS, 1.0 - _BCE_EPS)
    t = label.data
    cost = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).sum(dim=-1)
    return _per_sample(cost, prob)


@register_layer("smooth_l1", auto_activation=False, full_precision=True)
def smooth_l1_apply(conf, params, inputs, ctx):
    """SmoothL1Cost: 0.5 d^2 where |d| < 1, else |d| - 0.5, summed per
    sample."""
    x, y = inputs[0], inputs[1]
    d = x.data - y.data
    a = d.abs()
    return _per_sample(torch.where(a < 1.0, 0.5 * d * d, a - 0.5).sum(dim=-1), x)


@register_layer("huber_regression", auto_activation=False, full_precision=True)
def huber_regression_apply(conf, params, inputs, ctx):
    delta = conf.attr("delta", 1.0)
    x, y = inputs[0], inputs[1]
    a = (x.data - y.data).abs()
    cost = torch.where(a <= delta, 0.5 * a * a, delta * (a - 0.5 * delta)).sum(dim=-1)
    return _per_sample(cost, x)


@register_layer("huber_classification", auto_activation=False, full_precision=True)
def huber_classification_apply(conf, params, inputs, ctx):
    """HuberTwoClassification: labels {0, 1} as y in {-1, +1}; the cost of
    z = y f is 0 above 1, (1 - z)^2 in [-1, 1] and -4 z below -1."""
    x, label = inputs[0], inputs[1]
    f = x.data[..., 0] if x.data.dim() >= 2 else x.data
    z = (2.0 * _label_ids(label).to(f.dtype) - 1.0) * f
    cost = torch.where(z > 1.0, torch.zeros_like(z),
                       torch.where(z < -1.0, -4.0 * z, (1.0 - z) ** 2))
    return _per_sample(cost, x)


@register_layer("rank_cost", auto_activation=False, full_precision=True)
def rank_cost_apply(conf, params, inputs, ctx):
    """RankingCost (RankNet): the logistic loss of the score difference
    o = left - right against the label t, softplus(o) - t o."""
    left, right, label = inputs[0], inputs[1], inputs[2]
    o = left.data[..., 0] - right.data[..., 0]
    t = label.data
    t = (t[..., 0] if t.dim() >= 2 else t).to(o.dtype)
    return _per_sample(softplus(o) - t * o, left)


@register_layer("sum_cost", auto_activation=False, full_precision=True)
def sum_cost_apply(conf, params, inputs, ctx):
    """SumCostLayer: the sum of the input row (over a sequence's valid
    steps)."""
    x = inputs[0]
    cost = x.data.sum(dim=-1)
    if x.is_seq and cost.dim() == 2:
        cost = (cost * x.mask(cost.dtype)).sum(dim=-1)
    return _per_sample(cost, x)


@register_layer("cross_entropy_with_selfnorm", auto_activation=False, full_precision=True)
def ce_selfnorm_apply(conf, params, inputs, ctx):
    """MultiClassCrossEntropyWithSelfNorm: cross-entropy of the row
    normalised by its sum Z, plus alpha log(Z)^2."""
    prob, label = inputs[0], inputs[1]
    alpha = conf.attr("softmax_selfnorm_alpha", 0.1)
    ids = _label_ids(label)
    z = prob.data.sum(dim=-1)
    p = torch.gather(prob.data, -1, ids[..., None].long())[..., 0] / torch.clamp(z, min=_EPS)
    cost = (-torch.log(torch.clamp(p, min=_EPS))
            + alpha * torch.log(torch.clamp(z, min=_EPS)) ** 2)
    return _per_sample(cost, prob)


@register_layer("multi_nn_cost", auto_activation=False, full_precision=True)
def multi_nn_cost_apply(conf, params, inputs, ctx):
    """The joint objective of a ``model_type('multi_nn')`` ensemble: the sum
    of every sub-network's mean cost (the reference trainer sums the output
    Arguments of MultiNetwork::forward), one value of shape [1]."""
    return SeqTensor(torch.stack([t.data.mean() for t in inputs]).sum().reshape(1))
