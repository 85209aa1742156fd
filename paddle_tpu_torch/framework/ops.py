"""The op set (reference: paddle/operators/*.cc — add, mul, rowwise_add,
sigmoid, softmax, cross_entropy (onehot), mean, sgd, fill_zeros_like, scale,
plus the fc composite built in net.py); the counterpart of
``paddle_tpu/framework/ops.py``, each kernel the torch expression of the
JAX package's."""

from __future__ import annotations

import torch

from paddle_tpu_torch.framework.op import register_op


def _same_shape(in_shapes, attrs):
    return [in_shapes[0]]


@register_op("add", ["X", "Y"], ["Out"], infer_shape=_same_shape)
def add(x, y):
    """add_op.cc: Out = X + Y"""
    return x + y


@register_op(
    "mul", ["X", "Y"], ["Out"],
    infer_shape=lambda s, a: [(s[0][0], s[1][1])],
)
def mul(x, y):
    """mul_op.cc: matrix product"""
    return torch.matmul(x, y)


@register_op("rowwise_add", ["X", "b"], ["Out"], infer_shape=_same_shape)
def rowwise_add(x, b):
    """rowwise_add_op.cc: broadcast-add a row vector"""
    return x + b[None, :]


@register_op("sigmoid", ["X"], ["Y"], infer_shape=_same_shape)
def sigmoid(x):
    return torch.sigmoid(x)


@register_op("softmax", ["X"], ["Y"], infer_shape=_same_shape)
def softmax(x):
    return torch.softmax(x, dim=-1)


@register_op(
    "onehot_cross_entropy", ["X", "label"], ["Y"],
    infer_shape=lambda s, a: [(s[0][0],)],
)
def onehot_cross_entropy(x, label):
    """cross_entropy_op.cc: Y_i = -log(X_i[label_i]); a float label
    truncates to its integer, as the JAX package's ``astype(int32)`` does"""
    picked = torch.gather(x, 1, label.long()[:, None])[:, 0]
    return -torch.log(torch.clamp(picked, min=1e-12))


@register_op("mean", ["X"], ["Out"], infer_shape=lambda s, a: [()])
def mean(x):
    return torch.mean(x)


@register_op("scale", ["X"], ["Out"], attrs=("scale",), infer_shape=_same_shape)
def scale(x, scale=1.0):
    return x * scale


@register_op("fill_zeros_like", ["Src"], ["Dst"], infer_shape=_same_shape)
def fill_zeros_like(src):
    return torch.zeros_like(src)


@register_op(
    "sgd", ["param", "grad"], ["param_out"],
    attrs=("learning_rate",), infer_shape=_same_shape,
)
def sgd(param, grad, learning_rate=0.01):
    """sgd_op.cc: param_out = param - lr * grad"""
    return param - learning_rate * grad
