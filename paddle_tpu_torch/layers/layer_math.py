"""Layer arithmetic — the ``paddle.trainer_config_helpers.math`` surface
(reference python/paddle/trainer_config_helpers/math.py): elementwise math
functions over LayerOutputs plus operator overloading, so v1 configs can
write ``layer_math.exp(logvar) * 0.5`` or ``mu + sigma``.

Everything lowers to existing layers: unary functions are identity-addto
layers with the matching activation; scalar affine ops are slope_intercept;
layer+layer is addto; layer*layer is a dotmul mixed term — the same
lowering the reference's math.py performs onto mixed/slope_intercept."""

from __future__ import annotations

from paddle_tpu_torch.core.topology import LayerOutput

__all__ = [
    "exp", "log", "sqrt", "square", "abs", "reciprocal", "sigmoid", "tanh",
    "relu", "add", "sub", "mul",
]


def _act(input: LayerOutput, act_name: str) -> LayerOutput:
    from paddle_tpu_torch import activation as A
    from paddle_tpu_torch.layers import addto

    cls = {
        "exponential": A.Exp, "log": A.Log, "sqrt": A.Sqrt,
        "square": A.Square, "abs": A.Abs, "reciprocal": A.Reciprocal,
        "sigmoid": A.Sigmoid, "tanh": A.Tanh, "relu": A.Relu,
    }[act_name]
    return addto([input], act=cls(), bias_attr=False)


def exp(input: LayerOutput) -> LayerOutput:
    return _act(input, "exponential")


def log(input: LayerOutput) -> LayerOutput:
    return _act(input, "log")


def sqrt(input: LayerOutput) -> LayerOutput:
    return _act(input, "sqrt")


def square(input: LayerOutput) -> LayerOutput:
    return _act(input, "square")


def abs(input: LayerOutput) -> LayerOutput:  # noqa: A001 - reference name
    return _act(input, "abs")


def reciprocal(input: LayerOutput) -> LayerOutput:
    return _act(input, "reciprocal")


def sigmoid(input: LayerOutput) -> LayerOutput:
    return _act(input, "sigmoid")


def tanh(input: LayerOutput) -> LayerOutput:
    return _act(input, "tanh")


def relu(input: LayerOutput) -> LayerOutput:
    return _act(input, "relu")


def add(a, b):
    from paddle_tpu_torch.layers import addto, slope_intercept

    if isinstance(a, LayerOutput) and isinstance(b, LayerOutput):
        return addto([a, b], bias_attr=False)
    if isinstance(a, LayerOutput):
        return slope_intercept(a, slope=1.0, intercept=float(b))
    return slope_intercept(b, slope=1.0, intercept=float(a))


def sub(a, b):
    from paddle_tpu_torch.layers import addto, slope_intercept

    if isinstance(a, LayerOutput) and isinstance(b, LayerOutput):
        return addto([a, slope_intercept(b, slope=-1.0)], bias_attr=False)
    if isinstance(a, LayerOutput):
        return slope_intercept(a, slope=1.0, intercept=-float(b))
    return slope_intercept(b, slope=-1.0, intercept=float(a))


def mul(a, b):
    from paddle_tpu_torch.layers import dotmul_operator, slope_intercept

    if isinstance(a, LayerOutput) and isinstance(b, LayerOutput):
        return dotmul_operator(a, b)
    if isinstance(a, LayerOutput):
        return slope_intercept(a, slope=float(b))
    return slope_intercept(b, slope=float(a))


# -- operator overloading on LayerOutput (reference math.py registers the
#    same dunders) ----------------------------------------------------------
LayerOutput.__add__ = add
LayerOutput.__radd__ = lambda self, other: add(other, self)
LayerOutput.__sub__ = sub
LayerOutput.__rsub__ = lambda self, other: sub(other, self)
LayerOutput.__mul__ = mul
LayerOutput.__rmul__ = lambda self, other: mul(other, self)
