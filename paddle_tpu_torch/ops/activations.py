"""Activation registry — the counterpart of ``paddle_tpu/ops/activations.py``,
holding the elementwise activations and softmax; ``sequence_softmax``
masks padding over the time axis."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

Activation = Callable[..., torch.Tensor]

_ACTIVATIONS: Dict[str, Activation] = {}


def register_activation(*names: str):
    def deco(fn: Activation) -> Activation:
        for n in names:
            _ACTIVATIONS[n] = fn
        return fn

    return deco


def get_activation(name: str) -> Activation:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise KeyError(
            f"unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}"
        ) from None


def registered_activations():
    return sorted(_ACTIVATIONS)


def apply_activation(name: str, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
    if name == "sequence_softmax":
        return _ACTIVATIONS[name](x, mask)
    return _ACTIVATIONS[name](x)


@register_activation("identity", "linear", "")
def _identity(x):
    return x


@register_activation("sigmoid")
def _sigmoid(x):
    return torch.sigmoid(x)


@register_activation("softmax")
def _softmax(x):
    # f32 (or wider) statistics inside, result in the input dtype (as
    # jax.nn.softmax)
    return torch.softmax(x, dim=-1, dtype=torch.promote_types(x.dtype, torch.float32)).to(x.dtype)


@register_activation("sequence_softmax")
def _sequence_softmax(x, mask=None):
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    logits = x[..., 0] if squeeze else x
    if mask is not None:
        logits = torch.where(mask > 0, logits, torch.full_like(logits, -1e9))
    out = torch.softmax(logits, dim=-1)
    if mask is not None:
        out = out * mask.to(out.dtype)
    return out[..., None] if squeeze else out


@register_activation("relu")
def _relu(x):
    return torch.relu(x)


@register_activation("brelu")
def _brelu(x):
    return torch.clamp(x, 0.0, 24.0)


@register_activation("tanh")
def _tanh(x):
    return torch.tanh(x)


@register_activation("stanh")
def _stanh(x):
    return 1.7159 * torch.tanh((2.0 / 3.0) * x)


@register_activation("softrelu")
def _softrelu(x):
    return torch.nn.functional.softplus(torch.clamp(x, -40.0, 40.0))


@register_activation("abs")
def _abs(x):
    return torch.abs(x)


@register_activation("square")
def _square(x):
    return torch.square(x)


@register_activation("exponential", "exp")
def _exp(x):
    return torch.exp(x)


@register_activation("reciprocal")
def _reciprocal(x):
    return 1.0 / x


@register_activation("sqrt")
def _sqrt(x):
    return torch.sqrt(x)


@register_activation("log")
def _log(x):
    return torch.log(x)
