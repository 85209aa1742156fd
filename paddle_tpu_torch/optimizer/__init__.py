"""Optimizers — the counterpart of ``paddle_tpu/optimizer/__init__.py``: its
eight rules (``Momentum``, alias ``SGD``, plain or Nesterov;
``SparseMomentum``, ``AdaGrad``, ``AdaDelta``, ``RMSProp``,
``DecayedAdaGrad``, ``Adam`` and ``AdaMax``), with the learning-rate
schedules, L1/L2 regularization, elementwise gradient clipping and
``ModelAverage``.  The slots carry the JAX package's names, so the
optimizer state of a checkpoint loads in either package.

The order of one update is the JAX package's: the schedule's counter, the
clip, L2 folded into the gradient, the per-leaf rule, the step bump, the L1
shrink, the model average.  Where the JAX package returns new trees, the
port updates the parameter and slot tensors **in place** under
``torch.no_grad()`` (one copy of each in device memory) and returns the same
objects; each rule's arithmetic follows the JAX order.  The parameter tree
is ``{layer: {key: tensor}}``; the optimizer state is ``{"step": int,
<slot>: tree, ...}``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from paddle_tpu_torch.utils.tree import get_path, leaf_paths, map_leaves

OptState = Dict[str, Any]
Schedule = Callable[[float], float]  # counter -> lr multiplier


# ---------------------------------------------------------------------------
# learning-rate schedules
# ---------------------------------------------------------------------------


def constant_schedule() -> Schedule:
    return lambda step: 1.0


def poly_schedule(a: float, b: float) -> Schedule:
    """(1 + a*t)^-b."""
    return lambda step: (1.0 + a * step) ** -b


def caffe_poly_schedule(a: float, b: float, max_steps: float) -> Schedule:
    return lambda step: (1.0 - min(step, max_steps) / max_steps) ** b


def exp_schedule(a: float, b: float) -> Schedule:
    """a^(t/b)."""
    return lambda step: a ** (step / b)


def discexp_schedule(a: float, b: float) -> Schedule:
    """a^floor(t/b)."""
    return lambda step: a ** math.floor(step / b)


def linear_schedule(a: float, b: float) -> Schedule:
    """max(1 - a*t, b)."""
    return lambda step: max(1.0 - a * step, b)


def manual_schedule(boundaries, multipliers) -> Schedule:
    """Piecewise constant: the first segment with counter <= boundaries[i]
    selects multipliers[i]; past the last boundary the last one holds."""
    bs, ms = list(boundaries), list(multipliers)

    def fn(step):
        idx = sum(1 for x in bs if step > x)
        return ms[min(idx, len(ms) - 1)]

    return fn


def parse_lr_args(args: str):
    """``'seg0:rate0,seg1:rate1,...'`` -> (segments, rates)."""
    segments, rates = [], []
    for piece in (args or "").split(","):
        piece = piece.strip()
        if not piece:
            continue
        seg, sep, rate = piece.partition(":")
        if not sep:
            raise ValueError(
                f"wrong format for learning_rate_args {args!r}: expected "
                "'seg0:rate0,seg1:rate1,...'"
            )
        segments.append(float(seg))
        rates.append(float(rate))
    if not segments:
        raise ValueError(
            f"learning_rate_schedule 'manual'/'pass_manual' needs a "
            f"non-empty learning_rate_args; got {args!r}"
        )
    return segments, rates


def make_schedule(
    name: str, a: float = 0.0, b: float = 0.0, max_steps: float = 0.0, args: str = ""
) -> Schedule:
    if name in ("constant", "fixed", ""):
        return constant_schedule()
    if name == "poly":
        return poly_schedule(a, b)
    if name == "caffe_poly":
        return caffe_poly_schedule(a, b, max_steps)
    if name == "exp":
        return exp_schedule(a, b)
    if name == "discexp":
        return discexp_schedule(a, b)
    if name == "linear":
        return linear_schedule(a, b)
    if name in ("manual", "pass_manual"):
        return manual_schedule(*parse_lr_args(args))
    raise ValueError(f"unknown learning_rate_schedule {name!r}")


def schedule_counter_unit(name: str) -> str:
    """The counter a schedule reads: "pass" for pass_manual, "samples" for
    manual, "step" otherwise."""
    if name == "pass_manual":
        return "pass"
    if name == "manual":
        return "samples"
    return "step"


# ---------------------------------------------------------------------------
# regularization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class L2Regularization:
    rate: float


@dataclasses.dataclass(frozen=True)
class L1Regularization:
    rate: float


@dataclasses.dataclass(frozen=True)
class ModelAverage:
    """Exponential parameter average kept beside the parameters."""

    average_window: float = 0.01


# ---------------------------------------------------------------------------
# optimizer base
# ---------------------------------------------------------------------------


def _zeros_like_tree(params):
    return map_leaves(torch.zeros_like, params)


class Optimizer:
    """Base: subclasses name their slots and implement the per-leaf rule.
    Keywords as in the JAX package (and ``paddle.v2.optimizer``)."""

    def __init__(
        self,
        learning_rate: float = 0.001,
        learning_rate_schedule: str = "constant",
        learning_rate_decay_a: float = 0.0,
        learning_rate_decay_b: float = 0.0,
        learning_rate_max_steps: float = 1.0,
        learning_rate_args: str = "",
        regularization: Optional[Any] = None,
        gradient_clipping_threshold: float = 0.0,
        model_average: Optional[ModelAverage] = None,
        samples_per_step: float = 1.0,
    ):
        self.learning_rate = learning_rate
        self.schedule = make_schedule(
            learning_rate_schedule,
            learning_rate_decay_a,
            learning_rate_decay_b,
            learning_rate_max_steps,
            learning_rate_args,
        )
        self.schedule_unit = schedule_counter_unit(learning_rate_schedule)
        self.samples_per_step = float(samples_per_step)
        self.regularization = regularization
        self.clip = gradient_clipping_threshold
        self.model_average = model_average

    # -- slots ---------------------------------------------------------
    def slot_names(self) -> Tuple[str, ...]:
        return ()

    def init(self, params) -> OptState:
        state: OptState = {"step": 0}
        if self.schedule_unit == "pass":
            state["pass"] = 0
        for name in self.slot_names():
            state[name] = _zeros_like_tree(params)
        if self.model_average is not None:
            state["avg"] = map_leaves(lambda v: v.detach().float().clone(), params)
            state["avg_count"] = 0.0
        return state

    # -- update --------------------------------------------------------
    def rule(self, g, p, lr, slots, step) -> None:
        """Per-leaf update of `p` and its slots, in place."""
        raise NotImplementedError

    def learning_rate_at(self, state: OptState) -> float:
        step = state["step"]
        if self.schedule_unit == "pass":
            counter = float(state["pass"])
        elif self.schedule_unit == "samples":
            # the counter is bumped before the rate is read, so the first
            # update already sees one batch of samples
            counter = (step + 1.0) * self.samples_per_step
        else:
            counter = float(step)
        return self.learning_rate * self.schedule(counter)

    @torch.no_grad()
    def update(self, grads, state: OptState, params) -> Tuple[Any, OptState]:
        """Apply one update to `params` and `state` in place; returns them."""
        step = state["step"]
        lr = self.learning_rate_at(state)
        l2 = self.regularization.rate if isinstance(self.regularization, L2Regularization) else 0.0
        names = self.slot_names()
        for path, p in leaf_paths(params):
            g = get_path(grads, path)
            if self.clip > 0:
                g = g.clamp(-self.clip, self.clip)
            if l2:
                g = g + l2 * p
            self.rule(g, p, lr, tuple(get_path(state[n], path) for n in names), step)
        state["step"] = step + 1

        if isinstance(self.regularization, L1Regularization) and self.regularization.rate:
            lam = lr * self.regularization.rate
            for _, p in leaf_paths(params):
                p.copy_(torch.sign(p) * torch.clamp(p.abs() - lam, min=0.0))

        if self.model_average is not None:
            window = self.model_average.average_window
            for path, p in leaf_paths(params):
                get_path(state["avg"], path).mul_(1.0 - window).add_(p, alpha=window)
            state["avg_count"] += 1.0
        return params, state


# ---------------------------------------------------------------------------
# concrete optimizers
# ---------------------------------------------------------------------------


class Momentum(Optimizer):
    """SGD with (optionally Nesterov) momentum: m = mu*m - lr*g, then
    p += m (or p += mu*m - lr*g with Nesterov)."""

    def __init__(self, momentum: float = 0.0, nesterov: bool = False, **kw):
        super().__init__(**kw)
        self.momentum = momentum
        self.nesterov = nesterov

    def slot_names(self):
        return ("m",) if self.momentum else ()

    def rule(self, g, p, lr, slots, step):
        if not self.momentum:
            p.sub_(lr * g)
            return
        (m,) = slots
        m.mul_(self.momentum).sub_(lr * g)
        if self.nesterov:
            p.add_(self.momentum * m - lr * g)
        else:
            p.add_(m)


SGD = Momentum


class SparseMomentum(Momentum):
    """The reference's SparseMomentum computes plain momentum (its lazy
    bookkeeping only spares untouched rows on a CPU parameter server), so
    this is Momentum under the v1 name, with its default momentum 0.9."""

    def __init__(self, momentum: float = 0.9, **kw):
        super().__init__(momentum=momentum, **kw)


class AdaGrad(Optimizer):
    """acc += g^2; p -= lr * g / (sqrt(acc) + eps)."""

    def __init__(self, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.epsilon = epsilon

    def slot_names(self):
        return ("accum",)

    def rule(self, g, p, lr, slots, step):
        (acc,) = slots
        acc.add_(torch.square(g))
        p.sub_(lr * g / (torch.sqrt(acc) + self.epsilon))


class AdaDelta(Optimizer):
    """E[g^2] and E[dx^2] with decay rho; dx = -sqrt((E[dx^2] + eps) /
    (E[g^2] + eps)) * g; p += lr * dx."""

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.rho = rho
        self.epsilon = epsilon

    def slot_names(self):
        return ("accum_g", "accum_x")

    def rule(self, g, p, lr, slots, step):
        eg, ex = slots
        eg.mul_(self.rho).add_((1 - self.rho) * torch.square(g))
        dx = -torch.sqrt((ex + self.epsilon) / (eg + self.epsilon)) * g
        ex.mul_(self.rho).add_((1 - self.rho) * torch.square(dx))
        p.add_(lr * dx)


class RMSProp(Optimizer):
    """Centred, as the reference's: E[g^2] and E[g] with decay rho;
    p -= lr * g / sqrt(E[g^2] - E[g]^2 + eps)."""

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.rho = rho
        self.epsilon = epsilon

    def slot_names(self):
        return ("ms", "mg")

    def rule(self, g, p, lr, slots, step):
        ms, mg = slots
        ms.mul_(self.rho).add_((1 - self.rho) * torch.square(g))
        mg.mul_(self.rho).add_((1 - self.rho) * g)
        p.sub_(lr * g / torch.sqrt(ms - torch.square(mg) + self.epsilon))


class DecayedAdaGrad(Optimizer):
    """acc = rho * acc + (1 - rho) * g^2; p -= lr * g / sqrt(acc + eps)."""

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.rho = rho
        self.epsilon = epsilon

    def slot_names(self):
        return ("accum",)

    def rule(self, g, p, lr, slots, step):
        (acc,) = slots
        acc.mul_(self.rho).add_((1 - self.rho) * torch.square(g))
        p.sub_(lr * g / torch.sqrt(acc + self.epsilon))


def _bias_correction(beta: float, t: float, dtype) -> torch.Tensor:
    """max(1 - beta^t, 1e-16) in the parameters' dtype, as the JAX package
    computes it; the floor never binds for t >= 1 (a zero-dimensional CPU
    tensor, which acts as a scalar on a CUDA operand)."""
    return torch.clamp(1 - torch.tensor(beta, dtype=dtype) ** t, min=1e-16)


class Adam(Optimizer):
    """Adam with bias correction."""

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8, **kw):
        super().__init__(**kw)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def slot_names(self):
        return ("m", "v")

    def rule(self, g, p, lr, slots, step):
        m, v = slots
        t = step + 1.0
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        v.mul_(self.beta2).add_((1 - self.beta2) * torch.square(g))
        mhat = m / _bias_correction(self.beta1, t, p.dtype)
        vhat = v / _bias_correction(self.beta2, t, p.dtype)
        p.sub_(lr * mhat / (torch.sqrt(vhat) + self.epsilon))


class AdaMax(Optimizer):
    """m = b1 * m + (1 - b1) * g; u = max(b2 * u, |g|);
    p -= lr / (1 - b1^t) * m / (u + 1e-12)."""

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999, **kw):
        super().__init__(**kw)
        self.beta1 = beta1
        self.beta2 = beta2

    def slot_names(self):
        return ("m", "u")

    def rule(self, g, p, lr, slots, step):
        m, u = slots
        t = step + 1.0
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        torch.maximum(u.mul_(self.beta2), torch.abs(g), out=u)
        corr = _bias_correction(self.beta1, t, p.dtype)
        p.sub_((lr / corr) * m / (u + 1e-12))
