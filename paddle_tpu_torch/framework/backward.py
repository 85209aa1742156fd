"""Backward — gradient program construction (reference:
paddle/framework/backward.cc:179 builds a reversed net of per-op grad ops
with X->X@GRAD renaming); the counterpart of
``paddle_tpu/framework/backward.py``.

The forward op or net is one traceable function, so the gradient is
``torch.autograd.grad`` over its trace (the JAX package takes ``jax.vjp``)
instead of a reversed list of grad ops.  The scope-facing contract is
kept: running the backward op reads each external output's ``name@GRAD``
and writes each input's ``name@GRAD``."""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Set

import torch

from paddle_tpu_torch.framework.scope import compute_value

GRAD_SUFFIX = "@GRAD"


def grad_name(name: str) -> str:
    return name + GRAD_SUFFIX


class BackwardOp:
    """The gradient operator for a forward op/net."""

    type = "backward"

    def __init__(self, forward, no_grad_set: Optional[Set[str]] = None):
        self.forward = forward
        self.no_grad_set = set(no_grad_set or ())
        self.fwd_inputs = forward.input_names()
        self.fwd_outputs = forward.output_names()
        self.grad_inputs = [n for n in self.fwd_inputs if n not in self.no_grad_set]

    def input_names(self) -> List[str]:
        return self.fwd_inputs + [grad_name(n) for n in self.fwd_outputs]

    def output_names(self) -> List[str]:
        return [grad_name(n) for n in self.grad_inputs]

    def trace(self, values: Dict[str, Any]) -> Dict[str, Any]:
        grads = _vjp_trace(
            self.forward,
            {n: values[n] for n in self.fwd_inputs},
            {n: values[grad_name(n)] for n in self.fwd_outputs},
            self.grad_inputs,
        )
        new_values = dict(values)
        for n in self.grad_inputs:
            new_values[grad_name(n)] = grads[n]
        return new_values

    def run(self, scope) -> None:
        dev = scope.device
        values = {n: compute_value(scope.get_var(n).get(), dev) for n in self.fwd_inputs}
        for n in self.fwd_outputs:
            g = scope.find_var(grad_name(n))
            if g is None or g.get() is None:
                # default seed: ones like the forward output (callers usually
                # seed the loss grad explicitly)
                values[grad_name(n)] = torch.ones_like(
                    compute_value(scope.find_var(n).get(), dev))
            else:
                values[grad_name(n)] = compute_value(g.get(), dev)
        out = self.trace(values)
        for n in self.grad_inputs:
            scope.new_var(grad_name(n)).set(out[grad_name(n)])


def _vjp_trace(forward, inputs: Dict[str, Any], out_grads: Dict[str, Any],
               wrt: List[str]) -> Dict[str, Any]:
    """d(sum over outputs of output . out_grad) / d input for each input in
    `wrt`: the forward traced again over copies of those inputs that
    require grad.  An input no output depends on differentiably (the float
    label behind onehot_cross_entropy's integer cast, an integer input)
    gets zeros, as ``jax.vjp`` gives; the cotangents are float32, as the
    JAX package casts them."""
    out_names = forward.output_names()
    primals = {n: inputs[n].detach().requires_grad_(inputs[n].is_floating_point())
               for n in wrt}
    values = dict(inputs)
    values.update(primals)
    with torch.enable_grad():
        values = forward.trace(values)
        roots = [(values[n], out_grads[n].to(torch.float32)) for n in out_names
                 if values[n].requires_grad]
        diff = [n for n in wrt if primals[n].requires_grad]
        grads = torch.autograd.grad(
            [r for r, _ in roots], [primals[n] for n in diff], [c for _, c in roots],
            allow_unused=True) if roots and diff else [None] * len(diff)
    got = dict(zip(diff, grads))
    out = {}
    for n in wrt:
        g, p = got.get(n), primals[n]
        if g is None:
            g = torch.zeros_like(p, dtype=p.dtype if p.is_floating_point() else torch.float32)
        out[n] = g
    return out


def Backward(forward, no_grad_set: Optional[Iterable[str]] = None) -> BackwardOp:
    """reference backward.cc Backward(): returns the op computing
    d(outputs)/d(inputs) with @GRAD-named scope variables."""
    return BackwardOp(forward, set(no_grad_set or ()))
