"""Numeric-vs-analytic gradient checking for ops (reference:
python/paddle/v2/framework/tests/gradient_checker.py; the same
finite-difference strategy as gserver's LayerGradUtil); the counterpart of
``paddle_tpu/framework/gradient_checker.py``.

The objective is evaluated in float32, as the JAX package's is: its float64
inputs pass through ``jnp.asarray``, which makes them float32 with 64-bit
mode off.  Only the sum over the outputs is taken in float64."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.framework.backward import Backward, grad_name
from paddle_tpu_torch.framework.scope import Scope, compute_value


def numeric_gradient(op, inputs: Dict[str, np.ndarray], wrt: str,
                     out_grads: Optional[Dict[str, np.ndarray]] = None,
                     delta: float = 1e-3, device=None) -> np.ndarray:
    """Central finite differences of sum(outputs . out_grads) w.r.t. `wrt`,
    the op run on `device` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    out_names = op.output_names()

    def objective(vals: Dict[str, np.ndarray]) -> float:
        traced = op.trace({k: compute_value(v, dev) for k, v in vals.items()})
        total = 0.0
        for n in out_names:
            o = traced[n].detach().double().cpu().numpy()
            g = (
                np.asarray(out_grads[n], dtype=np.float64)
                if out_grads is not None
                else np.ones_like(o)
            )
            total += float(np.sum(o * g))
        return total

    base = {k: np.array(v, dtype=np.float64) for k, v in inputs.items()}
    x = base[wrt]
    grad = np.zeros_like(x)
    flat = x.reshape(-1)
    gflat = grad.reshape(-1)
    for i in range(flat.size):
        orig = flat[i]
        flat[i] = orig + delta
        plus = objective(base)
        flat[i] = orig - delta
        minus = objective(base)
        flat[i] = orig
        gflat[i] = (plus - minus) / (2 * delta)
    return grad


def check_gradients(op, inputs: Dict[str, np.ndarray],
                    wrt: Optional[Sequence[str]] = None,
                    out_grads: Optional[Dict[str, np.ndarray]] = None,
                    rtol: float = 1e-2, atol: float = 1e-3, device=None) -> None:
    """Assert the BackwardOp's analytic grads match finite differences, on
    `device` (the card unless the caller asks for the CPU)."""
    scope = Scope(device=device)
    for k, v in inputs.items():
        scope.new_var(k).set(np.asarray(v, np.float32))
    op.run(scope)
    bwd = Backward(op)
    if out_grads is not None:
        for n, g in out_grads.items():
            scope.new_var(grad_name(n)).set(np.asarray(g, np.float32))
    bwd.run(scope)
    targets = list(wrt) if wrt is not None else bwd.grad_inputs
    for name in targets:
        analytic = scope.get_var(grad_name(name)).get().cpu().numpy()
        numeric = numeric_gradient(op, inputs, name, out_grads, device=scope.device)
        np.testing.assert_allclose(
            analytic, numeric, rtol=rtol, atol=atol,
            err_msg=f"gradient mismatch for {name!r} of op {op!r}",
        )
