"""Train and eval steps — the counterpart of ``paddle_tpu/trainer/step.py``.

One train step is the cost of the network on a batch, its gradient with
respect to every master parameter by ``torch.autograd.grad``, one optimizer
update (in place), the layer state the forward produced (batch norm's moving
statistics, detached) and the metrics.  PyTorch runs it eagerly; the JAX package
jits the same body into one program.  Multi-head attention routed through
flash attention takes its gradient from the hand-written backward kernels
(``ops/flash_attention.py``).

Not ported yet: a device mesh (data or model parallelism), static pruning
masks, the divergence sentinel and the quantized gradient reduction.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from paddle_tpu_torch.core.compiler import CompiledNetwork
from paddle_tpu_torch.optimizer import Optimizer

Metrics = Dict[str, torch.Tensor]
MetricsFn = Callable[[Dict[str, Any]], Metrics]


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


def _train_step_body(network: CompiledNetwork, optimizer: Optimizer, extra_metrics=None):
    """(params, state, opt_state, batch) -> (params, state, opt_state,
    metrics), with the parameter and optimizer tensors updated in place and
    the layer state replaced."""

    def step(params, state, opt_state, batch):
        # views of the masters that share their storage: the graph hangs off
        # these, and the in-place update below writes the masters themselves
        leaves = {
            layer: {k: v.detach().requires_grad_(True) for k, v in p.items()}
            for layer, p in params.items()
        }
        with torch.enable_grad():
            cost, (outs, new_state) = network.cost(leaves, batch, state=state, train=True)
            flat = [v for p in leaves.values() for v in p.values()]
            grads_flat = torch.autograd.grad(cost, flat, allow_unused=True)
        grads, i = {}, 0
        for layer, p in leaves.items():
            grads[layer] = {}
            for k, v in p.items():
                g = grads_flat[i]
                grads[layer][k] = torch.zeros_like(v) if g is None else g
                i += 1
        params, opt_state = optimizer.update(grads, opt_state, params)
        # the state carries no graph into the next step
        new_state = {
            layer: {k: v.detach() for k, v in s.items()} for layer, s in new_state.items()
        }
        metrics: Metrics = {"cost": cost.detach()}
        if extra_metrics is not None:
            metrics.update(extra_metrics(outs))
        return params, new_state, opt_state, metrics

    return step


def make_train_step(
    network: CompiledNetwork,
    optimizer: Optimizer,
    mesh=None,
    extra_metrics: Optional[MetricsFn] = None,
    prune_masks=None,
    sentinel: Optional[bool] = None,
    quantized: Optional[bool] = None,
):
    """The train step ``(params, state, opt_state, batch) -> (params, state,
    opt_state, metrics)``; see :func:`_train_step_body`."""
    if mesh is not None:
        _not_ported("training over a device mesh")
    if prune_masks:
        _not_ported("static pruning")
    if sentinel:
        _not_ported("the divergence sentinel")
    if quantized:
        _not_ported("the quantized gradient reduction")
    return _train_step_body(network, optimizer, extra_metrics)


def make_eval_step(
    network: CompiledNetwork, mesh=None, extra_metrics: Optional[MetricsFn] = None
):
    """``(params, state, batch) -> metrics`` at test time, without gradients
    and with global statistics (``train=False``); the state is not updated."""
    if mesh is not None:
        _not_ported("evaluation over a device mesh")

    @torch.no_grad()
    def step(params, state, batch):
        cost, (outs, _) = network.cost(params, batch, state=state, train=False)
        metrics: Metrics = {"cost": cost}
        if extra_metrics is not None:
            metrics.update(extra_metrics(outs))
        return metrics

    return step
