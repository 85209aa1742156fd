"""Train and eval steps — the counterpart of ``paddle_tpu/trainer/step.py``.

One train step is the cost of the network on a batch, its gradient with
respect to every master parameter by ``torch.autograd.grad``, one optimizer
update (in place), the layer state the forward produced (batch norm's moving
statistics, detached) and the metrics.  PyTorch runs it eagerly; the JAX package
jits the same body into one program.  Multi-head attention routed through
flash attention takes its gradient from the hand-written backward kernels
(``ops/flash_attention.py``).

The divergence sentinel (the ``divergence_sentinel`` flag, on by default as
in the JAX package) checks that the cost and the gradients' global norm are
finite.  The JAX package computes the update and then selects the old or the
new trees; the port updates in place, so it decides first: an unhealthy step
skips the update and returns the parameters, the layer state and the
optimizer state as they were, bit for bit.  ``health`` and ``grad_norm``
ride the metrics.

Static pruning (a ``HookAttr("pruning", r)`` on a layer's ParamAttr):
:func:`build_prune_masks` keeps the largest (1 - r) fraction of each weight
by initial magnitude, and the step masks the weights in place after every
update (reference StaticPruningHook), as the JAX package does.

Not ported yet: a device mesh (data or model parallelism) and the quantized
gradient reduction.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.core.compiler import CompiledNetwork
from paddle_tpu_torch.optimizer import Optimizer
from paddle_tpu_torch.utils.tree import leaf_paths, leaves as tree_leaves, map_leaves, set_path

Metrics = Dict[str, torch.Tensor]
MetricsFn = Callable[[Dict[str, Any]], Metrics]


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


def build_prune_masks(network: CompiledNetwork, params) -> Optional[Dict[str, Any]]:
    """Static pruning masks (reference StaticPruningHook,
    ParameterUpdaterHook.cpp:39), as the JAX package builds them: for every
    layer whose ParamAttr declared a 'pruning' hook, each weight (``w*``
    leaf) keeps its largest (1 - sparsity_ratio) fraction by initial
    magnitude (ties at the threshold are kept); other leaves get all-ones
    masks.  None when nothing prunes."""
    masks: Dict[str, Any] = {}
    for name, conf in network.topology.layers.items():
        ratio = conf.attr("prune_sparsity")
        if not ratio:
            continue
        # a layer sharing parameters by name stores them under the owner
        name = network._param_owner.get(name, name)
        if name not in params or name in masks:
            continue

        def mask_leaf(v, r=ratio):
            flat = v.detach().abs().reshape(-1)
            k = max(int(flat.shape[0] * (1.0 - r)), 1)
            thresh = torch.topk(flat, k).values[-1]
            return (v.detach().abs() >= thresh).to(v.dtype)

        masks[name] = {
            k: (mask_leaf(v) if k.startswith("w") else torch.ones_like(v))
            for k, v in params[name].items()
        }
    return masks or None


@torch.no_grad()
def apply_prune_masks(params, masks: Optional[Dict[str, Any]]):
    """Multiply the masked layers' parameters by their masks, in place;
    returns `params`."""
    if masks:
        for name, m in masks.items():
            for k, mk in m.items():
                params[name][k].mul_(mk.to(params[name][k].dtype))
    return params


def _global_norm(grads) -> torch.Tensor:
    """float32 L2 norm over every gradient leaf, in one reduction per device
    (``_foreach_norm``) rather than one kernel per leaf: any NaN or Inf leaf
    makes it non-finite, so its finiteness is the whole tree's health."""
    leaves = [g.float() for g in tree_leaves(grads)]
    if not leaves:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def _sentinel_enabled(sentinel: Optional[bool]) -> bool:
    if sentinel is not None:
        return bool(sentinel)
    from paddle_tpu_torch.utils.flags import get_flag

    return bool(get_flag("divergence_sentinel"))


def draw_seed(gen: torch.Generator) -> int:
    """The next step seed from a trainer's generator."""
    return int(torch.randint(0, 2**62, (1,), generator=gen))


def _train_step_body(network: CompiledNetwork, optimizer: Optimizer, extra_metrics=None,
                     sentinel: Optional[bool] = None, prune_masks=None):
    """(params, state, opt_state, batch, rng=None) -> (params, state,
    opt_state, metrics), with the parameter and optimizer tensors updated in
    place (and masked by `prune_masks`) and the layer state replaced; `rng`
    is the step's seed (dropout)."""
    guard = _sentinel_enabled(sentinel)

    def step(params, state, opt_state, batch, rng: Optional[int] = None):
        # views of the masters that share their storage: the graph hangs off
        # these, and the in-place update below writes the masters themselves
        leaves = map_leaves(lambda v: v.detach().requires_grad_(True), params)
        with torch.enable_grad():
            cost, (outs, new_state) = network.cost(
                leaves, batch, state=state, train=True, rng=rng)
            paths = list(leaf_paths(leaves))
            grads_flat = torch.autograd.grad(
                cost, [v for _, v in paths], allow_unused=True)
        grads: Dict[str, Any] = {}
        for (path, v), g in zip(paths, grads_flat):
            set_path(grads, path, torch.zeros_like(v) if g is None else g)
        metrics: Metrics = {"cost": cost.detach()}
        healthy = True
        if guard:
            grad_norm = _global_norm(grads)
            # the one host sync of the step (the trainer reads the cost anyway)
            healthy = bool(torch.isfinite(cost.detach().float()) & torch.isfinite(grad_norm))
            metrics["health"] = torch.tensor(float(healthy))
            metrics["grad_norm"] = grad_norm
        if healthy:
            params, opt_state = optimizer.update(grads, opt_state, params)
            params = apply_prune_masks(params, prune_masks)
            # the state carries no graph into the next step
            state = map_leaves(torch.Tensor.detach, new_state)
        if extra_metrics is not None:
            metrics.update(extra_metrics(outs))
        return params, state, opt_state, metrics

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
    """The train step ``(params, state, opt_state, batch, rng=None) ->
    (params, state, opt_state, metrics)``; see :func:`_train_step_body`.
    `sentinel` None reads the ``divergence_sentinel`` flag; `prune_masks`
    (from :func:`build_prune_masks`) are applied after every update."""
    if mesh is not None:
        _not_ported("training over a device mesh")
    if quantized:
        _not_ported("the quantized gradient reduction")
    return _train_step_body(network, optimizer, extra_metrics, sentinel, prune_masks)


def _step_slice(batches, i: int):
    """Batch `i` of batches stacked on a leading [n_steps, ...] axis."""
    return {
        name: SeqTensor(
            t.data[i],
            None if t.lengths is None else t.lengths[i],
            None if t.sub_lengths is None else t.sub_lengths[i],
        )
        for name, t in batches.items()
    }


def make_multi_train_step(
    network: CompiledNetwork,
    optimizer: Optimizer,
    n_steps: int,
    mesh=None,
    extra_metrics: Optional[MetricsFn] = None,
    prune_masks=None,
    sentinel: Optional[bool] = None,
):
    """``n_steps`` train steps in one call over batches stacked on a leading
    [n_steps, ...] axis: ``(params, state, opt_state, batches, rng=None) ->
    (params, state, opt_state, last step's metrics)``.  Step i's seed is the
    i-th draw of a generator seeded with `rng`.  With the sentinel on, each
    step skips on its own, and the metrics fold the call: ``health`` is the
    minimum over the steps and ``skipped_steps`` counts the skipped ones."""
    step = make_train_step(network, optimizer, mesh, extra_metrics, prune_masks, sentinel)

    def multi(params, state, opt_state, batches, rng: Optional[int] = None):
        gen = None if rng is None else torch.Generator().manual_seed(int(rng))
        history = []
        for i in range(n_steps):
            seed = None if gen is None else draw_seed(gen)
            params, state, opt_state, m = step(
                params, state, opt_state, _step_slice(batches, i), seed)
            history.append(m)
        out = dict(history[-1])
        if "health" in out:
            health = torch.stack([m["health"] for m in history])
            out["health"] = health.min()
            out["skipped_steps"] = (1.0 - health).sum()
        return params, state, opt_state, out

    return multi


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
