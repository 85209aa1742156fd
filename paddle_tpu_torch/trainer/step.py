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
ride the metrics.  The decision needs the host: the step fetches its cost,
its gradient norm and every metric in one copy (:func:`fetch_metrics`), the
one host sync of a step, and returns them as host tensors.

The whole-pass epoch program (:func:`make_epoch_program`) runs a cached
pass with no host read inside: its steps decide on the card, keeping each
leaf's old value where the step was unhealthy (``torch.where``), fold the
health and the cost into the carry, and hand back the stacked per-step
metrics for one fetch.

Static pruning (a ``HookAttr("pruning", r)`` on a layer's ParamAttr):
:func:`build_prune_masks` keeps the largest (1 - r) fraction of each weight
by initial magnitude, and the step masks the weights in place after every
update (reference StaticPruningHook), as the JAX package does.

Not ported yet: a device mesh (data or model parallelism, ROADMAP Queue 1
item 6) and the quantized gradient reduction (item 6).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from paddle_tpu_torch.core.batch import (
    DEFAULT_LADDER,
    SeqTensor,
    canonicalize_batch,
    set_host_lengths,
)
from paddle_tpu_torch.core.compiler import CompiledNetwork, CompileShapeCache
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


def value_and_grad(fn, params):
    """(value, aux, grads) of ``fn(leaves) -> (scalar value, aux)``, where
    `leaves` are views of `params` that share their storage and require
    grad: the graph hangs off them, so an in-place update of `params`
    afterwards writes the masters themselves.  `grads` has the tree's
    structure, zeros where `fn` does not use a leaf; `value` is detached."""
    leaves = map_leaves(lambda v: v.detach().requires_grad_(True), params)
    with torch.enable_grad():
        value, aux = fn(leaves)
        paths = list(leaf_paths(leaves))
        grads_flat = torch.autograd.grad(value, [v for _, v in paths], allow_unused=True)
    grads: Dict[str, Any] = {}
    for (path, v), g in zip(paths, grads_flat):
        set_path(grads, path, torch.zeros_like(v) if g is None else g)
    return value.detach(), aux, grads


def fetch_metrics(metrics: Metrics) -> Metrics:
    """`metrics` with every CUDA tensor replaced by its host copy, all of
    them through one device-to-host copy (one host sync however many
    metrics a step has).  Values keep their dtypes and shapes (the copy
    travels as float64, exact for every float and for integers below
    2**53); host values pass through."""
    on_card = [(k, v) for k, v in metrics.items() if torch.is_tensor(v) and v.is_cuda]
    if not on_card:
        return metrics
    flat = torch.cat([v.detach().reshape(-1).to(torch.float64) for _, v in on_card]).cpu()  # trace: allow[T101,T103] the step's one device-to-host copy, by design: every metric rides one float64 carrier (exact for f32 and for ints below 2**53)
    out = dict(metrics)
    at = 0
    for k, v in on_card:
        n = v.numel()
        out[k] = flat[at:at + n].reshape(v.shape).to(v.dtype)  # trace: allow[T101] host-side unpacking of the float64 carrier the one copy brought back
        at += n
    return out


def _tensor_leaves(tree):
    """The tensor leaves of a tree, in its leaf order (host counters and
    other plain values left out)."""
    return [v for v in tree_leaves(tree) if torch.is_tensor(v)]


def _select(ok: torch.Tensor, new, old):
    """`new`'s tree with each leaf that `old` also holds taken from `old`
    where `ok` is false."""
    if isinstance(new, dict):
        return {k: _select(ok, v, old.get(k)) if isinstance(old, dict) else v
                for k, v in new.items()}
    return new if old is None else torch.where(ok, new, old)


def _train_step_body(network: CompiledNetwork, optimizer: Optimizer, extra_metrics=None,
                     sentinel: Optional[bool] = None, prune_masks=None,
                     on_device: bool = False):
    """(params, state, opt_state, batch, rng=None) -> (params, state,
    opt_state, metrics), with the parameter and optimizer tensors updated in
    place (and masked by `prune_masks`) and the layer state replaced; `rng`
    is the step's seed (dropout).

    The sentinel's decision is made on the host by default: one fetch
    (:func:`fetch_metrics`) of the metrics, which come back as host tensors.
    `on_device` (the epoch program) reads nothing: the update runs, and
    every parameter, optimizer and state tensor then keeps its old value
    where ``health`` is 0 (a per-leaf ``torch.where``); the metrics stay on
    the device.  The optimizer's step counter is a host int, so it advances
    on a skipped step there (the trainer replays such a pass stepwise)."""
    guard = _sentinel_enabled(sentinel)

    def step(params, state, opt_state, batch, rng: Optional[int] = None):
        cost, (outs, new_state), grads = value_and_grad(
            lambda p: network.cost(p, batch, state=state, train=True, rng=rng), params)
        metrics: Metrics = {"cost": cost}
        if extra_metrics is not None:
            metrics.update(extra_metrics(outs))
        new_state = map_leaves(torch.Tensor.detach, new_state)
        if not guard:
            params, opt_state = optimizer.update(grads, opt_state, params)
            return apply_prune_masks(params, prune_masks), new_state, opt_state, metrics
        grad_norm = _global_norm(grads)
        metrics["grad_norm"] = grad_norm
        if on_device:
            ok = torch.isfinite(cost.detach().float()) & torch.isfinite(grad_norm)
            metrics["health"] = ok.float()
            with torch.no_grad():
                kept = [v.clone() for v in _tensor_leaves(params) + _tensor_leaves(opt_state)]  # trace: allow[T106] the skip must leave every leaf bit-identical and the optimizer updates in place, so the old values are kept for the step (2x the carry; ROADMAP Queue 3)
                params, opt_state = optimizer.update(grads, opt_state, params)
                params = apply_prune_masks(params, prune_masks)
                for v, old in zip(_tensor_leaves(params) + _tensor_leaves(opt_state), kept):
                    v.copy_(torch.where(ok, v, old))
                new_state = _select(ok, new_state, state or {})
            return params, new_state, opt_state, metrics
        # the one host sync of the step: the trainer reads these anyway
        metrics = fetch_metrics(metrics)
        ok = torch.isfinite(metrics["cost"].float()) & torch.isfinite(metrics["grad_norm"].float())
        healthy = bool(ok)  # trace: allow[T103] the sentinel decides on the host copy fetch_metrics brought back: no sync of its own beyond that one copy
        metrics["health"] = torch.tensor(float(healthy))
        if healthy:
            params, opt_state = optimizer.update(grads, opt_state, params)
            params = apply_prune_masks(params, prune_masks)
            state = new_state
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


def _row(x, i: int):
    """Row `i` of a stacked tensor (a view), with its host lengths."""
    if x is None:
        return None
    host = getattr(x, "_host_lengths", None)
    return x[i] if host is None else set_host_lengths(x[i], host[i])


def _step_slice(batches, i: int):
    """Batch `i` of batches stacked on a leading [n_steps, ...] axis: views,
    carrying the host copies of the lengths when the stack has them."""
    return {
        name: SeqTensor(_row(t.data, i), _row(t.lengths, i), _row(t.sub_lengths, i),
                        sparse_ids=t.sparse_ids)
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


def _carry_scalar(params, value: float) -> torch.Tensor:
    leaves = _tensor_leaves(params)
    return torch.full((), value, dtype=torch.float32,
                      device=leaves[0].device if leaves else None)


def make_train_carry(params, state, opt_state, rng: torch.Generator):
    """The carried state of the whole-pass epoch program as one tree:
    parameters, layer state, optimizer state, the generator the step seeds
    are drawn from, and the on-device folds ``health_min``, ``skipped``
    (unhealthy steps), ``cost_sum`` (of the healthy steps) and ``ok_steps``,
    0-d float32 tensors on the parameters' device."""
    return {
        "params": params,
        "state": state,
        "opt_state": opt_state,
        "rng": rng,
        "health_min": _carry_scalar(params, 1.0),
        "skipped": _carry_scalar(params, 0.0),
        "cost_sum": _carry_scalar(params, 0.0),
        "ok_steps": _carry_scalar(params, 0.0),
    }


def split_train_carry(carry):
    """(params, state, opt_state, rng) back out of an epoch-program carry."""
    return carry["params"], carry["state"], carry["opt_state"], carry["rng"]


def make_epoch_program(
    network: CompiledNetwork,
    optimizer: Optimizer,
    mesh=None,
    extra_metrics: Optional[MetricsFn] = None,
    prune_masks=None,
    sentinel: Optional[bool] = None,
):
    """A whole training pass with no host read inside: ``(carry,
    stacked_batches, perm) -> (carry, per_step_metrics)``.

    ``stacked_batches`` is the cached pass stacked on a leading [N, ...]
    axis in capture order (``PassCache.stacked``); ``perm`` is this pass's
    order, a host tensor or list (``PassCache.epoch_perm``): the loop reads
    it on the host and takes each step's batch as a view of the stack, so
    nothing is gathered or uploaded.  Step i draws its seed from the
    carry's generator exactly as ``SGD.train``'s stepwise loop draws it
    (:func:`draw_seed`), and runs the shared step body with its decision on
    the device, so parameters, metrics and the sentinel's skips match the
    stepwise path bit for bit while every step is healthy.  The carry
    folds ``health_min``, ``skipped``, ``cost_sum`` and ``ok_steps`` on the
    device; the per-step metrics come back stacked [N, ...] on the device
    for one fetch (:func:`fetch_metrics`).  No ``torch.compile`` and no CUDA
    graph: the program is the same eager step, without its host sync."""
    if mesh is not None:
        _not_ported("the epoch program over a device mesh")
    step = _train_step_body(network, optimizer, extra_metrics, sentinel, prune_masks,
                            on_device=True)

    def epoch(carry, batches, perm):
        order = perm.tolist() if torch.is_tensor(perm) else [int(i) for i in perm]
        params, state, opt_state, gen = split_train_carry(carry)
        folds = {k: carry[k] for k in ("health_min", "skipped", "cost_sum", "ok_steps")}
        history = []
        for i in order:
            params, state, opt_state, m = step(
                params, state, opt_state, _step_slice(batches, i), draw_seed(gen))
            h = m.get("health")
            if h is None:
                h = torch.ones_like(folds["health_min"])
            folds["health_min"] = torch.minimum(folds["health_min"], h)
            folds["skipped"] = folds["skipped"] + (1.0 - h)
            folds["cost_sum"] = folds["cost_sum"] + torch.where(
                h >= 0.5, m["cost"].detach().float(), torch.zeros_like(h))
            folds["ok_steps"] = folds["ok_steps"] + h
            history.append(m)
        stacked = {k: torch.stack([m[k].detach() for m in history]) for k in history[0]} \
            if history else {}
        return {**make_train_carry(params, state, opt_state, gen), **folds}, stacked

    return epoch


def make_bucketed_train_step(
    network: CompiledNetwork,
    optimizer: Optimizer,
    mesh=None,
    extra_metrics: Optional[MetricsFn] = None,
    infer_param_shardings: bool = False,
    prune_masks=None,
    ladder=DEFAULT_LADDER,
    cache: Optional[CompileShapeCache] = None,
):
    """A train step that holds the bucket-shape contract where it is
    called: every batch is padded to the shape ladder
    (``core.batch.canonicalize_batch``) and counted by a
    :class:`~paddle_tpu_torch.core.compiler.CompileShapeCache`.  Returns
    ``(step, cache)``; ``step`` has :func:`make_train_step`'s signature."""
    if infer_param_shardings:
        _not_ported("parameter sharding inference over a device mesh")
    inner = make_train_step(network, optimizer, mesh, extra_metrics, prune_masks)
    if cache is None:
        cache = CompileShapeCache("train_step")

    def step(params, state, opt_state, batch, rng: Optional[int] = None):
        batch = canonicalize_batch(batch, ladder)
        cache.observe(batch)
        return inner(params, state, opt_state, batch, rng)

    return step, cache


def make_grad_step(network: CompiledNetwork, mesh=None, infer_param_shardings: bool = False):
    """``(params, state, batch, rng) -> (grads, cost)``: the gradient half of
    the train step, with no update, the unit of work of the elastic trainer
    (``trainer/elastic.py`` ``TrainerTaskModel``).  The layer-state update
    of the forward is dropped, as in the JAX package."""
    if mesh is not None or infer_param_shardings:
        _not_ported("the gradient step over a device mesh")

    def gstep(params, state, batch, rng: Optional[int] = None):
        cost, _, grads = value_and_grad(
            lambda p: network.cost(p, batch, state=state, rng=rng, train=True), params)
        return grads, cost

    return gstep


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


def make_forward_fn(network: CompiledNetwork, output_names=None):
    """An inference forward returning the selected layer outputs' data
    (``paddle/capi``'s gradient-machine forward): ``fwd(params, state,
    batch, train=False) -> {name: tensor}``, without gradients."""

    @torch.no_grad()
    def fwd(params, state, batch, train: bool = False):
        outs, _ = network.apply(params, batch, state=state, train=train)
        names = output_names or network.topology.output_names
        return {n: outs[n].data for n in names}

    return fwd
