"""The training loop — the ``paddle.v2.trainer.SGD`` surface, the
counterpart of ``paddle_tpu/trainer/sgd.py`` over the eager train step::

    trainer = paddle.trainer.SGD(cost, parameters, paddle.optimizer.Adam(1e-3))
    trainer.train(paddle.batch(reader, 8), num_passes=2, event_handler=...,
                  feeding={...}, save_dir="out")

It runs on the card unless the caller passes ``device="cpu"`` (and raises
without one).  The parameters are updated in place; the layer state (batch
norm's moving statistics) is carried from step to step and written back to
``parameters.state`` (with the optimizer state) before every ``EndPass``, so
``test``, a tar saved or an ``Inference`` built in an ``EndPass`` handler
see the trained values.  Each step draws its seed (dropout) from the
trainer's generator, seeded with ``seed + 1``.  ``evaluators=`` adds
evaluator results to ``EndIteration``, ``EndPass`` and ``test``.

Saving: ``save_dir`` writes ``pass-%05d/`` (``params.tar`` and one v1 file
per parameter) every ``saving_period`` passes and, with
``saving_period_by_batches``, every that many batches; ``save_pass`` /
``load_pass`` do it by hand.  ``save_checkpoint`` / ``restore_checkpoint``
write and read the full training state (parameters, layer state,
optimizer state, the generator and the step count) through a
``checkpoint.CheckpointManager``.

A ``HookAttr("pruning", r)`` on a layer's ParamAttr builds static pruning
masks from the initial parameters, applied to them at construction and
after every update, as the JAX package's ``SGD`` does.
``show_parameter_stats_period`` logs per-parameter statistics.

Not ported yet: ``checkpoint_dir``/``resume`` (the recovery plane with
rollback and preemption), the device-resident pass cache, the
ahead-of-time executable cache, asynchronous feeding
(``async_load_data=True`` raises), elastic training and device meshes.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import event as v2_event
from paddle_tpu_torch.core.batch import DEFAULT_LADDER
from paddle_tpu_torch.core.compiler import CompiledNetwork
from paddle_tpu_torch.core.device import resolve_device, tree_to
from paddle_tpu_torch.core.topology import LayerOutput, Topology
from paddle_tpu_torch.optimizer import Optimizer
from paddle_tpu_torch.parameters import create_from_network
from paddle_tpu_torch.reader.feeder import DataFeeder, feed_dtypes_of
from paddle_tpu_torch.trainer.evaluators import default_metrics_fn
from paddle_tpu_torch.trainer.step import (
    apply_prune_masks,
    build_prune_masks,
    draw_seed,
    make_eval_step,
    make_train_step,
)
from paddle_tpu_torch.utils import flags as _flags

_log = logging.getLogger("paddle_tpu_torch.trainer")


def _batch_rows(batch) -> int:
    """Sample count of a fed batch (any slot's leading dim): costs and
    metrics average over batches weighted by it."""
    for t in batch.values():
        return int(t.data.shape[0])
    return 1


def _no_async_feed(async_load_data: bool) -> None:
    if async_load_data:
        raise NotImplementedError(
            "async_load_data=True (feeding on a prefetch thread) is not ported "
            "yet (ROADMAP Queue 1 item 5); the port feeds inline")


class SGD:
    """paddle.v2.trainer.SGD(cost, parameters, update_equation, ...).

    ``parameters`` may come from ``parameters.create``, be a network-less
    tree from ``parameters.from_numpy``, which the trainer adopts, or a
    topology-free ``DetachedParameters`` from ``Parameters.from_tar(f)``,
    merged by name into parameters built for this topology; None creates
    them from `seed`.  ``is_local`` is accepted for the reference's surface
    and ignored, as the JAX package ignores it: training is always local."""

    def __init__(
        self,
        cost,
        parameters=None,
        update_equation: Optional[Optimizer] = None,
        extra_layers: Optional[Sequence[LayerOutput]] = None,
        is_local: bool = True,
        seed: int = 0,
        evaluators: Optional[Sequence] = None,
        device=None,
    ):
        if update_equation is None:
            raise ValueError("update_equation (an Optimizer) is required")
        self.device = resolve_device(device)
        self.evaluators = list(evaluators or [])
        self._seed = seed
        if isinstance(cost, Topology):
            outputs: List[LayerOutput] = list(cost.outputs)
        elif isinstance(cost, LayerOutput):
            outputs = [cost]
        else:
            outputs = list(cost)
        outputs += list(extra_layers or ())
        for ev in self.evaluators:
            outputs += list(ev.layers)
        self.topology = Topology(outputs)
        self.network = CompiledNetwork(self.topology)
        if parameters is not None and not hasattr(parameters, "network"):
            detached = parameters
            parameters = create_from_network(self.network, seed, self.device)
            detached.merge_into(parameters)
        if parameters is None:
            parameters = create_from_network(self.network, seed, self.device)
        stale = [n for n in parameters.params if n not in self.topology.layers]
        if stale:
            raise ValueError(
                f"parameters were created for a different topology: param "
                f"layers {stale} do not exist in this trainer's network"
            )
        if parameters.network is None:
            parameters.network = self.network
        parameters.params = tree_to(parameters.params, self.device)
        parameters.state = tree_to(parameters.state, self.device)
        self.parameters = parameters
        self.optimizer = update_equation
        self._metrics_fn = self._build_metrics_fn()
        # static pruning hooks: masks from the initial magnitudes, applied to
        # the initial values and after every update (StaticPruningHook)
        self._prune_masks = build_prune_masks(self.network, self.parameters.params)
        apply_prune_masks(self.parameters.params, self._prune_masks)
        self._train_step = make_train_step(
            self.network, self.optimizer, extra_metrics=self._metrics_fn,
            prune_masks=self._prune_masks,
        )
        self._eval_step = make_eval_step(self.network, extra_metrics=self._metrics_fn)
        self._opt_state = self.optimizer.init(self.parameters.params)
        self._rng = torch.Generator().manual_seed(seed + 1)
        self._step_count = 0

    # ------------------------------------------------------------------
    def _build_metrics_fn(self):
        default = default_metrics_fn(self.topology)
        if not self.evaluators:
            return default
        from paddle_tpu_torch.evaluator import combined_update

        ev_update = combined_update(self.evaluators)

        def metrics(outs):
            m = default(outs) if default else {}
            m.update(ev_update(outs))
            return m

        return metrics

    @staticmethod
    def _split_metrics(metrics):
        """(scalar metrics, evaluator accumulators as host arrays) of a step's
        metrics."""
        scalars, accums = {}, {}
        for k, v in metrics.items():
            if k.startswith("ev:"):
                accums[k] = v.detach().cpu().numpy()
            elif k != "cost":
                scalars[k] = float(v)
        return scalars, accums

    def _finalize(self, accums):
        from paddle_tpu_torch.evaluator import finalize_all

        return finalize_all(self.evaluators, accums) if self.evaluators else {}

    def _make_feeder(self, feeding) -> DataFeeder:
        """Under the ``use_bucketing`` flag, sequence slots pad to the shape
        ladder: the rung ``reader.bucketing.token_budget_batch`` packed each
        batch for."""
        return DataFeeder(
            self.topology.data_types(), feeding,
            feed_dtypes=feed_dtypes_of(self.topology), device=self.device,
            ladder=DEFAULT_LADDER if _flags.get_flag("use_bucketing") else None,
        )

    def train(
        self,
        reader: Callable,
        num_passes: int = 1,
        event_handler: Optional[Callable] = None,
        feeding=None,
        save_dir: Optional[str] = None,
        saving_period: Optional[int] = None,
        saving_period_by_batches: Optional[int] = None,
        start_pass: int = 0,
        show_parameter_stats_period: Optional[int] = None,
        async_load_data: bool = False,
        checkpoint_dir: Optional[str] = None,
        checkpoint_period_batches: Optional[int] = None,
        resume: bool = False,
    ) -> None:
        """One train step per minibatch of `reader`, for `num_passes`
        passes numbered from `start_pass`, with the BeginPass /
        BeginIteration / EndIteration(cost, metrics) / EndPass(mean_cost,
        evaluators) events.  A step the divergence sentinel skipped still
        reports its (non-finite) cost in EndIteration, and counts in no pass
        mean.  With `save_dir`, pass-%05d is written every `saving_period`
        passes (None: the flag) and every `saving_period_by_batches`
        batches (the reference trainer's cadence).  Every
        `show_parameter_stats_period` steps (None: the flag; 0: off) the
        per-parameter statistics are logged.  Feeding runs inline:
        ``async_load_data=True`` (a prefetch thread) is not ported yet and
        raises."""
        _no_async_feed(async_load_data)
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint_dir (periodic full-state checkpoints with rollback, "
                "preemption and resume) is not ported yet (ROADMAP Queue 1 item 8); "
                "checkpoint with save_checkpoint / restore_checkpoint")
        if resume:
            raise ValueError("resume=True requires checkpoint_dir")
        if event_handler is None:
            event_handler = lambda e: None
        if saving_period is None:
            saving_period = _flags.get_flag("saving_period")
        log_period = _flags.get_flag("log_period")
        if show_parameter_stats_period is None:  # an explicit 0 disables too
            show_parameter_stats_period = _flags.get_flag("show_parameter_stats_period")
        feeder = self._make_feeder(feeding)
        params, state, opt_state = (
            self.parameters.params, self.parameters.state, self._opt_state
        )
        for pass_id in range(start_pass, start_pass + num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            if "pass" in opt_state:
                opt_state["pass"] = pass_id  # the pass_manual schedule reads it
            costs: List[float] = []
            weights: List[int] = []
            pass_accums: Dict[str, np.ndarray] = {}
            for batch_id, data in enumerate(reader()):
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                batch = feeder(data)
                params, state, opt_state, metrics = self._train_step(
                    params, state, opt_state, batch, draw_seed(self._rng)
                )
                self._step_count += 1
                health = metrics.pop("health", None)
                metrics.pop("grad_norm", None)
                cost = float(metrics["cost"])
                if log_period and self._step_count % log_period == 0:
                    _log.info("pass %d batch %d cost %.6f", pass_id, batch_id, cost)
                if (show_parameter_stats_period
                        and self._step_count % show_parameter_stats_period == 0):
                    # reference TrainerInternal.cpp:83-110 per-parameter stats
                    from paddle_tpu_torch.utils.debug import (
                        format_parameter_stats,
                        parameter_stats,
                    )

                    _log.info("parameter stats @ step %d:\n%s", self._step_count,
                              format_parameter_stats(parameter_stats(params)))
                evaluator: Dict[str, float] = {}
                if health is None or float(health) >= 0.5:
                    costs.append(cost)
                    weights.append(_batch_rows(batch))
                    evaluator, accums = self._split_metrics(metrics)
                    for k, v in accums.items():
                        pass_accums[k] = pass_accums.get(k, 0) + v
                    evaluator.update(self._finalize(accums))
                else:
                    _log.warning("sentinel: non-finite step skipped (pass %d batch %d)",
                                 pass_id, batch_id)
                event_handler(v2_event.EndIteration(pass_id, batch_id, cost, evaluator))
                if (save_dir and saving_period_by_batches
                        and (batch_id + 1) % saving_period_by_batches == 0):
                    self.parameters.params, self.parameters.state = params, state
                    self._opt_state = opt_state
                    self.save_pass(save_dir, pass_id, batch_id=batch_id + 1)
            # the latest values, so that test, tar saving and checkpoints in
            # an EndPass handler see them
            self.parameters.params, self.parameters.state = params, state
            self._opt_state = opt_state
            # per-sample mean: each batch weighs by its row count
            pass_metrics = {
                "mean_cost": float(np.average(costs, weights=weights)) if costs else 0.0
            }
            pass_metrics.update(self._finalize(pass_accums))
            event_handler(v2_event.EndPass(pass_id, pass_metrics))
            if save_dir and (pass_id + 1 - start_pass) % saving_period == 0:
                self.save_pass(save_dir, pass_id)

    def test(self, reader: Callable, feeding=None,
             async_load_data: bool = False) -> v2_event.TestResult:
        """Cost and metrics over `reader`, averaged per sample, with the
        layer state as global statistics; evaluators finalize over the
        whole reader.  ``async_load_data=True`` raises (not ported yet)."""
        _no_async_feed(async_load_data)
        feeder = self._make_feeder(feeding)
        costs: List[float] = []
        weights: List[int] = []
        sums: Dict[str, float] = {}
        accum_sums: Dict[str, np.ndarray] = {}
        for data in reader():
            batch = feeder(data)
            metrics = self._eval_step(self.parameters.params, self.parameters.state, batch)
            rows = _batch_rows(batch)
            costs.append(float(metrics["cost"]))
            weights.append(rows)
            scalars, accums = self._split_metrics(metrics)
            for k, v in scalars.items():
                sums[k] = sums.get(k, 0.0) + v * rows
            for k, v in accums.items():
                accum_sums[k] = accum_sums.get(k, 0) + v
        n = max(sum(weights), 1)
        avg = {k: v / n for k, v in sums.items()}
        avg.update(self._finalize(accum_sums))
        return v2_event.TestResult(
            avg, float(np.average(costs, weights=weights)) if costs else 0.0,
        )

    # -- parameter saving -------------------------------------------------
    def save_parameter_to_tar(self, f) -> None:
        self.parameters.to_tar(f)

    def save_pass(self, save_dir: str, pass_id: int, batch_id: Optional[int] = None) -> str:
        """Write pass-%05d/ (with a -batch-%d suffix for a batch save) holding
        params.tar and one v1 binary file per parameter, as the reference
        trainer's pass dirs."""
        from paddle_tpu_torch import checkpoint as ckpt

        name = f"pass-{pass_id:05d}"
        if batch_id is not None:
            name += f"-batch-{batch_id}"
        d = os.path.join(save_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "params.tar"), "wb") as f:
            self.parameters.to_tar(f)
        ckpt.save_parameter_dir(self.parameters, d)
        return d

    def load_pass(self, save_dir: str, pass_id: int) -> None:
        """Load parameter values from a pass dir (reference --init_model_path
        with --start_pass)."""
        from paddle_tpu_torch import checkpoint as ckpt

        ckpt.load_parameter_dir(self.parameters, os.path.join(save_dir, f"pass-{pass_id:05d}"))

    # -- full-state checkpoints -------------------------------------------
    def _rng_key(self) -> np.ndarray:
        """The leaf the JAX package keeps its PRNG key in ([2] uint32),
        derived from this trainer's seed and step count so that the JAX
        package accepts the file; the port's own generator state rides the
        checkpoint's extra dict."""
        return np.array([self._step_count & 0xFFFFFFFF, (self._seed + 1) & 0xFFFFFFFF],
                        np.uint32)

    def _full_state(self) -> Dict[str, Any]:
        return {
            "params": self.parameters.params,
            "state": self.parameters.state,
            "opt_state": self._opt_state,
            "rng": self._rng_key(),
        }

    def save_checkpoint(self, manager, step: Optional[int] = None, async_: bool = False,
                        extra: Optional[Dict[str, Any]] = None) -> None:
        """Write parameters, layer state, optimizer state and counters
        through a ``checkpoint.CheckpointManager``; `extra` merges into the
        step's extra dict."""
        manager.save(
            step if step is not None else self._step_count,
            self._full_state(),
            extra={"step_count": self._step_count,
                   "torch_rng": self._rng.get_state().numpy().tobytes().hex(),
                   **(extra or {})},
            async_=async_,
        )

    def _apply_restored(self, tree, extra) -> None:
        self.parameters.params = tree["params"]
        self.parameters.state = tree["state"]
        self._opt_state = tree["opt_state"]
        if "torch_rng" in extra:
            self._rng.set_state(torch.frombuffer(
                bytearray(bytes.fromhex(extra["torch_rng"])), dtype=torch.uint8))
        else:
            # a JAX package checkpoint: seed the generator from its key
            key = [int(x) for x in np.asarray(tree["rng"]).reshape(-1)]
            self._rng.manual_seed((key[0] << 32 | key[-1]) & 0x7FFFFFFFFFFFFFFF)
        self._step_count = int(extra.get("step_count", self._step_count))

    def restore_checkpoint(self, manager, step: Optional[int] = None) -> bool:
        """Restore the latest restorable (or the given) checkpoint; False
        when the directory holds none."""
        if step is None:
            restored = manager.restore_latest(self._full_state())
            if restored is None:
                return False
            _, tree, extra = restored
        else:
            tree, extra = manager.restore(step, self._full_state())
        self._apply_restored(tree, extra)
        return True
