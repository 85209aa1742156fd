"""The training loop — the ``paddle.v2.trainer.SGD`` surface, the
counterpart of ``paddle_tpu/trainer/sgd.py`` over the eager train step::

    trainer = paddle.trainer.SGD(cost, parameters, paddle.optimizer.Adam(1e-3))
    trainer.train(paddle.batch(reader, 8), num_passes=2, event_handler=...,
                  feeding={...})

It runs on the card unless the caller passes ``device="cpu"`` (and raises
without one).  The parameters are updated in place; the layer state (batch
norm's moving statistics) is carried from step to step and written back to
``parameters.state``, and ``test`` evaluates with it as global statistics.

Not ported yet: checkpoints and tar saving, the device-resident pass cache,
the ahead-of-time executable cache, asynchronous feeding, the divergence
sentinel with rollback, elastic training, evaluators beyond the default
classification error, and device meshes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch import event as v2_event
from paddle_tpu_torch.core.compiler import CompiledNetwork
from paddle_tpu_torch.core.device import resolve_device, tree_to
from paddle_tpu_torch.core.topology import LayerOutput, Topology
from paddle_tpu_torch.optimizer import Optimizer
from paddle_tpu_torch.parameters import Parameters, create_from_network
from paddle_tpu_torch.reader.feeder import DataFeeder, feed_dtypes_of
from paddle_tpu_torch.trainer.evaluators import default_metrics_fn
from paddle_tpu_torch.trainer.step import make_eval_step, make_train_step


def _batch_rows(batch) -> int:
    """Sample count of a fed batch (any slot's leading dim): costs and
    metrics average over batches weighted by it."""
    for t in batch.values():
        return int(t.data.shape[0])
    return 1


class SGD:
    """paddle.v2.trainer.SGD(cost, parameters, update_equation, ...).

    ``parameters`` may come from ``parameters.create`` or be a network-less
    tree from ``parameters.from_numpy``, which the trainer adopts; None
    creates them from `seed`."""

    def __init__(
        self,
        cost,
        parameters: Optional[Parameters] = None,
        update_equation: Optional[Optimizer] = None,
        extra_layers: Optional[Sequence[LayerOutput]] = None,
        seed: int = 0,
        device=None,
    ):
        if update_equation is None:
            raise ValueError("update_equation (an Optimizer) is required")
        self.device = resolve_device(device)
        if isinstance(cost, Topology):
            outputs: List[LayerOutput] = list(cost.outputs)
        elif isinstance(cost, LayerOutput):
            outputs = [cost]
        else:
            outputs = list(cost)
        outputs += list(extra_layers or ())
        self.topology = Topology(outputs)
        self.network = CompiledNetwork(self.topology)
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
        self._metrics_fn = default_metrics_fn(self.topology)
        self._train_step = make_train_step(
            self.network, self.optimizer, extra_metrics=self._metrics_fn
        )
        self._eval_step = make_eval_step(self.network, extra_metrics=self._metrics_fn)
        self._opt_state = self.optimizer.init(self.parameters.params)

    def _make_feeder(self, feeding) -> DataFeeder:
        return DataFeeder(
            self.topology.data_types(), feeding,
            feed_dtypes=feed_dtypes_of(self.topology), device=self.device,
        )

    def train(
        self,
        reader: Callable,
        num_passes: int = 1,
        event_handler: Optional[Callable] = None,
        feeding=None,
    ) -> None:
        """One train step per minibatch of `reader`, for `num_passes`
        passes, with the BeginPass / BeginIteration / EndIteration(cost,
        metrics) / EndPass(mean_cost) events."""
        if event_handler is None:
            event_handler = lambda e: None
        feeder = self._make_feeder(feeding)
        params, state, opt_state = (
            self.parameters.params, self.parameters.state, self._opt_state
        )
        for pass_id in range(num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            if "pass" in opt_state:
                opt_state["pass"] = pass_id  # the pass_manual schedule reads it
            costs: List[float] = []
            weights: List[int] = []
            for batch_id, data in enumerate(reader()):
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                batch = feeder(data)
                params, state, opt_state, metrics = self._train_step(
                    params, state, opt_state, batch
                )
                cost = float(metrics.pop("cost"))
                costs.append(cost)
                weights.append(_batch_rows(batch))
                evaluator = {k: float(v) for k, v in metrics.items()}
                event_handler(v2_event.EndIteration(pass_id, batch_id, cost, evaluator))
            # per-sample mean: each batch weighs by its row count
            mean_cost = float(np.average(costs, weights=weights)) if costs else 0.0
            event_handler(v2_event.EndPass(pass_id, {"mean_cost": mean_cost}))
        self.parameters.params, self.parameters.state = params, state
        self._opt_state = opt_state

    def test(self, reader: Callable, feeding=None) -> v2_event.TestResult:
        """Cost and metrics over `reader`, averaged per sample, with the
        layer state as global statistics."""
        feeder = self._make_feeder(feeding)
        costs: List[float] = []
        weights: List[int] = []
        sums: Dict[str, float] = {}
        for data in reader():
            batch = feeder(data)
            metrics = self._eval_step(self.parameters.params, self.parameters.state, batch)
            rows = _batch_rows(batch)
            costs.append(float(metrics.pop("cost")))
            weights.append(rows)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v) * rows
        n = max(sum(weights), 1)
        return v2_event.TestResult(
            {k: v / n for k, v in sums.items()},
            float(np.average(costs, weights=weights)) if costs else 0.0,
        )
