"""Metrics computed beside the train and eval steps — the counterpart of
``paddle_tpu/trainer/evaluators.py``: the classification error of each
classification cost in the topology, masked over sequences, averaged over
batches by the trainer."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.core.topology import Topology

_CLS_COST_TYPES = {"softmax_with_cost", "cross_entropy"}


def default_metrics_fn(topology: Topology) -> Optional[Callable]:
    """An ``extra_metrics`` function emitting ``classification_error``
    (argmax(pred) != label) for the classification costs of `topology`, or
    None when it has none."""
    cls = [conf for conf in topology.layers.values() if conf.type in _CLS_COST_TYPES]
    if not cls:
        return None

    @torch.no_grad()
    def metrics(outs: Dict[str, SeqTensor]) -> Dict[str, torch.Tensor]:
        m: Dict[str, torch.Tensor] = {}
        for conf in cls:
            pred_name, label_name = conf.inputs[0], conf.inputs[1]
            pred, label = outs[pred_name], outs[label_name]
            ids = label.data.to(torch.int64)
            if ids.dim() >= 2 and ids.shape[-1] == 1:
                ids = ids[..., 0]
            # argmax(softmax(x)) == argmax(x): read the pre-activation when
            # the producer exposed it
            lg = outs.get(pred_name + "@logits")
            scores = lg.data if lg is not None else pred.data
            err = (torch.argmax(scores, dim=-1) != ids).float()
            if pred.is_seq and err.dim() == 2:
                mask = pred.mask()
                err = (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)
            else:
                err = err.mean()
            key = "classification_error" if len(cls) == 1 else f"classification_error/{conf.name}"
            m[key] = err
        return m

    return metrics
