"""paddle.infer / Inference — the counterpart of ``paddle_tpu/inference.py``.

The same batch ladder, chunking and unpadding as the JAX package: a batch
pads its sequence slots to a ladder rung and its batch axis to a
DEFAULT_BATCH_LADDER rung, runs the network's forward under
``torch.inference_mode()``, and sequence outputs are unpadded back to the
reference's concatenated valid rows.  The parameters may be a
``Parameters``, a bare ``{layer: {key: tensor}}`` tree or the topology-free
``DetachedParameters`` of ``Parameters.from_tar(f)``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.core.batch import (
    DEFAULT_BATCH_LADDER,
    DEFAULT_LADDER,
    SeqTensor,
    host_lengths,
    ladder_len,
    pad_batch_rows,
    slice_batch_rows,
)
from paddle_tpu_torch.core.compiler import CompiledNetwork, get_default_compute_dtype
from paddle_tpu_torch.core.device import resolve_device, tree_to
from paddle_tpu_torch.core.topology import LayerOutput, Topology

__all__ = ["infer", "Inference"]


def _extract_field(out: SeqTensor, field: str) -> np.ndarray:
    """'value' (activations / scores) or 'id' (integer outputs); sequence
    outputs are unpadded to the concatenated valid rows, nested outputs over
    both levels.  Floating outputs come back as float32 (numpy has no
    bfloat16)."""
    data = out.data.detach()
    if data.is_floating_point():
        data = data.float()
    data = data.cpu().numpy()
    if field == "id":
        data = data.astype(np.int64)
    if not out.is_seq:
        return data
    lengths = host_lengths(out.lengths)
    rows: List[np.ndarray] = []
    if out.is_nested:
        sub_lengths = host_lengths(out.sub_lengths)
        for i in range(data.shape[0]):
            for j in range(int(lengths[i])):
                rows.append(data[i, j, : int(sub_lengths[i, j])])
    else:
        rows = [data[i, : int(lengths[i])] for i in range(data.shape[0])]
    return np.concatenate(rows, axis=0) if rows else data[:0].reshape(0, *data.shape[2:])


class Inference:
    """Inference over one or more output layers, on `device` (the card
    unless the caller asks for the CPU)::

        inferer = Inference(output_layer=prediction, parameters=parameters)
        probs = inferer.infer(input=samples)
    """

    def __init__(
        self,
        output_layer: Union[LayerOutput, Sequence[LayerOutput]],
        parameters,
        device=None,
    ):
        outs = list(output_layer) if isinstance(output_layer, (list, tuple)) else [output_layer]
        self.device = resolve_device(device)
        self.output_names = [o.name for o in outs]
        self.topology = Topology(outs)
        self.network = CompiledNetwork(self.topology, compute_dtype=get_default_compute_dtype())
        if not hasattr(parameters, "network") and hasattr(parameters, "merge_into"):
            # a topology-free bag from the static Parameters.from_tar(f):
            # parameters for this topology, merged by name
            from paddle_tpu_torch.parameters import create_from_network

            detached = parameters
            parameters = create_from_network(self.network, seed=0, device=self.device)
            detached.merge_into(parameters)
        # parameters may come from a larger (training) topology: apply()
        # looks layers up by name, so the superset carries unused entries,
        # and a parameter shared by name moves to this topology's owner
        tree = getattr(parameters, "params", parameters)
        source = getattr(parameters, "network", None)
        if source is not None and source is not self.network:
            tree = self.network.adopt_named(tree, source)
        self._params = tree_to(tree, self.device)
        # layer state (batch norm's moving statistics) serves as the global
        # statistics of inference
        self._state = tree_to(getattr(parameters, "state", None) or {}, self.device)

    def _fwd(self, batch):
        all_outs, _ = self.network.apply(self._params, batch, state=self._state, train=False)
        keep = set(self.output_names)
        return {n: v for n, v in all_outs.items() if n in keep or n.split("@")[0] in keep}

    def iter_infer(self, input: Sequence[Any], feeding=None, batch_size: Optional[int] = None):
        from paddle_tpu_torch.reader.feeder import DataFeeder, feed_dtypes_of

        if not len(input):
            raise ValueError("infer() needs at least one input sample")
        feeder = DataFeeder(
            self.topology.data_types(), feeding,
            feed_dtypes=feed_dtypes_of(self.topology),
            ladder=DEFAULT_LADDER,
            device=self.device,
        )
        # chunk at the top batch rung: full rungs plus one padded remainder
        bs = min(batch_size or len(input), DEFAULT_BATCH_LADDER[-1])
        with torch.inference_mode():
            for lo in range(0, len(input), bs):
                rows = list(input[lo : lo + bs])
                batch = pad_batch_rows(feeder(rows), ladder_len(len(rows), DEFAULT_BATCH_LADDER))
                yield slice_batch_rows(self._fwd(batch), len(rows))

    def iter_infer_field(self, field, **kwargs):
        fields = list(field) if isinstance(field, (list, tuple)) else [field]
        for result in self.iter_infer(**kwargs):
            yield [
                _extract_field(result[name], f)
                for name in self.output_names
                for f in fields
            ]

    def infer(
        self,
        input: Sequence[Any],
        field: Union[str, Sequence[str]] = "value",
        feeding=None,
        batch_size: Optional[int] = None,
    ):
        """One ndarray per (output layer × field), concatenated over
        batches; a single array when there is exactly one."""
        collected: Optional[List[List[np.ndarray]]] = None
        for res in self.iter_infer_field(
            field=field, input=input, feeding=feeding, batch_size=batch_size
        ):
            if collected is None:
                collected = [[] for _ in res]
            for i, item in enumerate(res):
                collected[i].append(item)
        merged = [np.concatenate(c, axis=0) for c in collected]
        return merged[0] if len(merged) == 1 else merged


def infer(output_layer, parameters, input, feeding=None, field="value",
          batch_size: Optional[int] = None, device=None):
    """One-shot inference (reference paddle.infer)."""
    return Inference(output_layer, parameters, device=device).infer(
        input=input, field=field, feeding=feeding, batch_size=batch_size
    )
