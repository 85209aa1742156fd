"""RecurrentOp — the op framework's RNN container (reference:
paddle/operators/recurrent_op.cc/h + rnn/ helpers: segments each inlink
along time, keeps a vector of per-step Scopes, and links memories
pre_state<->state); the counterpart of ``paddle_tpu/framework/recurrent.py``.

There are no per-step scopes: the step net's trace runs once per time step
in a Python loop over the time-major inlinks (the JAX package's
``lax.scan``), the memories are the loop's carry, and the outlinks stack to
[T, ...] tensors.  Autograd differentiates through the loop, so
``Backward(RecurrentOp)`` works as ``jax.vjp`` does through the scan."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from paddle_tpu_torch.framework.net import NetOp
from paddle_tpu_torch.framework.op import run_on_scope


class RecurrentOp:
    """inlinks: scope var -> step var ([T, ...] sliced per step);
    memories: (pre_state, state, boot_var) triples;
    outlinks: step vars stacked back to [T, ...]."""

    type = "recurrent_op"

    def __init__(
        self,
        step_net: NetOp,
        inlinks: Dict[str, str],
        outlinks: Sequence[str],
        memories: Sequence[Tuple[str, str, str]] = (),
    ):
        self.step_net = step_net
        self.inlinks = dict(inlinks)
        self.outlinks = list(outlinks)
        self.memories = list(memories)
        pre_names = {pre for pre, _, _ in memories}
        self.static_inputs = [
            n
            for n in step_net.input_names()
            if n not in set(self.inlinks.values()) and n not in pre_names
        ]

    def input_names(self) -> List[str]:
        return (
            list(self.inlinks.keys())
            + [boot for _, _, boot in self.memories]
            + self.static_inputs
        )

    def output_names(self) -> List[str]:
        return list(self.outlinks)

    def trace(self, values: Dict[str, Any]) -> Dict[str, Any]:
        static_vals = {n: values[n] for n in self.static_inputs}
        carry = {state: values[boot_name] for _, state, boot_name in self.memories}
        xs = {step_var: values[v] for v, step_var in self.inlinks.items()}
        steps = next(iter(xs.values())).shape[0]
        outs: Dict[str, List[torch.Tensor]] = {o: [] for o in self.outlinks}
        for t in range(steps):
            step_values = dict(static_vals)
            step_values.update({k: x[t] for k, x in xs.items()})
            for pre, state, _ in self.memories:
                step_values[pre] = carry[state]
            step_values = self.step_net.trace(step_values)
            carry = {state: step_values[state] for _, state, _ in self.memories}
            for o in self.outlinks:
                outs[o].append(step_values[o])
        new_values = dict(values)
        for o in self.outlinks:
            new_values[o] = torch.stack(outs[o])
        return new_values

    def run(self, scope) -> None:
        run_on_scope(self, scope)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"RecurrentOp(inlinks={self.inlinks}, outlinks={self.outlinks}, "
            f"memories={self.memories})"
        )
