"""NetOp — the sequential op container (reference:
paddle/operators/net_op.h, which interprets the list, op->Run per op); the
counterpart of ``paddle_tpu/framework/net.py``.  PyTorch runs eagerly, so
``lower()`` is one callable that runs the ops in order, one torch call per
op: where the JAX package's ``jax.jit`` fuses across op boundaries, nothing
is fused here."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from paddle_tpu_torch.framework.op import Operator, create_op, run_on_scope


class NetOp:
    """add_op(...) ops in order; complete_add_op() computes the net's
    external inputs/outputs by dataflow (reference net_op.cc
    CompleteAddOp dedup of in/out)."""

    type = "plain_net"

    def __init__(self, ops: Optional[Sequence[Operator]] = None):
        self.ops: List[Operator] = list(ops or [])
        self._complete = False
        self.external_inputs: List[str] = []
        self.external_outputs: List[str] = []

    def add_op(self, op) -> "NetOp":
        if self._complete:
            raise RuntimeError("cannot add_op after complete_add_op")
        self.ops.append(op)
        return self

    def complete_add_op(self) -> "NetOp":
        produced: List[str] = []
        needed: List[str] = []
        for op in self.ops:
            for n in op.input_names():
                if n not in produced and n not in needed:
                    needed.append(n)
            for n in op.output_names():
                if n not in produced:
                    produced.append(n)
        self.external_inputs = needed
        self.external_outputs = produced
        self._complete = True
        return self

    # -- introspection ---------------------------------------------------
    def input_names(self) -> List[str]:
        if not self._complete:
            self.complete_add_op()
        return list(self.external_inputs)

    def output_names(self) -> List[str]:
        if not self._complete:
            self.complete_add_op()
        return list(self.external_outputs)

    def infer_shape(self, scope) -> None:
        for op in self.ops:
            op.infer_shape(scope)

    # -- execution -------------------------------------------------------
    def trace(self, values: Dict[str, Any]) -> Dict[str, Any]:
        for op in self.ops:
            values = op.trace(values)
        return values

    def lower(self):
        """fn(*external_input_tensors) -> tuple(external_outputs): the ops
        run in order, each one eager torch call."""
        in_names = self.input_names()
        out_names = self.output_names()

        def fn(*tensors):
            values = self.trace(dict(zip(in_names, tensors)))
            return tuple(values[n] for n in out_names)

        return fn

    def run(self, scope) -> None:
        """Execute against a scope; the values stay on its device."""
        run_on_scope(self, scope)

    def __repr__(self) -> str:  # pragma: no cover
        body = "\n  ".join(repr(op) for op in self.ops)
        return f"NetOp[\n  {body}\n]"


def fc_net(x: str, w: str, b: Optional[str], out: str, *, hidden: str = None) -> NetOp:
    """The fc composite op (reference paddle/operators/fc_op.cc builds
    mul + rowwise_add + sigmoid via NetOp)."""
    hidden = hidden or out + "@mul"
    net = NetOp()
    net.add_op(create_op("mul", X=x, Y=w, Out=hidden))
    if b is not None:
        added = out + "@add"
        net.add_op(create_op("rowwise_add", X=hidden, b=b, Out=added))
        hidden = added
    net.add_op(create_op("sigmoid", X=hidden, Y=out))
    net.complete_add_op()
    return net
