"""Operator + registry (reference: paddle/framework/operator.h
OperatorBase::InferShape/Run, op_registry.h:338 REGISTER_OP/OpProto); the
counterpart of ``paddle_tpu/framework/op.py``.

An op kernel is one function ``fn(*inputs, **attrs) -> output(s)`` over
torch tensors; the same function serves the card and the CPU, since torch
dispatches by the tensors' device."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from paddle_tpu_torch.framework.scope import compute_value


@dataclasses.dataclass
class OpInfo:
    type: str
    fn: Callable  # (*input_tensors, **attrs) -> tensor | tuple of tensors
    inputs: Tuple[str, ...]  # formal input slot names (OpProto)
    outputs: Tuple[str, ...]  # formal output slot names
    infer_shape: Optional[Callable] = None  # (in_shapes, attrs) -> out_shapes
    attrs: Tuple[str, ...] = ()


class OpRegistry:
    """REGISTER_OP equivalent (reference op_registry.h:338-429)."""

    _ops: Dict[str, OpInfo] = {}

    @classmethod
    def register(cls, info: OpInfo) -> None:
        if info.type in cls._ops:
            raise ValueError(f"duplicate op type {info.type!r}")
        cls._ops[info.type] = info

    @classmethod
    def get(cls, type_name: str) -> OpInfo:
        try:
            return cls._ops[type_name]
        except KeyError:
            raise KeyError(
                f"unknown op type {type_name!r}; registered: {sorted(cls._ops)}"
            ) from None

    @classmethod
    def op_types(cls) -> List[str]:
        return sorted(cls._ops)


def register_op(
    type_name: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    attrs: Sequence[str] = (),
    infer_shape: Optional[Callable] = None,
):
    """Decorator: @register_op("add", ["X", "Y"], ["Out"])."""

    def deco(fn):
        OpRegistry.register(
            OpInfo(
                type=type_name,
                fn=fn,
                inputs=tuple(inputs),
                outputs=tuple(outputs),
                infer_shape=infer_shape,
                attrs=tuple(attrs),
            )
        )
        return fn

    return deco


def run_on_scope(node, scope) -> None:
    """Run an op, a net or a recurrent op against `scope`: its inputs read
    from the scope chain as the ops compute on them (float64 as float32),
    its outputs written to the scope as tensors on its device."""
    values = {n: compute_value(scope.get_var(n).get(), scope.device) for n in node.input_names()}
    out = node.trace(values)
    for n in node.output_names():
        scope.new_var(n).set(out[n])


class Operator:
    """A bound op instance: formal slots -> scope variable names (the
    OpDesc, reference op_desc.proto), runnable against a Scope and
    traceable inside a net."""

    def __init__(
        self,
        type_name: str,
        inputs: Dict[str, Union[str, Sequence[str]]],
        outputs: Dict[str, Union[str, Sequence[str]]],
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.info = OpRegistry.get(type_name)
        self.type = type_name
        self.inputs = {k: _as_names(v) for k, v in inputs.items()}
        self.outputs = {k: _as_names(v) for k, v in outputs.items()}
        self.attrs = dict(attrs or {})
        for slot in self.info.inputs:
            if slot not in self.inputs:
                raise ValueError(f"{type_name}: missing input slot {slot!r}")
        for slot in self.info.outputs:
            if slot not in self.outputs:
                raise ValueError(f"{type_name}: missing output slot {slot!r}")

    # -- introspection (reference OperatorBase::Input/Outputs) ----------
    def input_names(self) -> List[str]:
        return [n for slot in self.info.inputs for n in self.inputs[slot]]

    def output_names(self) -> List[str]:
        return [n for slot in self.info.outputs for n in self.outputs[slot]]

    # -- shape inference (reference InferShape) -------------------------
    def infer_shape(self, scope) -> None:
        if self.info.infer_shape is None:
            return
        in_shapes = [tuple(scope.get_var(n).get().shape) for n in self.input_names()]
        out_shapes = self.info.infer_shape(in_shapes, self.attrs)
        for name, shp in zip(self.output_names(), out_shapes):
            scope.new_var(name).set_dims(shp)

    # -- tracing / execution -------------------------------------------
    def trace(self, values: Dict[str, Any]) -> Dict[str, Any]:
        """Apply the kernel on a name->tensor dict; returns the dict
        updated with this op's outputs."""
        args = [values[n] for n in self.input_names()]
        result = self.info.fn(*args, **self.attrs)
        outs = result if isinstance(result, tuple) else (result,)
        names = self.output_names()
        if len(outs) != len(names):
            raise ValueError(
                f"{self.type}: kernel returned {len(outs)} outputs, "
                f"desc names {len(names)}"
            )
        new_values = dict(values)
        for n, o in zip(names, outs):
            new_values[n] = o
        return new_values

    def run(self, scope) -> None:
        """Execute against a scope (for op-at-a-time use; a NetOp runs a
        whole op list)."""
        run_on_scope(self, scope)

    def __repr__(self) -> str:  # pragma: no cover
        ins = ", ".join(self.input_names())
        outs = ", ".join(self.output_names())
        return f"Op({self.type}: {ins} -> {outs})"


def _as_names(v) -> List[str]:
    return [v] if isinstance(v, str) else list(v)


def create_op(type_name: str, **kwargs) -> Operator:
    """Convenience mirroring v2/framework create_op_creation_methods:
    create_op("add", X="x", Y="y", Out="out", attr=...)."""
    info = OpRegistry.get(type_name)
    inputs = {k: kwargs[k] for k in info.inputs}
    outputs = {k: kwargs[k] for k in info.outputs}
    attrs = {k: kwargs[k] for k in info.attrs if k in kwargs}
    return Operator(type_name, inputs, outputs, attrs)
