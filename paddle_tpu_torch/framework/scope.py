"""Scope/Variable — the hierarchical name->value store (reference:
paddle/framework/scope.h:36, variable.h); the counterpart of
``paddle_tpu/framework/scope.py``.

A Scope lives on a device: the card unless the caller asks for the CPU, and
a child scope inherits its parent's.  Every value is a tensor on that device:
``Variable.set`` moves a numpy array or a tensor there.  The JAX package's
``run`` methods write host numpy after every op; here values stay on the
device, so a net run op by op makes no host round trip.  Ops never mutate a
value in place: a run writes fresh tensors."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device


def as_tensor(value, device: torch.device) -> torch.Tensor:
    """`value` (numpy, a python number or a tensor) as a tensor on `device`."""
    if torch.is_tensor(value):
        return value.to(device)
    return torch.as_tensor(np.asarray(value), device=device)


def compute_value(value, device: torch.device) -> torch.Tensor:
    """`value` as an op computes on it: a tensor on `device`, float64 as
    float32.  The JAX package's runs pass every input through
    ``jnp.asarray``, which makes float64 float32 with 64-bit mode off (its
    default, and its tests' setting)."""
    t = as_tensor(value, device)
    return t.float() if t.dtype == torch.float64 else t


class Variable:
    """A named slot.  `value` is a tensor on the scope's device, or None
    until set; `shape` mirrors the reference Tensor::dims."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.device = device
        self.value: Optional[torch.Tensor] = None

    def set(self, value) -> "Variable":
        self.value = as_tensor(value, self.device)
        return self

    def get(self) -> Optional[torch.Tensor]:
        return self.value

    def set_dims(self, dims) -> "Variable":
        """Pre-allocate by shape (reference tensor.mutable_data pattern):
        float32 zeros on the scope's device."""
        self.value = torch.zeros(tuple(dims), dtype=torch.float32, device=self.device)
        return self

    @property
    def shape(self):
        return None if self.value is None else tuple(self.value.shape)


class Scope:
    """Hierarchical variable scope (reference scope.h: parent chain lookup)
    on one device: `device` (the card unless the caller asks for the CPU),
    or the parent's."""

    def __init__(self, parent: Optional["Scope"] = None, device=None):
        self.parent = parent
        self.device = parent.device if parent is not None else resolve_device(device)
        self.vars: Dict[str, Variable] = {}
        self._kids: List["Scope"] = []

    def new_var(self, name: str) -> Variable:
        if name in self.vars:
            return self.vars[name]
        v = Variable(name, self.device)
        self.vars[name] = v
        return v

    # reference naming
    var = new_var

    def find_var(self, name: str) -> Optional[Variable]:
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def get_var(self, name: str) -> Variable:
        v = self.find_var(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in scope chain")
        return v

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def local_names(self) -> List[str]:
        return sorted(self.vars)
