"""Device choice for the port's entry points: the card unless the caller asks
for the CPU.  There is no silent fallback — asking for CUDA (explicitly or
by default) on a machine without it raises."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

_default_device = "cuda"


def set_default_device(device: Union[str, torch.device]) -> None:
    global _default_device
    _default_device = str(resolve_device(device))


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device(device if device is not None else _default_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array (or a tensor) as a float32 tensor on `device`; to the
    card through pinned memory, without a host sync."""
    if torch.is_tensor(a):
        return a.to(device, torch.float32)
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def tree_to(tree, device: torch.device):
    """A tree of tensors (parameters or layer state, nested to any depth)
    with every tensor on `device`."""
    from paddle_tpu_torch.utils.tree import map_leaves

    return map_leaves(lambda v: v.to(device), tree)
