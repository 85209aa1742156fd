"""Parameter initialisation on a ``torch.Generator`` — the counterpart of
``paddle_tpu/core/initializers.py`` (gaussian, default std 1/sqrt(fan_in);
``conv_normal`` for HWIO conv kernels).

Values are drawn on the CPU generator and then moved to ``device``, so one
seed gives the same parameters on every device.  They differ from the JAX
package's draws: parity tests carry parameters over instead."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def default_std(fan_in: int) -> float:
    return 1.0 / math.sqrt(max(fan_in, 1))


def normal(gen: torch.Generator, shape: Sequence[int], std: Optional[float] = None,
           device="cpu", dtype=torch.float32) -> torch.Tensor:
    if std is None:
        fan_in = shape[0] if len(shape) >= 2 else shape[-1]
        std = default_std(int(fan_in))
    x = torch.randn(tuple(shape), generator=gen, dtype=dtype) * std
    return x.to(device)


def zeros(shape: Sequence[int], device="cpu", dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones(shape: Sequence[int], device="cpu", dtype=torch.float32) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def conv_normal(gen: torch.Generator, shape: Sequence[int], device="cpu",
                dtype=torch.float32) -> torch.Tensor:
    """For conv kernels laid out [kh, kw, cin, cout]: std over the receptive
    field kh * kw * cin."""
    kh, kw, cin, _ = shape
    return normal(gen, shape, default_std(kh * kw * cin), device, dtype)
