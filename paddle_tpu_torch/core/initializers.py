"""Parameter initialisation on a ``torch.Generator`` — the counterpart of
``paddle_tpu/core/initializers.py`` (gaussian, default std 1/sqrt(fan_in);
uniform; ``conv_normal`` for HWIO conv kernels).

Values are drawn on the CPU generator and then moved to ``device``, so one
seed gives the same parameters on every device.  They differ from the JAX
package's draws: parity tests carry parameters over instead."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def split_seeds(seed: int, n: int = 2) -> list:
    """`n` seeds drawn from a torch.Generator seeded with `seed` (where the
    JAX package splits its key)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2**31 - 1, (n,), generator=gen).tolist()


def default_std(fan_in: int) -> float:
    return 1.0 / math.sqrt(max(fan_in, 1))


def normal(gen: torch.Generator, shape: Sequence[int], std: Optional[float] = None,
           device="cpu", dtype=torch.float32) -> torch.Tensor:
    if std is None:
        fan_in = shape[0] if len(shape) >= 2 else shape[-1]
        std = default_std(int(fan_in))
    x = torch.randn(tuple(shape), generator=gen, dtype=dtype) * std
    return x.to(device)


def uniform(gen: torch.Generator, shape: Sequence[int], scale: float, device="cpu",
            dtype=torch.float32) -> torch.Tensor:
    """Uniform in [-scale, scale)."""
    x = torch.empty(tuple(shape), dtype=dtype).uniform_(-scale, scale, generator=gen)
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
