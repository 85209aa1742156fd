"""Op helpers shared by the layer impls — the counterpart of
``paddle_tpu/ops/__init__.py``.

``acc_matmul``/``acc_einsum`` are the one spelling of a GEMM under mixed
precision: sub-f32 operands contract with an f32 accumulator and round ONCE
to the compute dtype.  PyTorch's bf16 GEMMs accumulate in f32 and round once
on the way out (on the card with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` set
False, as ``chip_smoke.py`` sets it), so here they are plain
``torch.matmul``/``torch.einsum`` at every dtype.
"""

from __future__ import annotations

import torch

__all__ = ["acc_matmul", "acc_einsum", "needs_f32_acc"]


def needs_f32_acc(dtype: torch.dtype) -> bool:
    """True for sub-f32 float dtypes (bf16, f16, f8): the dtypes whose
    contractions must accumulate upward."""
    return dtype.is_floating_point and torch.finfo(dtype).bits < 32


def acc_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, f32-accumulated, result in the operand dtype."""
    return torch.matmul(x, w)


def acc_einsum(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    return torch.einsum(subscripts, *operands)
