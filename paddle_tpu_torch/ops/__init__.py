"""Op helpers shared by the layer impls — the counterpart of
``paddle_tpu/ops/__init__.py``.

``acc_matmul``/``acc_einsum`` are the one spelling of a GEMM under mixed
precision: sub-f32 operands contract with an f32 accumulator and round ONCE
to the compute dtype.  PyTorch's bf16 and f16 GEMMs accumulate in f32 and
round once on the way out only while cuBLAS may not reduce in the operand
type: ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
and ``allow_fp16_reduced_precision_reduction`` False, which PyTorch does not
default to.  :func:`pin_f32_accumulation` sets both, and both places that
select a sub-f32 compute dtype call it: ``paddle_tpu_torch.init`` (the
process-wide selection, which also covers GEMMs a user's own code issues
through these helpers without a network) and ``CompiledNetwork`` (the
lint, command-line and ``Inference`` paths build networks at an explicit
compute dtype without ``init``).  So here the GEMMs are plain
``torch.matmul``/``torch.einsum`` at every dtype.  The numerics lint
(analysis/numerics_lint.py, N401) reads the flags when it traces a step.
"""

from __future__ import annotations

import torch

__all__ = ["acc_matmul", "acc_einsum", "needs_f32_acc", "pin_f32_accumulation"]


def needs_f32_acc(dtype: torch.dtype) -> bool:
    """True for sub-f32 float dtypes (bf16, f16, f8): the dtypes whose
    contractions must accumulate upward."""
    return dtype.is_floating_point and torch.finfo(dtype).bits < 32


def pin_f32_accumulation() -> None:
    """Forbid cuBLAS reduced-precision reductions for bf16 and f16 GEMMs
    (process-wide switches; a no-op for CPU GEMMs)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def acc_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, f32-accumulated, result in the operand dtype."""
    return torch.matmul(x, w)


def acc_einsum(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    return torch.einsum(subscripts, *operands)
