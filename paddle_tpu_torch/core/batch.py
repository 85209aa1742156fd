"""Batch value types over torch tensors — the counterpart of
``paddle_tpu/core/batch.py``.

A :class:`SeqTensor` is a padded tensor plus optional per-sample lengths;
every layer impl consumes and produces SeqTensors.  The shape ladders are
kept as in the JAX package, so the port pads and routes exactly as it does.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


class SeqTensor:
    """data: [B, ...] for plain samples, [B, T, ...] padded for sequences;
    lengths: [B] int32 valid timesteps, or None for non-sequence values."""

    def __init__(self, data, lengths=None, sub_lengths=None):
        self.data = data
        self.lengths = lengths
        self.sub_lengths = sub_lengths

    @property
    def is_seq(self) -> bool:
        return self.lengths is not None

    @property
    def is_nested(self) -> bool:
        return self.sub_lengths is not None

    @property
    def max_len(self) -> int:
        assert self.is_seq
        return self.data.shape[1]

    def mask(self, dtype=torch.float32):
        """[B, T] 1/0 validity of the time axis."""
        assert self.is_seq
        t = torch.arange(self.max_len, device=self.lengths.device)
        return (t[None, :] < self.lengths[:, None]).to(dtype)

    def with_data(self, data) -> "SeqTensor":
        return SeqTensor(data, self.lengths, self.sub_lengths)

    def __repr__(self) -> str:  # pragma: no cover
        shp = tuple(getattr(self.data, "shape", ()))
        return f"SeqTensor(shape={shp}, seq={self.is_seq}, nested={self.is_nested})"


Batch = Dict[str, SeqTensor]

DEFAULT_LADDER: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

DEFAULT_BATCH_LADDER: Tuple[int, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
)


def shape_ladder(base: int = 16, rungs: int = 9) -> Tuple[int, ...]:
    """Geometric shape ladder base*2^k, k in [0, rungs)."""
    return tuple(base << k for k in range(rungs))


def ladder_len(n: int, ladder: Sequence[int] = DEFAULT_LADDER) -> int:
    """Smallest ladder rung >= n; past the top rung, the next multiple of it."""
    n = max(int(n), 1)
    for r in ladder:
        if n <= r:
            return r
    top = ladder[-1]
    return ((n + top - 1) // top) * top


def _pad_axis(data: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    cur = data.shape[axis]
    if cur >= to:
        return data
    shape = list(data.shape)
    shape[axis] = to - cur
    return torch.cat([data, data.new_zeros(shape)], dim=axis)


def batch_shape_key(batch: Batch) -> tuple:
    """Hashable shape signature of a fed batch: slot names, data shapes and
    dtypes (two batches with equal keys have the same padded shapes)."""
    return tuple(
        (name, tuple(int(d) for d in batch[name].data.shape), str(batch[name].data.dtype))
        for name in sorted(batch)
    )


def canonicalize_batch(batch: Batch, ladder: Sequence[int] = DEFAULT_LADDER) -> Batch:
    """Round every plain sequence slot's padded time axis up to the shape
    ladder.  Lengths are untouched: the new positions lie past every row's
    valid range, so masks, cost sums and the scans' early exit treat them as
    padding.  Nested slots are not ported yet and raise."""
    out: Batch = {}
    for name, t in batch.items():
        if t.is_nested:
            raise NotImplementedError(f"{name}: nested sequence slots are not ported yet")
        if t.is_seq:
            data = _pad_axis(t.data, 1, ladder_len(t.data.shape[1], ladder))
            t = SeqTensor(data, t.lengths)
        out[name] = t
    return out


def set_host_lengths(lengths: torch.Tensor, host: np.ndarray) -> torch.Tensor:
    """Attach the host copy `host` of a lengths tensor (the feeder has it
    before the upload), so the scans find their live range without reading
    the device."""
    lengths._host_lengths = host
    return lengths


def host_lengths(lengths: torch.Tensor) -> np.ndarray:
    """The host copy of a lengths tensor: the feeder's, or one read of the
    device that is kept on the tensor for later callers."""
    host = getattr(lengths, "_host_lengths", None)
    if host is None:
        host = lengths.detach().cpu().numpy()
        lengths._host_lengths = host
    return host


def pad_batch_rows(batch: Batch, to_b: int) -> Batch:
    """Pad every slot's batch axis up to ``to_b`` rows.  Dead rows are zero
    data with length 1 (one valid zero timestep), so per-row normalisers
    never see 0/0; the live rows are untouched.  A host copy of the lengths
    (``set_host_lengths``) is padded along."""
    out: Batch = {}
    for name, t in batch.items():
        b = t.data.shape[0]
        if b >= to_b:
            out[name] = t
            continue
        data = _pad_axis(t.data, 0, to_b)
        lengths = t.lengths
        if lengths is not None:
            host = getattr(lengths, "_host_lengths", None)
            lengths = torch.cat([lengths, lengths.new_ones((to_b - b,))])
            if host is not None:
                set_host_lengths(lengths, np.concatenate([host, np.ones(to_b - b, host.dtype)]))
        sub_lengths = t.sub_lengths
        if sub_lengths is not None:
            sub_lengths = torch.cat(
                [sub_lengths, sub_lengths.new_ones((to_b - b,) + tuple(sub_lengths.shape[1:]))]
            )
        out[name] = SeqTensor(data, lengths, sub_lengths)
    return out


def slice_batch_rows(outs: Dict[str, SeqTensor], b: int) -> Dict[str, SeqTensor]:
    """Undo :func:`pad_batch_rows`: keep the first ``b`` rows."""
    return {
        name: SeqTensor(
            t.data[:b],
            None if t.lengths is None else t.lengths[:b],
            None if t.sub_lengths is None else t.sub_lengths[:b],
        )
        for name, t in outs.items()
    }
