"""Batch value types over torch tensors — the counterpart of
``paddle_tpu/core/batch.py``.

A :class:`SeqTensor` is a padded tensor plus optional per-sample lengths
(and, for a nested sequence, the per-subsequence lengths); every layer impl
consumes and produces SeqTensors.  The shape ladders are kept as in the JAX
package, so the port pads and routes exactly as it does.  The feeder
attaches the host copy of every lengths and sub-lengths tensor it uploads
(:func:`set_host_lengths`), so nothing downstream reads them back from the
card.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


class SeqTensor:
    """data: [B, ...] for plain samples, [B, T, ...] padded for sequences,
    [B, S, T, ...] doubly padded for nested sequences (a sequence of
    subsequences, the reference's SUB_SEQUENCE slots);
    lengths: [B] int32 valid timesteps (plain) or valid subsequence count
    (nested), or None for non-sequence values;
    sub_lengths: [B, S] int32 valid timesteps of each subsequence, or None;
    sparse_ids: True when `data` is the padded-id form of a big-vocabulary
    sparse slot ([..., max_nnz] int32 ids, the sentinel == vocab), set by
    the feeder and read by ``layers.base.is_sparse_ids``."""

    def __init__(self, data, lengths=None, sub_lengths=None, sparse_ids=False):
        self.data = data
        self.lengths = lengths
        self.sub_lengths = sub_lengths
        self.sparse_ids = sparse_ids

    @property
    def is_seq(self) -> bool:
        return self.lengths is not None

    @property
    def is_nested(self) -> bool:
        return self.sub_lengths is not None

    @property
    def max_len(self) -> int:
        """Extent of the outer padded axis: T (plain) or S (nested)."""
        assert self.is_seq
        return self.data.shape[1]

    @property
    def max_sub_len(self) -> int:
        assert self.is_nested
        return self.data.shape[2]

    def mask(self, dtype=torch.float32):
        """[B, T] (or [B, S] for nested) 1/0 validity of the outer axis."""
        assert self.is_seq
        t = torch.arange(self.max_len, device=self.lengths.device)
        return (t[None, :] < self.lengths[:, None]).to(dtype)

    def sub_mask(self, dtype=torch.float32):
        """[B, S, T] joint validity: subsequence s valid and timestep t
        valid within it."""
        assert self.is_nested
        t = torch.arange(self.max_sub_len, device=self.sub_lengths.device)
        inner = (t[None, None, :] < self.sub_lengths[:, :, None]).to(dtype)
        return self.mask(dtype)[:, :, None] * inner

    def masked_data(self):
        """data with the padding timesteps zeroed."""
        if not self.is_seq:
            return self.data
        m = self.sub_mask(self.data.dtype) if self.is_nested else self.mask(self.data.dtype)
        return self.data * m.reshape(m.shape + (1,) * (self.data.dim() - m.dim()))

    def with_data(self, data) -> "SeqTensor":
        return SeqTensor(data, self.lengths, self.sub_lengths)

    def __repr__(self) -> str:  # pragma: no cover
        shp = tuple(getattr(self.data, "shape", ()))
        return f"SeqTensor(shape={shp}, seq={self.is_seq}, nested={self.is_nested})"


Batch = Dict[str, SeqTensor]

DEFAULT_LADDER: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

# a nested sequence's S axis (subsequence count) is small (2-8): it rounds on
# a 4-based ladder, as in the JAX package
DEFAULT_SUB_LADDER: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256, 512, 1024)

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
    """Round every sequence slot's padded extents up to the shape ladders:
    T (axis 1) of a plain sequence on `ladder`; S (axis 1) of a nested one
    on DEFAULT_SUB_LADDER and its T (axis 2) on `ladder`, its sub-lengths
    padded along S with empty subsequences.  Lengths are untouched: the new
    positions lie past every row's valid range, so masks, cost sums and the
    scans' early exit treat them as padding.  Zero padding is right for
    every slot kind: the added positions are whole masked-out timesteps."""
    out: Batch = {}
    for name, t in batch.items():
        if t.is_seq:
            sub_lengths = t.sub_lengths
            if t.is_nested:
                data = _pad_axis(t.data, 1, ladder_len(t.data.shape[1], DEFAULT_SUB_LADDER))
                data = _pad_axis(data, 2, ladder_len(data.shape[2], ladder))
                sub_lengths = _pad_axis(sub_lengths, 1, data.shape[1])
                host = getattr(t.sub_lengths, "_host_lengths", None)
                if host is not None and sub_lengths is not t.sub_lengths:
                    pad = np.zeros((host.shape[0], data.shape[1] - host.shape[1]), host.dtype)
                    set_host_lengths(sub_lengths, np.concatenate([host, pad], axis=1))
            else:
                data = _pad_axis(t.data, 1, ladder_len(t.data.shape[1], ladder))
            t = SeqTensor(data, t.lengths, sub_lengths, sparse_ids=t.sparse_ids)
        out[name] = t
    return out


def set_host_lengths(lengths: torch.Tensor, host: np.ndarray) -> torch.Tensor:
    """Attach the host copy `host` of a lengths (or sub-lengths) tensor (the
    feeder has it before the upload), so the scans find their live range
    without reading the device."""
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
            host = getattr(sub_lengths, "_host_lengths", None)
            rest = tuple(sub_lengths.shape[1:])
            sub_lengths = torch.cat([sub_lengths, sub_lengths.new_ones((to_b - b,) + rest)])
            if host is not None:
                set_host_lengths(sub_lengths, np.concatenate(
                    [host, np.ones((to_b - b,) + rest, host.dtype)]))
        out[name] = SeqTensor(data, lengths, sub_lengths, sparse_ids=t.sparse_ids)
    return out


def slice_batch_rows(outs: Dict[str, SeqTensor], b: int) -> Dict[str, SeqTensor]:
    """Undo :func:`pad_batch_rows`: keep the first ``b`` rows."""
    return {
        name: SeqTensor(
            t.data[:b],
            None if t.lengths is None else t.lengths[:b],
            None if t.sub_lengths is None else t.sub_lengths[:b],
            sparse_ids=t.sparse_ids,
        )
        for name, t in outs.items()
    }


def seq(data, lengths, device=None) -> SeqTensor:
    return SeqTensor(torch.as_tensor(data, device=device),
                     torch.as_tensor(lengths, dtype=torch.int32, device=device))


def nested_seq(data, n_sub, sub_lengths, device=None) -> SeqTensor:
    """[B, S, T, ...] doubly padded nested sequence: n_sub[B] valid
    subsequences, sub_lengths[B, S] valid timesteps per subsequence."""
    return SeqTensor(
        torch.as_tensor(data, device=device),
        torch.as_tensor(n_sub, dtype=torch.int32, device=device),
        torch.as_tensor(sub_lengths, dtype=torch.int32, device=device),
    )
