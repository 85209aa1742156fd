"""DataFeeder — python samples → padded torch batches on a device; the
counterpart of ``paddle_tpu/reader/feeder.py`` for dense and integer slots
(plain and sequence).  Sequence slots pad to a ladder rung (or a multiple of
``seq_multiple``) and carry int32 lengths beside the data.  Sparse and
nested slots are not ported yet and raise."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from paddle_tpu_torch.core.batch import SeqTensor, ladder_len, set_host_lengths
from paddle_tpu_torch.core.data_types import InputType, SeqLevel, SlotKind
from paddle_tpu_torch.core.device import resolve_device


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def feed_dtypes_of(topology) -> Dict[str, str]:
    """{slot: wire dtype} for data layers declaring a narrow feed dtype."""
    return {
        name: conf.attr("feed_dtype")
        for name, conf in topology.data_layers().items()
        if conf.attr("feed_dtype")
    }


class DataFeeder:
    """feeding: {slot_name: index_in_sample}, or slot names in sample order;
    None means the order of `data_types`.  ``device=None`` is the port's
    default device (the card; raises without one)."""

    def __init__(
        self,
        data_types: Sequence[Tuple[str, InputType]],
        feeding: Optional[Union[Dict[str, int], Sequence[str]]] = None,
        seq_multiple: int = 8,
        min_seq_len: int = 8,
        dtype=np.float32,
        feed_dtypes: Optional[Dict[str, Any]] = None,
        ladder: Optional[Sequence[int]] = None,
        device=None,
    ):
        self.data_types = list(data_types)
        self.feed_dtypes = dict(feed_dtypes or {})
        if feeding is None:
            self.index = {name: i for i, (name, _) in enumerate(self.data_types)}
        elif isinstance(feeding, dict):
            self.index = dict(feeding)
        else:
            self.index = {name: i for i, name in enumerate(feeding)}
        self.seq_multiple = seq_multiple
        self.min_seq_len = min_seq_len
        self.ladder = tuple(ladder) if ladder else None
        self.dtype = dtype
        self.device = resolve_device(device)

    def __call__(self, batch_data: List[Any]) -> Dict[str, SeqTensor]:
        return self.convert(batch_data)

    def convert(self, batch_data: List[Any]) -> Dict[str, SeqTensor]:
        n_slots = max(self.index.values()) + 1 if self.index else 0
        for sample in batch_data[:1]:
            if not isinstance(sample, (tuple, list)) or len(sample) < n_slots:
                raise ValueError(
                    f"each sample must be a tuple of {n_slots} slot(s) "
                    f"({[n for n, _ in self.data_types]}); got "
                    f"{type(sample).__name__}"
                )
        out: Dict[str, SeqTensor] = {}
        for name, itype in self.data_types:
            col = [sample[self.index[name]] for sample in batch_data]
            out[name] = self._convert_slot(col, itype, self.feed_dtypes.get(name, self.dtype))
        return out

    def _bucket_len(self, max_len: int) -> int:
        if self.ladder:
            return ladder_len(max(max_len, self.min_seq_len), self.ladder)
        return max(_round_up(max_len, self.seq_multiple), self.min_seq_len)

    def _to(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _convert_slot(self, col, itype: InputType, dtype) -> SeqTensor:
        if itype.kind not in (SlotKind.DENSE, SlotKind.INDEX) or itype.seq == SeqLevel.SUB_SEQ:
            raise NotImplementedError(
                f"{itype.kind.value} slots at sequence level {itype.seq.name} "
                "are not ported yet"
            )
        b = len(col)
        if itype.seq == SeqLevel.NONE:
            if itype.kind == SlotKind.DENSE:
                return SeqTensor(self._to(np.asarray(col, dtype=dtype).reshape(b, itype.dim)))
            return SeqTensor(self._to(np.asarray(col, dtype=np.int32).reshape(b)))
        lengths = np.asarray([len(s) for s in col], dtype=np.int32)
        t = self._bucket_len(int(lengths.max()) if b else 1)
        if itype.kind == SlotKind.INDEX:
            arr = np.zeros((b, t), dtype=np.int32)
            for i, s in enumerate(col):
                arr[i, : len(s)] = np.asarray(s, dtype=np.int32)
        else:
            arr = np.zeros((b, t, itype.dim), dtype=dtype)
            for i, s in enumerate(col):
                if len(s):
                    arr[i, : len(s)] = np.asarray(s, dtype=dtype)
        # the scans read their live range from the host copy, not the device
        return SeqTensor(self._to(arr), set_host_lengths(self._to(lengths), lengths))
