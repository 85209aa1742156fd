"""DataFeeder — python samples → padded torch batches on a device; the
counterpart of ``paddle_tpu/reader/feeder.py`` for every slot kind (dense,
index, sparse binary and sparse float) at every sequence level (plain,
sequence and nested).  Sequence slots pad to a ladder rung (or a multiple of
``seq_multiple``) and carry int32 lengths beside the data; a nested slot is
a doubly padded [B, S, T, ...] block with n_sub[B] and sub_lengths[B, S].
The host copies of the lengths and sub-lengths ride their tensors
(``core.batch.set_host_lengths``), so nothing reads them back from the card.
Sparse slots are densified to multi-hot rows, except a sparse_binary slot
above SPARSE_IDS_THRESHOLD, which feeds as padded ids (the sentinel is the
vocabulary size) for the consumers' gather-sum.

Staging (``DataFeeder.stage``, the torch form of the JAX package's
``jax.device_put`` on its prefetch thread): the batch is converted on the
host, each array is copied into pinned memory and sent with a
non-blocking copy on the feeder's own CUDA stream, and one CUDA event
recorded after the last copy rides the batch (:class:`StagedBatch`).
``DataFeeder.consume`` makes the consuming stream wait on that event and
marks every tensor as used on it (``record_stream``), so the caching
allocator does not hand a tensor's memory to the next staged batch while
the step still reads it.  A worker thread stages under the feeder's device
and stream explicitly: the current stream is per thread.  On the CPU
nothing is pinned and no stream is made.  ``DataFeeder.__call__`` keeps the
synchronous copy on the current stream."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from paddle_tpu_torch.core.batch import (
    DEFAULT_SUB_LADDER,
    SeqTensor,
    ladder_len,
    set_host_lengths,
)
from paddle_tpu_torch.core.data_types import InputType, SeqLevel, SlotKind
from paddle_tpu_torch.core.device import resolve_device


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# Above this vocabulary size a sparse_binary slot feeds as padded ids
# (sentinel = dim) instead of a dense multi-hot row: the multi-hot form is
# O(B*T*vocab) memory, the id form O(B*T*max_nnz), and consumers gather-sum
# the touched rows (layers/base.py gather_sum_rows).  Read at every call.
SPARSE_IDS_THRESHOLD = 65536


def _ids_form(itype: InputType) -> bool:
    return itype.kind == SlotKind.SPARSE_BINARY and itype.dim > SPARSE_IDS_THRESHOLD


def feed_dtypes_of(topology) -> Dict[str, str]:
    """{slot: wire dtype} for data layers declaring a narrow feed dtype."""
    return {
        name: conf.attr("feed_dtype")
        for name, conf in topology.data_layers().items()
        if conf.attr("feed_dtype")
    }


class StagedBatch(dict):
    """A fed batch whose host-to-device copies were issued on a side stream;
    ``ready`` is the CUDA event recorded after the last of them (None when
    nothing was copied asynchronously)."""

    ready = None
    device = None


def _batch_tensors(batch):
    for t in batch.values():
        for x in (t.data, t.lengths, t.sub_lengths):
            if x is not None:
                yield x


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
        self._stream = None  # the staging stream, made at the first stage()

    def __call__(self, batch_data: List[Any]) -> Dict[str, SeqTensor]:
        """The batch on the feeder's device, copied synchronously."""
        return self.upload(self.convert(batch_data))

    # -- staging ---------------------------------------------------------
    def upload(self, host: Dict[str, SeqTensor], staged: bool = False) -> Dict[str, SeqTensor]:
        """`host` (from :meth:`convert`) on the feeder's device: with
        `staged` on a CUDA device, through pinned memory on the feeder's
        stream (a :class:`StagedBatch`), else synchronously."""
        if self.device.type != "cuda" or not staged:
            out = {name: self._upload_slot(t, False) for name, t in host.items()}
            return StagedBatch(out) if staged else out
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        # a worker thread must name the device and the stream: both are
        # per-thread state, and the default stream would serialise the
        # copies with the step
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = StagedBatch({name: self._upload_slot(t, True) for name, t in host.items()})
            out.ready = torch.cuda.Event()
            out.ready.record(self._stream)
            out.device = self.device
        return out

    def stage(self, batch_data: List[Any]) -> Dict[str, SeqTensor]:
        """:meth:`convert` then a staged :meth:`upload`: the feed work a
        prefetch worker runs."""
        return self.upload(self.convert(batch_data), staged=True)

    @staticmethod
    def consume(batch):
        """Make the current stream wait for a staged batch's copies, and
        mark its tensors as used on that stream; a batch that was not
        staged passes through."""
        ev = getattr(batch, "ready", None)
        if ev is None:
            return batch
        stream = torch.cuda.current_stream(batch.device)
        stream.wait_event(ev)
        for x in _batch_tensors(batch):
            if x.is_cuda:
                x.record_stream(stream)
        return batch

    def _upload_slot(self, t: SeqTensor, pinned: bool) -> SeqTensor:
        def up(x):
            if x is None:
                return None
            host = getattr(x, "_host_lengths", None)
            if pinned:
                x = x.pin_memory().to(self.device, non_blocking=True)
            else:
                x = x.to(self.device)
            return x if host is None else set_host_lengths(x, host)

        return SeqTensor(up(t.data), up(t.lengths), up(t.sub_lengths), sparse_ids=t.sparse_ids)

    def convert(self, batch_data: List[Any]) -> Dict[str, SeqTensor]:
        """The batch converted on the host: CPU tensors with their host
        lengths attached; :meth:`upload` puts it on the device."""
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

    @staticmethod
    def _to(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr)

    def _lengths(self, host: np.ndarray) -> torch.Tensor:
        """A lengths or sub-lengths tensor, its host copy attached (it rides
        the upload)."""
        return set_host_lengths(self._to(host), host)

    def _convert_slot(self, col, itype: InputType, dtype) -> SeqTensor:
        if itype.seq == SeqLevel.NONE:
            return self._convert_plain(col, itype, dtype)
        if itype.seq == SeqLevel.SEQ:
            return self._convert_seq(col, itype, dtype)
        return self._convert_sub_seq(col, itype, dtype)

    @staticmethod
    def _nnz(id_lists) -> int:
        return max(_round_up(max((len(ids) for ids in id_lists), default=1), 8), 8)

    def _multi_hot(self, arr: np.ndarray, idx: tuple, ids, itype: InputType) -> None:
        """Write one sparse sample's ids (binary) or (id, value) pairs
        (float) into the dense row arr[idx]."""
        if itype.kind == SlotKind.SPARSE_BINARY:
            arr[idx + (np.asarray(ids, dtype=np.int64),)] = 1.0
        else:
            pos, vals = zip(*ids) if ids else ((), ())
            arr[idx + (np.asarray(pos, dtype=np.int64),)] = np.asarray(vals, self.dtype)

    def _convert_plain(self, col, itype: InputType, dtype) -> SeqTensor:
        b = len(col)
        if itype.kind == SlotKind.DENSE:
            return SeqTensor(self._to(np.asarray(col, dtype=dtype).reshape(b, itype.dim)))
        if itype.kind == SlotKind.INDEX:
            return SeqTensor(self._to(np.asarray(col, dtype=np.int32).reshape(b)))
        if _ids_form(itype):
            arr = np.full((b, self._nnz(col)), itype.dim, dtype=np.int32)  # sentinel pad
            for i, ids in enumerate(col):
                arr[i, : len(ids)] = np.asarray(ids, dtype=np.int32)
            return SeqTensor(self._to(arr), sparse_ids=True)
        arr = np.zeros((b, itype.dim), dtype=self.dtype)
        for i, ids in enumerate(col):
            self._multi_hot(arr, (i,), ids, itype)
        return SeqTensor(self._to(arr))

    def _convert_seq(self, col, itype: InputType, dtype) -> SeqTensor:
        b = len(col)
        lengths = np.asarray([len(s) for s in col], dtype=np.int32)
        t = self._bucket_len(int(lengths.max()) if b else 1)
        sparse_ids = False
        if itype.kind == SlotKind.INDEX:
            arr = np.zeros((b, t), dtype=np.int32)
            for i, s in enumerate(col):
                arr[i, : len(s)] = np.asarray(s, dtype=np.int32)
        elif itype.kind == SlotKind.DENSE:
            arr = np.zeros((b, t, itype.dim), dtype=dtype)
            for i, s in enumerate(col):
                if len(s):
                    arr[i, : len(s)] = np.asarray(s, dtype=dtype)
        elif _ids_form(itype):
            arr = np.full((b, t, self._nnz(ids for s in col for ids in s)), itype.dim,
                          dtype=np.int32)
            for i, s in enumerate(col):
                for j, ids in enumerate(s):
                    arr[i, j, : len(ids)] = np.asarray(ids, dtype=np.int32)
            sparse_ids = True
        else:
            arr = np.zeros((b, t, itype.dim), dtype=self.dtype)
            for i, s in enumerate(col):
                for j, ids in enumerate(s):
                    self._multi_hot(arr, (i, j), ids, itype)
        # the scans read their live range from the host copy, not the device
        return SeqTensor(self._to(arr), self._lengths(lengths), sparse_ids=sparse_ids)

    def _convert_sub_seq(self, col, itype: InputType, dtype) -> SeqTensor:
        """Nested sequences: each sample is a list of subsequences, fed as a
        doubly padded [B, S, T, ...] block with n_sub[B] and
        sub_lengths[B, S] (the reference's two-level CSR, Argument.h:84-93).
        S pads to a multiple of 4, or on DEFAULT_SUB_LADDER with a ladder."""
        b = len(col)
        n_sub = np.asarray([len(s) for s in col], dtype=np.int32)
        raw_s = int(n_sub.max()) if b else 1
        if self.ladder:
            s_max = ladder_len(max(raw_s, 1), DEFAULT_SUB_LADDER)
        else:
            s_max = max(_round_up(raw_s, 4), 4)
        sub_lengths = np.zeros((b, s_max), dtype=np.int32)
        for i, sample in enumerate(col):
            for j, sub in enumerate(sample):
                sub_lengths[i, j] = len(sub)
        t = self._bucket_len(max(int(sub_lengths.max()) if b else 1, 1))
        sparse_ids = False
        if itype.kind == SlotKind.INDEX:
            arr = np.zeros((b, s_max, t), dtype=np.int32)
            for i, sample in enumerate(col):
                for j, sub in enumerate(sample):
                    arr[i, j, : len(sub)] = np.asarray(sub, dtype=np.int32)
        elif _ids_form(itype):
            nnz = self._nnz(ids for s in col for sub in s for ids in sub)
            arr = np.full((b, s_max, t, nnz), itype.dim, dtype=np.int32)
            for i, sample in enumerate(col):
                for j, sub in enumerate(sample):
                    for k, ids in enumerate(sub):
                        arr[i, j, k, : len(ids)] = np.asarray(ids, np.int32)
            sparse_ids = True
        elif itype.kind == SlotKind.DENSE:
            arr = np.zeros((b, s_max, t, itype.dim), dtype=dtype)
            for i, sample in enumerate(col):
                for j, sub in enumerate(sample):
                    if len(sub):
                        arr[i, j, : len(sub)] = np.asarray(sub, dtype=dtype)
        else:
            arr = np.zeros((b, s_max, t, itype.dim), dtype=self.dtype)
            for i, sample in enumerate(col):
                for j, sub in enumerate(sample):
                    for k, ids in enumerate(sub):
                        self._multi_hot(arr, (i, j, k), ids, itype)
        return SeqTensor(self._to(arr), self._lengths(n_sub), self._lengths(sub_lengths),
                         sparse_ids=sparse_ids)
