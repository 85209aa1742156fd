"""Device-resident pass cache and data echo — the counterpart of
``paddle_tpu/reader/pass_cache.py`` (the reference's CACHE_PASS_IN_MEM,
PyDataProvider2.cpp:69, kept in device memory instead of host RAM).

* **Capture (pass 1).**  Every staged batch (the feeder's output on the
  device, in its wire form: uint8 pixels stay uint8 when the data layer
  declares ``feed_dtype="uint8"``; the feed transform runs in the step) is
  held by reference.  Nothing is copied: the batch the step consumed is
  the cache entry.  Torch tensors are mutable where JAX arrays are not, so
  the port keeps a rule: no layer, feed transform or fault point writes
  into a batch tensor (``chaos.poison_batch`` clones the slot it poisons).
* **Budget.**  Every batch's device bytes (:func:`batch_nbytes`) count
  against ``hbm_budget_bytes``; an overflow drops every reference, warns,
  and the run streams from then on.
* **Data echo (pass 1).**  ``echo_factor=k`` trains each transferred batch
  k times back to back.
* **Replay (pass >= 2).**  The order comes from a CPU ``torch.Generator``
  seeded from ``(seed, pass_id)``: reproducible from the seed, different
  across passes, the same on the card and on the CPU, and free of any
  host-to-device copy.  (It cannot be the JAX package's
  ``jax.random.permutation`` order; with ``shuffle=False`` both replay in
  capture order.)  ``sample_shuffle=True`` also permutes the rows of each
  batch on the device with one index per batch, shared by every slot.
* **Buckets.**  Batches of different shapes (the ``use_bucketing`` feed)
  keep their own shapes; the replay order mixes all of them.

A cached pass replays the very tensors the streamed pass trained on, so
with ``shuffle=False`` the trained parameters equal streaming the same
batches bit for bit.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.batch import SeqTensor, batch_shape_key, set_host_lengths

_log = logging.getLogger("paddle_tpu_torch.pass_cache")

__all__ = ["PassCache", "batch_nbytes", "copy_cache_tags"]


def _tensors(batch):
    if isinstance(batch, dict):
        for v in batch.values():
            yield from _tensors(v)
    elif isinstance(batch, SeqTensor):
        for x in (batch.data, batch.lengths, batch.sub_lengths):
            if x is not None:
                yield x
    elif torch.is_tensor(batch):
        yield batch


def batch_nbytes(batch) -> int:
    """Device bytes a staged batch holds: every tensor's data, lengths and
    sub-lengths."""
    return sum(int(x.numel()) * x.element_size() for x in _tensors(batch))


def copy_cache_tags(src, dst):
    """Carry the @provider CACHE_PASS_IN_MEM tags from a reader to a wrapper
    around it (``paddle.batch``, ``token_budget_batch``)."""
    if getattr(src, "cache_pass_in_mem", False):
        dst.cache_pass_in_mem = True
        dst.cache_pass_shuffle = getattr(src, "cache_pass_shuffle", True)
    return dst


def _take(x: Optional[torch.Tensor], index: torch.Tensor, host_index: np.ndarray):
    """Rows `index` of a tensor (a device gather), its host lengths taken
    along."""
    if x is None:
        return None
    out = x.index_select(0, index.to(x.device))
    host = getattr(x, "_host_lengths", None)
    return out if host is None else set_host_lengths(out, host[host_index])


def _permute_rows(batch, perm: torch.Tensor):
    """One row permutation applied to every slot of a batch (data, lengths
    and sub-lengths alike), so a sample's slots stay aligned."""
    host = perm.numpy()
    return {
        name: SeqTensor(_take(t.data, perm, host), _take(t.lengths, perm, host),
                        _take(t.sub_lengths, perm, host), sparse_ids=t.sparse_ids)
        for name, t in batch.items()
    }


def _stack(xs: List[Optional[torch.Tensor]]):
    """The tensors stacked on a new leading axis, their host lengths too."""
    if xs[0] is None:
        return None
    out = torch.stack(xs)
    hosts = [getattr(x, "_host_lengths", None) for x in xs]
    if all(h is not None for h in hosts):
        set_host_lengths(out, np.stack(hosts))
    return out


def _row_count(batch) -> int:
    for x in _tensors(batch):
        if x.dim():
            return int(x.shape[0])
    return 1


class PassCache:
    """Capture a pass of staged batches during pass 1, replay it from the
    device (shuffled, reproducibly) for every later pass.

    hbm_budget_bytes: cap on cached bytes; None is unbounded.  An overflow
    warns, frees everything held and turns the cache off (streaming).
    echo_factor: train each pass-1 batch this many times; 1 is off.
    seed: the replay-order seed (with the pass id).
    shuffle: permute the batch order of each pass; False replays capture
    order (the bit-parity mode).
    sample_shuffle: also permute the rows within each batch on the device.
    """

    def __init__(self, hbm_budget_bytes: Optional[int] = None, echo_factor: int = 1,
                 seed: int = 0, shuffle: bool = True, sample_shuffle: bool = False):
        self.budget = hbm_budget_bytes
        self.echo_factor = max(int(echo_factor), 1)
        self.seed = int(seed)
        self.shuffle = shuffle
        self.sample_shuffle = sample_shuffle
        self.active = True  # False after an overflow
        self.ready = False  # True after a completed capture pass
        self.nbytes = 0
        self._batches: List[Any] = []
        self._bucket_counts: Dict[tuple, int] = {}
        self._stacked = None  # the capture-order stack (epoch program)

    @classmethod
    def from_flags(cls, reader=None, seed: Optional[int] = None,
                   echo_factor: Optional[int] = None,
                   shuffle: Optional[bool] = None) -> "PassCache":
        """The cache the flags describe: budget ``pass_cache_hbm_budget_mb``,
        seed the ``seed`` flag unless the caller pins one (the trainer
        passes its own), echo ``data_echo_factor``, and shuffle from the
        reader's ``cache_pass_shuffle`` tag (a should_shuffle=False provider
        replays in capture order)."""
        from paddle_tpu_torch.utils import flags as _flags

        if echo_factor is None:
            echo_factor = _flags.get_flag("data_echo_factor")
        if shuffle is None:
            shuffle = bool(getattr(reader, "cache_pass_shuffle", True))
        return cls(
            hbm_budget_bytes=_flags.get_flag("pass_cache_hbm_budget_mb") << 20,
            echo_factor=echo_factor,
            seed=_flags.get_flag("seed") if seed is None else seed,
            shuffle=shuffle,
        )

    # -- capture ---------------------------------------------------------
    @property
    def n_batches(self) -> int:
        return len(self._batches)

    @property
    def n_buckets(self) -> int:
        return len(self._bucket_counts)

    def observe(self, batch) -> None:
        """Count and hold one staged batch; an overflow turns the cache
        off."""
        if not self.active or self.ready:
            return
        nb = batch_nbytes(batch)
        if self.budget is not None and self.nbytes + nb > self.budget:
            _log.warning(
                "pass cache over its device-memory budget (%d + %d > %d bytes after %d "
                "batches); falling back to streaming: every pass pays the host feed.  "
                "Raise pass_cache_hbm_budget_mb if the pass should fit (n_samples x "
                "bytes per sample in wire form).",
                self.nbytes, nb, self.budget, self.n_batches)
            self.drop()
            return
        self.nbytes += nb
        self._batches.append(batch)
        key = batch_shape_key(batch) if isinstance(batch, dict) else ()
        self._bucket_counts[key] = self._bucket_counts.get(key, 0) + 1

    def capture(self, batches: Iterable) -> Iterator:
        """Wrap pass 1's staged batches: hold each, echo it, and seal the
        cache when the pass ends (an abandoned pass never seals: a partial
        pass must not pass for the whole one)."""
        if self.active and not self.ready and self._batches:
            # an earlier capture pass was abandoned: start the count afresh
            self._batches = []
            self._bucket_counts = {}
            self.nbytes = 0
        for batch in batches:
            self.observe(batch)
            yield batch
            # echo even after an overflow: it needs the batch in hand only
            for _ in range(self.echo_factor - 1):
                yield batch
        self.seal()

    def drop(self) -> None:
        """Release every held batch and turn caching off."""
        self.active = False
        self.ready = False
        self._batches = []
        self._bucket_counts = {}
        self._stacked = None
        self.nbytes = 0

    def seal(self) -> None:
        """Mark the captured pass complete; replay becomes available."""
        if not self.active or not self._batches:
            return
        self.ready = True
        _log.info("pass cache sealed: %d batches (%d shape bucket(s)), %.1f MB on the "
                  "device; passes >= 2 replay with no host-to-device copy",
                  self.n_batches, self.n_buckets, self.nbytes / 1e6)

    # -- replay ----------------------------------------------------------
    def _generator(self, pass_id: int, salt: int = 0) -> torch.Generator:
        key = ((self.seed & 0x7FFFFFFF) << 32) | ((pass_id * 1_000_003 + salt) & 0xFFFFFFFF)
        return torch.Generator().manual_seed(key)

    def epoch_order(self, pass_id: int) -> List[int]:
        """The replay order of one pass, drawn on the host."""
        n = self.n_batches
        if not self.shuffle or n <= 1:
            return list(range(n))
        return torch.randperm(n, generator=self._generator(pass_id)).tolist()

    def epoch(self, pass_id: int) -> Iterator:
        """Yield the cached pass for `pass_id`, in its order."""
        assert self.ready, "pass cache not sealed; nothing to replay"
        for j, i in enumerate(self.epoch_order(pass_id)):
            b = self._batches[i]
            if self.sample_shuffle:
                b = _permute_rows(b, torch.randperm(
                    _row_count(b), generator=self._generator(pass_id, j + 1)))
            yield b

    def stream(self, start_pass: int = 1) -> Iterator:
        """Endless replay: epoch(start_pass), epoch(start_pass + 1), ..."""
        assert self.ready, "pass cache not sealed; nothing to replay"
        p = start_pass
        while True:
            yield from self.epoch(p)
            p += 1

    def sample_batch(self):
        """One cached batch (the first captured)."""
        assert self.ready, "pass cache not sealed"
        return self._batches[0]

    def fits_stacked(self) -> bool:
        """Whether the stacked capture-order copy fits the budget beside the
        per-batch cache (the epoch program holds both: 2x the pass)."""
        return self.budget is None or 2 * self.nbytes <= self.budget

    def stacked(self):
        """The cached pass stacked on a leading [N, ...] axis in capture
        order, host lengths included; built once and held for the cache's
        life.  One shape bucket only; callers check :meth:`fits_stacked`."""
        assert self.ready, "pass cache not sealed; nothing to stack"
        assert self.n_buckets <= 1, (
            f"stacked() needs a single shape bucket; this cache holds {self.n_buckets} "
            "(use epoch() for bucketed replay)")
        if self._stacked is None:
            first = self._batches[0]
            self._stacked = {
                name: SeqTensor(
                    _stack([b[name].data for b in self._batches]),
                    _stack([b[name].lengths for b in self._batches]),
                    _stack([b[name].sub_lengths for b in self._batches]),
                    sparse_ids=first[name].sparse_ids)
                for name in first
            }
        return self._stacked

    def epoch_perm(self, pass_id: int) -> torch.Tensor:
        """This pass's replay order as a host int64 tensor: the `perm`
        argument of the epoch program, which reads it on the host."""
        return torch.tensor(self.epoch_order(pass_id), dtype=torch.int64)

    def stacked_pass(self, pass_id: int):
        """The whole cached pass stacked [N, ...] in this pass's order (a
        gather on the device), for ``make_multi_train_step``."""
        perm = self.epoch_perm(pass_id)
        return _permute_rows(self.stacked(), perm)

    # -- introspection ---------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        return {
            "active": self.active,
            "ready": self.ready,
            "n_batches": self.n_batches,
            "n_buckets": self.n_buckets,
            "mb": round(self.nbytes / 1e6, 2),
            "echo_factor": self.echo_factor,
            "budget_mb": round(self.budget / 1e6, 2) if self.budget is not None else None,
        }
