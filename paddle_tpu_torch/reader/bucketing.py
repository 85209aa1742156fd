"""Length-bucketed batching + token-budget packing — a copy of
``paddle_tpu/reader/bucketing.py`` (jax-free there too), without the JAX
package's pass-cache tags (the port has no pass cache).

Variable-length sequence workloads (NMT, text classification) waste most of
their compute when every batch is padded to the global max length: the
masked-out tail rows still ride through every GEMM and every scan step.  The
classic fix is a bucketing input pipeline (TensorFlow's bucket_by_sequence_
length, arXiv:1605.08695); on TPU the extra constraint is that XLA compiles
one executable per batch shape, so bucket shapes must come from a small
canonical ladder or the jit cache grows without bound (in the port the
ladder bounds the set of padded shapes the scans and GEMMs see).

This module supplies the feed half of that contract (the shape half lives in
``core.batch``: :data:`~paddle_tpu_torch.core.batch.DEFAULT_LADDER`,
:func:`~paddle_tpu_torch.core.batch.ladder_len`):

* :func:`sort_within_window` — length-sorted shuffle-window bucketing: pull a
  window of samples from an (already shuffled) stream and re-emit it in
  length order, so nearby samples have similar lengths without giving up
  stochasticity beyond the window.
* :func:`token_budget_batch` — the batcher: group samples into minibatches
  whose PADDED token count (batch_size × ladder rung) stays ~constant, i.e.
  batch size scales inversely with bucket length.  Every emitted full batch
  has the canonical size for its rung, so distinct batch shapes across an
  epoch are bounded by the ladder — exactly one (B, T) per rung when every
  sequence slot shares the sample's length; slots with uncorrelated lengths
  each round to their own rung, multiplying the realized combinations
  (bucket on the dominant slot via ``key``/``slots`` if that matters).

Both are ordinary reader decorators (``reader() -> iterable``) composable
with ``paddle.reader.shuffle`` etc.; ``token_budget_batch`` replaces
``paddle.batch`` for variable-length data and its output feeds the same
:class:`~paddle_tpu_torch.reader.feeder.DataFeeder` (give the feeder the same
``ladder=`` so padded array shapes land on the rung the batcher packed for).
"""

from __future__ import annotations

import random as _random
from typing import Any, Callable, Iterable, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch.core.batch import DEFAULT_LADDER, ladder_len

Reader = Callable[[], Iterable[Any]]


def sample_len(sample: Any, slots: Optional[Sequence[int]] = None) -> int:
    """Token length of a sample tuple: the max length over its sequence-like
    fields (lists/tuples and 1-D+ ndarrays); scalars count as 1.

    This is the right default for id-sequence workloads (every slot of an
    NMT triple or a text-cls pair is a token list).  Samples that mix
    sequence slots with wide DENSE vector slots (a flat image next to a
    caption) must say which fields carry length — pass ``slots`` (field
    indices) here or a custom ``key=`` to the decorators."""
    if not isinstance(sample, (tuple, list)):
        return 1
    n = 1
    for i, field in enumerate(sample):
        if slots is not None and i not in slots:
            continue
        if isinstance(field, np.ndarray):
            if field.ndim >= 1:
                n = max(n, int(field.shape[0]))
        elif isinstance(field, (list, tuple)):
            n = max(n, len(field))
    return n


def sort_within_window(
    reader: Reader,
    window: int = 2048,
    key: Callable[[Any], int] = sample_len,
) -> Reader:
    """Re-emit each ``window`` of samples in (stable) length-sorted order.

    Upstream shuffling decides WHICH samples share a window; the sort only
    reorders inside it, so training order stays stochastic at the window
    scale while neighbours become length-homogeneous for the batcher."""

    def sorted_reader():
        buf: List[Any] = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= window:
                buf.sort(key=key)
                yield from buf
                buf = []
        if buf:
            buf.sort(key=key)
            yield from buf

    return sorted_reader


def bucket_batch_size(
    rung: int,
    token_budget: int,
    batch_multiple: int = 8,
    max_batch: Optional[int] = None,
) -> int:
    """Canonical examples-per-batch for a ladder rung: the largest multiple
    of ``batch_multiple`` whose padded token count fits the budget (at least
    1).  One deterministic size per rung keeps the (B, T) shape set bounded
    by the ladder size."""
    cap = max(token_budget // rung, 1)
    if cap >= batch_multiple:
        cap -= cap % batch_multiple
    if max_batch is not None:
        cap = min(cap, max_batch)
    return max(cap, 1)


def token_budget_batch(
    reader: Reader,
    token_budget: Optional[int] = None,
    batch_size: Optional[int] = None,
    key: Callable[[Any], int] = sample_len,
    ladder: Sequence[int] = DEFAULT_LADDER,
    window: int = 2048,
    batch_multiple: int = 8,
    max_batch: Optional[int] = None,
    shuffle_batches: bool = True,
    seed: int = 0,
    drop_last: bool = False,
) -> Reader:
    """Group a variable-length sample reader into length-bucketed minibatches
    that fill a ~constant PADDED-token budget per step.

    Each sample joins the bucket of ``ladder_len(key(sample))``; a bucket
    flushes a batch whenever it holds :func:`bucket_batch_size` samples for
    its rung.  Within each ``window`` of consumed samples, ready batches are
    emitted in seeded-shuffled order so the stream doesn't degenerate into
    long same-length runs.  Residual samples carry over between windows; at
    end of stream the partial per-rung remainders are emitted too (shapes
    beyond the canonical set, at most one per rung per epoch) unless
    ``drop_last``.

    ``token_budget=None`` derives the budget from ``batch_size`` × the
    tallest rung seen in the first window — i.e. the padded token count the
    UNBUCKETED pipeline would have spent per step, so switching bucketing on
    keeps per-step compute comparable while making nearly all of it valid.

    Feed the emitted batches through a ``DataFeeder(..., ladder=ladder)`` so
    the padded array shapes land exactly on the rung each batch was packed
    for."""
    if token_budget is None and batch_size is None:
        raise ValueError("token_budget_batch needs token_budget or batch_size")

    # a derived budget is pinned on the FIRST pass and reused by every later
    # reader() restart: re-deriving per pass under a shuffled upstream would
    # drift the budget (different first-window max), change every rung's
    # canonical batch size, and recompile every bucket each pass — exactly
    # the instability the bounded-shapes contract exists to prevent
    derived = [token_budget]

    def batched_reader():
        rng = _random.Random(seed)
        budget = derived[0]
        buckets: dict = {}
        ready: List[List[Any]] = []
        pending: List[Any] = []  # first-window holdback while budget derives

        def place(sample) -> None:
            rung = ladder_len(key(sample), ladder)
            buckets.setdefault(rung, []).append(sample)
            cap = bucket_batch_size(rung, budget, batch_multiple, max_batch)
            if len(buckets[rung]) >= cap:
                ready.append(buckets.pop(rung))

        def flush_ready():
            if shuffle_batches:
                rng.shuffle(ready)
            yield from ready
            ready.clear()

        seen = 0
        for sample in reader():
            seen += 1
            if budget is None:
                pending.append(sample)
                if len(pending) >= window:
                    budget = derived[0] = batch_size * max(
                        ladder_len(key(s), ladder) for s in pending
                    )
                    for s in pending:
                        place(s)
                    pending.clear()
                    yield from flush_ready()
                continue
            place(sample)
            if seen % window == 0:
                yield from flush_ready()
        if budget is None and pending:  # short stream: derive from all of it
            budget = derived[0] = batch_size * max(
                ladder_len(key(s), ladder) for s in pending
            )
            for s in pending:
                place(s)
            pending.clear()
        yield from flush_ready()
        if not drop_last:
            leftovers = [buckets[r] for r in sorted(buckets) if buckets[r]]
            if shuffle_batches:
                rng.shuffle(leftovers)
            yield from leftovers

    return batched_reader
