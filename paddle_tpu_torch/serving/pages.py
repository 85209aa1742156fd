"""Block-paged decode-state cache — fixed-size HBM blocks + page table; a copy
of ``paddle_tpu/serving/pages.py`` (it imports no JAX), with its imports
pointed at the port.

Ragged in-flight sequences must share ONE compiled decode step; the state
that is ragged per sequence (the attended-over encoder memory — this
model family's "KV cache") therefore lives in fixed-size blocks of a big
HBM pool, and each live sequence owns a row of page ids (its page-table
row).  The compiled step gathers ``pool[page_table]`` — physical layout is
an argument, never a shape — so admitting or retiring a sequence changes
page-table CONTENTS, not compiled shapes (the Ragged Paged Attention
design, arXiv:2604.15464, on XLA gather/scatter instead of a custom
kernel).

Budget discipline is the pass-cache rule (reader/pass_cache.py):
capacity is derived up front from an explicit per-device HBM budget, every
allocation is accounted in bytes, and exhaustion is a *refused admission*
(the request waits in queue), never an OOM.  Block 0..n-1 are real; one
extra SCRATCH block absorbs the writes/gathers of padded (dead) rows so
ladder padding never corrupts live state.

**Copy-on-write prefix sharing** replaces the free/shadow-set
discipline with per-block REFCOUNTS — the ragged-paged-attention
blueprint's shared-prefix blocks as first-class citizens:

* :meth:`alloc` hands out blocks at refcount 1;
* :meth:`share` maps an already-populated block into another page table
  (refcount +1) — N sessions over one warmed prefix hold ONE copy;
* :meth:`release` drops a reference; a block frees only at refcount 0.
  ``retain=True`` parks a refcount-0 block in the RETAINED pool instead
  of the free list: still populated, instantly revivable by a later
  ``share`` (the prefix cache's warm blocks), evicted LRU-first when
  ``alloc`` outgrows the free list — the same ``serving_hbm_budget_mb``
  covers live and retained blocks, retained capacity is free capacity;
* :meth:`cow` gives a writer private copies of any block it shares with
  another reader BEFORE the write (the caller copies the pool rows the
  returned (src, dst) pairs name) — a decode/prefill write can never
  mutate bytes another sequence is attending over.

``free`` remains as the non-retaining release spelling (the original call
surface).  Counters ride the StatSet plane: ``serving/pages_alloc``,
``serving/pages_free``, ``serving/alloc_refused``, plus the sharing
plane's ``serving/pages_shared``, ``serving/pages_evicted`` and
``serving/pages_cow``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["BlockPagedCache"]


class BlockPagedCache:
    """Host-side allocator + device pool layout for block-paged state.

    ``feature_dims`` maps pool name -> per-token feature width (the NMT
    engine stores two pools: ``enc`` [block, 2H] attention values and
    ``ep`` [block, H] projected score keys).  The device arrays themselves
    are owned by the engine (they are donated through jit every prefill);
    this class owns the refcounts, the budget math and the page-table
    bookkeeping.

    Sizing rule (README "Serving"): with f32 pools,
    ``bytes_per_block = block_tokens * sum(feature_dims) * 4`` and
    ``n_blocks = budget_bytes // bytes_per_block``; a request of S source
    tokens needs ``ceil(S / block_tokens)`` blocks while in flight —
    shared blocks count ONCE no matter how many page tables map them.

    ``on_evict(block_id)`` (assignable) fires when :meth:`alloc` reclaims
    a retained refcount-0 block — the prefix cache invalidates the entry
    whose bytes just died.
    """

    def __init__(
        self,
        block_tokens: int,
        feature_dims: Dict[str, int],
        hbm_budget_bytes: Optional[int] = None,
        n_blocks: Optional[int] = None,
        dtype_bytes: int = 4,
        stats=None,
    ):
        from paddle_tpu_torch.utils.timers import global_stats

        if block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        self.block_tokens = int(block_tokens)
        self.feature_dims = dict(feature_dims)
        self.bytes_per_block = (
            self.block_tokens * sum(self.feature_dims.values()) * dtype_bytes
        )
        if n_blocks is None:
            if hbm_budget_bytes is None:
                raise ValueError("need hbm_budget_bytes or n_blocks")
            n_blocks = int(hbm_budget_bytes) // self.bytes_per_block
        if n_blocks < 1:
            raise ValueError(
                f"HBM budget {hbm_budget_bytes} holds zero "
                f"{self.bytes_per_block}-byte blocks; raise "
                "serving_hbm_budget_mb or shrink block_tokens"
            )
        self.n_blocks = int(n_blocks)
        self._stats = stats if stats is not None else global_stats
        # LIFO free list: recently freed (still-warm) blocks re-allocate
        # first.  Block ids are stable ints in [0, n_blocks); _ref[b] counts
        # the page tables mapping block b (0 = free or retained).
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._ref: List[int] = [0] * self.n_blocks
        # refcount-0 blocks whose bytes are still warm (prefix-cache
        # entries): insertion order IS the LRU order — oldest first out
        self._retained: "OrderedDict[int, None]" = OrderedDict()
        self.on_evict: Optional[Callable[[int], None]] = None

    # -- scratch ---------------------------------------------------------
    @property
    def scratch(self) -> int:
        """The extra pool row (index ``n_blocks``) every padded page id
        points at; its contents are garbage by design and every consumer
        masks it out."""
        return self.n_blocks

    @property
    def pool_rows(self) -> int:
        """Rows each device pool must have: real blocks + the scratch row."""
        return self.n_blocks + 1

    # -- budget ----------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_retained(self) -> int:
        """Refcount-0 blocks kept warm for the prefix cache (reclaimable)."""
        return len(self._retained)

    @property
    def n_used(self) -> int:
        """Blocks some page table maps (refcount >= 1).  Retained blocks
        are NOT used: they are evictable capacity, and the SLO gauge
        ``pages_in_use`` must return to 0 when the plane drains even with
        a warm prefix cache."""
        return self.n_blocks - len(self._free) - len(self._retained)

    @property
    def n_shared(self) -> int:
        """Blocks mapped by MORE than one page table right now."""
        return sum(1 for r in self._ref if r >= 2)

    @property
    def used_bytes(self) -> int:
        return self.n_used * self.bytes_per_block

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def pages_for_tokens(self, n_tokens: int) -> int:
        """Blocks a sequence of ``n_tokens`` source tokens occupies."""
        return max(1, -(-int(n_tokens) // self.block_tokens))

    # -- alloc / share / release -----------------------------------------
    def alloc(self, n_pages: int) -> Optional[List[int]]:
        """``n_pages`` block ids at refcount 1, or None when the budget
        can't cover them (admission control: the caller keeps the request
        queued).  The free list drains first; then retained refcount-0
        blocks are EVICTED oldest-first (LRU) — ``on_evict`` fires per
        reclaimed block so the prefix cache drops the dead entry."""
        if n_pages > len(self._free) + len(self._retained):
            self._stats.incr("serving/alloc_refused")
            return None
        pages = []
        for _ in range(n_pages):
            if self._free:
                p = self._free.pop()
            else:
                p, _ = self._retained.popitem(last=False)  # LRU-oldest
                self._stats.incr("serving/pages_evicted")
                if self.on_evict is not None:
                    self.on_evict(p)
            self._ref[p] = 1
            pages.append(p)
        self._stats.incr("serving/pages_alloc", n_pages)
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Map already-populated blocks into ANOTHER page table: refcount
        +1 each; a retained block revives (leaves the LRU pool).  Sharing
        a free block is a bug — its bytes are undefined — and raises."""
        for p in pages:
            if not (0 <= p < self.n_blocks):
                raise ValueError(f"sharing foreign block id {p}")
            if self._ref[p] == 0 and p not in self._retained:
                raise ValueError(
                    f"sharing free block {p} (undefined contents)"
                )
        for p in pages:
            if self._ref[p] == 0:
                self._retained.pop(p)
            self._ref[p] += 1
        self._stats.incr("serving/pages_shared", len(pages))

    def release(self, pages: Sequence[int], retain: bool = False) -> None:
        """Drop one reference per block; a block frees only at refcount 0.
        ``retain=True`` parks refcount-0 blocks in the warm LRU pool
        (most-recently-released = last out) instead of the free list.
        Releasing a block no table maps (double release / foreign id)
        raises — the double-free discipline, now refcount-exact."""
        for p in pages:
            if not (0 <= p < self.n_blocks):
                raise ValueError(f"freeing foreign block id {p}")
            if self._ref[p] == 0:
                raise ValueError(
                    f"double free of block {p} (refcount already 0)"
                )
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                if retain:
                    self._retained[p] = None  # appended = most recent
                else:
                    self._free.append(p)
        self._stats.incr("serving/pages_free", len(pages))

    def free(self, pages: Sequence[int]) -> None:
        """The non-retaining release (the original call surface)."""
        self.release(pages, retain=False)

    def cow(self, pages: Sequence[int]
            ) -> Tuple[Optional[List[int]], List[Tuple[int, int]]]:
        """Copy-on-write: private replacements for every block of
        ``pages`` that another page table also maps (refcount >= 2).
        Returns ``(new_pages, copies)`` — ``new_pages`` is the caller's
        page list with shared blocks swapped for fresh refcount-1 blocks,
        ``copies`` the (src, dst) pairs whose POOL ROWS the caller must
        copy BEFORE writing (the copy half of copy-on-write; this class
        never touches device memory).  ``(None, [])`` when the budget
        can't cover the copies (the write waits, exactly like a refused
        admission).  Exclusively-owned pages come back unchanged."""
        shared = [p for p in pages if self._ref[p] >= 2]
        if not shared:
            return list(pages), []
        fresh = self.alloc(len(shared))
        if fresh is None:
            return None, []
        repl = dict(zip(shared, fresh))
        for p in shared:
            self._ref[p] -= 1  # >= 2 on entry, so never reaches 0 here
        self._stats.incr("serving/pages_cow", len(shared))
        return [repl.get(p, p) for p in pages], [
            (p, repl[p]) for p in shared
        ]

    def summary(self) -> Dict[str, int]:
        return {
            "n_blocks": self.n_blocks,
            "block_tokens": self.block_tokens,
            "bytes_per_block": self.bytes_per_block,
            "n_free": self.n_free,
            "n_retained": self.n_retained,
            "n_shared": self.n_shared,
            "used_bytes": self.used_bytes,
        }
