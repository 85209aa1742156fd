"""Paged decode engine — the greedy core of ``paddle_tpu/serving/engine.py``:
continuous batching over the block-paged encoder cache.

* **prefill** (:meth:`ServingEngine.admit`): the bucketed encoder forward
  over an admitted group (source tokens padded to a ``DEFAULT_LADDER``
  rung, rows to the engine's ``rows``), its encoder memory split into fixed-size
  blocks and written in place at the allocator's page ids, the decoder's
  boot state written into the slot plane;
* **decode** (:meth:`ServingEngine.step`): ``block_steps`` greedy steps of
  the fused attention-GRU chain (``models/seq2seq.py``
  ``make_fused_logits``, the one-shot generator's arithmetic) for every
  live sequence at once, over encoder memory gathered through the page
  table (``pool[page_table]``, padded to a page rung; the true lengths ride
  as a mask), then one host copy of the [B, K] tokens (and their
  log-probabilities, which land in ``Request.token_logprobs``).

The pools are device tensors allocated once at the budget's size and
written in place; admission and retirement change page-table contents and
the live mask.  Each (rows, page rung) pair is one shape variant of the
decode, counted in ``decode_shapes`` (``prefill_shapes`` counts the
prefill's batch shapes), so the variants stay bounded by the ladders.

Each request's tokens and their log-probabilities equal the one-shot
``Seq2SeqGenerator.generate_greedy`` path's bit for bit
(:meth:`ServingEngine.reference_decode`): the gathered pages hold the bytes
prefill wrote, masked padding contributes exact zeros, and every product
runs at the shapes the one-shot path gives it.  cuBLAS, and torch's CPU
matmul, pick their algorithm by the number of rows M, and each rounds a
row its own way; at one M a row's result does not depend on its position.
So every dispatch runs on ``rows`` = the ``max_slots`` rung (padding rows
point at the scratch slot and page), prefill runs one dispatch per source
rung of the admitted group, ``reference_decode`` feeds its request padded
to ``rows`` rows, and the decode step sums its attention context in fixed
blocks (``ops/rnn.py`` ``attention_gru_step``), so a row's result does not
depend on the page rung its batch pads to.  At low occupancy the decode
computes padding rows; it is bound by its launches, not by its products.

Not ported yet, each raising ``NotImplementedError`` naming it: chunked
prefill (``prefill_chunk_tokens``), the copy-on-write prefix cache
(``prefix_cache``), speculative decoding (``spec_decode``), per-request beam
serving (``Request.beam_size > 1``), int8 weights (``int8_weights``) and the
AOT cache (``aot_cache_dir``); the ``obs`` spans around prefill.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.batch import (
    DEFAULT_BATCH_LADDER,
    DEFAULT_LADDER,
    batch_shape_key,
    ladder_len,
    pad_batch_rows,
)
from paddle_tpu_torch.core.device import resolve_device, tree_to
from paddle_tpu_torch.models.seq2seq import make_fused_logits
from paddle_tpu_torch.ops.beam import greedy_token_chain
from paddle_tpu_torch.reader.feeder import DataFeeder
from paddle_tpu_torch.serving.pages import BlockPagedCache
from paddle_tpu_torch.utils import flags as _flags
from paddle_tpu_torch.utils.timers import global_stats

__all__ = ["ServingEngine"]

class _Slot:
    """One in-flight sequence: its pages and host-side decode state."""

    __slots__ = ("request", "pages", "enc_tokens", "last_id", "tokens", "max_new", "admit_seq")

    def __init__(self, request, pages, enc_tokens, last_id, tokens, max_new, admit_seq):
        self.request = request
        self.pages = pages
        self.enc_tokens = enc_tokens
        self.last_id = last_id
        self.tokens = tokens
        self.max_new = max_new
        self.admit_seq = admit_seq


class ServingEngine:
    """Continuous-batching greedy decode over a :class:`Seq2SeqGenerator`,
    on `device` (the card unless the caller asks for the CPU; the
    generator's device).  Single-threaded: one caller drives ``admit`` and
    ``step``.

    Requires the decoder to match the fused attention-GRU idiom: a
    topology that does not raises, as in the JAX package."""

    def __init__(
        self,
        generator,
        *,
        max_slots: Optional[int] = None,
        block_tokens: Optional[int] = None,
        hbm_budget_mb: Optional[float] = None,
        max_new_tokens: Optional[int] = None,
        block_steps: Optional[int] = None,
        prefill_chunk_tokens: Optional[int] = None,
        aot_cache_dir: Optional[str] = None,
        int8_weights: Optional[bool] = None,
        prefix_cache: Optional[bool] = None,
        spec_decode: Optional[bool] = None,
        clock=time.perf_counter,
        stats=None,
        device=None,
    ):
        # the JAX engine's options that are not ported yet
        for name, value, what in (
                ("prefill_chunk_tokens", prefill_chunk_tokens, "chunked prefill"),
                ("prefix_cache", prefix_cache, "the copy-on-write prefix cache"),
                ("spec_decode", spec_decode, "speculative decoding"),
                ("int8_weights", int8_weights, "int8 weights"),
                ("aot_cache_dir", aot_cache_dir, "the AOT cache")):
            if value:
                raise NotImplementedError(f"ServingEngine({name}=...): {what} is not ported yet")
        if generator._match is None or not _flags.get_flag("fused_attention_gru"):
            raise ValueError(
                "serving requires the fused attention-GRU decoder step "
                "(the topology did not match, or fused_attention_gru is off)")
        self.device = resolve_device(device)
        if self.device != generator.device:
            raise ValueError(f"the engine's device {self.device} is not the generator's "
                             f"{generator.device}")
        self._gen = generator
        self._clock = clock
        self._stats = stats if stats is not None else global_stats
        self.max_slots = max_slots if max_slots is not None else _flags.get_flag(
            "serving_max_slots")
        blk = block_tokens if block_tokens is not None else _flags.get_flag(
            "serving_block_tokens")
        if DEFAULT_LADDER[0] % blk != 0:
            raise ValueError(
                f"serving_block_tokens={blk} must divide the base ladder rung "
                f"{DEFAULT_LADDER[0]} so every padded source extent splits into whole blocks")
        budget_mb = hbm_budget_mb if hbm_budget_mb is not None else _flags.get_flag(
            "serving_hbm_budget_mb")
        self.default_max_new_tokens = (
            max_new_tokens if max_new_tokens is not None
            else _flags.get_flag("serving_max_new_tokens"))
        # every product's row count (see the module docstring)
        self.rows = ladder_len(self.max_slots, DEFAULT_BATCH_LADDER)
        # K tokens per dispatch: one host copy of the tokens covers K steps
        # of every live slot; finished rows re-emit EOS
        self.block_steps = max(1, int(block_steps if block_steps is not None
                                      else _flags.get_flag("serving_decode_block_steps")))

        # the fused decode weights, shared with the generator's stepping
        self._gp = generator.net.materialize_shared(
            tree_to(generator.params.params, self.device))
        self._state = tree_to(generator.params.state or {}, self.device)
        self._w = generator.fused_decode_weights(self._gp)
        self.weight_bytes = generator.decode_weight_bytes(self._gp)
        mt = generator._match
        self._acts = {"gate_act": mt.gate_act, "act": mt.act, "att_act": mt.att_act}
        self.hidden_dim = int(self._w["w_c"].shape[0])
        d_enc = int(self._w["w_ctx"].shape[0])
        d_ep = int(self._w["v"].shape[0])
        self._dtype = self._w["w_ctx"].dtype
        # which encoder outputs feed the two static placeholders
        pmap = dict(zip([p for p, _ in generator._static_info], ["enc", "enc_proj"]))
        self._enc_layer = pmap[mt.enc_name]
        self._ep_layer = pmap[mt.ep_name]

        # a feeder over the pruned encoder graph's one source slot, on the
        # ladder
        dts = generator._enc_net.topology.data_types()
        seq_slots = [n for n, it in dts if it.seq.name != "NONE"]
        if len(seq_slots) != 1:
            raise ValueError(f"serving expects one source sequence slot, got {seq_slots}")
        self.src_slot = seq_slots[0]
        self._feeder = DataFeeder(dts, ladder=DEFAULT_LADDER, min_seq_len=1, device=self.device)

        # the block-paged cache and its device pools (+1 scratch row each;
        # the slot plane has a scratch row too, for the padding rows' writes)
        self._pages = BlockPagedCache(
            blk, {"enc": d_enc, "ep": d_ep},
            hbm_budget_bytes=int(float(budget_mb) * (1 << 20)),
            dtype_bytes=self._dtype.itemsize, stats=self._stats)
        self.block_tokens = blk
        rows = self._pages.pool_rows
        self._enc_pool = torch.zeros((rows, blk, d_enc), dtype=self._dtype, device=self.device)
        self._ep_pool = torch.zeros((rows, blk, d_ep), dtype=self._dtype, device=self.device)
        self._h = torch.zeros((self.max_slots + 1, self.hidden_dim), dtype=self._dtype,
                              device=self.device)
        self._scratch_slot = self.max_slots
        # page-count rungs mirror the time ladder: P * block_tokens is a
        # DEFAULT_LADDER extent, the one the one-shot path pads to
        self._page_ladder = tuple(sorted({max(1, r // blk) for r in DEFAULT_LADDER}))

        self._slots: Dict[int, _Slot] = {}
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self._admit_seq = 0
        # shape variants, each with its dispatch count: prefill batch shapes
        # and decode (rows, page rung) pairs
        self.prefill_shapes: collections.Counter = collections.Counter()
        self.decode_shapes: collections.Counter = collections.Counter()

    # ------------------------------------------------------------------
    @property
    def n_live(self) -> int:
        return len(self._slots)

    @property
    def n_free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def pages(self) -> BlockPagedCache:
        return self._pages

    def outstanding_requests(self) -> List:
        """Every request holding a slot."""
        return [s.request for s in self._slots.values()]

    # -- cancellation ----------------------------------------------------
    def cancel(self, request) -> bool:
        """Release ``request``'s slot and pages without finishing it; True
        when the request held a slot here."""
        for sid, s in self._slots.items():
            if s.request is request:
                self._slots.pop(sid)
                self._release_slot_pages(s)
                self._free_slots.append(sid)
                self._stats.incr("serving/canceled")
                return True
        return False

    def cancel_by_id(self, req_id: str):
        """Cancel by ``req_id``; returns the released request, or None."""
        for s in list(self._slots.values()):
            if s.request.req_id == req_id:
                self.cancel(s.request)
                return s.request
        return None

    def _release_slot_pages(self, s: _Slot) -> None:
        """Retire, cancel and preempt release a slot's pages here."""
        self._pages.free(s.pages)

    # -- the two device programs -----------------------------------------
    def _prefill(self, batch, page_rows, slot_rows, boot_mask, h_override) -> None:
        """The encoder over an admitted group, its memory written into the
        pools at `page_rows` and the boot state (or a resumed slot's saved
        state) into the slot plane at `slot_rows`.  Padding rows write the
        scratch page and the scratch slot, which no live slot reads."""
        outs, _ = self._gen._enc_net.apply(self._gp, batch, state=self._state, train=False)
        enc = outs[self._enc_layer].data.to(self._dtype)  # [b, S, De]
        ep = outs[self._ep_layer].data.to(self._dtype)
        if self._w["sp_b"] is not None:
            ep = ep + self._w["sp_b"]  # the score-key bias folds in once
        boot = outs["dec_boot"].data.to(self._dtype)
        b, s = enc.shape[0], enc.shape[1]
        nb = s // self.block_tokens
        flat = page_rows.reshape(-1)
        self._enc_pool.index_copy_(0, flat, enc.reshape(b * nb, self.block_tokens, -1))
        self._ep_pool.index_copy_(0, flat, ep.reshape(b * nb, self.block_tokens, -1))
        self._h.index_copy_(0, slot_rows, torch.where(boot_mask[:, None], boot, h_override))

    def _decode(self, p_rung: int, meta: torch.Tensor):
        """`block_steps` greedy steps for the slot rows of `meta` ([rows,
        4 + p_rung] int32: slot, encoder length, last id, live, page table);
        returns the [rows, K] tokens and their log-probabilities.  Dead
        rows and finished rows re-emit EOS and keep their state."""
        eos = self._gen.eos_id
        slot_idx = meta[:, 0].long()
        enc_len = meta[:, 1]
        ids = meta[:, 2]
        live = meta[:, 3].bool()
        tables = meta[:, 4:].long()
        extent = p_rung * self.block_tokens
        h = self._h[slot_idx]
        enc = self._enc_pool[tables].reshape(self.rows, extent, -1)
        ep = self._ep_pool[tables].reshape(self.rows, extent, -1)
        emask = torch.arange(extent, device=self.device)[None, :] < enc_len[:, None]
        step = make_fused_logits(self._w, enc, ep, emask, **self._acts)
        fin = torch.zeros((self.rows,), dtype=torch.bool, device=self.device)
        toks, logps = [], []
        for _ in range(self.block_steps):
            logits, h_t = step(ids, h)
            # the one-shot greedy chain, for identical tokens
            logp, nxt = greedy_token_chain(logits)
            logps.append(torch.gather(logp, 1, nxt[:, None].long())[:, 0])
            dead = fin | ~live
            ids = torch.where(dead, eos, nxt).to(torch.int32)
            h = torch.where(dead[:, None], h, h_t)
            fin = fin | (ids == eos)
            toks.append(ids)
        self._h.index_copy_(0, slot_idx, h)
        return torch.stack(toks, dim=1), torch.stack(logps, dim=1)

    # -- admission -------------------------------------------------------
    def admit(self, requests: Sequence) -> List:
        """Admit a FIFO prefix of ``requests`` (a free slot and pages for
        each; the first misfit stops admission, strict FCFS) and prefill
        them, one bucketed batch per source rung.  A preempted request
        resumes from its saved state.  Returns the admitted requests in
        order."""
        beams = [r.req_id for r in requests if int(getattr(r, "beam_size", None) or 0) > 1]
        if beams:
            raise NotImplementedError(
                f"per-request beam serving (Request.beam_size > 1; requests {beams}) "
                "is not ported yet")
        admitted = []
        for r in requests:
            if not self._free_slots:
                break
            pages = self._pages.alloc(self._pages.pages_for_tokens(len(r.src_ids)))
            if pages is None:
                break
            sid = self._free_slots.pop()
            resume = r._resume
            self._slots[sid] = _Slot(
                request=r, pages=pages, enc_tokens=len(r.src_ids),
                last_id=resume["last_id"] if resume is not None else self._gen.bos_id,
                tokens=list(resume["tokens"]) if resume is not None else [],
                max_new=min(r.max_new_tokens or self.default_max_new_tokens,
                            self._gen.max_length),
                admit_seq=self._admit_seq)
            self._admit_seq += 1
            admitted.append((sid, r, pages))
        if not admitted:
            return []
        self._stats.incr("serving/admitted", len(admitted))
        by_rung: Dict[int, list] = {}
        for entry in admitted:
            by_rung.setdefault(ladder_len(len(entry[1].src_ids), DEFAULT_LADDER), []).append(entry)
        for group in by_rung.values():
            self._prefill_group(group)
        now = self._clock()
        for _, r, _ in admitted:
            r.t_admit = now
        return [r for _, r, _ in admitted]

    def _prefill_group(self, group) -> None:
        """One prefill dispatch over (slot, request, pages) entries whose
        sources share a ladder rung, padded to ``rows`` rows."""
        batch = pad_batch_rows(self._feeder([(list(r.src_ids),) for _, r, _ in group]), self.rows)
        nb = batch[self.src_slot].data.shape[1] // self.block_tokens
        page_rows = np.full((self.rows, nb), self._pages.scratch, np.int64)
        slot_rows = np.full((self.rows,), self._scratch_slot, np.int64)
        boot_mask = np.zeros((self.rows,), bool)
        h_override = torch.zeros((self.rows, self.hidden_dim), dtype=self._dtype,
                                 device=self.device)
        for k, (sid, r, pages) in enumerate(group):
            page_rows[k, : len(pages)] = pages
            slot_rows[k] = sid
            if r._resume is None:
                boot_mask[k] = True
            else:
                h_override[k] = r._resume["h"]
                r._resume = None
        self.prefill_shapes[batch_shape_key(batch)] += 1
        with torch.no_grad():
            self._prefill(batch, self._to_device(page_rows), self._to_device(slot_rows),
                          self._to_device(boot_mask), h_override)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # -- decode ----------------------------------------------------------
    def step(self) -> List:
        """One decode dispatch (``block_steps`` tokens) for every live slot;
        returns the requests that finished (EOS emitted or their
        ``max_new_tokens`` reached), their pages freed and slots recycled."""
        if not self._slots:
            return []
        live_ids = sorted(self._slots)
        p_rung = ladder_len(max(len(self._slots[s].pages) for s in live_ids), self._page_ladder)
        # one host-to-device copy: slot, encoder length, last id, live, pages
        meta = np.zeros((self.rows, 4 + p_rung), np.int32)
        meta[:, 0] = self._scratch_slot
        meta[:, 2] = self._gen.eos_id
        meta[:, 4:] = self._pages.scratch
        for k, sid in enumerate(live_ids):
            s = self._slots[sid]
            meta[k, :4] = (sid, s.enc_tokens, s.last_id, 1)
            meta[k, 4:4 + len(s.pages)] = s.pages
        self.decode_shapes[(self.rows, p_rung)] += 1
        with torch.no_grad():
            toks, logps = self._decode(p_rung, self._to_device(meta))
        toks_host = toks.cpu().numpy()  # [B, K]: one host sync per K tokens
        logps_host = logps.cpu().numpy()
        now = self._clock()
        finished = []
        for k, sid in enumerate(live_ids):
            s = self._slots[sid]
            r = s.request
            if r.t_first_token is None:
                r.t_first_token = now
            done = False
            for tok, lp in zip(toks_host[k].tolist(), logps_host[k].tolist()):
                if tok == self._gen.eos_id:
                    done = True
                    break
                s.tokens.append(tok)
                s.last_id = tok
                r.token_times.append(now)
                r.token_logprobs.append(lp)
                if len(s.tokens) >= s.max_new:
                    done = True
                    break
            if done:
                finished.append(self._retire(sid))
        self._stats.incr("serving/decode_steps")
        return finished

    def _retire(self, sid: int):
        s = self._slots.pop(sid)
        self._release_slot_pages(s)
        self._free_slots.append(sid)
        s.request.tokens = s.tokens
        self._stats.incr("serving/completed")
        return s.request

    # -- preemption ------------------------------------------------------
    def preempt(self):
        """Evict the newest-admitted live sequence (the least progress
        lost): free its pages, save its GRU state and generated prefix on
        the request and hand it back for re-queueing.  Re-admission re-runs
        prefill and restores the saved state, so its tokens equal an
        uninterrupted decode's.  Returns the request, or None when nothing
        is live."""
        if not self._slots:
            return None
        sid = max(self._slots, key=lambda s: self._slots[s].admit_seq)
        s = self._slots.pop(sid)
        self._release_slot_pages(s)
        self._free_slots.append(sid)
        s.request._resume = {"h": self._h[sid].clone(), "last_id": s.last_id,
                             "tokens": list(s.tokens)}
        self._stats.incr("serving/preempted")
        return s.request

    # -- the one-shot reference path --------------------------------------
    def reference_decode(self, src_ids, max_new_tokens: Optional[int] = None) -> List[int]:
        """The one-shot ``Seq2SeqGenerator.generate_greedy`` path for one
        request, through the same ladder feeder, padded to ``rows`` rows (see
        the module docstring): the golden the engine's tokens are held to."""
        mx = max_new_tokens if max_new_tokens is not None else self.default_max_new_tokens
        batch = pad_batch_rows(self._feeder([(list(src_ids),)]), self.rows)
        toks, lengths = self._gen.generate_greedy(batch, max_new_tokens=mx)
        n = int(lengths[0])
        return [int(t) for t in toks[0, :n].tolist()]

    def slots_per_gb(self, src_tokens: Optional[int] = None) -> float:
        """Concurrent decode slots one GB holds after the resident weight
        bundle, at the footprint of a ``src_tokens``-token source (default
        one page)."""
        pages = self._pages.pages_for_tokens(src_tokens) if src_tokens is not None else 1
        per_slot = pages * self._pages.bytes_per_block + self.hidden_dim * self._dtype.itemsize
        return max((1 << 30) - self.weight_bytes, 0) / float(per_slot)

    def summary(self) -> Dict[str, Any]:
        return {
            "live": self.n_live,
            "free_slots": self.n_free_slots,
            "pages": self._pages.summary(),
            "prefill_shapes": len(self.prefill_shapes),
            "decode_shapes": len(self.decode_shapes),
            "weight_bytes": self.weight_bytes,
            "slots_per_gb": self.slots_per_gb(),
        }
