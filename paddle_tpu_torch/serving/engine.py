"""Paged decode engine — the counterpart of ``paddle_tpu/serving/engine.py``:
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
prefill's batch shapes), so the variants stay bounded by the ladders;
``trace_counts`` counts the dispatches of each program family under the JAX
package's keys (``prefill``, ``decode``, ``prefill_chunk``, ``verify``,
``beam``).

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

The four arms keep that rule:

* **chunked prefill** (``prefill_chunk_tokens``): a prompt whose padded
  extent exceeds the chunk bound prefills one chunk of one GRU direction
  per :meth:`ServingEngine.step` (the forward direction's chunks left to
  right, then the reversed direction's right to left, each from the carried
  state), so a decode waits for one chunk, not a whole prompt.  The
  request runs in row 0 of ``rows`` rows: the first chunk dispatch computes
  the embedding and both directions' gate projections over the whole
  padded prompt through the encoder network itself (the one-shot M), each
  chunk runs the GRU core's steps of its span at M = ``rows`` over the
  same live range and mask as the unsplit scan, and the last chunk runs
  the encoder's concat, projection and boot layers over the whole prompt
  (the one-shot M again) and writes the pages and the boot state.
* **copy-on-write prefix cache** (``prefix_cache``): a retired prompt's
  pages and boot state (a clone) park in a cache keyed on a signature-
  seeded block hash chain; a request whose whole prompt matches maps the
  same blocks (refcount + 1) and makes no prefill dispatch.  Writes into a
  shared block go through :meth:`ServingEngine.ensure_private_pages`;
  chunked prefills resume their forward pass from cached carries.
* **speculative decoding** (``spec_decode``): an n-gram draft of K tokens
  is verified in one dispatch of K teacher-forced steps, each step's input
  projection at M = ``rows`` as in the greedy decode; the emitted tokens
  are the greedy chain's, ``n_emit = min(m + 1, K)``.
* **beam serving** (``Request.beam_size > 1``): one whole-sequence dispatch
  of ``ops/beam.py``'s search over the gathered pages, the request padded
  to ``rows`` rows (``rows * k`` beam rows), as the one-shot ``generate``
  runs it (:meth:`ServingEngine.reference_beam`).

**int8 weights** (``int8_weights``): the resident decode bundle holds int8
blocks and f32 scales (``ops/quantize.py``); every dispatch dequantizes it
with torch ops.

Not ported: the AOT cache (``aot_cache_dir``, ROADMAP Queue 1 item 7)
raises ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import obs as _obs
from paddle_tpu_torch.core.aot_cache import topology_fingerprint
from paddle_tpu_torch.core.batch import (
    DEFAULT_BATCH_LADDER,
    DEFAULT_LADDER,
    SeqTensor,
    batch_shape_key,
    ladder_len,
    pad_batch_rows,
)
from paddle_tpu_torch.core.device import resolve_device, tree_to
from paddle_tpu_torch.models.seq2seq import make_fused_logits, make_fused_step
from paddle_tpu_torch.ops import quantize as _bsq
from paddle_tpu_torch.ops.beam import beam_search, greedy_token_chain
from paddle_tpu_torch.ops.rnn import GruCore, _mask_seq, live_range
from paddle_tpu_torch.reader.feeder import DataFeeder
from paddle_tpu_torch.serving.pages import BlockPagedCache
from paddle_tpu_torch.utils import flags as _flags
from paddle_tpu_torch.utils.timers import global_stats

__all__ = ["ServingEngine"]


class _Slot:
    """One in-flight sequence: its pages and host-side decode state.
    ``beam`` > 0 routes it through the beam dispatch; ``boot_h`` is a clone
    of its decoder boot state (prefix cache on, clean prefill), which
    becomes the cache entry's state when it retires."""

    __slots__ = ("request", "pages", "enc_tokens", "last_id", "tokens", "max_new", "admit_seq",
                 "beam", "boot_h")

    def __init__(self, request, pages, enc_tokens, last_id, tokens, max_new, admit_seq,
                 beam=0, boot_h=None):
        self.request = request
        self.pages = pages
        self.enc_tokens = enc_tokens
        self.last_id = last_id
        self.tokens = tokens
        self.max_new = max_new
        self.admit_seq = admit_seq
        self.beam = beam
        self.boot_h = boot_h


class _PendingPrefill:
    """One long prompt in chunked prefill: its slot and pages are held; the
    padded batch, the gate projections (made by its first chunk dispatch),
    the carried GRU state and each chunk's outputs live here until the
    last chunk writes the pages, then the slot goes live."""

    __slots__ = ("request", "pages", "enc_tokens", "max_new", "admit_seq", "batch", "ids",
                 "true_len", "s_pad", "rows", "n_chunks", "phase", "cursor", "h", "xs",
                 "fw_chunks", "bw_chunks", "resume")

    def __init__(self, request, pages, enc_tokens, max_new, admit_seq, batch, ids, true_len,
                 s_pad, rows, n_chunks, resume):
        self.request = request
        self.pages = pages
        self.enc_tokens = enc_tokens
        self.max_new = max_new
        self.admit_seq = admit_seq
        self.batch = batch  # the feeder batch padded to the engine's rows
        self.ids = ids  # host copy of the padded source ids [S_pad]
        self.true_len = true_len
        self.s_pad = s_pad
        self.rows = rows  # [S_pad // block_tokens] page ids, scratch past the pages
        self.n_chunks = n_chunks
        self.phase = "fw"  # "fw" then "bw"
        self.cursor = 0  # next chunk (fw ascends; bw descends in source time)
        self.h = None  # carried GRU state [rows, H]
        self.xs = None  # per direction: (time-major gates, mask, live range)
        self.fw_chunks: List[Optional[torch.Tensor]] = [None] * n_chunks  # [C, rows, H]
        self.bw_chunks: List[Optional[torch.Tensor]] = [None] * n_chunks
        self.resume = resume  # preemption save-state or None


class ServingEngine:
    """Continuous-batching decode over a :class:`Seq2SeqGenerator`, on
    `device` (the card unless the caller asks for the CPU; the generator's
    device).  Single-threaded: one caller (the scheduler's step thread, or
    a test) drives ``admit`` and ``step``.

    Requires the decoder to match the fused attention-GRU idiom, and with
    chunked prefill the encoder to match the bi-GRU idiom: a topology that
    does not raises when the engine is built, as in the JAX package."""

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
        spec_ngram: Optional[int] = None,
        clock=time.perf_counter,
        stats=None,
        device=None,
    ):
        if aot_cache_dir:
            raise NotImplementedError(
                "ServingEngine(aot_cache_dir=...): the AOT cache is not ported yet "
                "(ROADMAP Queue 1 item 7)")
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
        # weight-only int8: the resident bundle holds int8 blocks and f32
        # scales, dequantized at the top of every dispatch; biases and
        # vectors (and sp_b, folded at prefill) stay f32
        self.int8_weights = bool(int8_weights if int8_weights is not None
                                 else _flags.get_flag("serving_int8_weights"))
        self._w_meta: Dict[str, Any] = {}
        if self.int8_weights:
            self._w_arg, self._w_meta = _bsq.quantize_weight_bundle(self._w)
        else:
            self._w_arg = self._w
        self.weight_bytes = _bsq.weight_bundle_bytes(self._w_arg)
        mt = generator._match
        self._acts = {"gate_act": mt.gate_act, "act": mt.act, "att_act": mt.att_act}
        self.hidden_dim = int(self._w["w_c"].shape[0])
        self.trg_vocab = int(self._w["head_w"].shape[1])
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
        self.src_vocab = int(dict(dts)[self.src_slot].dim)
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
        self._prefilling: Dict[int, _PendingPrefill] = {}
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self._admit_seq = 0

        # -- copy-on-write prefix cache ------------------------------------
        # Whole-prompt entries only: the reversed GRU makes every encoded
        # position depend on the prompt's suffix.  The key chains per-block
        # hashes seeded by the engine's signature, and the stored token
        # tuple turns a hash collision into a miss.
        self.prefix_cache_enabled = bool(
            prefix_cache if prefix_cache is not None
            else _flags.get_flag("serving_prefix_cache"))
        self._cache_sig = (topology_fingerprint(generator.net), str(self._dtype), self.src_slot,
                           self.src_vocab, int(generator.bos_id), int(generator.eos_id),
                           self.int8_weights)
        self._cache_sig_hash = hash(self._cache_sig)
        self._prefix_cache: Dict[tuple, Dict[str, Any]] = {}
        self._prefix_owner: Dict[int, tuple] = {}
        self._pages.on_evict = self._on_block_evicted
        self.prefix_hits = 0
        self.prefix_misses = 0
        # forward-GRU carries of chunked prefills: (signature, padded extent,
        # chunk-aligned prefix) -> carried state and chunk outputs, a
        # bounded LRU; the tensors are never written in place
        self._fw_cache: "OrderedDict[tuple, Dict[str, Any]]" = OrderedDict()
        self._fw_cache_cap = 8

        # -- speculative decoding ------------------------------------------
        self.spec_decode = bool(spec_decode if spec_decode is not None
                                else _flags.get_flag("serving_spec_decode"))
        self.spec_ngram = max(1, int(spec_ngram if spec_ngram is not None
                                     else _flags.get_flag("serving_spec_ngram")))
        self.spec_proposed = 0
        self.spec_accepted = 0

        # -- chunked prefill: the chunk bound against the block size and the
        # ladder, then the encoder idiom (an unmatched topology fails here)
        pc = (prefill_chunk_tokens if prefill_chunk_tokens is not None
              else _flags.get_flag("serving_prefill_chunk_tokens"))
        self.prefill_chunk_tokens = max(0, int(pc))
        self._enc_spec = None
        if self.prefill_chunk_tokens:
            c = self.prefill_chunk_tokens
            if c % blk != 0:
                raise ValueError(f"serving_prefill_chunk_tokens={c} must be a multiple "
                                 f"of serving_block_tokens={blk}")
            bad = [r for r in DEFAULT_LADDER if r > c and r % c != 0]
            if bad:
                raise ValueError(f"serving_prefill_chunk_tokens={c} must divide every "
                                 f"taller shape-ladder rung; {bad} are not multiples")
            self._enc_spec = self._encoder_idiom()

        # shape variants, each with its dispatch count: prefill batch shapes,
        # decode and verify (rows, page rung) pairs, beam (page rung, width,
        # length) triples
        self.prefill_shapes: collections.Counter = collections.Counter()
        self.decode_shapes: collections.Counter = collections.Counter()
        self.verify_shapes: collections.Counter = collections.Counter()
        self.beam_shapes: collections.Counter = collections.Counter()
        # dispatches per program family, under the JAX package's keys
        self.trace_counts = {"prefill": 0, "decode": 0, "prefill_chunk": 0, "verify": 0,
                             "beam": 0}

    # ------------------------------------------------------------------
    @property
    def n_live(self) -> int:
        return len(self._slots)

    @property
    def n_prefilling(self) -> int:
        """Slots held by chunked prefills still running their prompt."""
        return len(self._prefilling)

    @property
    def n_free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def pages(self) -> BlockPagedCache:
        return self._pages

    @property
    def shape_variants(self) -> int:
        """Distinct dispatch shapes seen so far: a step that adds one pays a
        first-run warm-up (the scheduler leaves it out of its service-time
        estimate)."""
        return (len(self.prefill_shapes) + len(self.decode_shapes) + len(self.verify_shapes)
                + len(self.beam_shapes))

    def max_src_tokens(self) -> int:
        """Longest admissible source: its pages must fit the whole pool."""
        return self._pages.n_blocks * self.block_tokens

    def outstanding_requests(self) -> List:
        """Every request holding a slot (live decode or chunked prefill)."""
        return ([s.request for s in self._slots.values()]
                + [p.request for p in self._prefilling.values()])

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
        for sid, p in self._prefilling.items():
            if p.request is request:
                # a chunked prefill's pages are partly written: never cached
                self._prefilling.pop(sid)
                self._pages.free(p.pages)
                self._free_slots.append(sid)
                self._stats.incr("serving/canceled")
                return True
        return False

    def cancel_by_id(self, req_id: str):
        """Cancel by ``req_id``; returns the released request, or None."""
        for r in self.outstanding_requests():
            if r.req_id == req_id:
                self.cancel(r)
                return r
        return None

    # -- copy-on-write prefix cache ---------------------------------------
    def _prefix_key(self, tokens) -> tuple:
        """A whole prompt's key: the per-block hash chain seeded by the
        engine's signature (topology fingerprint, dtype, source slot and
        vocabulary, special ids, weight precision), so engines that
        tokenize or compute differently never share an entry."""
        h = self._cache_sig_hash
        toks = [int(t) for t in tokens]
        for i in range(0, len(toks), self.block_tokens):
            h = hash((h, tuple(toks[i:i + self.block_tokens])))
        return (h, len(toks))

    def _prefix_lookup(self, src):
        """(key, entry) when the whole prompt is cached, else None; the
        stored token tuple is compared on every hit."""
        key = self._prefix_key(src)
        ent = self._prefix_cache.get(key)
        if ent is None or ent["tokens"] != tuple(int(t) for t in src):
            return None
        return key, ent

    def _release_slot_pages(self, s: _Slot) -> None:
        """Retire, cancel and preempt release a slot's pages here, the
        prefix cache's insertion point: a slot whose pages are the cache
        entry releases them with retain (refcount-0 blocks park in the
        LRU pool); a slot with a captured boot state and no entry yet
        inserts one; anything else frees."""
        if not self.prefix_cache_enabled:
            self._pages.free(s.pages)
            return
        key = self._prefix_key(s.request.src_ids)
        ent = self._prefix_cache.get(key)
        if ent is not None and list(ent["pages"]) == list(s.pages):
            self._pages.release(s.pages, retain=True)
            return
        if ent is None and s.boot_h is not None:
            self._prefix_cache[key] = {
                "tokens": tuple(int(t) for t in s.request.src_ids),
                "pages": list(s.pages),
                "boot_h": s.boot_h,
                "enc_tokens": s.enc_tokens,
            }
            for p in s.pages:
                self._prefix_owner[p] = key
            self._pages.release(s.pages, retain=True)
            self._stats.incr("serving/prefix_inserted")
            return
        self._pages.free(s.pages)

    def _on_block_evicted(self, block: int) -> None:
        """The allocator reclaimed a retained block: drop its whole entry,
        so a later hit never maps a half-evicted prompt."""
        key = self._prefix_owner.pop(block, None)
        if key is None:
            return
        ent = self._prefix_cache.pop(key, None)
        if ent is not None:
            for p in ent["pages"]:
                self._prefix_owner.pop(p, None)
            self._stats.incr("serving/prefix_evicted")

    def ensure_private_pages(self, s: _Slot) -> bool:
        """The copy-on-write barrier before any write into a slot's encoder
        pages: each block the slot shares (refcount >= 2) is swapped for a
        private copy, the pool rows copied before the page table is
        remapped.  False when there are no blocks for the copies (the
        caller waits; nothing changed).  Decode, verify and beam only read
        the pools, so shared pages are safe while decoding."""
        if all(self._pages.refcount(p) == 1 for p in s.pages):
            return True
        new_pages, copies = self._pages.cow(s.pages)
        if new_pages is None:
            return False
        src = self._to_device(np.asarray([a for a, _ in copies], np.int64))
        dst = self._to_device(np.asarray([b for _, b in copies], np.int64))
        self._enc_pool.index_copy_(0, dst, self._enc_pool.index_select(0, src))
        self._ep_pool.index_copy_(0, dst, self._ep_pool.index_select(0, src))
        s.pages = new_pages
        self._stats.incr("serving/cow_copies", len(copies))
        return True

    @property
    def prefix_cache_len(self) -> int:
        return len(self._prefix_cache)

    def spec_accept_rate(self) -> float:
        """Share of drafted tokens the target confirmed (0.0 before any
        speculative dispatch)."""
        if not self.spec_proposed:
            return 0.0
        return self.spec_accepted / float(self.spec_proposed)

    # -- chunked prefill: the encoder idiom ---------------------------------
    def _encoder_idiom(self) -> Dict[str, Any]:
        """The layer names of the bi-GRU encoder idiom (embedding ->
        per-direction gate fc -> gru / reversed gru -> concat -> identity
        projection fc; boot = fc over first_seq(enc)), which the chunk
        dispatches run through the encoder network (the JAX package's
        ``_extract_encoder_weights`` matches the same idiom); a topology
        outside it, or a compute dtype other than f32, raises."""
        net = self._gen._enc_net
        topo = net.topology
        if net.compute_dtype != torch.float32:
            raise ValueError("chunked prefill runs the encoder in f32; the encoder's "
                             f"compute dtype is {net.compute_dtype}")

        def conf(name):
            return topo.layers[name]

        enc_c = conf(self._enc_layer)
        if enc_c.type != "concat" or len(enc_c.inputs) != 2:
            raise ValueError("chunked prefill requires enc = concat(fwd GRU, bwd GRU); "
                             f"got {enc_c.type} over {enc_c.inputs}")
        dirs: Dict[str, Tuple[str, str]] = {}
        emb_name = None
        for gname in enc_c.inputs:
            g = conf(gname)
            if g.type != "gru":
                raise ValueError(f"chunked prefill: encoder branch {gname} is {g.type}, "
                                 "expected a fused grumemory")
            t = conf(g.inputs[0])
            if t.type != "fc" or len(t.inputs) != 1:
                raise ValueError(f"chunked prefill: gate projection {g.inputs[0]} must "
                                 "be a single-input fc")
            e = conf(t.inputs[0])
            if e.type != "embedding":
                raise ValueError(f"chunked prefill: encoder input {t.inputs[0]} must be "
                                 "an embedding")
            if emb_name is None:
                emb_name = e.name
            elif emb_name != e.name:
                raise ValueError("chunked prefill: both GRU directions must share one "
                                 "source embedding")
            key = "bw" if g.attr("reverse", False) else "fw"
            if key in dirs:
                raise ValueError("chunked prefill: expected one forward and one "
                                 "reversed GRU direction")
            dirs[key] = (gname, t.name)
        if set(dirs) != {"fw", "bw"}:
            raise ValueError("chunked prefill: encoder must pair a forward and a reversed GRU")
        ep_c = conf(self._ep_layer)
        if (ep_c.type != "fc" or tuple(ep_c.inputs) != (enc_c.name,)
                or ep_c.act not in ("identity", "linear", "")):
            raise ValueError("chunked prefill: encoded projection must be an identity "
                             f"fc over {enc_c.name}")
        boot_names = [n for n in topo.output_names if n not in (self._enc_layer, self._ep_layer)]
        if len(boot_names) != 1:
            raise ValueError(f"chunked prefill: expected one boot output, got {boot_names}")
        boot_c = conf(boot_names[0])
        first_c = conf(boot_c.inputs[0]) if boot_c.inputs else None
        if (boot_c.type != "fc" or first_c is None or first_c.type != "seqlastins"
                or not first_c.attr("select_first", False)
                or tuple(first_c.inputs) != (enc_c.name,)):
            raise ValueError("chunked prefill: decoder boot must be fc(first_seq(enc))")
        return {
            "dirs": dirs,
            "head": {self.src_slot, emb_name, dirs["fw"][1], dirs["bw"][1]},
            "tail": {enc_c.name, ep_c.name, first_c.name, boot_c.name},
        }

    def _chunk_gates(self, p: _PendingPrefill) -> None:
        """The first chunk dispatch's prologue: the embedding and both gate
        projections over the whole padded prompt (the encoder network's
        own layers, at the one-shot M), then each direction's time-major
        inputs, mask and live range as ``ops/rnn.py`` ``gru_scan`` forms
        them."""
        net = self._gen._enc_net
        outs, _ = net.apply(self._gp, p.batch, state=self._state, train=False,
                            only=self._enc_spec["head"])
        p.xs = {}
        for key, (gname, tname) in self._enc_spec["dirs"].items():
            gates_in = outs[tname]
            params, (x,) = net.resolve_layer_call(gname, self._gp, [gates_in])
            conf = net.topology.layers[gname]
            reverse = key == "bw"
            t = x.data.shape[1]
            xs = x.data.transpose(0, 1)
            if params.get("b") is not None:
                xs = xs + params["b"]
            if reverse:
                xs = xs.flip(0)
            mask = _mask_seq(x.lengths, t, reverse)
            if mask is None:
                mask = torch.ones((t, x.data.shape[0], 1), dtype=torch.bool, device=self.device)
            acts = (conf.attr("gate_act", "sigmoid"), conf.attr("active_type", conf.act or "tanh"))
            p.xs[key] = (xs, mask, live_range(x.lengths, t, reverse), params, acts)

    def _chunk_run(self, p: _PendingPrefill, key: str, k: int) -> torch.Tensor:
        """Steps of chunk `k` (in the direction's own time order) of the GRU
        core from the carried state, over the unsplit scan's live range:
        the chunk's [C, rows, H] outputs; the carried state moves on."""
        xs, mask, (lo, hi), params, acts = p.xs[key]
        c = self.prefill_chunk_tokens
        a = k * c
        lo_k = min(max(lo - a, 0), c)
        hi_k = max(min(hi - a, c), lo_k)
        hs, p.h = GruCore.apply(xs[a:a + c], params["w_h"], params["w_c"], p.h, mask[a:a + c],
                                acts, lo_k, hi_k)
        return hs

    def _chunk_finish(self, sid: int, p: _PendingPrefill) -> None:
        """The last chunk dispatch's epilogue: the concat, projection and
        boot layers over the whole prompt (the encoder network's own
        layers), the pages written and the boot (or resumed) state too."""
        net = self._gen._enc_net
        lengths = p.batch[self.src_slot].lengths
        fw = torch.cat(p.fw_chunks).transpose(0, 1)
        bw = torch.cat(p.bw_chunks).flip(0).transpose(0, 1)
        dirs = self._enc_spec["dirs"]
        outs, _ = net.apply(self._gp, p.batch, state=self._state, train=False,
                            only=self._enc_spec["tail"],
                            preset={dirs["fw"][0]: SeqTensor(fw, lengths),
                                    dirs["bw"][0]: SeqTensor(bw, lengths)})
        enc = outs[self._enc_layer].data.to(self._dtype)[:1]
        ep = outs[self._ep_layer].data.to(self._dtype)[:1]
        if self._w["sp_b"] is not None:
            ep = ep + self._w["sp_b"]
        nb = p.s_pad // self.block_tokens
        rows = self._to_device(p.rows.astype(np.int64))
        self._enc_pool.index_copy_(0, rows, enc.reshape(nb, self.block_tokens, -1))
        self._ep_pool.index_copy_(0, rows, ep.reshape(nb, self.block_tokens, -1))
        if p.resume is None:
            h_row = outs["dec_boot"].data.to(self._dtype)[0]
        else:
            h_row = p.resume["h"]
        self._h[sid] = h_row

    # -- the device programs ----------------------------------------------
    def _weights(self) -> Dict[str, Any]:
        """The decode bundle of this dispatch: the resident one, or its
        int8 blocks dequantized."""
        if self._w_meta:
            return _bsq.dequantize_weight_bundle(self._w_arg, self._w_meta)
        return self._w

    def _prefill(self, batch, page_rows, slot_rows, boot_mask, h_override) -> None:
        """The encoder over an admitted group, its memory written into the
        pools at `page_rows` and the boot state (or a resumed slot's saved
        state) into the slot plane at `slot_rows`.  Padding rows write the
        scratch page and the scratch slot, which no live slot reads."""
        self.trace_counts["prefill"] += 1
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

    def _gather(self, p_rung: int, meta: torch.Tensor):
        """(state, encoder memory, projected keys, mask) of the slot rows of
        `meta` ([rows, 4 + p_rung] int32: slot, encoder length, last id,
        live, page table), gathered through the page table."""
        slot_idx = meta[:, 0].long()
        enc_len = meta[:, 1]
        tables = meta[:, 4:].long()
        extent = p_rung * self.block_tokens
        n = meta.shape[0]
        enc = self._enc_pool[tables].reshape(n, extent, -1)
        ep = self._ep_pool[tables].reshape(n, extent, -1)
        emask = torch.arange(extent, device=self.device)[None, :] < enc_len[:, None]
        return self._h[slot_idx], enc, ep, emask

    def _decode(self, p_rung: int, meta: torch.Tensor):
        """`block_steps` greedy steps for the slot rows of `meta`; returns
        the [rows, K] tokens and their log-probabilities.  Dead rows and
        finished rows re-emit EOS and keep their state."""
        self.trace_counts["decode"] += 1
        eos = self._gen.eos_id
        ids = meta[:, 2]
        live = meta[:, 3].bool()
        h, enc, ep, emask = self._gather(p_rung, meta)
        step = make_fused_logits(self._weights(), enc, ep, emask, **self._acts)
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
        self._h.index_copy_(0, meta[:, 0].long(), h)
        return torch.stack(toks, dim=1), torch.stack(logps, dim=1)

    def _verify(self, p_rung: int, meta: torch.Tensor, draft: torch.Tensor):
        """The speculative verify: `block_steps` steps whose inputs are the
        last token and the draft (step j consumes ``draft[j - 1]``), each
        through the greedy decode's step at M = ``rows``.  With ``m`` the
        leading positions where the target's argmax agreed with the draft,
        steps 0..m consumed the greedy chain's own context, so ``n_emit =
        min(m + 1, K)`` tokens per row are the greedy chain's; dead rows
        emit 0 and keep their state.  Returns (tokens, log-probabilities,
        n_emit, m), each row's state left after its last emitted step."""
        self.trace_counts["verify"] += 1
        ids = meta[:, 2]
        live = meta[:, 3].bool()
        h, enc, ep, emask = self._gather(p_rung, meta)
        step = make_fused_logits(self._weights(), enc, ep, emask, **self._acts)
        toks, logps, hs = [], [], []
        h_t = h
        for j in range(self.block_steps):
            inp = ids if j == 0 else draft[:, j - 1]
            logits, h_t = step(inp, h_t)
            logp, nxt = greedy_token_chain(logits)
            logps.append(torch.gather(logp, 1, nxt[:, None].long())[:, 0])
            toks.append(nxt.to(torch.int32))
            hs.append(h_t)
        toks_t = torch.stack(toks, dim=1)  # [B, K]
        match = torch.cumprod((toks_t == draft).to(torch.int32), dim=1)
        m_full = match.sum(dim=1)
        n_emit = torch.clamp(m_full + 1, max=self.block_steps)
        hs_t = torch.stack(hs, dim=1)  # [B, K, H]
        h_sel = hs_t[torch.arange(self.rows, device=self.device), n_emit - 1]
        self._h.index_copy_(0, meta[:, 0].long(), torch.where(live[:, None], h_sel, h))
        n_emit = torch.where(live, n_emit, torch.zeros_like(n_emit))
        return toks_t, torch.stack(logps, dim=1), n_emit, m_full

    def _beam(self, p_rung: int, meta: torch.Tensor, beam_k: int, max_new: int):
        """The whole-sequence beam dispatch of row 0 of `meta` (the other
        rows pad as the one-shot path's batch does): ``ops/beam.py``'s
        search over the fused step the one-shot ``generate`` uses, from the
        slot's boot state, on ``rows * beam_k`` beam rows."""
        self.trace_counts["beam"] += 1
        gen = self._gen
        h, enc, ep, emask = self._gather(p_rung, meta)
        fused = make_fused_step(
            self._weights(), torch.repeat_interleave(enc, beam_k, dim=0),
            torch.repeat_interleave(ep, beam_k, dim=0),
            torch.repeat_interleave(emask, beam_k, dim=0), **self._acts)

        def step_fn(step_ids, carry):
            logp, h_t = fused(step_ids, carry["h"])
            return logp, {"h": h_t}

        return beam_search(step_fn, {"h": h}, batch_size=self.rows, beam_size=beam_k,
                           vocab_size=self.trg_vocab, bos_id=gen.bos_id, eos_id=gen.eos_id,
                           max_len=max_new, candidate_adjust_fn=gen.candidate_adjust_fn,
                           drop_fn=gen.drop_fn, norm_fn=gen.norm_fn)

    # -- admission -------------------------------------------------------
    def _max_new(self, r) -> int:
        return min(r.max_new_tokens or self.default_max_new_tokens, self._gen.max_length)

    @staticmethod
    def _beam_of(r) -> int:
        k = int(getattr(r, "beam_size", None) or 0)
        return k if k > 1 else 0  # a beam of one is the greedy loop

    def _chunked_extent(self, src_len: int) -> Optional[int]:
        """The padded extent when a ``src_len``-token prompt takes the
        chunked path (its rung exceeds the chunk bound), else None."""
        if not self.prefill_chunk_tokens:
            return None
        s_pad = ladder_len(src_len, DEFAULT_LADDER)
        return s_pad if s_pad > self.prefill_chunk_tokens else None

    def _admit_chunked(self, r, sid: int, pages, s_pad: int) -> None:
        """Register one long prompt for chunk-at-a-time prefill, behind any
        already in flight; with the prefix cache on, resume its forward
        pass at the longest cached chunk boundary inside its true length
        (forward carries depend on the prefix only; the reversed pass reads
        the suffix and always runs)."""
        batch = pad_batch_rows(self._feeder([(list(r.src_ids),)]), self.rows)
        rows = np.full((s_pad // self.block_tokens,), self._pages.scratch, np.int64)
        rows[: len(pages)] = pages
        resume = r._resume
        r._resume = None
        ids = [int(t) for t in r.src_ids] + [0] * (s_pad - len(r.src_ids))
        p = _PendingPrefill(
            request=r, pages=pages, enc_tokens=len(r.src_ids), max_new=self._max_new(r),
            admit_seq=self._admit_seq, batch=batch, ids=ids, true_len=len(r.src_ids),
            s_pad=s_pad, rows=rows, n_chunks=s_pad // self.prefill_chunk_tokens, resume=resume)
        self._prefilling[sid] = p
        self._admit_seq += 1
        self._stats.incr("serving/chunked_prefills")
        if not self.prefix_cache_enabled:
            return
        c = self.prefill_chunk_tokens
        for j in range(p.n_chunks - 1, -1, -1):
            if (j + 1) * c > p.true_len:
                continue
            key = self._fw_key(p, j)
            ent = self._fw_cache.get(key)
            if ent is None:
                continue
            p.cursor = j + 1
            p.h = ent["h"]
            p.fw_chunks[: j + 1] = ent["chunks"]
            self._fw_cache.move_to_end(key)
            self._stats.incr("serving/prefix_fw_reuse", j + 1)
            break

    def _fw_key(self, p: _PendingPrefill, j: int) -> tuple:
        """The forward-carry cache key after chunk `j`: the gate projection
        runs at the padded extent's M, so the extent is part of it."""
        return (self._cache_sig_hash, p.s_pad, tuple(p.ids[: (j + 1) * self.prefill_chunk_tokens]))

    def admit(self, requests: Sequence) -> List:
        """Admit a FIFO prefix of ``requests`` (a free slot and pages for
        each; the first misfit stops admission, strict FCFS): a cached
        prompt maps its entry's pages, a prompt past the chunk bound
        registers for chunked prefill, the rest prefill at once, one
        bucketed batch per source rung.  A preempted request resumes from
        its saved state.  Returns the admitted requests in order."""
        group = []  # (slot, request, pages)
        admitted = []
        for r in requests:
            if not self._free_slots:
                break
            src = r.src_ids
            resume = r._resume
            hit = self._prefix_lookup(src) if self.prefix_cache_enabled else None
            if hit is not None:
                # prefill once: the entry's blocks map into this request's
                # page table and the decoder boots from its state
                _, ent = hit
                self._pages.share(ent["pages"])
                sid = self._free_slots.pop()
                admitted.append(r)
                self.prefix_hits += 1
                self._stats.incr("serving/prefix_hits")
                self._h[sid] = resume["h"] if resume is not None else ent["boot_h"]
                r._resume = None
                self._slots[sid] = _Slot(
                    request=r, pages=list(ent["pages"]), enc_tokens=ent["enc_tokens"],
                    last_id=resume["last_id"] if resume is not None else self._gen.bos_id,
                    tokens=list(resume["tokens"]) if resume is not None else [],
                    max_new=self._max_new(r), admit_seq=self._admit_seq, beam=self._beam_of(r))
                self._admit_seq += 1
                r.t_admit = self._clock()
                continue
            pages = self._pages.alloc(self._pages.pages_for_tokens(len(src)))
            if pages is None:
                break
            if self.prefix_cache_enabled:
                self.prefix_misses += 1
                self._stats.incr("serving/prefix_misses")
            sid = self._free_slots.pop()
            admitted.append(r)
            extent = self._chunked_extent(len(src))
            if extent is not None:
                self._admit_chunked(r, sid, pages, extent)
                r.t_admit = self._clock()
                continue
            self._slots[sid] = _Slot(
                request=r, pages=pages, enc_tokens=len(src),
                last_id=resume["last_id"] if resume is not None else self._gen.bos_id,
                tokens=list(resume["tokens"]) if resume is not None else [],
                max_new=self._max_new(r), admit_seq=self._admit_seq, beam=self._beam_of(r))
            self._admit_seq += 1
            group.append((sid, r, pages))
        if admitted:
            self._stats.incr("serving/admitted", len(admitted))
        if not group:
            return admitted
        by_rung: Dict[int, list] = {}
        for entry in group:
            by_rung.setdefault(ladder_len(len(entry[1].src_ids), DEFAULT_LADDER), []).append(entry)
        for g in by_rung.values():
            self._prefill_group(g)
        now = self._clock()
        for _, r, _ in group:
            r.t_admit = now
        return admitted

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
        with torch.no_grad(), _obs.span("prefill", cat="serving", n=len(group),
                                        src_pad=int(nb * self.block_tokens),
                                        reqs=[r.req_id for _, r, _ in group]):
            self._prefill(batch, self._to_device(page_rows), self._to_device(slot_rows),
                          self._to_device(boot_mask), h_override)
            if self.prefix_cache_enabled:
                # a cleanly booted slot's boot state, cloned: at retire its
                # pages and this state become the cache entry
                for k, (sid, _, _) in enumerate(group):
                    if boot_mask[k]:
                        self._slots[sid].boot_h = self._h[sid].clone()

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # -- chunked prefill advance ------------------------------------------
    def _advance_prefill(self) -> None:
        """One chunk dispatch of the oldest chunked prefill: the forward
        direction ascends the chunks, the reversed one descends them; the
        last (leftmost) reversed chunk writes the pages and the boot state,
        and the slot goes live."""
        sid, p = next(iter(self._prefilling.items()))
        c = self.prefill_chunk_tokens
        n = p.n_chunks
        _obs.instant("prefill_chunk", cat="serving", req=p.request.req_id, phase=p.phase,
                     chunk=p.cursor, n_chunks=n)
        self.trace_counts["prefill_chunk"] += 1
        with torch.no_grad():
            if p.xs is None:
                self._chunk_gates(p)
                if p.h is None:
                    p.h = torch.zeros((self.rows, self.hidden_dim), dtype=self._dtype,
                                      device=self.device)
            if p.phase == "fw" and p.cursor >= n:
                self._start_bw(p)  # the forward pass came whole from the cache
            if p.phase == "fw":
                k = p.cursor
                p.fw_chunks[k] = self._chunk_run(p, "fw", k)
                if self.prefix_cache_enabled and (k + 1) * c <= p.true_len:
                    # a chunk inside the true length: its outputs and carry
                    # depend on the prefix only, so any prompt sharing this
                    # chunk-aligned prefix (at this extent) can resume here
                    key = self._fw_key(p, k)
                    self._fw_cache.pop(key, None)
                    self._fw_cache[key] = {"h": p.h, "chunks": list(p.fw_chunks[: k + 1])}
                    while len(self._fw_cache) > self._fw_cache_cap:
                        self._fw_cache.popitem(last=False)
                p.cursor += 1
                if p.cursor == n:
                    self._start_bw(p)
                return
            # the reversed pass runs its own time order: source chunk k is
            # its chunk n - 1 - k
            k = p.cursor
            p.bw_chunks[n - 1 - k] = self._chunk_run(p, "bw", n - 1 - k)
            if k > 0:
                p.cursor -= 1
                return
            self._chunk_finish(sid, p)
        self._prefilling.pop(sid)
        boot_h = self._h[sid].clone() if self.prefix_cache_enabled and p.resume is None else None
        self._slots[sid] = _Slot(
            request=p.request, pages=p.pages, enc_tokens=p.enc_tokens,
            last_id=p.resume["last_id"] if p.resume is not None else self._gen.bos_id,
            tokens=list(p.resume["tokens"]) if p.resume is not None else [],
            max_new=p.max_new, admit_seq=p.admit_seq, beam=self._beam_of(p.request),
            boot_h=boot_h)

    def _start_bw(self, p: _PendingPrefill) -> None:
        """Turn to the reversed pass: it starts from a zero state at the
        prompt's end."""
        p.phase = "bw"
        p.cursor = p.n_chunks - 1
        p.h = torch.zeros_like(p.h)
        p.xs["fw"] = None

    # -- decode ----------------------------------------------------------
    def _meta(self, sids: List[int]) -> Tuple[int, np.ndarray]:
        """(page rung, [rows, 4 + rung] int32 meta) of the given slots:
        slot, encoder length, last id, live, page table; padding rows point
        at the scratch slot and page."""
        slots = [self._slots[sid] for sid in sids]
        p_rung = ladder_len(max(len(s.pages) for s in slots), self._page_ladder)
        meta = np.zeros((self.rows, 4 + p_rung), np.int32)
        meta[:, 0] = self._scratch_slot
        meta[:, 2] = self._gen.eos_id
        meta[:, 4:] = self._pages.scratch
        for k, (sid, s) in enumerate(zip(sids, slots)):
            meta[k, :4] = (sid, s.enc_tokens, s.last_id, 1)
            meta[k, 4:4 + len(s.pages)] = s.pages
        return p_rung, meta

    def step(self) -> List:
        """One chunked-prefill dispatch (when a long prompt is mid-prefill:
        the interleave that bounds its stall of the decode), then one
        decode dispatch (``block_steps`` tokens; a verify dispatch under
        speculative decoding) for every live slot and one beam dispatch per
        beam slot; returns the requests that finished (EOS emitted or their
        ``max_new_tokens`` reached), their pages released and slots
        recycled."""
        if self._prefilling:
            self._advance_prefill()
        if not self._slots:
            return []
        finished = []
        # beam slots: one whole-sequence dispatch each, retired at once
        for sid in sorted(self._slots):
            if self._slots[sid].beam:
                finished.append(self._finish_beam(sid))
        live_ids = sorted(self._slots)
        if not live_ids:
            self._stats.incr("serving/decode_steps")
            return finished
        p_rung, meta = self._meta(live_ids)
        k_steps = self.block_steps
        n_emit_host = m_host = None
        with torch.no_grad(), _obs.span("decode", cat="serving", live=len(live_ids),
                                        spec=self.spec_decode):
            if self.spec_decode:
                draft = np.full((self.rows, k_steps), self._gen.eos_id, np.int32)
                for k, sid in enumerate(live_ids):
                    draft[k] = self._draft_tokens(self._slots[sid], k_steps)
                self.verify_shapes[(self.rows, p_rung)] += 1
                toks, logps, n_emit, m_full = self._verify(
                    p_rung, self._to_device(meta), self._to_device(draft))
                n_emit_host = n_emit.cpu().numpy()
                m_host = m_full.cpu().numpy()
            else:
                self.decode_shapes[(self.rows, p_rung)] += 1
                toks, logps = self._decode(p_rung, self._to_device(meta))
            toks_host = toks.cpu().numpy()  # [B, K]: one host sync per K tokens
            logps_host = logps.cpu().numpy()
        now = self._clock()
        for k, sid in enumerate(live_ids):
            s = self._slots[sid]
            r = s.request
            if r.t_first_token is None:
                r.t_first_token = now
            done = False
            # speculative: exactly the verified tokens reach the request
            limit = int(n_emit_host[k]) if n_emit_host is not None else k_steps
            for tok, lp in zip(toks_host[k, :limit].tolist(), logps_host[k, :limit].tolist()):
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
            if n_emit_host is not None:
                self.spec_proposed += k_steps
                self.spec_accepted += int(m_host[k])
            if done:
                finished.append(self._retire(sid))
        self._stats.incr("serving/decode_steps")
        return finished

    def _draft_tokens(self, s: _Slot, k: int) -> List[int]:
        """Prompt-lookup n-gram draft: match the request's trailing
        ``spec_ngram`` generated tokens against its own earlier generation
        and propose the continuation after the most recent match, padded by
        repetition.  A wrong guess costs nothing: the verify emits the
        greedy tokens either way."""
        n = self.spec_ngram
        hist = s.tokens
        out: List[int] = []
        if len(hist) > n:
            key = tuple(hist[-n:])
            for i in range(len(hist) - n - 1, -1, -1):
                if tuple(hist[i:i + n]) == key:
                    out = list(hist[i + n:i + n + k])
                    break
        fill = out[-1] if out else s.last_id
        while len(out) < k:
            out.append(fill)
        return out[:k]

    def _finish_beam(self, sid: int):
        """One beam slot to completion: one beam dispatch, the best
        hypothesis cut at EOS onto the request, the slot retired."""
        s = self._slots[sid]
        p_rung, meta = self._meta([sid])
        meta[1:, 1] = 1  # padding rows: one valid position, as pad_batch_rows gives
        self.beam_shapes[(p_rung, s.beam, s.max_new)] += 1
        with torch.no_grad(), _obs.span("beam", cat="serving", req=s.request.req_id, beam=s.beam):
            seqs, scores = self._beam(p_rung, self._to_device(meta), s.beam, s.max_new)
            best = seqs[0, 0].cpu().tolist()
            score = float(scores[0, 0].cpu())
        toks: List[int] = []
        for t in best:
            if int(t) == self._gen.eos_id:
                break
            toks.append(int(t))
        s.tokens = toks[: s.max_new]
        now = self._clock()
        r = s.request
        if r.t_first_token is None:
            r.t_first_token = now
        r.token_times.extend([now] * len(s.tokens))
        r.beam_score = score
        self._stats.incr("serving/beam_requests")
        return self._retire(sid)

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
        lost): release its pages, save a clone of its GRU state and its
        generated prefix on the request and hand it back for re-queueing.
        Re-admission re-runs prefill (or hits the prefix cache) and
        restores the saved state, so its tokens equal an uninterrupted
        decode's.  Returns the request, or None when nothing is live."""
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

    # -- the one-shot reference paths ---------------------------------------
    def _reference_batch(self, src_ids):
        return pad_batch_rows(self._feeder([(list(src_ids),)]), self.rows)

    def reference_decode(self, src_ids, max_new_tokens: Optional[int] = None) -> List[int]:
        """The one-shot ``Seq2SeqGenerator.generate_greedy`` path for one
        request, through the same ladder feeder, padded to ``rows`` rows (see
        the module docstring): the golden the engine's tokens are held to."""
        mx = max_new_tokens if max_new_tokens is not None else self.default_max_new_tokens
        toks, lengths = self._gen.generate_greedy(self._reference_batch(src_ids),
                                                  max_new_tokens=mx)
        n = int(lengths[0])
        return [int(t) for t in toks[0, :n].tolist()]

    def reference_beam(self, src_ids, beam_size: int,
                       max_new_tokens: Optional[int] = None) -> Tuple[List[int], float]:
        """The one-shot ``Seq2SeqGenerator.generate`` of one request padded
        to ``rows`` rows: its best hypothesis cut at EOS (and at
        ``max_new_tokens``) and its score, the golden of beam serving."""
        mx = max_new_tokens if max_new_tokens is not None else self.default_max_new_tokens
        seqs, scores = self._gen.generate(self._reference_batch(src_ids), beam_size=beam_size)
        best: List[int] = []
        for t in seqs[0, 0].cpu().tolist():
            if int(t) == self._gen.eos_id:
                break
            best.append(int(t))
        return best[: min(mx, self._gen.max_length)], float(scores[0, 0].cpu())

    def weight_drift(self) -> float:
        """Drift of the resident int8 bundle from its f32 source: the max
        over quantized keys of ``max|dequant(q) - w| / max|w|`` (0.0 for
        f32 weights); the ``serving_int8_drift_budget`` flag bounds it."""
        if not self._w_meta:
            return 0.0
        deq = _bsq.dequantize_weight_bundle(self._w_arg, self._w_meta)
        worst = 0.0
        for k in self._w_meta:
            a = self._w[k].to(torch.float32)
            d = deq[k].to(torch.float32)
            denom = float(a.abs().max()) or 1.0
            worst = max(worst, float((d - a).abs().max()) / denom)
        return worst

    def slots_per_gb(self, src_tokens: Optional[int] = None) -> float:
        """Concurrent decode slots one GB holds after the resident weight
        bundle, at the footprint of a ``src_tokens``-token source (default
        one page); int8 weights shrink the bundle about 4x."""
        pages = self._pages.pages_for_tokens(src_tokens) if src_tokens is not None else 1
        per_slot = pages * self._pages.bytes_per_block + self.hidden_dim * self._dtype.itemsize
        return max((1 << 30) - self.weight_bytes, 0) / float(per_slot)

    def summary(self) -> Dict[str, Any]:
        return {
            "live": self.n_live,
            "prefilling": self.n_prefilling,
            "free_slots": self.n_free_slots,
            "pages": self._pages.summary(),
            "prefill_shapes": len(self.prefill_shapes),
            "decode_shapes": len(self.decode_shapes),
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "trace_counts": dict(self.trace_counts),
            "int8_weights": self.int8_weights,
            "weight_bytes": self.weight_bytes,
            "slots_per_gb": self.slots_per_gb(),
            "prefix_cache": self.prefix_cache_enabled,
            "prefix_entries": self.prefix_cache_len,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "spec_decode": self.spec_decode,
            "spec_accept_rate": self.spec_accept_rate(),
        }
