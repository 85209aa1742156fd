"""Beam and greedy search — the counterpart of ``paddle_tpu/ops/beam.py``.

The JAX package runs the search as one jitted ``lax.scan`` (greedy's early
exit as a ``lax.while_loop``); here it is a Python loop over torch ops with
the same fixed beam width K and maximum length T, padded beams and
finished masks, and no host read inside a beam step.  Greedy's early exit
reads one flag from the device every ``EXIT_CHECK_STEPS`` steps.

Ties are broken as XLA breaks them: ``lax.top_k`` puts the lower index
first among equal values and ``jnp.argsort`` is stable, while
``torch.topk`` promises no order among ties.  :func:`top_k` therefore ranks
by (value descending, index ascending), and the final ranking is a stable
sort.  Finished beams make such ties on purpose: their non-EOS
candidates all sit at ``score + NEG_INF``.

User hooks (plain torch functions, called once per step between the
step's torch ops):

  candidate_adjust_fn(logp [B*K, V], seqs [B*K, T], t) -> logp
      restrict or adjust the candidate distribution given the prefixes and
      the step number (``t`` is a Python int).
  drop_fn(seqs [B*K, T], ids [B*K], scores [B*K], t) -> bool [B*K]
      True drops the expanded path (its score is pinned to NEG_INF).
  norm_fn(scores [B, K], seqs [B, K, T], lengths [B, K]) -> scores
      rescore the completed paths (length normalisation, ...) before the
      final best-first sort.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from paddle_tpu_torch.core.batch import SeqTensor

NEG_INF = -1e9

# greedy's early exit reads "every row finished" from the device once per
# this many steps (a host sync each time); the tokens do not depend on it
EXIT_CHECK_STEPS = 8


def log_probs(logits: torch.Tensor) -> torch.Tensor:
    """The generator head's log-probabilities: softmax, a floor at 1e-9,
    log."""
    return torch.log(torch.clamp(torch.softmax(logits, dim=-1), min=1e-9))


def greedy_token_chain(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logp [.., V], nxt [..] int32)`` from raw logits by the greedy
    chain of the one-shot generator: :func:`log_probs`, then the first
    maximum (as ``jnp.argmax``).  The serving engine's decode emits its
    tokens through it, so they ride the one-shot path's arithmetic."""
    logp = log_probs(logits)
    return logp, torch.argmax(logp, dim=-1).to(torch.int32)


def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """`fn` over every tensor of a carry: nested dicts, lists, tuples and
    SeqTensors (data and lengths); None passes."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, SeqTensor):
        return SeqTensor(tree_map(fn, tree.data), tree_map(fn, tree.lengths),
                         tree_map(fn, tree.sub_lengths))
    if tree is None:
        return None
    return fn(tree)


def _device_of(tree) -> torch.device:
    found = []
    tree_map(found.append, tree)
    return found[0].device if found else torch.device("cpu")


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` [B, k] of the k largest entries of each row of
    f32 x [B, N], by value descending and, among equal values, by index
    ascending: ``lax.top_k``'s order, ties at the k-th value included.  One
    ``torch.topk`` over an int64 key that orders (value, -index)
    lexicographically: the f32 bits mapped to an order-preserving int32 in
    the high word, N - 1 - index in the low word.  float64 scores (an f64
    reference run) take a stable descending sort, which orders ties the
    same way."""
    if x.dtype == torch.float64:
        vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]
    if x.dtype != torch.float32:
        raise TypeError(f"top_k ranks float32 or float64 scores, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    rank = (x.shape[1] - 1) - torch.arange(x.shape[1], device=x.device)
    idx = torch.topk((ordered << 32) | rank, k, dim=1).indices
    return torch.gather(x, 1, idx), idx


def beam_search(
    step_fn: Callable[[torch.Tensor, Any], Tuple[torch.Tensor, Any]],
    init_carry: Any,
    batch_size: int,
    beam_size: int,
    vocab_size: int,
    bos_id: int,
    eos_id: int,
    max_len: int,
    candidate_adjust_fn: Optional[Callable] = None,
    drop_fn: Optional[Callable] = None,
    norm_fn: Optional[Callable] = None,
):
    """Generic beam search.

    step_fn(ids [B*K] int32, carry) -> (log_probs [B*K, V], new_carry);
    carry leaves have leading dim B*K.  Returns (sequences [B, K, T] int32,
    scores [B, K] f32) sorted best-first.  A finished beam continues only
    through the EOS column at score delta 0, so shorter hypotheses stay
    comparable."""
    bk = batch_size * beam_size
    dev = _device_of(init_carry)
    carry = tree_map(lambda x: torch.repeat_interleave(x, beam_size, dim=0), init_carry)
    ids = torch.full((bk,), bos_id, dtype=torch.int32, device=dev)
    # only beam 0 of each sample starts alive, so the first step picks K
    # distinct tokens rather than K copies
    scores = torch.tensor([0.0] + [NEG_INF] * (beam_size - 1), dtype=torch.float32,
                          device=dev).repeat(batch_size)
    finished = torch.zeros((bk,), dtype=torch.bool, device=dev)
    seqs = torch.zeros((bk, max_len), dtype=torch.int32, device=dev)
    is_eos_col = torch.arange(vocab_size, device=dev) == eos_id
    row_base = torch.arange(batch_size, device=dev)[:, None] * beam_size
    for t in range(max_len):
        logp, new_carry = step_fn(ids, carry)  # [B*K, V]
        eos_row = torch.where(is_eos_col, 0.0, NEG_INF).to(logp.dtype)
        logp = torch.where(finished[:, None], eos_row[None, :], logp)
        if candidate_adjust_fn is not None:
            # the adjusted distribution keeps finished beams frozen on EOS
            adj = candidate_adjust_fn(logp, seqs, t)
            logp = torch.where(finished[:, None], eos_row[None, :], adj)
        cand = (scores[:, None] + logp).reshape(batch_size, beam_size * vocab_size)
        top_scores, top_idx = top_k(cand, beam_size)  # [B, K]
        parent = (top_idx // vocab_size + row_base).reshape(-1)
        new_ids = (top_idx % vocab_size).to(torch.int32).reshape(-1)
        new_scores = top_scores.reshape(-1)
        was_finished = finished[parent]
        finished = was_finished | (new_ids == eos_id)
        carry = tree_map(lambda x: x[parent], new_carry)
        seqs = seqs[parent]
        seqs[:, t] = new_ids
        if drop_fn is not None:
            # never re-judge a finished hypothesis: its tail is forced EOS
            # padding the hook should not see
            drop = drop_fn(seqs, new_ids, new_scores, t) & ~was_finished
            new_scores = torch.where(drop, NEG_INF, new_scores)
        ids, scores = new_ids, new_scores
    seqs = seqs.reshape(batch_size, beam_size, max_len)
    scores = scores.reshape(batch_size, beam_size)
    if norm_fn is not None:
        is_eos = seqs == eos_id
        first_eos = torch.argmax(is_eos.to(torch.int32), dim=-1)
        lengths = torch.where(is_eos.any(dim=-1), first_eos, max_len).to(torch.int32)
        scores = norm_fn(scores, seqs, lengths)
    order = torch.sort(-scores, dim=1, stable=True).indices
    seqs = torch.gather(seqs, 1, order[:, :, None].expand_as(seqs))
    return seqs, torch.gather(scores, 1, order)


def greedy_search(
    step_fn: Callable[[torch.Tensor, Any], Tuple[torch.Tensor, Any]],
    init_carry: Any,
    batch_size: int,
    bos_id: int,
    eos_id: int,
    max_len: int,
    max_new_tokens: Optional[int] = None,
    early_exit: bool = False,
):
    """Greedy decode: argmax each step; returns ([B, L] int32 ids, [B] int32
    lengths) with ``L = min(max_len, max_new_tokens)``.

    ``early_exit`` stops once every row has emitted EOS (checked every
    ``EXIT_CHECK_STEPS`` steps).  The output is bit-identical to the full
    unroll: a finished row only re-emits EOS, and the early-exit token
    buffer is filled with EOS, so the skipped steps would have written what
    the buffer already holds."""
    length = max_len if max_new_tokens is None else max(0, min(int(max_new_tokens), max_len))
    dev = _device_of(init_carry)
    if length == 0:
        return (torch.zeros((batch_size, 0), dtype=torch.int32, device=dev),
                torch.zeros((batch_size,), dtype=torch.int32, device=dev))
    ids = torch.full((batch_size,), bos_id, dtype=torch.int32, device=dev)
    finished = torch.zeros((batch_size,), dtype=torch.bool, device=dev)
    toks = torch.full((batch_size, length), eos_id, dtype=torch.int32, device=dev)
    carry = init_carry
    for t in range(length):
        if early_exit and t and t % EXIT_CHECK_STEPS == 0 and bool(finished.all()):
            break
        logp, carry = step_fn(ids, carry)
        nxt = torch.argmax(logp, dim=-1).to(torch.int32)
        ids = torch.where(finished, eos_id, nxt).to(torch.int32)
        finished = finished | (ids == eos_id)
        toks[:, t] = ids
    is_eos = toks == eos_id
    first_eos = torch.argmax(is_eos.to(torch.int32), dim=1)
    lengths = torch.where(is_eos.any(dim=1), first_eos, length).to(torch.int32)
    return toks, lengths
