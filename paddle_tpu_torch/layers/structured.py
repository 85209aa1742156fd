"""Structured prediction: the linear-chain CRF cost (``crf``), its Viterbi
decoding (``crf_decoding``) and the CTC cost (``ctc``, which ``warp_ctc``
builds with blank 0) — the counterpart of ``paddle_tpu/layers/structured.py``
(reference CRFLayer.cpp, CRFDecodingLayer.cpp, LinearChainCRF.cpp,
CTCLayer.cpp, LinearChainCTC.cpp, WarpCTCLayer.cpp).

Each dynamic programme is a Python loop over the padded time axis of
batched torch ops, masked per row by its length, as the JAX package's
``lax.scan``; autograd differentiates the forward algorithm, as JAX's
autodiff does through its scan, so no backward is written by hand.  The
loops stop after the batch's longest row (``ops.rnn.live_range``, read from
the host copy of the lengths): every later step leaves each carry as it
was.  The three layers run in float32 under a bfloat16 compute dtype
(``full_precision``).

The weight is the reference's [N + 2, N] matrix: row 0 the start scores,
row 1 the end scores, rows 2.. the transitions W[from, to].  ``crf`` and
``crf_decoding`` share it by name (``ParamAttr(name=...)``).

CTC keeps ``NEG = -1e30`` for an impossible path, never -inf: logaddexp of
two -inf values has a NaN gradient.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializers as init
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.layers.base import register_layer
from paddle_tpu_torch.ops.rnn import live_range

NEG = -1e30  # an effective -inf that stays finite under arithmetic


def crf_init(conf, in_confs, gen, device):
    n = conf.attrs["num_classes"]
    return {"w": init.normal(gen, (n + 2, n), 0.1, device)}


def _crf_unpack(w):
    return w[0], w[1], w[2:]  # a [N], b [N], trans [N, N]


def _labels_of(t: SeqTensor) -> torch.Tensor:
    labels = t.data.to(torch.int64)
    return labels[..., 0] if labels.dim() == 3 else labels


def _live_steps(lengths, t_: int) -> int:
    """Steps 1 .. n-1 of the recurrences can change a carry: n is the
    batch's longest row (at least 1)."""
    return max(live_range(lengths, t_, False)[1], 1)


def _crf_log_z(x, lengths, a, b, trans):
    """Log partition per sequence by the forward algorithm; x: [B, T, N]."""
    alpha = a[None, :] + x[:, 0]  # [B, N]
    for t in range(1, _live_steps(lengths, x.shape[1])):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + x[:, t]
        alpha = torch.where((t < lengths)[:, None], nxt, alpha)
    return torch.logsumexp(alpha + b[None, :], dim=-1)  # [B]


def _crf_path_score(x, labels, lengths, a, b, trans):
    """Score of the gold path per sequence; labels: [B, T] int."""
    tpos = torch.arange(x.shape[1], device=x.device)[None, :]
    mask = (tpos < lengths[:, None]).to(x.dtype)  # [B, T]
    emit = x.gather(-1, labels[..., None])[..., 0]
    score = (emit * mask).sum(1) + a[labels[:, 0]]
    last = labels.gather(1, (lengths.long() - 1).clamp(min=0)[:, None])[:, 0]
    score = score + b[last]
    return score + (trans[labels[:, :-1], labels[:, 1:]] * mask[:, 1:]).sum(1)


@register_layer("crf", init=crf_init, auto_activation=False, full_precision=True)
def crf_apply(conf, params, inputs, ctx):
    """-log P(label | emissions) per sequence: [B, 1]."""
    x_t, y_t = inputs
    if not x_t.is_seq:
        raise ValueError(f"{conf.name}: crf needs sequence emissions")
    a, b, trans = _crf_unpack(params["w"])
    labels, lengths = _labels_of(y_t), x_t.lengths
    nll = (_crf_log_z(x_t.data, lengths, a, b, trans)
           - _crf_path_score(x_t.data, labels, lengths, a, b, trans))
    return SeqTensor(nll[:, None])


@register_layer("crf_decoding", init=crf_init, auto_activation=False, full_precision=True)
def crf_decoding_apply(conf, params, inputs, ctx):
    """Viterbi decoding: [B, T] int32 best labels (0 at padding); with a
    label input, the [B, T] float32 0/1 mismatch map instead
    (CRFDecodingLayer.cpp).  Ties take the first maximum, as jnp.argmax."""
    x_t = inputs[0]
    if not x_t.is_seq:
        raise ValueError(f"{conf.name}: crf_decoding needs sequence emissions")
    a, b, trans = _crf_unpack(params["w"])
    x, lengths = x_t.data, x_t.lengths
    bsz, t_, _ = x.shape
    n_live = _live_steps(lengths, t_)
    alpha = a[None, :] + x[:, 0]
    bps = []  # bps[t - 1] maps the label at t to the best one at t - 1
    for t in range(1, n_live):
        cand = alpha[:, :, None] + trans[None]  # [B, from, to]
        bp = cand.argmax(dim=1)  # [B, to]
        nxt = cand.amax(dim=1) + x[:, t]
        alpha = torch.where((t < lengths)[:, None], nxt, alpha)
        bps.append(bp)
    y_last = (alpha + b[None, :]).argmax(dim=-1)  # [B]
    # backtrack t = n_live - 2 .. 0; the carry holds the label at t + 1 and
    # is reseeded with y_last where t + 1 is the row's last position
    path = torch.zeros((bsz, t_), dtype=torch.int64, device=x.device)
    carry = y_last
    last_pos = lengths.long() - 1
    for t in range(n_live - 2, -1, -1):
        carry = torch.where(last_pos == t + 1, y_last, carry)
        y_t = bps[t].gather(1, carry[:, None])[:, 0]
        emit = t <= last_pos - 1
        y_t = torch.where(emit, y_t, 0)
        carry = torch.where(emit, y_t, carry)
        path[:, t] = y_t
    rows = torch.arange(bsz, device=x.device)
    path[rows, last_pos] = y_last
    tpos = torch.arange(t_, device=x.device)[None, :]
    valid = tpos < lengths[:, None]
    path = torch.where(valid, path, 0).to(torch.int32)
    if len(inputs) > 1:
        err = (path != _labels_of(inputs[1])) & valid
        return SeqTensor(err.to(torch.float32), lengths)
    return SeqTensor(path, lengths)


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------


def _shift(a, k, pad):
    """a moved k places right along S, the [B, 2] NEG `pad` entering on the
    left."""
    return torch.cat([pad[:, :k], a[:, :-k]], dim=1)


@register_layer("ctc", auto_activation=False, full_precision=True)
def ctc_apply(conf, params, inputs, ctx):
    """CTC negative log likelihood per sequence: [B, 1].

    inputs[0]: [B, T, C] logits before the softmax (the reference applies it
    inside); inputs[1]: the label ids, a sequence with lengths of its own.
    The forward variable runs over the extended labels (blank, z1, blank,
    z2, ..., blank): each step takes stay, a shift by 1 and, where the
    label differs from the one two back and is not blank, a shift by 2."""
    logits_t, labels_t = inputs
    blank = conf.attrs.get("blank", conf.size - 1)
    logp = torch.log_softmax(logits_t.data, dim=-1)  # [B, T, C]
    in_len = logits_t.lengths
    labels = labels_t.data.to(torch.int64)
    if labels.dim() == 3:
        labels = labels[..., 0]
    lab_len = labels_t.lengths.to(torch.int64)
    b_, t_, _ = logp.shape
    s_ = 2 * labels.shape[1] + 1
    dev = logp.device

    ext = torch.full((b_, s_), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    s_eff = 2 * lab_len + 1  # [B]
    ext_valid = torch.arange(s_, device=dev)[None, :] < s_eff[:, None]
    prev2 = torch.cat([ext.new_full((b_, 2), -1), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != prev2)

    has_lab = lab_len > 0
    first = torch.where(has_lab, labels[:, 0], blank)
    alpha = torch.cat([
        logp[:, 0, blank][:, None],
        torch.where(has_lab, logp[:, 0].gather(1, first[:, None])[:, 0], NEG)[:, None],
        logp.new_full((b_, s_ - 2), NEG),
    ], dim=1)
    # [B, T, S] emission log-probs of the extended labels
    ems = logp.gather(2, ext[:, None, :].expand(b_, t_, s_))
    neg = logp.new_full((), NEG)
    pad = logp.new_full((b_, 2), NEG)
    for t in range(1, _live_steps(in_len, t_)):
        s2 = torch.where(can_skip, _shift(alpha, 2, pad), neg)
        nxt = torch.logaddexp(torch.logaddexp(alpha, _shift(alpha, 1, pad)), s2) + ems[:, t]
        nxt = torch.where(ext_valid, nxt, neg)
        alpha = torch.where((t < in_len)[:, None], nxt, alpha)

    last = alpha.gather(1, (s_eff - 1)[:, None])[:, 0]
    last2 = alpha.gather(1, (s_eff - 2).clamp(min=0)[:, None])[:, 0]
    # an empty label sequence has the all-blank path alone (s_eff == 1)
    last2 = torch.where(s_eff >= 2, last2, neg)
    nll = -torch.logaddexp(last, last2)
    if conf.attrs.get("norm_by_times", False):
        nll = nll / in_len.to(nll.dtype)
    return SeqTensor(nll[:, None])
