"""Recurrent cores — the counterpart of ``paddle_tpu/ops/rnn.py``: the LSTM
with peepholes (``lstm_scan``, the lstmemory layer), the GRU (``gru_scan``,
the grumemory layer), the simple recurrence (``simple_rnn_scan``, the
recurrent layer) and the fused attention-GRU decoder
(``attention_gru_scan``, what a matched recurrent_group decoder step lowers
onto, and ``attention_gru_step``, its single step for generation and
serving).

As in the JAX package the batch stays padded, [B, T, ...], and the loop runs
over the time axis with a carry mask: a padded step passes the previous
state through.  The input projections (x @ W) run once outside the loop.
Each core is a ``torch.autograd.Function`` with the JAX package's
hand-written backward (its custom VJPs): the backward loop runs only the
transposed chain GEMMs of each step, and every weight gradient is one GEMM
over the saved sequences after the loop.  The elementwise derivatives are
written out from the saved pre-activations (``_act_vjp``), so a step of
either loop runs no GEMM beyond its chain.

Early exit (the ``scan_early_exit`` flag): a step at which every row is
padding changes nothing, so the loops run only the live range of steps,
taken from the host copy of the lengths (``core.batch.host_lengths``, set by
the feeder: no step reads the device).  Dead steps emit the carry, as in the
JAX package, and their gradients are exact zeros.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch

from paddle_tpu_torch.core.batch import host_lengths
from paddle_tpu_torch.ops.activations import get_activation
from paddle_tpu_torch.utils.flags import get_flag

# steps each loop ran and skipped (early exit), since the last clear()
counters: collections.Counter = collections.Counter()

# d act(x) / dx from the input x and the output y, per elementwise activation
_DERIVS = {
    "": lambda x, y: torch.ones_like(x),
    "identity": lambda x, y: torch.ones_like(x),
    "linear": lambda x, y: torch.ones_like(x),
    "sigmoid": lambda x, y: y * (1.0 - y),
    "tanh": lambda x, y: 1.0 - y * y,
    "relu": lambda x, y: (x > 0).to(x.dtype),
    "brelu": lambda x, y: ((x > 0) & (x < 24.0)).to(x.dtype),
    "stanh": lambda x, y: (1.7159 * 2.0 / 3.0) * (1.0 - torch.square(y / 1.7159)),
    "softrelu": lambda x, y: torch.sigmoid(x) * (x.abs() <= 40.0).to(x.dtype),
    "abs": lambda x, y: torch.sign(x),
    "square": lambda x, y: 2.0 * x,
    "exponential": lambda x, y: y,
    "exp": lambda x, y: y,
    "reciprocal": lambda x, y: -y * y,
    "sqrt": lambda x, y: 0.5 / y,
    "log": lambda x, y: 1.0 / x,
}


def _act_vjp(name: str, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g times the derivative of activation `name` at x (y = act(x)); an
    activation outside the elementwise table (softmax) takes its exact VJP
    by autograd."""
    deriv = _DERIVS.get(name)
    if deriv is not None:
        return g * deriv(x, y)
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        return torch.autograd.grad(get_activation(name)(xx), xx, g)[0]


def _mask_seq(lengths: Optional[torch.Tensor], max_len: int, reverse: bool):
    """[T, B, 1] carry mask; in a reverse scan (inputs flipped) the valid
    positions are t >= T - len."""
    if lengths is None:
        return None
    t = torch.arange(max_len, device=lengths.device)[:, None]
    valid = t >= (max_len - lengths[None, :]) if reverse else t < lengths[None, :]
    return valid[..., None]


def live_range(lengths: Optional[torch.Tensor], max_len: int, reverse: bool) -> Tuple[int, int]:
    """[lo, hi): the loop steps at which some row is valid, under the
    ``scan_early_exit`` flag; every step otherwise."""
    if lengths is None or not get_flag("scan_early_exit") or lengths.numel() == 0:
        return 0, max_len
    n = min(max(int(host_lengths(lengths).max()), 0), max_len)
    return (max_len - n, max_len) if reverse else (0, n)


def _around(live: torch.Tensor, first: torch.Tensor, last: torch.Tensor, lo: int, t: int):
    """The [T, B, H] output sequence of a loop that ran steps [lo, lo +
    len(live)): dead steps before emit `first` (the initial carry), dead
    steps after emit `last` (the final carry)."""
    hi = lo + live.shape[0]
    parts = []
    if lo:
        parts.append(first[None].expand(lo, *first.shape))
    parts.append(live)
    if hi < t:
        parts.append(last[None].expand(t - hi, *last.shape))
    return torch.cat(parts) if len(parts) > 1 else live


def _gru_reset(acts, p_r, h_p):
    """rh = gate(p_r) * h_p (the reference's gru_resetOutput)."""
    return get_activation(acts[0])(p_r) * h_p


def _gru_final(acts, p_u, p_c, h_p, m):
    """h = (1 - u) * h_p + u * c with carry-through masking
    (gru_finalOutput)."""
    u = get_activation(acts[0])(p_u)
    c = get_activation(acts[1])(p_c)
    return torch.where(m, torch.lerp(h_p, c, u), h_p)


def _gru_final_vjp(acts, p_u, p_c, h_p, m, dh):
    """(dp_u, dp_c, dh_p) of :func:`_gru_final` at cotangent dh."""
    u = get_activation(acts[0])(p_u)
    c = get_activation(acts[1])(p_c)
    dhm = torch.where(m, dh, 0.0)
    dp_u = _act_vjp(acts[0], p_u, u, dhm * (c - h_p))
    dp_c = _act_vjp(acts[1], p_c, c, dhm * u)
    dh_p = torch.where(m, dh * (1.0 - u), dh)
    return dp_u, dp_c, dh_p


def _gru_reset_vjp(acts, p_r, h_p, drh):
    """(dp_r, dh_p, rh) of :func:`_gru_reset` at cotangent drh."""
    r = get_activation(acts[0])(p_r)
    return _act_vjp(acts[0], p_r, r, drh * h_p), drh * r, r * h_p


# ---------------------------------------------------------------------------
# LSTM with peepholes (JAX ``_lstm_core``)
# ---------------------------------------------------------------------------
#
# One step, a = x_t + h_p @ W_h (+ bias, folded into x_t), gates (i, f, g, o):
#
#   i = gate(a_i + w_ci * c_p)     f = gate(a_f + w_cf * c_p)
#   c = f * c_p + i * act(a_g)     o = gate(a_o + w_co * c)     h = o * state_act(c)
#
# The output gate reads the NEW cell, the input and forget gates the old one,
# so dc collects a term through o and dc_p terms through i and f.  A masked
# step passes both h and c through.


class LstmCore(torch.autograd.Function):
    """Time-major LSTM recurrence (JAX ``_lstm_core``).  xs: [T, B, 4H] input
    projections (+ bias) in (i, f, g, o) order; w_h: [H, 4H]; w_ci, w_cf,
    w_co: [H] peepholes; h0, c0: [B, H]; mask: [T, B, 1] bool; acts: (gate,
    act, state_act); steps [lo, hi) run.  Returns (hs [T, B, H], h_last,
    c_last).  The forward saves each step's activation inputs and outputs and
    the cell; the backward runs one transposed chain GEMM per step, takes
    dW_h as one GEMM over the saved sequences after the loop and the three
    peephole gradients as f32 reductions over all steps."""

    @staticmethod
    def forward(ctx, xs, w_h, w_ci, w_cf, w_co, h0, c0, mask, acts, lo, hi):
        f_gate, f_act, f_state = (get_activation(a) for a in acts)
        b, h = h0.shape
        w_cif = torch.stack([w_ci, w_cf])  # [2, H]: the old-cell peepholes
        h_t, c_t = h0, c0
        seqs = ([], [], [], [], [], [], [], [], [])  # hs, cs, p_if, y_if, p_g, g, p_o, o, s
        for t in range(lo, hi):
            a = torch.addmm(xs[t], h_t, w_h)  # the chain GEMM
            p_if = torch.addcmul(a[:, : 2 * h].view(b, 2, h), w_cif, c_t[:, None])
            y_if = f_gate(p_if)
            p_g = a[:, 2 * h: 3 * h]
            g = f_act(p_g)
            c_new = torch.addcmul(y_if[:, 1] * c_t, y_if[:, 0], g)
            p_o = torch.addcmul(a[:, 3 * h:], w_co, c_new)
            o = f_gate(p_o)
            s = f_state(c_new)
            m = mask[t]
            h_t = torch.where(m, o * s, h_t)
            c_t = torch.where(m, c_new, c_t)
            for acc, x in zip(seqs, (h_t, c_t, p_if, y_if, p_g, g, p_o, o, s)):
                acc.append(x)
        counters["lstm_steps"] += hi - lo
        counters["lstm_skipped"] += xs.shape[0] - (hi - lo)
        if hi > lo:
            saved = [torch.stack(x) for x in seqs]
        else:
            saved = [h0.new_zeros((0, b, h))] * len(seqs)
        ctx.acts, ctx.lo, ctx.hi = acts, lo, hi
        ctx.save_for_backward(*saved, w_h, w_ci, w_cf, w_co, h0, c0, mask)
        return _around(saved[0], h0, h_t, lo, xs.shape[0]), h_t, c_t

    @staticmethod
    def backward(ctx, dhs, dh_last, dc_last):
        (live, c_seq, p_if_seq, y_if_seq, p_g_seq, g_seq, p_o_seq, o_seq, s_seq,
         w_h, w_ci, w_cf, w_co, h0, c0, mask) = ctx.saved_tensors
        acts, lo, hi = ctx.acts, ctx.lo, ctx.hi
        b, h = h0.shape
        t_all = dhs.shape[0]
        dh = dh_last + dhs[hi:].sum(0) if hi < t_all else dh_last
        dc = dc_last
        h_prev = torch.cat([h0[None], live[:-1]])
        c_prev = torch.cat([c0[None], c_seq[:-1]])
        w_h_t = w_h.t()
        das = []
        for i in reversed(range(hi - lo)):
            t = lo + i
            dh = dh + dhs[t]
            m = mask[t]
            dhm = torch.where(m, dh, 0.0)
            dcm = torch.where(m, dc, 0.0)
            y_if, c_p, c_new = y_if_seq[i], c_prev[i], c_seq[i]
            dp_o = _act_vjp(acts[0], p_o_seq[i], o_seq[i], dhm * s_seq[i])
            dct = torch.addcmul(
                dcm + _act_vjp(acts[2], c_new, s_seq[i], dhm * o_seq[i]), dp_o, w_co)
            g = g_seq[i]
            dp_if = _act_vjp(acts[0], p_if_seq[i], y_if,
                             dct[:, None] * torch.stack([g, c_p], 1))
            da_g = _act_vjp(acts[1], p_g_seq[i], g, dct * y_if[:, 0])
            da = torch.cat([dp_if.reshape(b, 2 * h), da_g, dp_o], -1)
            # dc_p: the carry where masked, else through f and both peepholes
            dc = (dc - dcm) + dct * y_if[:, 1] + dp_if[:, 0] * w_ci + dp_if[:, 1] * w_cf
            dh = torch.addmm(dh - dhm, da, w_h_t)  # the chain GEMM
            das.append(da)
        if lo:
            dh = dh + dhs[:lo].sum(0)
        dxs = dhs.new_zeros(tuple(dhs.shape[:2]) + (4 * h,))
        need = ctx.needs_input_grad
        dw_h = dw_ci = dw_cf = dw_co = None
        if hi > lo:
            da_seq = torch.stack(das[::-1])
            dxs[lo:hi] = da_seq
            # one GEMM over the saved sequences: f32 accumulation, rounded
            # once to the compute dtype
            dw_h = torch.einsum("tbh,tbg->hg", h_prev, da_seq)
            # the peephole sums run over all T steps: reduce at f32 or wider
            # (a bf16 running sum over 100 steps loses low bits)
            acc = torch.promote_types(w_ci.dtype, torch.float32)
            if need[2] or need[3]:
                dcif = (da_seq[..., : 2 * h].reshape(-1, b, 2, h).to(acc)
                        * c_prev[:, :, None].to(acc)).sum((0, 1))
                dw_ci, dw_cf = dcif[0].to(w_ci.dtype), dcif[1].to(w_cf.dtype)
            if need[4]:
                dw_co = (da_seq[..., 3 * h:].to(acc) * c_seq.to(acc)).sum((0, 1)).to(w_co.dtype)
        else:
            dw_h = torch.zeros_like(w_h)
            dw_ci, dw_cf, dw_co = (torch.zeros_like(w) for w in (w_ci, w_cf, w_co))
        return (dxs, dw_h, dw_ci if need[2] else None, dw_cf if need[3] else None,
                dw_co if need[4] else None, dh, dc, None, None, None, None)


def lstm_scan(
    gates: torch.Tensor,  # [B, T, 4H] input projections (i, f, g, o)
    w_h: torch.Tensor,  # [H, 4H] recurrent weight
    bias: Optional[torch.Tensor],  # [4H]
    w_ci: Optional[torch.Tensor],  # [H] input-gate peephole
    w_cf: Optional[torch.Tensor],  # [H] forget-gate peephole
    w_co: Optional[torch.Tensor],  # [H] output-gate peephole
    lengths: Optional[torch.Tensor] = None,
    *,
    gate_act: str = "sigmoid",
    act: str = "tanh",
    state_act: str = "tanh",
    reverse: bool = False,
    h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Paddle-v1 LSTM with peepholes (LstmLayer.cpp forwardSequence):
        i = gate(a_i + w_ci * c_p)   f = gate(a_f + w_cf * c_p)
        c = f * c_p + i * act(a_g)   o = gate(a_o + w_co * c)   h = o * state_act(c)
    Absent peepholes are zeros (and get no gradient).  Returns ([B, T, H]
    hidden sequence, (h_last, c_last))."""
    b, t, g4 = gates.shape
    h = g4 // 4
    xs = gates.transpose(0, 1)
    if bias is not None:
        xs = xs + bias  # the gate bias adds in the compute dtype, as in the JAX package
    if reverse:
        xs = xs.flip(0)
    mask = _mask_seq(lengths, t, reverse)
    if mask is None:
        mask = torch.ones((t, b, 1), dtype=torch.bool, device=gates.device)
    h_prev = h0 if h0 is not None else gates.new_zeros((b, h))
    c_prev = c0 if c0 is not None else gates.new_zeros((b, h))
    zeros_h = gates.new_zeros((h,))
    peep = [w if w is not None else zeros_h for w in (w_ci, w_cf, w_co)]
    lo, hi = live_range(lengths, t, reverse)
    hs, h_last, c_last = LstmCore.apply(
        xs.contiguous(), w_h, *peep, h_prev, c_prev, mask, (gate_act, act, state_act), lo, hi)
    if reverse:
        hs = hs.flip(0)
    return hs.transpose(0, 1), (h_last, c_last)


# ---------------------------------------------------------------------------
# GRU
# ---------------------------------------------------------------------------


class GruCore(torch.autograd.Function):
    """Time-major GRU recurrence (JAX ``_gru_core``).  xs: [T, B, 3H] input
    projections (+ bias) in (u, r, c) order; w_h: [H, 2H]; w_c: [H, H]; h0:
    [B, H]; mask: [T, B, 1] bool; steps [lo, hi) run.  Returns (hs [T, B, H],
    h_last).  The forward saves the gate pre-activations and the states; the
    backward runs the two transposed chain GEMMs per step and takes dW_h and
    dW_c as two GEMMs over the saved sequences."""

    @staticmethod
    def forward(ctx, xs, w_h, w_c, h0, mask, acts, lo, hi):
        h = h0.shape[-1]
        h_t = h0
        hs, p_urs, p_cs = [], [], []
        for t in range(lo, hi):
            x_t = xs[t]
            p_ur = torch.addmm(x_t[:, : 2 * h], h_t, w_h)
            rh = _gru_reset(acts, p_ur[:, h:], h_t)
            p_c = torch.addmm(x_t[:, 2 * h:], rh, w_c)
            h_t = _gru_final(acts, p_ur[:, :h], p_c, h_t, mask[t])
            hs.append(h_t)
            p_urs.append(p_ur)
            p_cs.append(p_c)
        counters["gru_steps"] += hi - lo
        counters["gru_skipped"] += xs.shape[0] - (hi - lo)
        live = torch.stack(hs) if hs else h0.new_zeros((0,) + tuple(h0.shape))
        ctx.acts, ctx.lo, ctx.hi = acts, lo, hi
        ctx.save_for_backward(
            torch.stack(p_urs) if p_urs else live, torch.stack(p_cs) if p_cs else live,
            live, w_h, w_c, h0, mask)
        return _around(live, h0, h_t, lo, xs.shape[0]), h_t

    @staticmethod
    def backward(ctx, dhs, dh_last):
        p_ur_seq, p_c_seq, live, w_h, w_c, h0, mask = ctx.saved_tensors
        acts, lo, hi = ctx.acts, ctx.lo, ctx.hi
        h = h0.shape[-1]
        t_all = dhs.shape[0]
        dh = dh_last + dhs[hi:].sum(0) if hi < t_all else dh_last
        h_prev = torch.cat([h0[None], live[:-1]])
        w_h_t, w_c_t = w_h.t(), w_c.t()
        dp_urs, dp_cs, rhs = [], [], []
        for i in reversed(range(hi - lo)):
            t = lo + i
            dh = dh + dhs[t]
            h_p = h_prev[i]
            dp_u, dp_c, dh_p = _gru_final_vjp(
                acts, p_ur_seq[i, :, :h], p_c_seq[i], h_p, mask[t], dh)
            drh = dp_c @ w_c_t  # chain GEMM 1
            dp_r, dh_p_r, rh = _gru_reset_vjp(acts, p_ur_seq[i, :, h:], h_p, drh)
            dp_ur = torch.cat([dp_u, dp_r], -1)
            dh = torch.addmm(dh_p + dh_p_r, dp_ur, w_h_t)  # chain GEMM 2
            dp_urs.append(dp_ur)
            dp_cs.append(dp_c)
            rhs.append(rh)
        if lo:
            dh = dh + dhs[:lo].sum(0)
        dxs = dhs.new_zeros(tuple(dhs.shape[:2]) + (3 * h,))
        if hi > lo:
            dp_ur_seq = torch.stack(dp_urs[::-1])
            dp_c_seq = torch.stack(dp_cs[::-1])
            dxs[lo:hi] = torch.cat([dp_ur_seq, dp_c_seq], -1)
            # one GEMM each over the saved sequences: f32 accumulation,
            # rounded once to the compute dtype
            dw_h = torch.einsum("tbh,tbg->hg", h_prev, dp_ur_seq)
            dw_c = torch.einsum("tbh,tbg->hg", torch.stack(rhs[::-1]), dp_c_seq)
        else:
            dw_h, dw_c = torch.zeros_like(w_h), torch.zeros_like(w_c)
        return dxs, dw_h, dw_c, dh, None, None, None, None


def gru_scan(
    gates: torch.Tensor,  # [B, T, 3H] input projections (u, r, c)
    w_h: torch.Tensor,  # [H, 2H] recurrent weight of the update and reset gates
    w_c: torch.Tensor,  # [H, H] recurrent weight of the candidate
    bias: Optional[torch.Tensor],  # [3H]
    lengths: Optional[torch.Tensor] = None,
    *,
    gate_act: str = "sigmoid",
    act: str = "tanh",
    reverse: bool = False,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paddle-v1 GRU (GatedRecurrentLayer.cpp):
        u = gate(x_u + U_u h_p)   r = gate(x_r + U_r h_p)
        c = act(x_c + (r * h_p) U_c)
        h = (1 - u) * h_p + u * c
    Returns ([B, T, H], h_last)."""
    b, t, _ = gates.shape
    h = w_c.shape[0]
    xs = gates.transpose(0, 1)
    if bias is not None:
        xs = xs + bias
    if reverse:
        xs = xs.flip(0)
    mask = _mask_seq(lengths, t, reverse)
    if mask is None:
        mask = torch.ones((t, b, 1), dtype=torch.bool, device=gates.device)
    h_prev = h0 if h0 is not None else gates.new_zeros((b, h))
    lo, hi = live_range(lengths, t, reverse)
    hs, h_last = GruCore.apply(xs, w_h, w_c, h_prev, mask, (gate_act, act), lo, hi)
    if reverse:
        hs = hs.flip(0)
    return hs.transpose(0, 1), h_last


# ---------------------------------------------------------------------------
# Simple recurrence (JAX ``_rnn_core``): h = act(x_t + h_p @ W_h)
# ---------------------------------------------------------------------------


class RnnCore(torch.autograd.Function):
    """Time-major plain recurrence (JAX ``_rnn_core``).  xs: [T, B, H] input
    projections (+ bias); w_h: [H, H]; h0: [B, H]; mask: [T, B, 1] bool;
    acts: (act,); steps [lo, hi) run.  Returns (hs [T, B, H], h_last), with
    the same deferred weight gradient as :class:`LstmCore`."""

    @staticmethod
    def forward(ctx, xs, w_h, h0, mask, acts, lo, hi):
        f_act = get_activation(acts[0])
        h_t = h0
        hs, pres, ys = [], [], []
        for t in range(lo, hi):
            a = torch.addmm(xs[t], h_t, w_h)  # the chain GEMM
            y = f_act(a)
            h_t = torch.where(mask[t], y, h_t)
            hs.append(h_t)
            pres.append(a)
            ys.append(y)
        counters["rnn_steps"] += hi - lo
        counters["rnn_skipped"] += xs.shape[0] - (hi - lo)
        if hs:
            live, a_seq, y_seq = torch.stack(hs), torch.stack(pres), torch.stack(ys)
        else:
            live = a_seq = y_seq = h0.new_zeros((0,) + tuple(h0.shape))
        ctx.acts, ctx.lo, ctx.hi = acts, lo, hi
        ctx.save_for_backward(a_seq, y_seq, live, w_h, h0, mask)
        return _around(live, h0, h_t, lo, xs.shape[0]), h_t

    @staticmethod
    def backward(ctx, dhs, dh_last):
        a_seq, y_seq, live, w_h, h0, mask = ctx.saved_tensors
        acts, lo, hi = ctx.acts, ctx.lo, ctx.hi
        t_all = dhs.shape[0]
        dh = dh_last + dhs[hi:].sum(0) if hi < t_all else dh_last
        w_h_t = w_h.t()
        das = []
        for i in reversed(range(hi - lo)):
            t = lo + i
            dh = dh + dhs[t]
            dhm = torch.where(mask[t], dh, 0.0)
            da = _act_vjp(acts[0], a_seq[i], y_seq[i], dhm)
            dh = torch.addmm(dh - dhm, da, w_h_t)  # the chain GEMM
            das.append(da)
        if lo:
            dh = dh + dhs[:lo].sum(0)
        dxs = torch.zeros_like(dhs)
        if hi > lo:
            da_seq = torch.stack(das[::-1])
            dxs[lo:hi] = da_seq
            h_prev = torch.cat([h0[None], live[:-1]])
            dw_h = torch.einsum("tbh,tbg->hg", h_prev, da_seq)
        else:
            dw_h = torch.zeros_like(w_h)
        return dxs, dw_h, dh, None, None, None, None


def simple_rnn_scan(
    x: torch.Tensor,  # [B, T, H] input projections
    w_h: torch.Tensor,  # [H, H]
    bias: Optional[torch.Tensor],
    lengths: Optional[torch.Tensor] = None,
    *,
    act: str = "tanh",
    reverse: bool = False,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain recurrence h_t = act(x_t + h_p W) (RecurrentLayer.cpp).
    Returns ([B, T, H], h_last)."""
    b, t, h = x.shape
    xs = x.transpose(0, 1)
    if bias is not None:
        xs = xs + bias
    if reverse:
        xs = xs.flip(0)
    mask = _mask_seq(lengths, t, reverse)
    if mask is None:
        mask = torch.ones((t, b, 1), dtype=torch.bool, device=x.device)
    h_prev = h0 if h0 is not None else x.new_zeros((b, h))
    lo, hi = live_range(lengths, t, reverse)
    hs, h_last = RnnCore.apply(xs.contiguous(), w_h, h_prev, mask, (act,), lo, hi)
    if reverse:
        hs = hs.flip(0)
    return hs.transpose(0, 1), h_last


# ---------------------------------------------------------------------------
# Fused attention-GRU decoder (JAX ``_attgru_core``)
# ---------------------------------------------------------------------------
#
# One decoder step of the v1 attention decoder (simple_attention + gru_step in
# a recurrent_group) as its minimal chain of dependent GEMMs:
#
#   a1    = h_p @ [W_sp | U_ur]            state projection and GRU u/r gates
#   alpha = softmax_S(act(ep + sp) . v)    score matvec, static encoder mask
#   ctx   = alpha . enc                    context reduce
#   p     = xg_t + ctx @ W_ctx             (the target-embedding half of the
#                                          input fc runs once for the whole
#                                          sequence, outside the loop)
#   c     = act(p_c + (r * h_p) @ W_c)
#   h     = (1 - u) * h_p + u * c
#
# The backward loop runs only the transposed chain GEMMs; dW1, dW_ctx, dW_c,
# dv and the static inputs' gradients d_enc and d_ep come after the loop.


def _att_scores(att_act: str, ep, sp, v):
    """[B, S] unnormalised scores act(ep + sp[:, None, :]) . v."""
    return get_activation(att_act)(ep + sp[:, None, :]) @ v


def _att_softmax(score, emask):
    """Masked softmax over S, as the sequence_softmax activation: -1e9
    fill, softmax, then zero the padding."""
    if emask is None:
        return torch.softmax(score, dim=-1)
    alpha = torch.softmax(score.masked_fill(~emask, -1e9), dim=-1)
    return alpha * emask.to(alpha.dtype)


def _context_bmm(alpha, enc):
    """[B, E] context alpha . enc as one batched product (the scan core)."""
    return torch.bmm(alpha[:, None, :], enc)[:, 0]


# positions per partial sum of the generation step's context
CONTEXT_BLOCK = 16


def _context_blocks(alpha, enc):
    """[B, E] context alpha . enc summed over S in blocks of CONTEXT_BLOCK
    positions, the blocks' partial sums added in order.  Padding positions
    (alpha exactly 0) add exact zeros, so at a fixed B a row's context does
    not depend on how far the batch pads S: a batched product or one sum
    over S picks its reduction by S, on the CPU and on the card."""
    ctx = None
    for s in range(0, enc.shape[1], CONTEXT_BLOCK):
        part = (alpha[:, s:s + CONTEXT_BLOCK, None] * enc[:, s:s + CONTEXT_BLOCK]).sum(dim=1)
        ctx = part if ctx is None else ctx + part
    return ctx


def _attgru_step(acts, xg_t, h_p, enc, ep, emask, w1, v, w_ctx, w_c, m, context=_context_bmm):
    """One fused decoder step: (h_t, (sp, alpha, ctx, p_ur, cpre)), the
    residuals the hand-written backward needs."""
    p_dim = ep.shape[-1]
    h = h_p.shape[-1]
    a1 = h_p @ w1  # [B, P + 2H]: state projection and GRU u/r gates
    sp = a1[:, :p_dim]
    alpha = _att_softmax(_att_scores(acts[2], ep, sp, v), emask)
    ctxv = context(alpha, enc)
    p = torch.addmm(xg_t, ctxv, w_ctx)  # [B, 3H] in (u, r, c) order
    p_ur = p[:, : 2 * h] + a1[:, p_dim:]
    rh = _gru_reset(acts, p_ur[:, h:], h_p)
    cpre = torch.addmm(p[:, 2 * h:], rh, w_c)
    h_t = _gru_final(acts, p_ur[:, :h], cpre, h_p, m)
    return h_t, (sp, alpha, ctxv, p_ur, cpre)


# rows of the [T, B, S, P] score-key tensors the post-loop dv / d_ep
# reductions hold at once (in f32)
_BIG_CHUNK_ELEMS = 1 << 25


class AttGruCore(torch.autograd.Function):
    """Time-major fused attention-GRU recurrence.  acts: (gate_act, act,
    att_act); xg: [T, B, 3H] target-side gate projections (+ biases); enc:
    [B, S, E] context values; ep: [B, S, P] score keys (+ biases); emask:
    [B, S] bool or None; w1: [H, P + 2H] = [W_state_proj | U_ur]; v: [P];
    w_ctx: [E, 3H]; w_c: [H, H]; h0: [B, H]; mask: [T, B, 1] bool; steps
    [lo, hi) run.  Returns (hs [T, B, H], h_last)."""

    @staticmethod
    def forward(ctx, xg, enc, ep, emask, w1, v, w_ctx, w_c, h0, mask, acts, lo, hi):
        h_t = h0
        seqs = ([], [], [], [], [], [])  # hs, sp, alpha, ctx, p_ur, cpre
        for t in range(lo, hi):
            h_t, saved = _attgru_step(acts, xg[t], h_t, enc, ep, emask, w1, v, w_ctx, w_c,
                                      mask[t])
            for acc, x in zip(seqs, (h_t,) + saved):
                acc.append(x)
        counters["attgru_steps"] += hi - lo
        counters["attgru_skipped"] += xg.shape[0] - (hi - lo)
        if hi > lo:
            live, sp_seq, alpha_seq, ctx_seq, pur_seq, cpre_seq = (torch.stack(s) for s in seqs)
        else:
            live = sp_seq = alpha_seq = ctx_seq = pur_seq = cpre_seq = h0.new_zeros(
                (0,) + tuple(h0.shape))
        ctx.acts, ctx.lo, ctx.hi = acts, lo, hi
        ctx.save_for_backward(sp_seq, alpha_seq, ctx_seq, pur_seq, cpre_seq, live,
                              enc, ep, w1, v, w_ctx, w_c, h0, mask)
        return _around(live, h0, h_t, lo, xg.shape[0]), h_t

    @staticmethod
    def backward(ctx, dhs, dh_last):
        (sp_seq, alpha_seq, ctx_seq, pur_seq, cpre_seq, live, enc, ep,
         w1, v, w_ctx, w_c, h0, mask) = ctx.saved_tensors
        acts, lo, hi = ctx.acts, ctx.lo, ctx.hi
        h = h0.shape[-1]
        t_all = dhs.shape[0]
        f_att = get_activation(acts[2])
        d_att = _DERIVS[acts[2]]
        dh = dh_last + dhs[hi:].sum(0) if hi < t_all else dh_last
        h_prev = torch.cat([h0[None], live[:-1]])
        w1_t, w_ctx_t, w_c_t = w1.t(), w_ctx.t(), w_c.t()
        outs = ([], [], [], [], [])  # da1, dxg, dctx, dpre, rh
        for i in reversed(range(hi - lo)):
            t = lo + i
            dh = dh + dhs[t]
            h_p, sp, alpha = h_prev[i], sp_seq[i], alpha_seq[i]
            dpu, dcpre, dh_p = _gru_final_vjp(
                acts, pur_seq[i, :, :h], cpre_seq[i], h_p, mask[t], dh)
            drh = dcpre @ w_c_t  # chain GEMM 1
            dpr, dh_p_r, rh = _gru_reset_vjp(acts, pur_seq[i, :, h:], h_p, drh)
            dxg = torch.cat([dpu, dpr, dcpre], -1)
            dctx = dxg @ w_ctx_t  # chain GEMM 2
            dalpha = torch.bmm(enc, dctx[:, :, None])[..., 0]
            # masked-softmax VJP: padding has alpha == 0 and drops out
            dpre = alpha * (dalpha - (alpha * dalpha).sum(-1, keepdim=True))
            x_s = ep + sp[:, None, :]
            fp = d_att(x_s, f_att(x_s))
            dsp = torch.bmm(dpre[:, None, :], fp)[:, 0] * v
            da1 = torch.cat([dsp, dpu, dpr], -1)
            dh = torch.addmm(dh_p + dh_p_r, da1, w1_t)  # chain GEMM 3 (the h_p link)
            for acc, x in zip(outs, (da1, dxg, dctx, dpre, rh)):
                acc.append(x)
        if lo:
            dh = dh + dhs[:lo].sum(0)
        dxg_all = dhs.new_zeros(tuple(dhs.shape[:2]) + (3 * h,))
        if hi == lo:
            zeros = [torch.zeros_like(x) for x in (enc, ep, w1, v, w_ctx, w_c)]
            return (dxg_all, *zeros[:2], None, *zeros[2:], dh, None, None, None, None)
        da1_seq, dxg_seq, dctx_seq, dpre_seq, rh_seq = (torch.stack(s[::-1]) for s in outs)
        dxg_all[lo:hi] = dxg_seq
        # one GEMM each over the saved sequences: f32 accumulation, rounded
        # once to the compute dtype
        dw1 = torch.einsum("tbh,tbg->hg", h_prev, da1_seq)
        dw_ctx = torch.einsum("tbe,tbg->eg", ctx_seq, dxg_seq)
        dw_c = torch.einsum("tbh,tbg->hg", rh_seq, dxg_seq[..., 2 * h:])
        d_enc = torch.einsum("tbs,tbe->bse", alpha_seq, dctx_seq)
        # static score-key gradients over the [T, B, S, P] act / act'
        # tensors, a few steps at a time, accumulated in f32
        acc = torch.promote_types(v.dtype, torch.float32)
        dv = torch.zeros(v.shape, dtype=acc, device=v.device)
        d_ep = torch.zeros(ep.shape, dtype=acc, device=ep.device)
        chunk = max(1, _BIG_CHUNK_ELEMS // max(ep.numel(), 1))
        for s in range(0, hi - lo, chunk):
            x_big = ep[None] + sp_seq[s:s + chunk, :, None, :]
            th_big = f_att(x_big)
            dpre_c = dpre_seq[s:s + chunk].to(acc)
            dv += torch.einsum("tbs,tbsp->p", dpre_c, th_big.to(acc))
            d_ep += torch.einsum("tbs,tbsp->bsp", dpre_c, d_att(x_big, th_big).to(acc))
        d_ep = (d_ep * v.to(acc)).to(ep.dtype)
        return (dxg_all, d_enc, d_ep, None, dw1, dv.to(v.dtype), dw_ctx, dw_c, dh,
                None, None, None, None)


def attention_gru_step(xg_t, h_p, enc, enc_proj, enc_mask, w1, v, w_ctx, w_c, *,
                       gate_act: str = "sigmoid", act: str = "tanh",
                       att_act: str = "tanh") -> torch.Tensor:
    """One fused decoder step for generation (beam and greedy stepping, the
    serving engine's decode): the scan core's step with every row live, its
    context summed in blocks so that a row's result does not depend on the
    padded extent S (the engine pads each row's memory to the batch's page
    rung, the one-shot path to its own ladder rung).  xg_t: [B, 3H] this step's
    target-side gate projections (+ biases); enc_mask: [B, S] bool or None.
    Returns h_t [B, H]."""
    m = torch.ones((h_p.shape[0], 1), dtype=torch.bool, device=h_p.device)
    h_t, _ = _attgru_step((gate_act, act, att_act), xg_t, h_p, enc, enc_proj, enc_mask, w1, v,
                          w_ctx, w_c, m, context=_context_blocks)
    return h_t


def attention_gru_scan(
    gates: torch.Tensor,  # [B, T, 3H] target-side input projections (+ bias)
    enc: torch.Tensor,  # [B, S, E] encoded sequence (context values)
    enc_proj: torch.Tensor,  # [B, S, P] projected keys (+ any folded biases)
    w1: torch.Tensor,  # [H, P + 2H] fused [W_state_proj | U_ur]
    v: torch.Tensor,  # [P] attention score vector
    w_ctx: torch.Tensor,  # [E, 3H] context -> gates projection
    w_c: torch.Tensor,  # [H, H] GRU candidate recurrent weight
    enc_lengths: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    *,
    gate_act: str = "sigmoid",
    act: str = "tanh",
    att_act: str = "tanh",
    reverse: bool = False,
    h0: Optional[torch.Tensor] = None,
    early_exit: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Bahdanau-attention GRU decoder over a padded batch, the same
    function as the unfused v1 lowering (simple_attention + gru_step in a
    recurrent_group).  `early_exit` runs only the live steps (with the
    ``scan_early_exit`` flag on).  Returns ([B, T, H], h_last)."""
    b, t, _ = gates.shape
    xs = gates.transpose(0, 1)
    if reverse:
        xs = xs.flip(0)
    mask = _mask_seq(lengths, t, reverse)
    if mask is None:
        mask = torch.ones((t, b, 1), dtype=torch.bool, device=gates.device)
    emask = None
    if enc_lengths is not None:
        emask = torch.arange(enc.shape[1], device=enc.device)[None, :] < enc_lengths[:, None]
    h_prev = h0 if h0 is not None else gates.new_zeros((b, w_c.shape[0]))
    lo, hi = live_range(lengths, t, reverse) if early_exit else (0, t)
    hs, h_last = AttGruCore.apply(xs, enc, enc_proj, emask, w1, v, w_ctx, w_c, h_prev, mask,
                                  (gate_act, act, att_act), lo, hi)
    if reverse:
        hs = hs.flip(0)
    return hs.transpose(0, 1), h_last
