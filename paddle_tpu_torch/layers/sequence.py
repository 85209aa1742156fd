"""Sequence layers — the counterpart of ``paddle_tpu/layers/sequence.py``:
sequence pooling (``seqpool`` :63) and first / last instance
(``seqlastins`` :133) at both nesting levels and over stride windows
(``_stride_windows`` :43), ``expand`` (:171) to a plain or a nested pattern,
``seqreshape`` (:213), ``seqconcat`` (:229), the LSTM over a whole sequence
(``lstmemory``, :254-290), the GRU over a whole sequence (``gru``,
grumemory, :293-326), the simple recurrence (``recurrent``, :327-353), one
GRU or LSTM step inside a recurrent group (``gru_step`` :356-408,
``lstm_step`` :409-445), ``sampling_id`` (:448), ``eos_id`` (:464),
``context_projection`` (:480), ``row_conv`` (:508), ``conv_shift`` (:528)
and ``slice_time`` (:545).

All work on padded [B, T, ...] SeqTensors with length masks, and a nested
sequence on its doubly padded [B, S, T, ...] block with the subsequence
count and the per-subsequence lengths.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializers as init
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.layers.base import register_layer
from paddle_tpu_torch.ops import rnn as rnn_ops
from paddle_tpu_torch.ops.activations import get_activation


def _bcast(m: torch.Tensor, ndim: int) -> torch.Tensor:
    """`m` with trailing unit axes up to rank `ndim`."""
    return m.reshape(tuple(m.shape) + (1,) * (ndim - m.dim()))


def _masked_pool(data, mask, counts, kind):
    """Pool `data` over axis 1 under `mask` (the same leading axes)."""
    m = _bcast(mask, data.dim())
    if kind == "max":
        out = torch.where(m > 0, data, torch.full_like(data, float("-inf"))).amax(dim=1)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))  # all padding -> 0
    s = (data * m).sum(dim=1)
    if kind == "sum":
        return s
    n = _bcast(torch.clamp(counts.to(data.dtype), min=1.0), s.dim())
    return s / torch.sqrt(n) if kind == "sqrt_n" else s / n


def _stride_windows(data, lengths, stride):
    """[B, T, ...] cut into ceil(T / stride) windows of `stride` steps (the
    reference SequencePoolLayer's stride path, which emits a shorter
    sequence of per-window values): (windows [B*W, stride, ...], valid
    steps per window [B*W], W, output lengths [B])."""
    b, t = data.shape[:2]
    w = -(-t // stride)
    if w * stride > t:
        pad = data.new_zeros((b, w * stride - t) + tuple(data.shape[2:]))
        data = torch.cat([data, pad], dim=1)
    flat = data.reshape((b * w, stride) + tuple(data.shape[2:]))
    starts = torch.arange(w, device=lengths.device, dtype=lengths.dtype) * stride
    win_len = torch.clamp(lengths[:, None] - starts[None, :], 0, stride)
    out_lengths = torch.div(lengths + stride - 1, stride, rounding_mode="floor")
    return flat, win_len.reshape(b * w), w, out_lengths


def _check_seq(conf, x: SeqTensor, what: str, to_seq: bool, stride: int) -> None:
    if not x.is_seq:
        raise ValueError(f"{conf.name}: {what} input must be a sequence")
    if stride > 0 and (x.is_nested or to_seq):
        raise ValueError(f"{conf.name}: stride {what} is TO_NO_SEQUENCE over a plain sequence only")
    if to_seq and not x.is_nested:
        raise ValueError(f"{conf.name}: TO_SEQUENCE {what} needs a nested input")


@register_layer("seqpool")
def seqpool_apply(conf, params, inputs, ctx):
    """SequencePoolLayer: max / average / sum / sqrt_n over time.  Nested
    input: TO_SEQUENCE pools each subsequence into a plain sequence of
    pooled vectors, TO_NO_SEQUENCE pools the whole nested sample; stride >
    0 pools windows of `stride` steps into a shorter sequence."""
    x = inputs[0]
    kind = conf.attr("pool_type", "max")
    to_seq = conf.attr("agg_level", 0) == 1  # AggregateLevel.TO_SEQUENCE
    stride = conf.attr("stride", -1)
    _check_seq(conf, x, "pooling", to_seq, stride)
    if conf.attr("output_max_index", False):
        # MaxPooling(output_max_index=True): the argmax timestep per feature
        if x.is_nested or stride > 0:
            raise ValueError(f"{conf.name}: output_max_index pools a plain sequence only")
        masked = torch.where(x.mask(torch.bool)[..., None], x.data,
                             torch.full_like(x.data, float("-inf")))
        return SeqTensor(masked.argmax(dim=1).to(torch.int32))
    if stride > 0:
        b = x.data.shape[0]
        flat, counts, w, out_len = _stride_windows(x.data, x.lengths, stride)
        mask = (torch.arange(stride, device=counts.device)[None, :] < counts[:, None]).to(
            x.data.dtype)
        pooled = _masked_pool(flat, mask, counts, kind).reshape((b, w) + tuple(flat.shape[2:]))
        out = SeqTensor(pooled, out_len)
        return out.with_data(out.masked_data())
    if x.is_nested:
        b, s, t = x.data.shape[:3]
        rest = tuple(x.data.shape[3:])
        if to_seq:
            # each subsequence pooled -> a plain sequence of pooled vectors
            inner = (torch.arange(t, device=x.sub_lengths.device)[None, None, :]
                     < x.sub_lengths[:, :, None]).to(x.data.dtype)
            flat = _masked_pool(x.data.reshape((b * s, t) + rest), inner.reshape(b * s, t),
                                x.sub_lengths.reshape(b * s), kind)
            out = flat.reshape((b, s) + tuple(flat.shape[1:]))
            return SeqTensor(out * _bcast(x.mask(out.dtype), out.dim()), x.lengths)
        # the whole outer sequence -> one vector per sample
        mask = x.sub_mask(x.data.dtype).reshape(b, s * t)
        counts = x.sub_mask(torch.int32).sum(dim=(1, 2))
        return SeqTensor(_masked_pool(x.data.reshape((b, s * t) + rest), mask, counts, kind))
    return SeqTensor(_masked_pool(x.data, x.mask(x.data.dtype), x.lengths, kind))


def _select_ins(data, lengths, first):
    """The first or last valid element along axis 1 of [N, T, ...]: a
    gather, whose backward is a scatter-add (advanced indexing's backward
    sorts its indices)."""
    if first:
        return data[:, 0]
    idx = torch.clamp(lengths.long() - 1, min=0)
    idx = idx.reshape((-1, 1) + (1,) * (data.dim() - 2)).expand((-1, 1) + tuple(data.shape[2:]))
    return data.gather(1, idx).squeeze(1)


@register_layer("seqlastins")
def seqlastins_apply(conf, params, inputs, ctx):
    """SequenceLastInstanceLayer: the first (select_first) or last valid
    element of each sequence; of each subsequence (TO_SEQUENCE) or of the
    whole nested sample; of each stride window."""
    x = inputs[0]
    first = conf.attr("select_first", False)
    to_seq = conf.attr("agg_level", 0) == 1
    stride = conf.attr("stride", -1)
    _check_seq(conf, x, "selection", to_seq, stride)
    if stride > 0:
        b = x.data.shape[0]
        flat, counts, w, out_len = _stride_windows(x.data, x.lengths, stride)
        sel = _select_ins(flat, torch.clamp(counts, min=1), first)
        out = SeqTensor(sel.reshape((b, w) + tuple(sel.shape[1:])), out_len)
        return out.with_data(out.masked_data())
    if x.is_nested:
        b, s, t = x.data.shape[:3]
        rest = tuple(x.data.shape[3:])
        per_sub = _select_ins(x.data.reshape((b * s, t) + rest), x.sub_lengths.reshape(b * s),
                              first).reshape((b, s) + rest)  # [B, S, ...]
        if to_seq:
            return SeqTensor(per_sub * _bcast(x.mask(per_sub.dtype), per_sub.dim()), x.lengths)
        # of the whole nested sample: the first / last valid subsequence's
        # first / last element
        return SeqTensor(_select_ins(per_sub, x.lengths, first))
    return SeqTensor(_select_ins(x.data, x.lengths, first))


@register_layer("expand")
def expand_apply(conf, params, inputs, ctx):
    """ExpandLayer: a per-sample [B, D] value (FROM_NO_SEQUENCE) repeated
    across every step of the pattern, plain or nested; or (FROM_SEQUENCE) a
    [B, S, D] sequence whose element s repeats across the steps of the
    nested pattern's subsequence s."""
    x, pattern = inputs
    if not pattern.is_seq:
        raise ValueError(f"{conf.name}: the expand pattern must be a sequence")
    from_seq = conf.attr("expand_level", 0) == 1  # ExpandLevel.FROM_SEQUENCE
    if from_seq != x.is_seq:
        raise ValueError(
            f"{conf.name}: expand_level {'FROM_SEQUENCE' if from_seq else 'FROM_NO_SEQUENCE'} "
            f"does not match a {'sequence' if x.is_seq else 'non-sequence'} input")
    b, d = x.data.shape[0], x.data.shape[-1]
    if pattern.is_nested:
        s, t = pattern.max_len, pattern.max_sub_len
        if from_seq:
            if x.is_nested:
                raise ValueError(f"{conf.name}: FROM_SEQUENCE expands a plain sequence")
            # the feeder pads the nested S axis and a plain T axis apart:
            # align to the pattern's S (valid entries lie within both)
            xd = x.data[:, :s]
            if xd.shape[1] < s:
                xd = torch.cat([xd, xd.new_zeros((b, s - xd.shape[1], d))], dim=1)
            out = xd[:, :, None, :].expand(b, s, t, d)
        else:
            out = x.data[:, None, None, :].expand(b, s, t, d)
        return SeqTensor(out, pattern.lengths, pattern.sub_lengths)
    if from_seq:
        raise ValueError(f"{conf.name}: FROM_SEQUENCE needs a nested pattern")
    t = pattern.max_len
    return SeqTensor(x.data[:, None, :].expand(b, t, d), pattern.lengths)


@register_layer("seqreshape")
def seqreshape_apply(conf, params, inputs, ctx):
    """SequenceReshapeLayer: feature width D -> D' = conf.size, T' = T*D/D'."""
    x = inputs[0]
    if not x.is_seq:
        raise ValueError(f"{conf.name}: seqreshape input must be a sequence")
    b, t, d = x.data.shape
    d2 = conf.size
    out = x.masked_data().reshape(b, t * d // d2, d2)
    return SeqTensor(out, torch.div(x.lengths * d, d2, rounding_mode="floor"))


def _seqconcat(conf, a: SeqTensor, b: SeqTensor) -> SeqTensor:
    """b's valid steps right after a's, per row."""
    if not (a.is_seq and b.is_seq):
        raise ValueError(f"{conf.name}: seqconcat inputs must be sequences")
    ta, tb = a.max_len, b.max_len
    total = ta + tb
    out_len = a.lengths + b.lengths
    pos = torch.arange(total, device=a.lengths.device)[None, :]
    from_a = pos < a.lengths[:, None]
    b_idx = torch.clamp(pos - a.lengths[:, None], 0, tb - 1).long()
    a_idx = torch.clamp(pos, 0, ta - 1).long().expand(a.data.shape[0], total)
    rows = torch.arange(a.data.shape[0], device=a.data.device)[:, None]
    out = torch.where(_bcast(from_a, a.data.dim()), a.data[rows, a_idx], b.data[rows, b_idx])
    out = out * _bcast(pos < out_len[:, None], out.dim()).to(out.dtype)
    return SeqTensor(out, out_len)


@register_layer("seqconcat")
def seqconcat_apply(conf, params, inputs, ctx):
    """SequenceConcatLayer: two sequences concatenated along time."""
    return _seqconcat(conf, *inputs)


def lstmemory_init(conf, in_confs, gen, device):
    h = conf.size
    p = {"w_h": init.normal(gen, (h, 4 * h), conf.attr("param_std"), device)}
    if conf.bias:
        # the reference packs the gate bias and the three peepholes into one
        # 7H bias (LstmLayer.cpp); they stay named, as in the JAX package
        p["b"] = init.zeros((4 * h,), device)
        for k in ("w_ci", "w_cf", "w_co"):
            p[k] = init.normal(gen, (h,), 1.0, device)
    return p


@register_layer("lstmemory", init=lstmemory_init, auto_activation=False)
def lstmemory_apply(conf, params, inputs, ctx):
    """LstmLayer over an input pre-projected to 4H, through the LSTM core
    of ``ops/rnn.py``; without a bias the layer has no peepholes."""
    x = inputs[0]
    if not x.is_seq or x.is_nested:
        raise ValueError(f"{conf.name}: lstmemory input must be a plain sequence")
    hs, _ = rnn_ops.lstm_scan(
        x.data, params["w_h"], params.get("b"),
        params.get("w_ci"), params.get("w_cf"), params.get("w_co"), x.lengths,
        gate_act=conf.attr("gate_act", "sigmoid"),
        act=conf.attr("active_type", conf.act or "tanh"),
        state_act=conf.attr("state_act", "tanh"),
        reverse=conf.attr("reverse", False),
    )
    return SeqTensor(hs, x.lengths)


def gru_init(conf, in_confs, gen, device):
    h = conf.size
    p = {
        "w_h": init.normal(gen, (h, 2 * h), None, device),
        "w_c": init.normal(gen, (h, h), None, device),
    }
    if conf.bias:
        p["b"] = init.zeros((3 * h,), device)
    return p


@register_layer("gru", init=gru_init, auto_activation=False)
def gru_apply(conf, params, inputs, ctx):
    """GatedRecurrentLayer over an input pre-projected to 3H (grumemory),
    through the GRU core of ``ops/rnn.py``."""
    x = inputs[0]
    if not x.is_seq or x.is_nested:
        raise ValueError(f"{conf.name}: gru input must be a plain sequence")
    hs, _ = rnn_ops.gru_scan(
        x.data, params["w_h"], params["w_c"], params.get("b"), x.lengths,
        gate_act=conf.attr("gate_act", "sigmoid"),
        act=conf.attr("active_type", conf.act or "tanh"),
        reverse=conf.attr("reverse", False),
    )
    return SeqTensor(hs, x.lengths)


def recurrent_init(conf, in_confs, gen, device):
    h = conf.size
    p = {"w_h": init.normal(gen, (h, h), conf.attr("param_std"), device)}
    if conf.bias:
        p["b"] = init.zeros((h,), device)
    return p


@register_layer("recurrent", init=recurrent_init, auto_activation=False)
def recurrent_apply(conf, params, inputs, ctx):
    """RecurrentLayer: h_t = act(x_t + h_p W_h), through the simple-RNN core
    of ``ops/rnn.py``; `reverse` runs it from the last valid step."""
    x = inputs[0]
    if not x.is_seq or x.is_nested:
        raise ValueError(f"{conf.name}: recurrent input must be a plain sequence")
    hs, _ = rnn_ops.simple_rnn_scan(
        x.data, params["w_h"], params.get("b"), x.lengths,
        act=conf.act or "tanh", reverse=conf.attr("reverse", False),
    )
    return SeqTensor(hs, x.lengths)


def gru_step_init(conf, in_confs, gen, device):
    h = conf.size
    std = conf.attr("param_std")
    if conf.attr("tied_weights", False):
        p = {"w": init.normal(gen, (h, h), std, device)}
    else:
        p = {
            "w_h": init.normal(gen, (h, 2 * h), std, device),
            "w_c": init.normal(gen, (h, h), std, device),
        }
    if conf.bias:
        p["b"] = init.zeros((3 * h,), device)
    return p


@register_layer("gru_step", init=gru_step_init, auto_activation=False)
def gru_step_apply(conf, params, inputs, ctx):
    """One GRU step (GruStepLayer.cpp; gru_step_naive_layer has the same
    math): inputs (x [B, 3H], h_p [B, H]);
        u = gate(x_u + h_p U_u),  r = gate(x_r + h_p U_r)
        c = act(x_c + (r * h_p) W_c),  h = (1 - u) * h_p + u * c
    A tied naive step uses one H x H matrix `w` for all three."""
    x, h_p = inputs[0].data, inputs[1].data
    h = conf.size
    f_gate = get_activation(conf.attr("gate_act", "sigmoid"))
    f_act = get_activation(conf.attr("active_type", "tanh"))
    if "b" in params:
        x = x + params["b"]
    x_u, x_r, x_c = x.split(h, dim=-1)
    if conf.attr("tied_weights", False):
        w_c = params["w"]
        hw = h_p @ w_c
        u_t, r_t = f_gate(x_u + hw), f_gate(x_r + hw)
    else:
        w_c = params["w_c"]
        ur = h_p @ params["w_h"]
        u_t, r_t = f_gate(x_u + ur[:, :h]), f_gate(x_r + ur[:, h:])
    c_t = f_act(x_c + (r_t * h_p) @ w_c)
    return SeqTensor((1.0 - u_t) * h_p + u_t * c_t)


def lstm_step_init(conf, in_confs, gen, device):
    h = conf.size
    p = {}
    if conf.attr("recurrent_weight", True):
        p["w_h"] = init.normal(gen, (h, 4 * h), None, device)
    if conf.bias:
        p["b"] = init.zeros((4 * h,), device)
    return p


@register_layer("lstm_step", init=lstm_step_init, auto_activation=False)
def lstm_step_apply(conf, params, inputs, ctx):
    """One LSTM step (LstmStepLayer.cpp): inputs (gates [B, 4H], h_p [B, H],
    c_p [B, H]); returns h and writes the cell as the side output
    ``<name>@cell``, which a ``memory(name=<name>@cell)`` links to (the
    reference reaches it by get_output_layer on the step's second output).
    The step has no peepholes; without ``recurrent_weight`` the recurrence
    enters through the gates input (lstmemory_unit's mixed projection)."""
    x, h_p, c_p = (t.data for t in inputs)
    h = conf.size
    f_gate = get_activation(conf.attr("gate_act", "sigmoid"))
    f_act = get_activation(conf.attr("active_type", "tanh"))
    f_state = get_activation(conf.attr("state_act", "tanh"))
    a = x + h_p @ params["w_h"] if "w_h" in params else x
    if "b" in params:
        a = a + params["b"]
    a_i, a_f, a_g, a_o = a.split(h, dim=-1)
    c_t = f_gate(a_f) * c_p + f_gate(a_i) * f_act(a_g)
    h_t = f_gate(a_o) * f_state(c_t)
    ctx.outputs[conf.name + "@cell"] = SeqTensor(c_t)
    return SeqTensor(h_t)


@register_layer("sampling_id", auto_activation=False)
def sampling_id_apply(conf, params, inputs, ctx):
    """SamplingIdLayer: an id drawn from each row's distribution (weights
    max(p, 1e-10)) from the layer's generator when the step has a seed;
    the argmax without one (evaluation)."""
    x = inputs[0]
    gen = ctx.layer_rng(conf.name, x.data.device)
    if gen is None:
        out = x.data.argmax(dim=-1)
    else:
        probs = torch.clamp(x.data.float(), min=1e-10)
        flat = probs.reshape(-1, probs.shape[-1])
        out = torch.multinomial(flat, 1, generator=gen).reshape(probs.shape[:-1])
    return SeqTensor(out.to(torch.int32), x.lengths)


@register_layer("eos_id", auto_activation=False)
def eos_id_apply(conf, params, inputs, ctx):
    """EosIdCheckLayer: 1.0 where the id is the end-of-sequence id."""
    x = inputs[0]
    ids = x.data.to(torch.int32)
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    return SeqTensor((ids == conf.attrs["eos_id"]).to(torch.float32), x.lengths)


@register_layer("context_projection")
def context_projection_apply(conf, params, inputs, ctx):
    """ContextProjection: each step's window of `context_len` steps from
    `context_start` on, concatenated; steps outside the sequence read zeros."""
    x = inputs[0]
    if not x.is_seq:
        raise ValueError(f"{conf.name}: context_projection input must be a sequence")
    clen, start = conf.attrs["context_len"], conf.attrs["context_start"]
    data = x.masked_data()
    b, t, d = data.shape
    lo, hi = max(-start, 0), max(start + clen - 1, 0)
    padded = torch.cat([data.new_zeros((b, lo, d)), data, data.new_zeros((b, hi, d))], dim=1)
    first = lo + start
    return SeqTensor(torch.cat([padded[:, first + k:first + k + t] for k in range(clen)], dim=-1),
                     x.lengths)


def row_conv_init(conf, in_confs, gen, device):
    k = conf.attrs["context_len"]
    return {"w": init.normal(gen, (k, conf.size), 1.0 / max(k, 1), device)}


@register_layer("row_conv", init=row_conv_init)
def row_conv_apply(conf, params, inputs, ctx):
    """RowConvLayer: out_t = sum_j x_{t+j} * w_j over the look-ahead window."""
    x = inputs[0]
    if not x.is_seq:
        raise ValueError(f"{conf.name}: row_conv input must be a sequence")
    data = x.masked_data()
    b, t, d = data.shape
    k = conf.attrs["context_len"]
    padded = torch.cat([data, data.new_zeros((b, k - 1, d))], dim=1)
    out = padded[:, 0:t] * params["w"][0]
    for j in range(1, k):
        out = out + padded[:, j:j + t] * params["w"][j]
    return SeqTensor(out, x.lengths)


@register_layer("conv_shift")
def conv_shift_apply(conf, params, inputs, ctx):
    """ConvShiftLayer: circular convolution of a [B, D] row with a [B, K]
    kernel (K odd)."""
    a, b = inputs
    k, d = b.data.shape[-1], a.data.shape[-1]
    half = k // 2
    idx = (torch.arange(d, device=a.data.device)[:, None]
           + torch.arange(-half, half + 1, device=a.data.device)[None, :]) % d
    return SeqTensor(torch.einsum("bdk,bk->bd", a.data[:, idx], b.data), a.lengths)


@register_layer("slice_time")
def slice_time_apply(conf, params, inputs, ctx):
    """Step `offset` of a sequence as a non-sequence row."""
    return SeqTensor(inputs[0].data[:, conf.attr("offset", 0)])
