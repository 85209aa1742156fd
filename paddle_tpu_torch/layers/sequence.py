"""Sequence layers — the counterpart of the part of
``paddle_tpu/layers/sequence.py`` the ported models use: sequence pooling
(``seqpool`` :63), first / last instance (``seqlastins`` :133), ``expand``
(:171), the LSTM over a whole sequence (``lstmemory``, :254-290), the GRU
over a whole sequence (``gru``, grumemory, :293-326), the simple recurrence
(``recurrent``, :327-353) and one GRU or LSTM step inside a recurrent group
(``gru_step`` :356-408, ``lstm_step`` :409-445).

All work on padded [B, T, ...] SeqTensors with length masks.  Not ported
yet: nested (sub-sequence) inputs and stride windows of the pooling and
selection layers (these raise), and the other sequence layers of the JAX
module (seqreshape, seqconcat, sampling_id, eos_id, ...).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializers as init
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.layers.base import register_layer
from paddle_tpu_torch.ops import rnn as rnn_ops
from paddle_tpu_torch.ops.activations import get_activation


def _plain_seq(conf, x: SeqTensor, what: str) -> None:
    if not x.is_seq:
        raise ValueError(f"{conf.name}: {what} input must be a sequence")
    if x.is_nested or conf.attr("agg_level", 0) == 1 or conf.attr("stride", -1) > 0:
        raise NotImplementedError(
            f"{conf.name}: {what} over nested sequences or stride windows is not ported yet")


def _masked_pool(data, mask, counts, kind):
    """Pool `data` over axis 1 under `mask`."""
    m = mask[..., None]
    if kind == "max":
        out = torch.where(m > 0, data, torch.full_like(data, float("-inf"))).amax(dim=1)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))  # all padding -> 0
    s = (data * m).sum(dim=1)
    if kind == "sum":
        return s
    n = torch.clamp(counts.to(data.dtype), min=1.0)[..., None]
    return s / torch.sqrt(n) if kind == "sqrt_n" else s / n


@register_layer("seqpool")
def seqpool_apply(conf, params, inputs, ctx):
    """SequencePoolLayer: max / average / sum / sqrt_n over time."""
    x = inputs[0]
    _plain_seq(conf, x, "seqpool")
    if conf.attr("output_max_index", False):
        masked = torch.where(x.mask(torch.bool)[..., None], x.data,
                             torch.full_like(x.data, float("-inf")))
        return SeqTensor(masked.argmax(dim=1).to(torch.int32))
    kind = conf.attr("pool_type", "max")
    return SeqTensor(_masked_pool(x.data, x.mask(x.data.dtype), x.lengths, kind))


@register_layer("seqlastins")
def seqlastins_apply(conf, params, inputs, ctx):
    """SequenceLastInstanceLayer: the first (select_first) or last valid
    element of each sequence."""
    x = inputs[0]
    _plain_seq(conf, x, "seqlastins")
    if conf.attr("select_first", False):
        return SeqTensor(x.data[:, 0])
    idx = torch.clamp(x.lengths.long() - 1, min=0)
    rows = torch.arange(x.data.shape[0], device=x.data.device)
    return SeqTensor(x.data[rows, idx])


@register_layer("expand")
def expand_apply(conf, params, inputs, ctx):
    """ExpandLayer FROM_NO_SEQUENCE: a per-sample [B, D] value repeated
    across the pattern sequence's [B, T] steps."""
    x, pattern = inputs
    if not pattern.is_seq or pattern.is_nested or x.is_seq or conf.attr("expand_level", 0):
        raise NotImplementedError(
            f"{conf.name}: expand is ported for a plain value over a plain sequence only")
    b, t = x.data.shape[0], pattern.max_len
    return SeqTensor(x.data[:, None, :].expand(b, t, x.data.shape[-1]), pattern.lengths)


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
