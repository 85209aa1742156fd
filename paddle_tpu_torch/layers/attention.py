"""Attention-family layers: layer norm, multi-head attention, positional
encoding — the counterpart of ``paddle_tpu/layers/attention.py`` (:43,
:84-214, :433), the building blocks of Transformer-base MT — and the
structural matcher of the v1 attention-GRU decoder step
(``match_attention_gru_step``, JAX :286), which routes the NMT decoder onto
the fused recurrence of ``ops/rnn.py``.

Under bf16 mixed precision the softmax and layer-norm statistics compute in
float32 and cast back, as in the JAX package.  Multi-head attention with
equal query and key lengths goes through the flash-attention kernels
(``ops/flash_attention.py``: the forward, and the dq and dk/dv backward
kernels when a gradient is taken) when the ``use_flash_attention`` flag is on
and ``supported()`` holds; otherwise the dense path materialises the [T, T]
scores.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from paddle_tpu_torch.core import initializers as init
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.layers.base import register_layer
from paddle_tpu_torch.ops import acc_einsum, acc_matmul
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.utils.flags import get_flag

NEG_INF = -1e9


def layer_norm_init(conf, in_confs, gen, device):
    d = conf.size
    return {"gamma": init.ones((d,), device), "beta": init.zeros((d,), device)}


@register_layer("layer_norm", init=layer_norm_init, auto_activation=False)
def layer_norm_apply(conf, params, inputs, ctx):
    x = inputs[0]
    eps = conf.attr("epsilon", 1e-6)
    x32 = x.data.float()
    # two-pass (subtract-mean-first) statistics, as in the JAX package
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * params["gamma"].float() + params["beta"].float()
    return x.with_data(y.to(x.data.dtype))


def mha_init(conf, in_confs, gen, device):
    d = conf.size
    d_in_q = in_confs[0].size
    d_in_kv = in_confs[1].size if len(in_confs) > 1 else d_in_q
    std_q = 1.0 / math.sqrt(d_in_q)
    std_kv = 1.0 / math.sqrt(d_in_kv)
    p = {
        "wq": init.normal(gen, (d_in_q, d), std_q, device),
        "wk": init.normal(gen, (d_in_kv, d), std_kv, device),
        "wv": init.normal(gen, (d_in_kv, d), std_kv, device),
        "wo": init.normal(gen, (d, d), 1.0 / math.sqrt(d), device),
    }
    if conf.bias:
        p["b"] = init.zeros((d,), device)
    return p


@register_layer("multi_head_attention", init=mha_init, auto_activation=False)
def mha_apply(conf, params, inputs, ctx):
    """inputs: (query, key_value) — the same layer twice for self-attention.
    attrs: n_heads, causal."""
    q_in = inputs[0]
    kv_in = inputs[1] if len(inputs) > 1 else inputs[0]
    h = conf.attrs["n_heads"]
    causal = conf.attr("causal", False)
    d = conf.size
    dh = d // h
    if d % h:
        raise ValueError(f"{conf.name}: size {d} not divisible by n_heads {h}")
    if conf.attr("seq_parallel_axis") is not None:
        raise NotImplementedError(
            f"{conf.name}: seq_parallel_axis (ring attention) is not ported yet"
        )

    # self-attention by topology: one [D, 3D] GEMM; q, k, v stay strided
    # column slices of it (the kernel reads them through their strides)
    same_input = len(conf.inputs) == 1 or conf.inputs[0] == conf.inputs[1]
    if same_input:
        qkv = acc_matmul(
            q_in.data, torch.cat([params["wq"], params["wk"], params["wv"]], dim=1)
        )
        q, k, v = qkv.split(d, dim=-1)
    else:
        q = acc_matmul(q_in.data, params["wq"])
        k = acc_matmul(kv_in.data, params["wk"])
        v = acc_matmul(kv_in.data, params["wv"])
    b, tq = q.shape[0], q.shape[1]
    tk = k.shape[1]
    q = q.view(b, tq, h, dh)
    k = k.view(b, tk, h, dh)
    v = v.view(b, tk, h, dh)

    out = None
    if tq == tk and get_flag("use_flash_attention") and fa.supported(tq, dh):
        # the kernels on a CUDA tensor, their plain versions on a CPU tensor;
        # the autograd Function (backward kernels) when a gradient is wanted
        lengths = kv_in.lengths if kv_in.is_seq else None
        wants_grad = torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad
        )
        attend = fa.flash_attention_diff if wants_grad else fa.flash_attention
        out = attend(q, k, v, lengths, causal).reshape(b, tq, d)

    if out is None:  # dense path
        qh = q.permute(0, 2, 1, 3)
        kh = k.permute(0, 2, 1, 3)
        vh = v.permute(0, 2, 1, 3)
        scores = acc_einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(dh)
        scores = scores.float()
        if kv_in.is_seq:
            key_mask = kv_in.mask(torch.float32)  # [B, Tk]
            scores = scores + (1.0 - key_mask)[:, None, None, :] * NEG_INF
        if causal:
            cm = torch.tril(torch.ones((tq, tk), dtype=torch.float32, device=scores.device))
            scores = scores + (1.0 - cm)[None, None, :, :] * NEG_INF
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        out = (
            acc_einsum("bhqk,bhkd->bhqd", w, vh)
            .permute(0, 2, 1, 3)
            .reshape(b, tq, d)
        )

    out = acc_matmul(out, params["wo"])
    if "b" in params:
        out = out + params["b"]
    return SeqTensor(out, q_in.lengths, q_in.sub_lengths)


@register_layer("pos_encoding", auto_activation=False)
def pos_encoding_apply(conf, params, inputs, ctx):
    x = inputs[0]
    if not x.is_seq or x.is_nested:
        raise ValueError(f"{conf.name}: pos_encoding needs a plain sequence input")
    b, t, d = x.data.shape
    dev = x.data.device
    scale = conf.attr("emb_scale", 1.0)
    pos = torch.arange(t, dtype=torch.float32, device=dev)[:, None]  # [T, 1]
    div = torch.exp(
        torch.arange(0, d, 2, dtype=torch.float32, device=dev) * (-math.log(10000.0) / d)
    )
    pe = torch.zeros((t, d), dtype=torch.float32, device=dev)
    pe[:, 0::2] = torch.sin(pos * div)  # ceil(d/2) even channels
    pe[:, 1::2] = torch.cos(pos * div[: d // 2])  # floor(d/2) odd channels
    dt = x.data.dtype
    out = x.data * torch.tensor(scale, dtype=dt, device=dev) + pe.to(dt)
    return x.with_data(out)


# ---------------------------------------------------------------------------
# the v1 attention-GRU decoder step (JAX layers/attention.py:225-420)
# ---------------------------------------------------------------------------
#
#   expand(memory, enc_proj) -> fc(identity) --\
#                                 enc_proj -----+-> addto(act) -> fc(1,
#   seq_softmax) -> scaling(scores, enc) -> seqpool(sum) = context
#   fc([context, scanned...], 3H, identity) -> gru_step(., memory)
#
# match_attention_gru_step recognises it structurally (types, wiring, act and
# bias constraints) so recurrent_group can run the WHOLE step on the fused
# core (ops/rnn.py AttGruCore) with no config edits.  Anything that does not
# match keeps the generic per-layer step.


@dataclasses.dataclass(frozen=True)
class AttentionGRUMatch:
    """Layer names of a matched attention-GRU decoder step."""

    gru: str  # gru_step — the memory link
    in_proj: str  # fc building the 3H gate input from [context, scanned...]
    pool: str  # seqpool(sum) -> context
    scale: str  # scaling(scores, enc)
    scores: str  # fc size-1 sequence_softmax
    hidden: str  # addto(enc_proj, state_proj)
    state_proj: str  # fc over the expanded memory
    expand: str  # expand(memory, enc_proj)
    mem: str  # memory placeholder name
    enc_name: str  # static placeholder: encoded sequence (context values)
    ep_name: str  # static placeholder: encoded projection (score keys)
    ctx_slot: int  # index of the context input within in_proj.inputs
    scan_slots: Tuple[Tuple[int, str], ...]  # (in_proj slot, scan placeholder)
    gate_act: str
    act: str
    att_act: str
    matched: frozenset  # every matched layer name, for body-coverage checks


def _clean(c) -> bool:
    """No dropout / error-clip / dynamic-width on a candidate layer — the
    fused core implements none of them."""
    return (
        c.drop_rate == 0.0
        and not c.attr("error_clip", 0.0)
        and not c.attr("dynamic_width_in")
    )


# The fused backward takes the score activation's derivative elementwise
# (ops/rnn.py AttGruCore.backward), exact ONLY for elementwise
# activations.  A non-elementwise act (softmax, ...) on the
# attention hidden layer must fall back to the generic scan, or it would
# match, run, and train with silently wrong gradients.
_ELEMENTWISE_ATT_ACTS = frozenset({
    "", "identity", "linear", "tanh", "sigmoid", "relu", "brelu",
    "stanh", "softrelu", "abs", "square",
})


def _ident_act(c) -> bool:
    return c.act in ("identity", "linear", "")


def match_attention_gru_step(
    layers, mem_conf, scan_names, static_seq_names
) -> Optional[AttentionGRUMatch]:
    """Match the sub-topology rooted at `mem_conf`'s link against the v1
    attention-GRU decoder idiom.  `layers` is the step sub-topology's
    {name: LayerConf}; `scan_names` the scanned placeholder names;
    `static_seq_names` the sequence-valued static placeholder names.
    Returns None on any structural mismatch (callers fall back to the
    generic scan)."""
    if mem_conf.attrs.get("is_seq") or mem_conf.attrs.get("boot_const_id") is not None:
        return None
    link = mem_conf.attrs.get("link") or ""
    gru = layers.get(link)
    if (
        gru is None
        or gru.type != "gru_step"
        or gru.attr("tied_weights", False)
        or not _clean(gru)
        or len(gru.inputs) != 2
        or gru.inputs[1] != mem_conf.name
    ):
        return None
    h = gru.size
    in_proj = layers.get(gru.inputs[0])
    if (
        in_proj is None
        or in_proj.type != "fc"
        or not _ident_act(in_proj)
        or not _clean(in_proj)
        or in_proj.size != 3 * h
    ):
        return None
    # exactly one in_proj input is the pooled context; the rest must be
    # scanned placeholders (their projections hoist out of the scan)
    ctx_slot = None
    scan_slots = []
    for i, nm in enumerate(in_proj.inputs):
        c = layers.get(nm)
        if c is not None and c.type == "seqpool":
            if ctx_slot is not None:
                return None
            ctx_slot = i
        elif nm in scan_names:
            scan_slots.append((i, nm))
        else:
            return None
    if ctx_slot is None or not scan_slots:
        return None
    pool = layers[in_proj.inputs[ctx_slot]]
    if (
        pool.attr("pool_type", "max") != "sum"
        or pool.attr("agg_level", 0) != 0
        or pool.attr("stride", -1) > 0
        or pool.attr("output_max_index", False)
        or not _ident_act(pool)
        or not _clean(pool)
        or len(pool.inputs) != 1
    ):
        return None
    scale = layers.get(pool.inputs[0])
    if (
        scale is None
        or scale.type != "scaling"
        or not _ident_act(scale)
        or not _clean(scale)
        or len(scale.inputs) != 2
    ):
        return None
    scores_name, enc_name = scale.inputs
    if enc_name not in static_seq_names:
        return None
    scores = layers.get(scores_name)
    if (
        scores is None
        or scores.type != "fc"
        or scores.size != 1
        or scores.act != "sequence_softmax"
        or scores.bias
        or not _clean(scores)
        or len(scores.inputs) != 1
    ):
        return None
    hidden = layers.get(scores.inputs[0])
    if (
        hidden is None
        or hidden.type != "addto"
        or hidden.bias
        or not _clean(hidden)
        or len(hidden.inputs) != 2
        or hidden.act not in _ELEMENTWISE_ATT_ACTS
    ):
        return None
    ep_name = state_proj = None
    for nm in hidden.inputs:
        if nm in static_seq_names:
            ep_name = nm
        else:
            state_proj = layers.get(nm)
    if ep_name is None or state_proj is None:
        return None
    if (
        state_proj.type != "fc"
        or not _ident_act(state_proj)
        or not _clean(state_proj)
        or len(state_proj.inputs) != 1
    ):
        return None
    exp = layers.get(state_proj.inputs[0])
    if (
        exp is None
        or exp.type != "expand"
        or exp.attr("expand_level", 0) != 0
        or not _ident_act(exp)
        or not _clean(exp)
        or tuple(exp.inputs) != (mem_conf.name, ep_name)
    ):
        return None
    matched = frozenset(
        (gru.name, in_proj.name, pool.name, scale.name, scores.name,
         hidden.name, state_proj.name, exp.name)
    )
    return AttentionGRUMatch(
        gru=gru.name,
        in_proj=in_proj.name,
        pool=pool.name,
        scale=scale.name,
        scores=scores.name,
        hidden=hidden.name,
        state_proj=state_proj.name,
        expand=exp.name,
        mem=mem_conf.name,
        enc_name=enc_name,
        ep_name=ep_name,
        ctx_slot=ctx_slot,
        scan_slots=tuple(scan_slots),
        gate_act=gru.attr("gate_act", "sigmoid"),
        act=gru.attr("active_type", "tanh"),
        att_act=hidden.act or "identity",
        matched=matched,
    )
