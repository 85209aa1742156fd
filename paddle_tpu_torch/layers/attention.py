"""Attention-family layers: layer norm, multi-head attention, positional
encoding — the counterpart of ``paddle_tpu/layers/attention.py`` (:43,
:84-214, :433), the building blocks of Transformer-base MT.

Under bf16 mixed precision the softmax and layer-norm statistics compute in
float32 and cast back, as in the JAX package.  Multi-head attention with
equal query and key lengths goes through the flash-attention kernels
(``ops/flash_attention.py``: the forward, and the dq and dk/dv backward
kernels when a gradient is taken) when the ``use_flash_attention`` flag is on
and ``supported()`` holds; otherwise the dense path materialises the [T, T]
scores.
"""

from __future__ import annotations

import math

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
