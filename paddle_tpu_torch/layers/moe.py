"""Mixture-of-experts FFN on one device — the counterpart of
``paddle_tpu/layers/moe.py``: top-1 routing (Switch Transformer), a fixed
expert capacity C = max(int(N / E * capacity_factor), 1), the router
softmax in f32, padded tokens masked out of the gates and the routing, and
the load-balance term E * sum_e fraction_e * mean_prob_e written to the aux
output ``<name>@aux_loss`` ([B, 1], every row the scalar).

Dispatch by index.  The JAX package forms [N, E, C] one-hot dispatch and
combine tensors and contracts them with two einsums (2 * N * E * C * D
operations each: 86 GFLOP each at N = 8192, E = 8, C = 1280, D = 512).
Each (expert, slot) holds at most one token, so the same values come from
indexing: every kept token's slot is e * C + position, the tokens are
copied into the [E, C, D] expert buffer, and each slot's output row, times
its gate (rounded to the compute dtype first, as the JAX package's
``combine.astype(y.dtype)``), is copied back to its token.  Both are
``index_copy``s, so both backwards are gathers.  A token over capacity or
padded gets a zero row; no one-hot of a position is formed (an
out-of-range ``F.one_hot`` raises where ``jax.nn.one_hot`` gives zeros).

A layer with ``ExtraAttr(shard_axis="model")`` runs here unsharded: the
axis only places experts on a mesh in the JAX package and changes no
value."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializers as init
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.layers.base import register_layer
from paddle_tpu_torch.ops.activations import get_activation


def moe_init(conf, in_confs, gen, device):
    """Explicit fan-in stds: the default reads shape[0], which for the
    expert-major [E, D, H] tensors would be 1/sqrt(num_experts)."""
    d = in_confs[0].size
    e, h = conf.attr("num_experts"), conf.attr("expert_hidden")
    std = conf.attr("param_std")
    p = {
        "router": init.normal(gen, (d, e), std or init.default_std(d), device),
        "w1": init.normal(gen, (e, d, h), std or init.default_std(d), device),
        "w2": init.normal(gen, (e, h, conf.size), std or init.default_std(h), device),
    }
    if conf.bias:
        p["b1"] = init.zeros((e, h), device)
        p["b2"] = init.zeros((e, conf.size), device)
    return p


@register_layer("moe", init=moe_init, auto_activation=False)
def moe_apply(conf, params, inputs, ctx):
    x = inputs[0]
    d = x.data.shape[-1]
    e = conf.attr("num_experts")
    f_act = get_activation(conf.attr("active_type", "relu"))
    tokens = x.data.reshape(-1, d)  # [N, D]
    n = tokens.shape[0]
    cap = max(int(n / e * conf.attr("capacity_factor", 1.25)), 1)

    logits = tokens @ params["router"].to(tokens.dtype)
    gates = torch.softmax(logits.float(), dim=-1)  # [N, E]
    valid = None
    if x.is_nested:
        valid = x.sub_mask().reshape(-1)
    elif x.is_seq:
        valid = x.mask().reshape(-1)
    if valid is not None:
        # padded tokens must not take expert capacity
        gates = gates * valid[:, None]
    top_idx = torch.argmax(gates, dim=-1)  # the first maximum, as jnp.argmax
    top_gate = torch.gather(gates, 1, top_idx[:, None])[:, 0]
    # the routing expert-major ([E, N]: the cumsum runs along the inner axis)
    onehot = (torch.arange(e, device=tokens.device)[:, None] == top_idx[None, :]).float()
    if valid is not None:
        onehot = onehot * valid[None, :]
    # each token's position within its expert (exclusive cumsum)
    pos = ((torch.cumsum(onehot, dim=1) - 1.0) * onehot).sum(0)  # [N]
    kept = (onehot.sum(0) > 0) & (pos < cap)
    trash = e * cap  # the slot of every token not kept, cut off below
    slot = torch.where(kept, top_idx * cap + pos.to(torch.int64), torch.full_like(top_idx, trash))
    # the token in each slot (n, a row cut off below, for an empty slot)
    owner = torch.full((trash + 1,), n, dtype=torch.int64, device=tokens.device)
    owner = owner.scatter_(0, slot, torch.arange(n, device=tokens.device))[:trash]
    # dispatch and combine are copies to rows (many dropped tokens share the
    # trash row, many empty slots the row n; both are cut off), so each
    # backward is a gather: an indexed read's backward would accumulate
    # through those shared rows
    xin = tokens.new_zeros((trash + 1, d)).index_copy(0, slot, tokens)[:trash]

    h = torch.bmm(xin.view(e, cap, d), params["w1"])
    if "b1" in params:
        h = h + params["b1"][:, None, :]
    h = f_act(h)
    y = torch.bmm(h, params["w2"])
    if "b2" in params:
        y = y + params["b2"][:, None, :]
    # each slot's gate, rounded to the compute dtype first (the JAX
    # package's combine.astype(y.dtype)); 0 for an empty slot
    gate = y.new_zeros(trash + 1).index_copy(0, slot, top_gate.to(y.dtype))[:trash]
    y = y.reshape(trash, -1) * gate[:, None]
    out = y.new_zeros((n + 1, y.shape[-1])).index_copy(0, owner, y)[:n]  # [N, Dout]

    # the Switch load-balance term, every row of [B, 1] the scalar (a
    # sum_cost over it then a batch mean gives the scalar back)
    denom = onehot.sum().clamp_min(1.0)
    frac = onehot.sum(1) / denom
    prob = gates.sum(0) / denom
    aux = e * (frac * prob).sum()
    ctx.outputs[conf.name + "@aux_loss"] = SeqTensor(aux.expand(x.data.shape[0], 1))

    if valid is not None:
        out = out * valid[:, None].to(out.dtype)
    out = out.reshape(*x.data.shape[:-1], conf.size)
    return SeqTensor(out, x.lengths, x.sub_lengths)
