"""Transformer-base MT — the counterpart of
``paddle_tpu/models/transformer.py`` (BASELINE.json config #5), line for line:
a pre-LN encoder-decoder built from multi_head_attention / layer_norm /
pos_encoding, per-timestep fc for the FFN (or, with ``moe_experts``, a
top-1-routed mixture of experts in each encoder layer) and residuals via
addto.  Sequence parallelism is not ported yet."""

from __future__ import annotations

from typing import Tuple

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import layers as L
from paddle_tpu_torch.attr import ExtraAttr
from paddle_tpu_torch.core import data_types
from paddle_tpu_torch.core.topology import LayerOutput


def _ffn(x: LayerOutput, d_model: int, d_ff: int, name: str,
         moe_experts: int = 0) -> LayerOutput:
    if moe_experts:
        # sparse FFN: top-1-routed experts (layers/moe.py), marked for the
        # mesh model axis as in the JAX package; one device runs it unsharded
        return L.moe_layer(
            x, expert_hidden=d_ff, num_experts=moe_experts, size=d_model,
            layer_attr=ExtraAttr(shard_axis="model"),
            name=f"{name}_moe",
        )
    h = L.fc(x, size=d_ff, act=A.Relu(), name=f"{name}_ff1")
    return L.fc(h, size=d_model, act=A.Identity(), name=f"{name}_ff2")


def _encoder_layer(x, d_model, n_heads, d_ff, name, moe_experts=0):
    att = L.multi_head_attention(
        L.layer_norm(x, name=f"{name}_ln1"), n_heads=n_heads, name=f"{name}_att"
    )
    x = L.addto([x, att], act=A.Identity(), bias_attr=False, name=f"{name}_res1")
    ff = _ffn(L.layer_norm(x, name=f"{name}_ln2"), d_model, d_ff, name, moe_experts)
    return L.addto([x, ff], act=A.Identity(), bias_attr=False, name=f"{name}_res2")


def _decoder_layer(x, enc, d_model, n_heads, d_ff, name):
    self_att = L.multi_head_attention(
        L.layer_norm(x, name=f"{name}_ln1"),
        n_heads=n_heads,
        causal=True,
        name=f"{name}_self",
    )
    x = L.addto([x, self_att], act=A.Identity(), bias_attr=False, name=f"{name}_res1")
    cross = L.multi_head_attention(
        L.layer_norm(x, name=f"{name}_ln2"),
        key_value=enc,
        n_heads=n_heads,
        name=f"{name}_cross",
    )
    x = L.addto([x, cross], act=A.Identity(), bias_attr=False, name=f"{name}_res2")
    ff = _ffn(L.layer_norm(x, name=f"{name}_ln3"), d_model, d_ff, name)
    return L.addto([x, ff], act=A.Identity(), bias_attr=False, name=f"{name}_res3")


def transformer_cost(
    src_vocab: int,
    trg_vocab: int,
    d_model: int = 512,
    n_heads: int = 8,
    n_layers: int = 6,
    d_ff: int = 2048,
    moe_experts: int = 0,
) -> Tuple[LayerOutput, LayerOutput]:
    """Training topology and its softmax output.  Data slots: src_word ids,
    trg_word ids (bos-led decoder input), trg_next ids (shifted targets).
    moe_experts > 0 swaps the encoder FFNs for MoE blocks of that many
    experts (the decoder's stay dense; no aux term joins the cost)."""
    src = L.data("src_word", data_types.integer_value_sequence(src_vocab))
    trg = L.data("trg_word", data_types.integer_value_sequence(trg_vocab))
    lbl = L.data("trg_next", data_types.integer_value_sequence(trg_vocab))

    scale = float(d_model) ** 0.5
    x = L.pos_encoding(L.embedding(src, size=d_model, name="src_emb"), emb_scale=scale)
    for i in range(n_layers):
        x = _encoder_layer(x, d_model, n_heads, d_ff, f"enc{i}", moe_experts)
    enc = L.layer_norm(x, name="enc_ln")

    y = L.pos_encoding(L.embedding(trg, size=d_model, name="trg_emb"), emb_scale=scale)
    for i in range(n_layers):
        y = _decoder_layer(y, enc, d_model, n_heads, d_ff, f"dec{i}")
    dec = L.layer_norm(y, name="dec_ln")

    logits = L.fc(dec, size=trg_vocab, act=A.Softmax(), name="dec_out")
    cost = L.classification_cost(input=logits, label=lbl, name="mt_cost")
    return cost, logits


def transformer_base(src_vocab: int, trg_vocab: int):
    """Transformer-base (d_model 512, 8 heads, 6+6 layers, FFN 2048)."""
    return transformer_cost(src_vocab, trg_vocab, 512, 8, 6, 2048)
