"""Seq2seq NMT with attention — the counterpart of the training half of
``paddle_tpu/models/seq2seq.py`` (BASELINE.json config #3, bench.py's
``nmt_tokens_per_sec``): a bi-GRU encoder and an attention-GRU decoder in a
recurrent_group, built from the same simple_gru2 / simple_attention DSL and
with the same layer names, so parameters carry over between the packages by
path.  The decoder step matches the fused attention-GRU idiom, so training
runs it on ``ops/rnn.py``'s ``attention_gru_scan``.

Not ported yet: generation (``seq2seq_generation``, ``Seq2SeqGenerator``,
``make_fused_step``, ops/beam.py).
"""

from __future__ import annotations

from typing import Tuple

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import layers as L
from paddle_tpu_torch.core import data_types
from paddle_tpu_torch.core.topology import LayerOutput
from paddle_tpu_torch.layers import networks


def encoder_net(src_word: LayerOutput, word_dim: int,
                hidden_dim: int) -> Tuple[LayerOutput, LayerOutput]:
    """Bi-GRU encoder; returns (encoded sequence [B, S, 2H], its
    projection [B, S, H])."""
    emb = L.embedding(src_word, size=word_dim, name="src_emb")
    fwd = networks.simple_gru2(emb, size=hidden_dim, name="enc_fw")
    bwd = networks.simple_gru2(emb, size=hidden_dim, reverse=True, name="enc_bw")
    enc = L.concat([fwd, bwd], name="enc")
    enc_proj = L.fc(enc, size=hidden_dim, act=A.Identity(), bias_attr=False, name="enc_proj")
    return enc, enc_proj


def decoder_step_builder(hidden_dim: int, trg_vocab: int, boot: LayerOutput):
    """The recurrent_group step function; `boot` (an outer layer) gives the
    decoder state's first value."""

    def step(trg_emb_t, enc_seq, enc_p):
        state = L.memory("dec_state", hidden_dim, boot_layer=boot)
        context = networks.simple_attention(
            encoded_sequence=enc_seq, encoded_proj=enc_p, decoder_state=state, name="att")
        inputs = L.fc([context, trg_emb_t], size=hidden_dim * 3, act=A.Identity(),
                      bias_attr=False, name="dec_in_proj")
        gru = L.gru_step(inputs, state, size=hidden_dim, name="dec_state")
        return L.fc(gru, size=trg_vocab, act=A.Softmax(), name="dec_out")

    return step


def _encoder_and_boot(src_vocab: int, word_dim: int, hidden_dim: int):
    """The source-side block: the encoder and the decoder's boot state."""
    src = L.data("src_word", data_types.integer_value_sequence(src_vocab))
    enc, enc_proj = encoder_net(src, word_dim, hidden_dim)
    boot = L.fc(L.first_seq(enc, name="enc_first"), size=hidden_dim, act=A.Tanh(),
                name="dec_boot")
    return enc, enc_proj, boot


def seq2seq_cost(src_vocab: int, trg_vocab: int, word_dim: int = 128,
                 hidden_dim: int = 256) -> Tuple[LayerOutput, LayerOutput]:
    """Training topology.  Data slots: src_word ids, trg_word ids (led by
    the start id), trg_next ids (the shifted targets).  Returns (cost,
    decoder output)."""
    enc, enc_proj, boot = _encoder_and_boot(src_vocab, word_dim, hidden_dim)
    trg = L.data("trg_word", data_types.integer_value_sequence(trg_vocab))
    lbl = L.data("trg_next", data_types.integer_value_sequence(trg_vocab))
    trg_emb = L.embedding(trg, size=word_dim, name="trg_emb")
    dec = L.recurrent_group(
        decoder_step_builder(hidden_dim, trg_vocab, boot),
        [trg_emb, L.StaticInput(enc, is_seq=True), L.StaticInput(enc_proj, is_seq=True)],
        name="decoder",
    )
    cost = L.classification_cost(input=dec, label=lbl, name="nmt_cost")
    return cost, dec
