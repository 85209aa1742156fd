"""Sequence-tagging NER — the v1_api_demo/sequence_tagging topology family
(rnn_crf.py) as the JAX package builds it (``paddle_tpu/models/
sequence_tagging.py``): a bidirectional simple-RNN encoder under a
linear-chain CRF, decoded by Viterbi.

``ParamAttr(sparse_update=True)`` marks the word table as the reference's
sparse-update parameter.  Without a device mesh the JAX package trains it
densely, and so does the port; a ``shard_axis`` (the mesh-sharded table) is
recorded on the layers and makes the network raise ``NotImplementedError``
when it is compiled, until the port has meshes."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core.topology import LayerOutput

L = paddle.layer
A = paddle.activation


def ner_crf_cost(
    vocab: int,
    num_labels: int,
    word_dim: int = 32,
    hidden_dim: int = 32,
    sparse_update: bool = True,
    shard_axis: Optional[str] = None,
) -> Tuple[LayerOutput, LayerOutput]:
    """Bidirectional RNN + linear-chain CRF tagger (rnn_crf.py's shape).
    Returns (crf cost, crf_decoding output).  Data slots: `word` id
    sequence, `label` id sequence."""
    word = L.data("word", paddle.data_type.integer_value_sequence(vocab))
    label = L.data("label", paddle.data_type.integer_value_sequence(num_labels))
    emb = L.embedding(
        word, size=word_dim,
        param_attr=paddle.attr.ParamAttr(sparse_update=sparse_update), name="word_emb",
    )
    fc_attr = paddle.attr.ExtraAttr(shard_axis=shard_axis) if shard_axis else None
    fwd = L.recurrent(
        L.fc(emb, size=hidden_dim, act=A.Linear(), name="proj_f", layer_attr=fc_attr),
        act=A.Tanh(), name="rnn_f",
    )
    bwd = L.recurrent(
        L.fc(emb, size=hidden_dim, act=A.Linear(), name="proj_b", layer_attr=fc_attr),
        act=A.Tanh(), reverse=True, name="rnn_b",
    )
    feat = L.fc(L.concat([fwd, bwd]), size=num_labels, act=A.Linear(), name="crf_input")
    # crf and crf_decoding share the transitions by parameter name, as the
    # reference configs do (linear_crf.py ParamAttr("crfw"))
    crfw = paddle.attr.ParamAttr(name="crfw")
    cost = L.crf(input=feat, label=label, size=num_labels, param_attr=crfw, name="crf_cost")
    decode = L.crf_decoding(input=feat, size=num_labels, param_attr=crfw, name="crf_decode")
    return cost, decode


def synthetic_tag_reader(vocab: int, num_labels: int, n: int = 128, seed: int = 0):
    """Synthetic NER-like data: each word id maps to one tag (id %
    num_labels), so the tagger can learn it from the embedding alone."""

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            length = int(rng.randint(3, 10))
            words = rng.randint(0, vocab, size=length)
            yield list(words), list(words % num_labels)

    return reader
