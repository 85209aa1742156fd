"""Prebuilt network compositions — the part of ``paddle_tpu/layers/networks.py``
(the ``trainer_config_helpers.networks`` surface) the attention NMT model
uses: ``simple_gru2`` (:401) and ``simple_attention`` (:521)."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import pooling as P
from paddle_tpu_torch.core.topology import LayerOutput
from paddle_tpu_torch.layers import addto, expand, fc, grumemory, pooling, scaling


def simple_gru2(
    input: LayerOutput,
    size: int,
    name: Optional[str] = None,
    reverse: bool = False,
    mixed_param_attr=None,
    mixed_bias_attr=None,
    gru_param_attr=None,
    gru_bias_attr=None,
    act=None,
    gate_act=None,
    mixed_layer_attr=None,
    gru_cell_attr=None,
) -> LayerOutput:
    """reference simple_gru2 (networks.py:1061): an identity fc to 3 x size,
    then the grumemory layer (one GRU core over the sequence)."""
    proj = fc(
        input,
        size=size * 3,
        act=A.Identity(),
        bias_attr=mixed_bias_attr if mixed_bias_attr is not None else False,
        param_attr=mixed_param_attr,
        layer_attr=mixed_layer_attr,
        name=(name + "_transform") if name else None,
    )
    return grumemory(
        proj, size=size, reverse=reverse, act=act, gate_act=gate_act,
        param_attr=gru_param_attr,
        bias_attr=gru_bias_attr if gru_bias_attr is not None else True,
        layer_attr=gru_cell_attr, name=name,
    )


def simple_attention(
    encoded_sequence: LayerOutput,
    encoded_proj: LayerOutput,
    decoder_state: LayerOutput,
    transform_bias_attr=False,
    name: Optional[str] = None,
) -> LayerOutput:
    """Bahdanau attention (reference simple_attention, networks.py:1400):
    score = fc(tanh(enc_proj + expand(fc(state)))) under sequence_softmax,
    context = the score-weighted sum over time.  Used inside a
    recurrent_group step: the encoded values are StaticInput sequences
    [B, S, D], decoder_state a memory [B, H]."""
    expanded = expand(decoder_state, encoded_proj)
    state_proj = fc(
        expanded,
        size=encoded_proj.size,
        act=A.Identity(),
        bias_attr=transform_bias_attr,
        name=(name + "_state_proj") if name else None,
    )
    attn_hidden = addto([encoded_proj, state_proj], act=A.Tanh(), bias_attr=False)
    scores = fc(
        attn_hidden,
        size=1,
        act=A.SequenceSoftmax(),
        bias_attr=False,
        name=(name + "_scores") if name else None,
    )
    scaled = scaling(scores, encoded_sequence)
    return pooling(scaled, P.Sum(), name=(name + "_context") if name else None)
