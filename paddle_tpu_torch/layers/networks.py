"""Prebuilt network compositions — the part of ``paddle_tpu/layers/networks.py``
(the ``trainer_config_helpers.networks`` surface) of the recurrent models:
``simple_lstm`` (:174), ``gru_unit`` (:212), ``gru_group`` (:242),
``lstmemory_unit`` (:277), ``lstmemory_group`` (:330), ``simple_gru``
(:366), ``simple_gru2`` (:401), ``bidirectional_lstm`` (:435),
``bidirectional_gru`` (:469) and ``simple_attention`` (:521).  Not ported
yet: the image networks and ``sequence_conv_pool`` (it needs
``context_projection``)."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import pooling as P
from paddle_tpu_torch.core.topology import LayerOutput, auto_name
from paddle_tpu_torch.layers import (
    addto, concat, expand, fc, first_seq, full_matrix_projection, grumemory, gru_step,
    identity_projection, last_seq, lstm_step, lstmemory, memory, mixed, pooling,
    recurrent_group, scaling,
)


def simple_lstm(
    input: LayerOutput,
    size: int,
    reverse: bool = False,
    act=None,
    gate_act=None,
    state_act=None,
    name: Optional[str] = None,
    mat_param_attr=None,
    bias_param_attr=None,
    inner_param_attr=None,
    lstm_cell_attr=None,
    mixed_layer_attr=None,
) -> LayerOutput:
    """An identity fc to 4 x size, then the lstmemory layer (reference
    simple_lstm).  lstm_cell_attr's drop_rate applies to the cell output;
    the parameter attrs beyond mat_param_attr are accepted and ignored, as
    in the JAX package."""
    proj = fc(
        input,
        size=size * 4,
        act=A.Identity(),
        bias_attr=False,
        param_attr=mat_param_attr,
        layer_attr=mixed_layer_attr,
        name=(name + "_transform") if name else None,
    )
    return lstmemory(proj, size=size, reverse=reverse, act=act, gate_act=gate_act,
                     state_act=state_act, layer_attr=lstm_cell_attr, name=name)


def gru_unit(
    input: LayerOutput,
    memory_boot: Optional[LayerOutput] = None,
    size: Optional[int] = None,
    name: Optional[str] = None,
    gru_bias_attr=None,
    gru_param_attr=None,
    act=None,
    gate_act=None,
    gru_layer_attr=None,
    naive: bool = False,
) -> LayerOutput:
    """One GRU step over a 3H-projected input with its own output memory
    (reference gru_unit): the building block of a recurrent_group."""
    size = size or input.size // 3
    name = name or auto_name("gru_unit")
    out_mem = memory(name=name, size=size, boot_layer=memory_boot)
    return gru_step(
        input=input, output_mem=out_mem, size=size,
        bias_attr=gru_bias_attr if gru_bias_attr is not None else True,
        param_attr=gru_param_attr, act=act, gate_act=gate_act, name=name, naive=naive,
    )


def gru_group(
    input: LayerOutput,
    memory_boot: Optional[LayerOutput] = None,
    size: Optional[int] = None,
    name: Optional[str] = None,
    reverse: bool = False,
    gru_bias_attr=None,
    gru_param_attr=None,
    act=None,
    gate_act=None,
    gru_layer_attr=None,
    naive: bool = False,
) -> LayerOutput:
    """The GRU as a recurrent_group of gru_step (reference gru_group): the
    math of grumemory through a composable step.  Two groups naming the same
    gru_param_attr (or bias attr) share exactly those parameters."""
    size = size or input.size // 3
    name = name or auto_name("gru_group")

    def step(x):
        return gru_unit(input=x, memory_boot=memory_boot, size=size, name=f"{name}_unit",
                        gru_bias_attr=gru_bias_attr, gru_param_attr=gru_param_attr,
                        act=act, gate_act=gate_act, naive=naive)

    return recurrent_group(step=step, input=input, reverse=reverse, name=name)


def lstmemory_unit(
    input: LayerOutput,
    out_memory: Optional[LayerOutput] = None,
    name: Optional[str] = None,
    size: Optional[int] = None,
    param_attr=None,
    act=None,
    gate_act=None,
    state_act=None,
    input_proj_bias_attr=None,
    input_proj_layer_attr=None,
    lstm_bias_attr=None,
    lstm_layer_attr=None,
) -> LayerOutput:
    """One LSTM step (reference lstmemory_unit): the recurrence enters
    through a mixed projection of the output memory (the step carries no
    W_h), and the cell rides the step's ``@cell`` side output."""
    size = size or input.size // 4
    name = name or auto_name("lstm_unit")
    out_mem = memory(name=name, size=size) if out_memory is None else out_memory
    state_mem = memory(name=f"{name}@cell", size=size)
    m = mixed(
        size=size * 4,
        input=[identity_projection(input=input),
               full_matrix_projection(input=out_mem, param_attr=param_attr)],
        bias_attr=input_proj_bias_attr if input_proj_bias_attr is not None else False,
        layer_attr=input_proj_layer_attr,
        act=A.Identity(),
        name=f"{name}_input_recurrent",
    )
    return lstm_step(
        input=m, output_mem=out_mem, state_mem=state_mem, size=size,
        bias_attr=lstm_bias_attr if lstm_bias_attr is not None else True,
        recurrent_weight=False, act=act, gate_act=gate_act, state_act=state_act, name=name,
    )


def lstmemory_group(
    input: LayerOutput,
    size: Optional[int] = None,
    name: Optional[str] = None,
    out_memory: Optional[LayerOutput] = None,
    reverse: bool = False,
    param_attr=None,
    act=None,
    gate_act=None,
    state_act=None,
    input_proj_bias_attr=None,
    input_proj_layer_attr=None,
    lstm_bias_attr=None,
    lstm_layer_attr=None,
) -> LayerOutput:
    """The LSTM as a recurrent_group of lstmemory_unit (reference
    lstmemory_group).  The inner projection declares param_attr's name and
    the step a named lstm_bias_attr, so same-named groups share per
    parameter."""
    size = size or input.size // 4
    name = name or auto_name("lstm_group")

    def step(x):
        return lstmemory_unit(
            input=x, out_memory=out_memory, name=f"{name}_unit", size=size,
            param_attr=param_attr, act=act, gate_act=gate_act, state_act=state_act,
            input_proj_bias_attr=input_proj_bias_attr,
            input_proj_layer_attr=input_proj_layer_attr,
            lstm_bias_attr=lstm_bias_attr, lstm_layer_attr=lstm_layer_attr,
        )

    return recurrent_group(step=step, input=input, reverse=reverse, name=name)


def simple_gru(
    input: LayerOutput,
    size: int,
    name: Optional[str] = None,
    reverse: bool = False,
    mixed_param_attr=None,
    mixed_bias_param_attr=None,
    mixed_layer_attr=None,
    gru_bias_attr=None,
    gru_param_attr=None,
    act=None,
    gate_act=None,
    gru_layer_attr=None,
    naive: bool = False,
) -> LayerOutput:
    """reference simple_gru: an identity fc to 3 x size, then gru_group."""
    proj = fc(
        input,
        size=size * 3,
        act=A.Identity(),
        bias_attr=mixed_bias_param_attr if mixed_bias_param_attr is not None else False,
        param_attr=mixed_param_attr,
        layer_attr=mixed_layer_attr,
        name=(name + "_transform") if name else None,
    )
    return gru_group(proj, size=size, name=name, reverse=reverse,
                     gru_bias_attr=gru_bias_attr, gru_param_attr=gru_param_attr, act=act,
                     gate_act=gate_act, gru_layer_attr=gru_layer_attr, naive=naive)


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


def _direction_kwargs(kwargs, what: str):
    """(forward kwargs, backward kwargs) of a bidirectional network: the
    reference routes fwd_* and bwd_* to each direction."""
    fwd = {k[4:]: v for k, v in kwargs.items() if k.startswith("fwd_")}
    bwd = {k[4:]: v for k, v in kwargs.items() if k.startswith("bwd_")}
    leftover = {k for k in kwargs if not k.startswith(("fwd_", "bwd_"))
                and k not in ("last_seq_attr", "first_seq_attr", "concat_attr", "concat_act")}
    if leftover:
        raise TypeError(f"{what} got unexpected kwargs {sorted(leftover)}")
    return fwd, bwd


def _bidirectional(fwd, bwd, name, return_seq, return_concat) -> LayerOutput:
    if return_concat is not None:  # the JAX package's legacy surface
        return concat([fwd, bwd]) if return_concat else addto([fwd, bwd])
    if return_seq:
        return concat([fwd, bwd], name=name)
    return concat([last_seq(input=fwd), first_seq(input=bwd)], name=name)


def bidirectional_lstm(
    input: LayerOutput,
    size: int,
    name: Optional[str] = None,
    return_seq: bool = False,
    return_concat: Optional[bool] = None,
    **kwargs,
) -> LayerOutput:
    """reference bidirectional_lstm: a forward and a reversed simple_lstm;
    return_seq=True concatenates the two output sequences [B, T, 2H], else
    (the reference default) the forward's last step with the backward's
    first [B, 2H]."""
    fwd_kw, bwd_kw = _direction_kwargs(kwargs, "bidirectional_lstm")
    fwd = simple_lstm(input, size, reverse=False, name=(name + "_fw") if name else None,
                      **fwd_kw)
    bwd = simple_lstm(input, size, reverse=True, name=(name + "_bw") if name else None,
                      **bwd_kw)
    return _bidirectional(fwd, bwd, name, return_seq, return_concat)


def bidirectional_gru(
    input: LayerOutput,
    size: int,
    name: Optional[str] = None,
    return_seq: bool = False,
    return_concat: Optional[bool] = None,
    **kwargs,
) -> LayerOutput:
    """reference bidirectional_gru: a forward and a reversed simple_gru2,
    combined as in :func:`bidirectional_lstm`."""
    fwd_kw, bwd_kw = _direction_kwargs(kwargs, "bidirectional_gru")
    fwd = simple_gru2(input, size, reverse=False, name=(name + "_fw") if name else None,
                      **fwd_kw)
    bwd = simple_gru2(input, size, reverse=True, name=(name + "_bw") if name else None,
                      **bwd_kw)
    return _bidirectional(fwd, bwd, name, return_seq, return_concat)


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
