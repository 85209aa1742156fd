"""Prebuilt network compositions — a copy of ``paddle_tpu/layers/networks.py``,
the ``trainer_config_helpers.networks`` surface (reference:
python/paddle/trainer_config_helpers/networks.py: simple_img_conv_pool,
vgg_16_network, simple_lstm, lstmemory_group, simple_gru,
bidirectional_lstm, simple_attention, sequence_conv_pool).  Auto names
follow the JAX package's exactly, so the Topologies serialize alike; a
composition over an unported layer type (``sequence_conv_pool`` needs
``context_projection``) fails when its network is compiled."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import pooling as P
from paddle_tpu_torch.core.topology import LayerOutput, auto_name
from paddle_tpu_torch.layers import (
    addto,
    concat,
    data,
    expand,
    fc,
    first_seq,
    full_matrix_projection,
    gru_step,
    grumemory,
    identity_projection,
    img_conv,
    img_pool,
    last_seq,
    lstm_step,
    lstmemory,
    mixed,
    pooling,
    recurrent_group,
    scaling,
    seq_reshape,
)
from paddle_tpu_torch.layers import StaticInput, memory
from paddle_tpu_torch.layers import sequence  # noqa: F401
from paddle_tpu_torch.core.topology import LayerConf


def simple_img_conv_pool(
    input: LayerOutput,
    filter_size: int,
    num_filters: int,
    pool_size: int,
    pool_stride: Optional[int] = None,
    num_channel: Optional[int] = None,
    act=None,
    padding: int = 0,
    pool_type=None,
    name: Optional[str] = None,
) -> LayerOutput:
    conv = img_conv(
        input,
        filter_size=filter_size,
        num_filters=num_filters,
        num_channels=num_channel,
        padding=padding,
        act=act,
        name=(name + "_conv") if name else None,
    )
    return img_pool(
        conv,
        pool_size=pool_size,
        stride=pool_stride or pool_size,
        pool_type=pool_type,
        name=(name + "_pool") if name else None,
    )


def img_conv_group(
    input: LayerOutput,
    conv_num_filter,
    pool_size: int,
    num_channels: Optional[int] = None,
    conv_padding=1,
    conv_filter_size=3,
    conv_act=None,
    conv_with_batchnorm=False,
    conv_batchnorm_drop_rate=0,
    pool_stride: int = 1,
    pool_type=None,
    param_attr=None,
) -> LayerOutput:
    """Image convolution group — [conv (+bn +dropout)]×N then one pool
    (reference networks.py:333 img_conv_group, the VGG building block).
    Scalar conv_* arguments broadcast across the group like the reference."""
    from paddle_tpu_torch.layers import batch_norm, dropout

    n = len(conv_num_filter)

    def bcast(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * n

    paddings = bcast(conv_padding)
    fsizes = bcast(conv_filter_size)
    acts = bcast(conv_act)
    with_bn = bcast(conv_with_batchnorm)
    bn_drop = bcast(conv_batchnorm_drop_rate)

    tmp = input
    for i in range(n):
        tmp = img_conv(
            tmp,
            filter_size=fsizes[i],
            num_filters=conv_num_filter[i],
            num_channels=num_channels if i == 0 else None,
            padding=paddings[i],
            act=A.Identity() if with_bn[i] else acts[i],
            param_attr=param_attr,
        )
        if with_bn[i]:
            tmp = batch_norm(tmp, act=acts[i])
            if bn_drop[i] > 0:
                tmp = dropout(tmp, bn_drop[i])
    return img_pool(tmp, pool_size=pool_size, stride=pool_stride, pool_type=pool_type)


def small_vgg(input_image: LayerOutput, num_channels: int, num_classes: int):
    """reference networks.py:435 small_vgg — 4 bn-conv groups + pool +
    dropout + fc."""
    from paddle_tpu_torch.layers import dropout

    def block(ipt, num_filter, times, dropouts, ch_in=None):
        return img_conv_group(
            ipt,
            num_channels=ch_in,
            pool_size=2,
            pool_stride=2,
            conv_num_filter=[num_filter] * times,
            conv_filter_size=3,
            conv_act=A.Relu(),
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts,
            pool_type=P.Max(),
        )

    tmp = block(input_image, 64, 2, [0.3, 0], num_channels)
    tmp = block(tmp, 128, 2, [0.4, 0])
    tmp = block(tmp, 256, 3, [0.4, 0.4, 0])
    tmp = block(tmp, 512, 3, [0.4, 0.4, 0])
    from paddle_tpu_torch.attr import ExtraAttr
    from paddle_tpu_torch.layers import batch_norm

    tmp = img_pool(tmp, stride=2, pool_size=2, pool_type=P.Max())
    tmp = dropout(tmp, 0.5)
    tmp = fc(tmp, size=512, act=A.Linear(), layer_attr=ExtraAttr(drop_rate=0.5))
    tmp = batch_norm(tmp, act=A.Relu())
    return fc(tmp, size=num_classes, act=A.Softmax())


def vgg_16_network(input_image: LayerOutput, num_channels: int, num_classes: int = 1000):
    """reference vgg_16_network (networks.py)."""

    def block(ipt, num_filter, groups, ch_in=None):
        out = ipt
        for i in range(groups):
            out = img_conv(
                out,
                filter_size=3,
                num_filters=num_filter,
                num_channels=ch_in if i == 0 else None,
                padding=1,
                act=A.Relu(),
            )
        return img_pool(out, pool_size=2, stride=2)

    t = block(input_image, 64, 2, num_channels)
    t = block(t, 128, 2)
    t = block(t, 256, 3)
    t = block(t, 512, 3)
    t = block(t, 512, 3)
    t = fc(t, size=4096, act=A.Relu(), layer_attr=None)
    t = fc(t, size=4096, act=A.Relu())
    return fc(t, size=num_classes, act=A.Softmax())


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


def sequence_conv_pool(
    input: LayerOutput,
    context_len: int,
    hidden_size: int,
    pool_type=None,
    act=None,
    name: Optional[str] = None,
) -> LayerOutput:
    """Text conv (context window projection + fc) then seq pooling
    (reference sequence_conv_pool / context_projection path)."""
    from paddle_tpu_torch.layers import context_projection

    ctxp = context_projection(input, context_len=context_len)
    h = fc(ctxp, size=hidden_size, act=act or A.Tanh(),
           name=(name + "_conv") if name else None)
    return pooling(h, pool_type or P.Max(), name=(name + "_pool") if name else None)


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
