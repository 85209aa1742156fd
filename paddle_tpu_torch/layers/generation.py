"""Generation layers: ``GeneratedInput`` and ``beam_search`` as a layer — the
counterpart of ``paddle_tpu/layers/generation.py`` (reference
trainer_config_helpers/layers.py beam_search/GeneratedInput and the
generation mode of RecurrentGradientMachine).  The whole search
(``ops/beam.py``) runs inside the layer, so
``paddle.infer(output_layer=beam, field='id')`` generates end to end.

Parameter layout: the step sub-network's parameters live under this layer's
name exactly as a ``recurrent_group`` of the same name stores them, so a
generation topology whose beam layer shares the training group's name and
step function loads trained weights unchanged.  The previous-token
embedding table is this layer's ``@gen_emb`` parameter; copy the training
embedding in with ``parameters.set("<beam_name>.@gen_emb.w",
trained.get("<emb_name>.w"))``.

The layer runs at full precision: under bf16 compute it gets f32 inputs and
parameters, and the search's scores stay f32 (its step sub-network computes
at the network's dtype).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from paddle_tpu_torch.core import initializers as init
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.core.topology import LayerConf, LayerOutput, Topology, auto_name
from paddle_tpu_torch.layers.base import ApplyContext, register_layer
from paddle_tpu_torch.layers.recurrent_group import StaticInput, _group_build
from paddle_tpu_torch.utils.flags import get_flag


class GeneratedInput:
    """The decoder's own previous output, embedded and fed back each step
    (reference GeneratedInput).  `size` is the vocabulary, `embedding_size`
    the embedding width fed to the step function."""

    def __init__(self, size: int, embedding_size: int, embedding_name: Optional[str] = None):
        self.size = size
        self.embedding_size = embedding_size
        self.embedding_name = embedding_name


def beam_search(
    step,
    input: Sequence[Union[GeneratedInput, StaticInput]],
    bos_id: int,
    eos_id: int,
    beam_size: Optional[int] = None,
    max_length: int = 30,
    num_results_per_sample: Optional[int] = None,
    name: Optional[str] = None,
    candidate_adjust_fn=None,
    drop_fn=None,
    norm_fn=None,
) -> LayerOutput:
    """A generation layer.  `step` is the step function a training
    ``recurrent_group`` would use: its GeneratedInput argument receives the
    embedded previous token ([B, embedding_size]), StaticInputs behave as in
    recurrent_group, and ``memory()`` links carry the decoder state.  The
    step ends in a softmax over the vocabulary.  The three hooks are
    ``ops/beam.py``'s.

    Output: int32 ids [B, N, T] best first, N = num_results_per_sample if
    set (the best of the K = beam_size searched beams) else K; the beam
    scores are the side output ``<name>@scores`` ([B, N]), which
    ``get_output(beam, "scores")`` selects."""
    if beam_size is None:
        beam_size = get_flag("beam_size")
    gens = [i for i in input if isinstance(i, GeneratedInput)]
    statics = [i for i in input if isinstance(i, StaticInput)]
    if len(gens) != 1:
        raise ValueError("beam_search needs exactly one GeneratedInput")
    gen = gens[0]
    gname = name or auto_name("beam_search")

    step_args: List[LayerOutput] = []
    gen_conf = LayerConf(name=f"{gname}@in0", type="step_input", size=gen.embedding_size,
                         bias=False)
    static_confs: List[LayerConf] = []
    # the step is called with its inputs in the user's order
    for i in input:
        if isinstance(i, GeneratedInput):
            step_args.append(LayerOutput(gen_conf))
        else:
            conf = LayerConf(name=f"{gname}@static{len(static_confs)}", type="step_input",
                             size=i.input.size, bias=False, attrs={"static_seq": i.is_seq})
            static_confs.append(conf)
            step_args.append(LayerOutput(conf))

    with _group_build() as gb:
        out = step(*step_args)
    if isinstance(out, (list, tuple)):
        raise ValueError("a beam_search step returns one layer")
    if out.size != gen.size:
        raise ValueError(f"beam step output size {out.size} != vocabulary {gen.size}")
    sub_topo = Topology([out])

    outer_inputs = [s.input for s in statics] + list(gb.boot_layers.values())
    attrs = {
        "_sub_topology": sub_topo,
        "_memories": tuple(gb.memories),
        "_gen_placeholder": gen_conf.name,
        "_static_placeholders": tuple(
            (c.name, c.attrs.get("static_seq", False)) for c in static_confs),
        "_output": out.name,
        "vocab": gen.size,
        "emb_size": gen.embedding_size,
        "bos_id": bos_id,
        "eos_id": eos_id,
        "beam_size": beam_size,
        "max_length": max_length,
    }
    if num_results_per_sample:
        attrs["num_results"] = int(num_results_per_sample)
    for key, fn in (("_candidate_adjust_fn", candidate_adjust_fn), ("_drop_fn", drop_fn),
                    ("_norm_fn", norm_fn)):
        if fn:
            attrs[key] = fn
    conf = LayerConf(name=gname, type="beam_search", size=max_length,
                     inputs=tuple(o.name for o in outer_inputs), bias=False, attrs=attrs)
    return LayerOutput(conf, outer_inputs)


def _bs_init(conf, in_confs, gen, device):
    from paddle_tpu_torch.core.compiler import CompiledNetwork

    seed = int(torch.randint(0, 2**62, (1,), generator=gen))
    params = CompiledNetwork(conf.attrs["_sub_topology"]).init_params(seed, device)
    params["@gen_emb"] = {
        "w": init.normal(gen, (conf.attrs["vocab"], conf.attrs["emb_size"]), device=device)}
    return params


def _bs_build(conf, compute_dtype):
    """The step sub-network, compiled once with the enclosing network."""
    from paddle_tpu_torch.core.compiler import CompiledNetwork

    return CompiledNetwork(conf.attrs["_sub_topology"], compute_dtype=compute_dtype)


@register_layer("beam_search", init=_bs_init, auto_activation=False, full_precision=True,
                build=_bs_build)
def beam_search_apply(conf, params, inputs, ctx: ApplyContext) -> SeqTensor:
    from paddle_tpu_torch.ops import beam as beam_ops

    a = conf.attrs
    subnet = ctx.plans[conf.name]
    memories = a["_memories"]
    static_info = a["_static_placeholders"]
    out_name = a["_output"]

    statics = inputs[: len(static_info)]  # the rest are boot layers
    b = (statics[0] if statics else inputs[0]).data.shape[0]
    emb_w = params["@gen_emb"]["w"]
    sub_params = {k: v for k, v in params.items() if k != "@gen_emb"}

    init_mem = {}
    for m in memories:
        boot = m.attrs.get("boot")
        if boot is not None:
            init_mem[m.name] = ctx.outputs[boot].data
        else:
            init_mem[m.name] = torch.zeros((b, m.size), dtype=emb_w.dtype, device=emb_w.device)
    # the statics ride the carry, so the search expands them to B*K rows and
    # the parent gather keeps them aligned
    static_carry = {
        pname: (st if is_seq else SeqTensor(st.data))
        for (pname, is_seq), st in zip(static_info, statics)
    }

    def step_fn(ids, carry):
        sub_batch = dict(carry["static"])
        sub_batch[a["_gen_placeholder"]] = SeqTensor(torch.index_select(emb_w, 0, ids))
        for m in memories:
            sub_batch[m.name] = SeqTensor(carry["mem"][m.name])
        outs, _ = subnet.apply(sub_params, sub_batch, train=False)
        new_mem = {m.name: outs[m.attrs["link"]].data for m in memories}
        logits = outs.get(out_name + "@logits")
        if logits is not None:  # the stashed pre-softmax: a stable log-softmax
            logp = torch.log_softmax(logits.data, dim=-1)
        else:
            logp = torch.log(torch.clamp(outs[out_name].data, min=1e-9))
        return logp, {"mem": new_mem, "static": carry["static"]}

    seqs, scores = beam_ops.beam_search(
        step_fn, {"mem": init_mem, "static": static_carry}, batch_size=b,
        beam_size=a["beam_size"], vocab_size=a["vocab"], bos_id=a["bos_id"],
        eos_id=a["eos_id"], max_len=a["max_length"],
        candidate_adjust_fn=a.get("_candidate_adjust_fn"), drop_fn=a.get("_drop_fn"),
        norm_fn=a.get("_norm_fn"))
    # num_results_per_sample: the best N of the K beams
    n_res = a.get("num_results")
    if n_res is not None and n_res < seqs.shape[1]:
        seqs, scores = seqs[:, :n_res], scores[:, :n_res]
    ctx.outputs[conf.name + "@scores"] = SeqTensor(scores)
    return SeqTensor(seqs)
