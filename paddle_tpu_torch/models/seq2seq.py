"""Seq2seq NMT with attention — the counterpart of
``paddle_tpu/models/seq2seq.py`` (BASELINE.json config #3, bench.py's
``nmt_tokens_per_sec`` and ``nmt_generate_tokens_per_sec``): a bi-GRU encoder
and an attention-GRU decoder in a recurrent_group, built from the same
simple_gru2 / simple_attention DSL and with the same layer names, so
parameters carry over between the packages by path.  The decoder step
matches the fused attention-GRU idiom, so training runs it on
``ops/rnn.py``'s ``attention_gru_scan``.

Generation re-uses the decoder step: :class:`Seq2SeqGenerator` runs the
pruned encoder once, then steps the decoder through ``ops/beam.py``'s beam
or greedy search — on the fused ``attention_gru_step`` chain
(:func:`make_fused_step`) when the step matches the idiom, else on the step
sub-network layer by layer.  :func:`seq2seq_generation` is the same model as
a topology ending in a ``beam_search`` layer.  ``counters`` counts the
decoder steps each stepping ran.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import layers as L
from paddle_tpu_torch.core import data_types
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.core.compiler import CompiledNetwork
from paddle_tpu_torch.core.device import resolve_device, tree_to
from paddle_tpu_torch.core.topology import LayerOutput, Topology
from paddle_tpu_torch.layers import networks
from paddle_tpu_torch.layers.attention import match_attention_gru_step
from paddle_tpu_torch.ops.beam import beam_search, greedy_search, log_probs
from paddle_tpu_torch.ops.rnn import attention_gru_step
from paddle_tpu_torch.utils.flags import get_flag

# decoder steps run on the fused chain ("fused") and on the step
# sub-network ("generic") by Seq2SeqGenerator, since the last clear()
counters: collections.Counter = collections.Counter()


def make_fused_logits(w, enc, ep, emask, *, gate_act, act, att_act):
    """``step(ids [N], h [N, H]) -> (logits [N, V], h_t [N, H])``: one decoder
    step over the fused attention-GRU chain, the per-token arithmetic of
    every decode face: the one-shot beam and greedy paths here
    (:func:`make_fused_step`) and the serving engine's paged decode, which
    gathers `enc` and `ep` through its page table.

    ``ep`` already carries the folded state-projection bias (``sp_b`` is
    added once, never per step); ``w`` is the
    :meth:`Seq2SeqGenerator.fused_decode_weights` bundle."""

    def step(ids, h):
        xg = torch.index_select(w["emb_w"], 0, ids) @ w["w_emb"]
        if w["xg_bias"] is not None:
            xg = xg + w["xg_bias"]
        h_t = attention_gru_step(xg, h, enc, ep, emask, w["w1"], w["v"], w["w_ctx"], w["w_c"],
                                 gate_act=gate_act, act=act, att_act=att_act)
        logits = h_t @ w["head_w"]
        if w["head_b"] is not None:
            logits = logits + w["head_b"]
        return logits, h_t

    return step


def make_fused_step(w, enc, ep, emask, **acts):
    """``step(ids, h) -> (logp [N, V], h_t)``: :func:`make_fused_logits`
    through the generator head's ``log_probs``."""
    logits_step = make_fused_logits(w, enc, ep, emask, **acts)

    def step(ids, h):
        logits, h_t = logits_step(ids, h)
        return log_probs(logits), h_t

    return step


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


def seq2seq_generation(src_vocab: int, trg_vocab: int, word_dim: int = 128,
                       hidden_dim: int = 256, bos_id: int = 0, eos_id: int = 1,
                       beam_size: int = 4, max_length: int = 32) -> LayerOutput:
    """Generation topology over the same step function and layer names as
    :func:`seq2seq_cost`, the target sequence replaced by a GeneratedInput
    beam (the reference's demo/seqToseq generation config).  The beam layer
    shares the training group's name ("decoder"), so trained parameters
    load by name; copy the target embedding with
    ``gen_params.set("decoder.@gen_emb.w", trained.get("trg_emb.w"))``.
    Build it with the same auto-name state as the training topology
    (``reset_auto_names()`` before each build)."""
    enc, enc_proj, boot = _encoder_and_boot(src_vocab, word_dim, hidden_dim)
    return L.beam_search(
        decoder_step_builder(hidden_dim, trg_vocab, boot),
        input=[L.GeneratedInput(trg_vocab, word_dim), L.StaticInput(enc, is_seq=True),
               L.StaticInput(enc_proj, is_seq=True)],
        bos_id=bos_id, eos_id=eos_id, beam_size=beam_size, max_length=max_length,
        name="decoder",
    )


def _subgraph(topo: Topology, names) -> Topology:
    """The pruned Topology over the ancestors of `names`, rebuilt from an
    existing Topology's confs."""
    cache = {}

    def build(n: str) -> LayerOutput:
        if n not in cache:
            conf = topo.get(n)
            cache[n] = LayerOutput(conf, [build(p) for p in conf.inputs])
        return cache[n]

    return Topology([build(n) for n in names])


class Seq2SeqGenerator:
    """Generation over a trained seq2seq network (``generate``: beam search,
    ``generate_greedy``), on `device`: the card unless the caller asks for
    the CPU.  Batches come from a DataFeeder on the same device."""

    def __init__(self, parameters, src_vocab: int, trg_vocab: int, word_dim: int = 128,
                 hidden_dim: int = 256, bos_id: int = 0, eos_id: int = 1,
                 max_length: int = 32, beam_size: int = 4, candidate_adjust_fn=None,
                 drop_fn=None, norm_fn=None, device=None):
        self.device = resolve_device(device)
        self.params = parameters
        self.net = parameters.network
        self.topo = self.net.topology
        self.hidden_dim = hidden_dim
        self.trg_vocab = trg_vocab
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.max_length = max_length
        self.beam_size = beam_size
        # the user beam-search hooks (ops/beam.py's module docstring)
        self.candidate_adjust_fn = candidate_adjust_fn
        self.drop_fn = drop_fn
        self.norm_fn = norm_fn

        dec_conf = self.topo.get("decoder")
        self._sub_topo = dec_conf.attrs["_sub_topology"]
        self._subnet = CompiledNetwork(self._sub_topo)
        self._scan_names = dec_conf.attrs["_scan_placeholders"]
        self._static_info = dec_conf.attrs["_static_placeholders"]
        self._memories = dec_conf.attrs["_memories"]
        # fused stepping when the decoder step matches the attention-GRU
        # idiom (the matcher the training lowering uses) and ends in a
        # plain softmax head over the GRU state
        self._match = None
        if len(self._memories) == 1:
            m = match_attention_gru_step(
                self._sub_topo.layers, self._memories[0], set(self._scan_names),
                {p for p, is_seq in self._static_info if is_seq})
            head = self._sub_topo.layers.get("dec_out")
            if (m is not None and len(m.scan_slots) == 1
                    and m.scan_slots[0][1] == self._scan_names[0]
                    and head is not None and head.type == "fc" and head.act == "softmax"
                    and head.drop_rate == 0.0 and tuple(head.inputs) == (m.gru,)):
                self._match = m
        # the pruned encoder-only graph: no training decoder, softmax or
        # cost, and no target slots to feed
        self._enc_net = CompiledNetwork(_subgraph(self.topo, ["enc", "enc_proj", "dec_boot"]))

    def _encode(self, batch, gp):
        state = tree_to(self.params.state or {}, self.device)
        outs, _ = self._enc_net.apply(gp, batch, state=state, train=False)
        return outs

    def fused_decode_weights(self, gp):
        """The weight bundle of the fused attention-GRU decode step, or None
        when the decoder step did not match the idiom; shared with the
        serving engine's paged decode.  ``gp`` is materialized
        (``self.net.materialize_shared``)."""
        if self._match is None:
            return None
        mt = self._match
        sub_params = gp["decoder"]

        def lp(n):
            return self._subnet.layer_params(sub_params, n)

        p_in, p_gru, p_sp, p_head = lp(mt.in_proj), lp(mt.gru), lp(mt.state_proj), lp("dec_out")
        biases = [p["b"] for p in (p_in, p_gru) if "b" in p]
        return {
            "emb_w": gp["trg_emb"]["w"],
            "w_emb": p_in[f"w{mt.scan_slots[0][0]}"],
            # the target-side gate bias (in_proj and gru biases folded);
            # None when both layers are bias-free
            "xg_bias": sum(biases[1:], biases[0]) if biases else None,
            "w1": torch.cat([p_sp["w0"], p_gru["w_h"]], dim=1),
            "v": lp(mt.scores)["w0"][:, 0],
            "w_ctx": p_in[f"w{mt.ctx_slot}"],
            "w_c": p_gru["w_c"],
            "head_w": p_head["w0"],
            "head_b": p_head.get("b"),
            # the state-projection bias folds into the score keys once
            # (ep = enc_proj + sp_b), not into the per-step chain
            "sp_b": p_sp.get("b"),
        }

    def decode_weight_bytes(self, gp=None) -> int:
        """Resident bytes of the fused decode bundle at full precision (0
        when the step did not match)."""
        if gp is None:
            gp = self.net.materialize_shared(self.params.params)
        w = self.fused_decode_weights(gp)
        if w is None:
            return 0
        return sum(v.numel() * v.element_size() for v in w.values() if v is not None)

    def _step_fn(self, statics, gp):
        """step_fn(ids, carry) for the searches: the fused chain when the
        topology matched (and the ``fused_attention_gru`` flag is on), else
        the decoder sub-network once per step."""
        m0 = self._memories[0] if self._memories else None
        if self._match is not None and get_flag("fused_attention_gru"):
            mt = self._match
            w = self.fused_decode_weights(gp)
            enc_t = statics[mt.enc_name]
            # a bf16 encoder's outputs meet the f32 decode weights in f32
            # (the JAX package's type promotion)
            dt = w["w_ctx"].dtype
            ep = statics[mt.ep_name].data.to(dt)
            if w["sp_b"] is not None:
                ep = ep + w["sp_b"]
            emask = enc_t.mask(torch.bool) if enc_t.lengths is not None else None
            fused = make_fused_step(w, enc_t.data.to(dt), ep, emask, gate_act=mt.gate_act,
                                    act=mt.act, att_act=mt.att_act)

            def step_fn(ids, carry):
                counters["fused"] += 1
                logp, h_t = fused(ids, carry[m0.name])
                return logp, {m0.name: h_t}

            return step_fn

        emb_w = gp["trg_emb"]["w"]
        sub_params = gp["decoder"]

        def step_fn(ids, carry):
            counters["generic"] += 1
            sub_batch = dict(statics)
            sub_batch[self._scan_names[0]] = SeqTensor(torch.index_select(emb_w, 0, ids))
            for m in self._memories:
                sub_batch[m.name] = SeqTensor(carry[m.name])
            outs, _ = self._subnet.apply(sub_params, sub_batch, train=False)
            new_carry = {m.name: outs[m.attrs["link"]].data for m in self._memories}
            prob = outs["dec_out"].data
            return torch.log(torch.clamp(prob, min=1e-9)), new_carry

        return step_fn

    def _prepare(self, batch, params=None):
        """(statics, carry, batch size, materialized params): the encoder's
        outputs as the decoder step's static inputs and its boot state.
        `params` (default: the constructor's Parameters) is a parameter
        tree, moved to the generator's device."""
        tree = self.params.params if params is None else params
        gp = self.net.materialize_shared(tree_to(tree, self.device))
        outs = self._encode(batch, gp)
        statics = {}
        for (pname, is_seq), lname in zip(self._static_info, ["enc", "enc_proj"]):
            val = outs[lname]
            statics[pname] = val if is_seq else SeqTensor(val.data)
        boot = outs["dec_boot"].data
        carry = {m.name: boot for m in self._memories}
        return statics, carry, boot.shape[0], gp

    @torch.no_grad()
    def generate(self, batch, beam_size: Optional[int] = None, *, params=None):
        """Beam-search decode; returns (sequences [B, K, T] int32, scores
        [B, K] f32), best first."""
        k = beam_size or self.beam_size
        statics, carry, b, gp = self._prepare(batch, params)
        # the searches repeat the carry to B*K rows; the statics are
        # expanded here
        statics_k = {
            n: SeqTensor(torch.repeat_interleave(t.data, k, dim=0),
                         None if t.lengths is None else torch.repeat_interleave(t.lengths, k, dim=0))
            for n, t in statics.items()
        }
        return beam_search(
            self._step_fn(statics_k, gp), carry, batch_size=b, beam_size=k,
            vocab_size=self.trg_vocab, bos_id=self.bos_id, eos_id=self.eos_id,
            max_len=self.max_length, candidate_adjust_fn=self.candidate_adjust_fn,
            drop_fn=self.drop_fn, norm_fn=self.norm_fn)

    @torch.no_grad()
    def generate_greedy(self, batch, *, params=None, max_new_tokens: Optional[int] = None,
                        early_exit: bool = True):
        """Greedy decode; returns ([B, L] int32 ids, [B] int32 lengths) with
        ``L = min(max_length, max_new_tokens)``.  ``max_new_tokens`` caps
        this call; ``early_exit`` stops once every row has emitted EOS.
        Both give the full run's output truncated, bit for bit."""
        statics, carry, b, gp = self._prepare(batch, params)
        return greedy_search(
            self._step_fn(statics, gp), carry, batch_size=b, bos_id=self.bos_id,
            eos_id=self.eos_id, max_len=self.max_length, max_new_tokens=max_new_tokens,
            early_exit=early_exit)
