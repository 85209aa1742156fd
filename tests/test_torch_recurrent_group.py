"""recurrent_group in the port (``paddle_tpu_torch/layers/recurrent_group.py``)
against the JAX package's, on the CPU in f32: the same topology built in
both, the JAX package's parameters carried over by path, the same numpy
batch; outputs within 1e-5 and gradients within 1e-5 relative L2 (the same
arithmetic in another summation order).

The cases of tests/test_recurrent_group.py that need no nested input: a
simple RNN as a group (forward and reverse), a booted memory, gradients
through the generic loop, a static-input attention decoder; and of
tests/test_attention_gru_fused.py: the seq2seq decoder matches the fused
pattern, a non-elementwise score activation does not, fused against generic
on seq2seq (outputs, gradients, a 4-step trajectory), a non-matching step
falls back to the generic loop, a reverse decoder on the fused core.  Also:
the hoisted prologue, parameters shared by name into a group, the early
exit of the generic loop, and the parts that raised before the nested
slice: a step that emits a sequence, a SubsequenceInput and a sequence
memory (their full cases are ``tests/test_torch_nested_seq.py``)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core.compiler import CompiledNetwork as JNet
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.layers.recurrent_group import counters
from paddle_tpu_torch.utils.flags import reset_flags, set_flag
from paddle_tpu_torch.utils.tree import map_leaves
from paddle_tpu.core.batch import SeqTensor as JSeq
from test_torch_parity import (
    assert_outputs_close, batch_both, build_both, carry, numpy_tree, outputs_both, rel_l2)

H = 6


@pytest.fixture(autouse=True)
def _flags():
    counters.clear()
    yield
    reset_flags()
    paddle_tpu.utils.flags.reset_flags()


def _seq(seed, b, t, d, lengths):
    rng = np.random.RandomState(seed)
    data = rng.randn(b, t, d).astype(np.float32)
    data *= (np.arange(t)[None, :] < np.asarray(lengths)[:, None])[..., None]
    return data, np.asarray(lengths, np.int32)


def _run_both(jout, tout, arrays, seed=0, names=None):
    """(JAX outputs, port outputs, JAX grads, port grads) of the named
    outputs' weighted sum, from the same parameters."""
    names = names or [jout.name]
    jnet, tnet = JNet(JTopo([jout])), TNet(TTopo([tout]))
    jparams = paddle_tpu.parameters.create(jout, seed=seed)
    jb, tb = batch_both(arrays)

    def weigh(x):
        return np.cos(np.arange(x.size)).reshape(x.shape).astype(np.float32)

    jouts = jnet.apply(jparams.params, jb, train=False)[0]
    ws = {n: weigh(np.asarray(jouts[n].data)) for n in names}

    def jloss(p):
        o = jnet.apply(p, jb, train=False)[0]
        return sum(jnp.sum(o[n].data * ws[n]) for n in names)

    jg = jax.grad(jloss)(jparams.params)
    leaves = map_leaves(lambda v: v.clone().requires_grad_(True), carry(jparams).params)
    touts = tnet.apply(leaves, tb, train=False)[0]
    loss = sum((touts[n].data * torch.from_numpy(ws[n])).sum() for n in names)
    loss.backward()
    tg = map_leaves(lambda v: v.grad, leaves)
    return ({n: np.asarray(jouts[n].data) for n in names},
            {n: touts[n].data.detach().numpy() for n in names}, numpy_tree(jg), tg)


def _assert_both(res, atol=1e-5, grad_tol=1e-5):
    jo, to, jg, tg = res
    for n in jo:
        np.testing.assert_allclose(to[n], jo[n], atol=atol, err_msg=n)
    assert rel_l2(tg, jg) <= grad_tol


def _rnn_group(pkg, reverse=False, boot=False):
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    x = L.data("x", dt.dense_vector_sequence(H))
    boot_layer = None
    if boot:
        boot_layer = L.fc(L.data("bootsrc", dt.dense_vector(4)), H, act=A.Tanh(), name="boot")

    def step(x_t):
        mem = L.memory("h", H, boot_layer=boot_layer)
        hm = L.fc(mem, H, act=A.Identity(), bias_attr=False, name="hproj")
        return L.addto([x_t, hm], act=A.Tanh(), bias_attr=True, name="h")

    return L.recurrent_group(step, x, reverse=reverse, name="grp")


@pytest.mark.parametrize("reverse", [False, True])
def test_group_matches_jax(reverse):
    jout, tout = build_both(lambda pkg: _rnn_group(pkg, reverse))
    res = _run_both(jout, tout, {"x": _seq(0, 4, 7, H, [7, 3, 5, 1])})
    _assert_both(res)
    assert counters["generic"] == 1 and counters["fused"] == 0
    # masking: steps past each row's length are zero
    assert np.all(res[1]["grp"][3, 1:] == 0) and np.all(res[1]["grp"][1, 3:] == 0)


def test_group_with_boot_memory():
    jout, tout = build_both(lambda pkg: _rnn_group(pkg, boot=True))
    rng = np.random.RandomState(1)
    arrays = {"x": _seq(0, 4, 7, H, [7, 3, 5, 1]),
              "bootsrc": (rng.randn(4, 4).astype(np.float32), None)}
    res = _run_both(jout, tout, arrays)
    _assert_both(res)
    # the boot reaches the first step: zeroing its input changes it
    zeroed = dict(arrays, bootsrc=(np.zeros((4, 4), np.float32), None))
    assert not np.allclose(_run_both(jout, tout, zeroed)[1]["grp"][:, 0], res[1]["grp"][:, 0])


def test_generic_early_exit_runs_only_live_steps():
    """T padded to 16 with every row at most 5 long: the loop runs 5 steps,
    and outputs and gradients equal the full loop's."""
    jout, tout = build_both(_rnn_group)
    arrays = {"x": _seq(3, 4, 16, H, [5, 3, 2, 1])}
    res = {}
    for early in (True, False):
        set_flag("scan_early_exit", early)
        counters.clear()
        res[early] = _run_both(jout, tout, arrays)
        res[early] += (dict(counters),)
    assert res[True][4]["steps"] == 5 and res[True][4]["skipped"] == 11
    assert res[False][4]["steps"] == 16
    np.testing.assert_allclose(res[True][1]["grp"], res[False][1]["grp"], atol=1e-7)
    assert rel_l2(res[True][3], res[False][3]) <= 1e-7
    _assert_both(res[True][:4])


def _prologue_group(pkg):
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    x = L.data("x", dt.dense_vector_sequence(4))

    def step(x_t):
        mem = L.memory("h", H)
        proj = L.fc(x_t, H, act=A.Identity(), name="xproj")  # fed by the scanned input only
        hm = L.fc(mem, H, act=A.Identity(), bias_attr=False, name="hproj")
        h = L.addto([proj, hm], act=A.Tanh(), name="h")
        return L.fc(h, 3, act=A.Softmax(), name="out")  # no memory depends on it

    return L.recurrent_group(step, x, name="grp")


def test_prologue_and_epilogue_hoisting_match_jax():
    jout, tout = build_both(_prologue_group)
    net = TNet(TTopo([tout]))
    plan = net._plans["grp"]
    assert plan.prologue == {"xproj"} and plan.epilogue == {"out"}
    _assert_both(_run_both(jout, tout, {"x": _seq(2, 3, 5, 4, [5, 2, 4])}, names=["grp"]))


def _seq_output_group(pkg):
    """A step whose output is a sequence: the loop's expand emits [B, S, H]
    per step (the nested output)."""
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    x = L.data("x", dt.dense_vector_sequence(H))
    src = L.data("src", dt.dense_vector_sequence(4))

    def step(x_t, src_s):
        mem = L.memory("h", H)
        hm = L.fc(mem, H, act=A.Identity(), bias_attr=False, name="hproj")
        h = L.addto([x_t, hm], act=A.Tanh(), name="h")
        e = L.expand(h, expand_as=src_s, name="e")
        return L.fc(e, 3, act=A.Tanh(), name="out")

    return L.recurrent_group(step, [x, L.StaticInput(src, is_seq=True)], name="grp")


def test_step_emitting_a_sequence_raises_at_build():
    """A step that emits a sequence: the network builds (nothing raises any
    more), the plan hoists no epilogue over the sequence, and the group
    returns the JAX package's nested output ([B, T, S, 3], the group's
    lengths outside, the static's inside, padding zero) and gradients."""
    jout, tout = build_both(_seq_output_group)
    plan = TNet(TTopo([tout]))._plans["grp"]
    assert plan.epilogue is None and plan.frontier == ("out",)
    src = _seq(6, 3, 4, 4, [4, 2, 3])
    jo, to, jg, tg = outputs_both(
        jout, tout, {"x": JSeq(*map(jnp.asarray, _seq(5, 3, 5, H, [5, 2, 4]))),
                     "src": JSeq(*map(jnp.asarray, src))})
    assert_outputs_close(jo, to)
    assert rel_l2(tg, jg) <= 1e-5
    o = to["grp"]
    assert o.data.shape == (3, 5, 4, 3)
    np.testing.assert_array_equal(o.sub_lengths[:, :2], np.stack([src[1]] * 2, axis=1))
    np.testing.assert_array_equal(o.data[1, 2:], 0.0)


def _attention_decoder(pkg):
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    src = L.data("src", dt.dense_vector_sequence(5))
    trg = L.data("trg", dt.dense_vector_sequence(3))
    enc = pkg.networks.simple_gru2(src, size=H, name="enc")
    enc_proj = L.fc(enc, size=H, act=A.Identity(), bias_attr=False, name="encproj")

    def step(trg_t, enc_seq, enc_p):
        state = L.memory("dec", H)
        context = pkg.networks.simple_attention(
            encoded_sequence=enc_seq, encoded_proj=enc_p, decoder_state=state, name="att")
        return L.fc([context, trg_t, state], size=H, act=A.Tanh(), name="dec")

    return L.recurrent_group(
        step, [trg, L.StaticInput(enc, is_seq=True), L.StaticInput(enc_proj, is_seq=True)],
        name="decoder")


def test_group_static_input_attention():
    jout, tout = build_both(_attention_decoder)
    arrays = {"src": _seq(0, 4, 6, 5, [6, 2, 4, 6]), "trg": _seq(1, 4, 5, 3, [5, 3, 1, 4])}
    res = _run_both(jout, tout, arrays)
    _assert_both(res)
    out = res[1]["decoder"]
    assert out.shape == (4, 5, H) and np.isfinite(out).all()
    assert np.all(out[2, 1:] == 0) and np.all(out[1, 3:] == 0)
    assert counters["generic"] == 1  # not the fused idiom: the step's output is no gru


# -- the seq2seq decoder and the fused lowering --------------------------------

VOCAB = 13


def _seq2seq(pkg, word=5, hidden=4):
    from paddle_tpu.models import seq2seq as jmod
    from paddle_tpu_torch.models import seq2seq as tmod

    mod = jmod if pkg is paddle_tpu else tmod
    return mod.seq2seq_cost(VOCAB, VOCAB, word_dim=word, hidden_dim=hidden)


def _nmt_arrays(seed=0, b=4, t=6):
    rng = np.random.RandomState(seed)
    src_len = rng.randint(2, t + 1, b).astype(np.int32)
    trg_len = rng.randint(2, t + 1, b).astype(np.int32)
    return {
        "src_word": (rng.randint(2, VOCAB, (b, t)).astype(np.int32), src_len),
        "trg_word": (rng.randint(2, VOCAB, (b, t)).astype(np.int32), trg_len),
        "trg_next": (rng.randint(2, VOCAB, (b, t)).astype(np.int32), trg_len),
    }


def _decoder_match(net):
    from paddle_tpu_torch.layers.attention import match_attention_gru_step

    conf = net.topology.get("decoder")
    statics = {p for p, is_seq in conf.attrs["_static_placeholders"] if is_seq}
    scans = set(conf.attrs["_scan_placeholders"])
    sub, mems = conf.attrs["_sub_topology"], conf.attrs["_memories"]
    return match_attention_gru_step, sub, mems[0], scans, statics


def test_seq2seq_decoder_matches_pattern_like_jax():
    from paddle_tpu.layers.attention import match_attention_gru_step as jmatch

    (jcost, _), (tcost, _) = build_both(_seq2seq)
    tmatch, sub, mem, scans, statics = _decoder_match(TNet(TTopo([tcost])))
    m = tmatch(sub.layers, mem, scans, statics)
    jconf = JTopo([jcost]).get("decoder")
    jm = jmatch(jconf.attrs["_sub_topology"].layers, jconf.attrs["_memories"][0], scans, statics)
    assert m is not None and dataclasses.asdict(m) == dataclasses.asdict(jm)
    assert (m.gru, m.in_proj) == ("dec_state", "dec_in_proj") and m.enc_name != m.ep_name
    assert TNet(TTopo([tcost]))._plans["decoder"].fusable()


def test_non_elementwise_att_act_rejected():
    _, (tcost, _) = build_both(_seq2seq)
    match, sub, mem, scans, statics = _decoder_match(TNet(TTopo([tcost])))
    base = match(sub.layers, mem, scans, statics)
    layers = dict(sub.layers)
    layers[base.hidden] = dataclasses.replace(layers[base.hidden], act="softmax")
    assert match(layers, mem, scans, statics) is None


def test_seq2seq_fused_vs_generic_forward_and_grad():
    """Cost, decoder output and every gradient agree between the fused core
    and the generic loop (the JAX test's tolerances), and both agree with
    the JAX package."""
    (jcost, _), (tcost, _) = build_both(_seq2seq)
    arrays = _nmt_arrays()
    res = {}
    for fused in (False, True):
        set_flag("fused_attention_gru", fused)
        counters.clear()
        res[fused] = _run_both(jcost, tcost, arrays, names=["nmt_cost", "decoder"])
        assert counters["fused" if fused else "generic"] == 1
        _assert_both(res[fused])
    for n in ("nmt_cost", "decoder"):
        np.testing.assert_allclose(res[True][1][n], res[False][1][n], rtol=2e-4, atol=2e-6)
    assert rel_l2(res[True][3], res[False][3]) <= 2e-4


def test_seq2seq_fused_vs_generic_training_trajectory():
    from paddle_tpu_torch.trainer.step import make_train_step

    _, (tcost, _) = build_both(_seq2seq)
    _, tb = batch_both(_nmt_arrays(5))
    jparams = paddle_tpu.parameters.create(_seq2seq(paddle_tpu)[0], seed=5)
    traj = {}
    for fused in (False, True):
        set_flag("fused_attention_gru", fused)
        net = TNet(TTopo([tcost]))
        params = carry(jparams).params
        opt = paddle_tpu_torch.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
        opt_state, state = opt.init(params), {}
        step = make_train_step(net, opt)
        costs = []
        for i in range(4):
            params, state, opt_state, m = step(params, state, opt_state, tb, i)
            costs.append(float(m["cost"]))
        traj[fused] = costs
    np.testing.assert_allclose(traj[False], traj[True], rtol=1e-4)
    assert traj[True][-1] < traj[True][0]


def _attention_gru_group(pkg, reverse):
    """The seq2seq decoder's step over dense inputs, scanned either way."""
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    src = L.data("src", dt.dense_vector_sequence(5))
    trg = L.data("trg", dt.dense_vector_sequence(3))
    enc = pkg.networks.simple_gru2(src, size=H, name="enc")
    enc_proj = L.fc(enc, size=H, act=A.Identity(), bias_attr=False, name="encproj")

    def step(trg_t, enc_seq, enc_p):
        state = L.memory("dec_state", H)
        context = pkg.networks.simple_attention(
            encoded_sequence=enc_seq, encoded_proj=enc_p, decoder_state=state, name="att")
        gates = L.fc([context, trg_t], size=3 * H, act=A.Identity(), bias_attr=False,
                     name="dec_in_proj")
        gru = L.gru_step(gates, state, size=H, name="dec_state")
        return L.fc(gru, size=4, act=A.Softmax(), name="dec_out")

    return L.recurrent_group(
        step, [trg, L.StaticInput(enc, is_seq=True), L.StaticInput(enc_proj, is_seq=True)],
        reverse=reverse, name="decoder")


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_group_runs_attention_gru_scan(reverse, monkeypatch):
    """The group's fused lowering goes through ``ops/rnn.py``'s
    ``attention_gru_scan`` (the wrapper the f64 core tests hold to the JAX
    package's), forward and reverse, and agrees with the JAX package and
    with the generic loop."""
    # by module path: the package attribute layers.recurrent_group is the
    # DSL function
    rg = importlib.import_module("paddle_tpu_torch.layers.recurrent_group")
    calls = []
    real = rg.attention_gru_scan

    def spy(*a, **k):
        calls.append(k["reverse"])
        return real(*a, **k)

    monkeypatch.setattr(rg, "attention_gru_scan", spy)
    jout, tout = build_both(lambda pkg: _attention_gru_group(pkg, reverse))
    arrays = {"src": _seq(7, 4, 6, 5, [6, 2, 4, 5]), "trg": _seq(8, 4, 5, 3, [5, 3, 1, 4])}
    res = {}
    for fused in (False, True):
        set_flag("fused_attention_gru", fused)
        counters.clear()
        res[fused] = _run_both(jout, tout, arrays)
        assert counters["fused" if fused else "generic"] == 1
        _assert_both(res[fused])
    assert calls == [reverse]
    np.testing.assert_allclose(res[True][1]["decoder"], res[False][1]["decoder"],
                               rtol=2e-4, atol=2e-6)
    assert rel_l2(res[True][3], res[False][3]) <= 2e-4


def _fallback_group(pkg):
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    src = L.data("src", dt.integer_value_sequence(VOCAB))
    emb = L.embedding(src, size=6, name="emb")

    def step(x_t):
        mem = L.memory("st", 4)
        gates = L.fc(x_t, size=12, act=A.Identity(), bias_attr=False, name="gates")
        g = L.gru_step(gates, mem, size=4, name="gru_raw")
        return L.fc(g, size=4, act=A.Tanh(), name="st")  # the memory links a transform

    return L.recurrent_group(step, emb, name="grp")


def test_non_matching_step_falls_back():
    jout, tout = build_both(_fallback_group)
    rng = np.random.RandomState(0)
    arrays = {"src": (rng.randint(0, VOCAB, (3, 5)).astype(np.int32),
                      np.array([5, 3, 2], np.int32))}
    outs = {}
    for fused in (False, True):
        set_flag("fused_attention_gru", fused)
        res = _run_both(jout, tout, arrays)
        _assert_both(res)
        outs[fused] = res[1]["grp"]
    assert counters["fused"] == 0 and counters["generic"] == 2
    np.testing.assert_array_equal(outs[False], outs[True])


def _shared_group(pkg):
    """A parameter shared by name between an outer fc and an fc inside the
    group."""
    L, A, dt, attr = pkg.layer, pkg.activation, pkg.data_type, pkg.attr
    x = L.data("x", dt.dense_vector_sequence(H))
    outer = L.fc(x, H, act=A.Tanh(), param_attr=attr.ParamAttr(name="shared_w"), name="outer")

    def step(x_t):
        mem = L.memory("h", H)
        hm = L.fc(mem, H, act=A.Identity(), bias_attr=False,
                  param_attr=attr.ParamAttr(name="shared_w"), name="hproj")
        return L.addto([x_t, hm], act=A.Tanh(), name="h")

    return L.addto([L.recurrent_group(step, outer, name="grp"), outer], name="sum")


def test_parameters_shared_by_name_into_a_group():
    jout, tout = build_both(_shared_group)
    jnet, tnet = JNet(JTopo([jout])), TNet(TTopo([tout]))
    assert tnet.named_parameters() == jnet.named_parameters() == {"shared_w": "outer.w0"}
    tparams = tnet.init_params(0, "cpu")
    # the group's one parameter lives at the outer owner
    assert "grp" not in tparams and "w0" in tparams["outer"]
    _assert_both(_run_both(jout, tout, {"x": _seq(4, 3, 5, H, [5, 4, 2])}, names=["sum"]))
    p = paddle_tpu_torch.parameters.Parameters(tnet, tparams)
    assert np.array_equal(p.get("shared_w"), p.get("outer.w0"))


def _nested_parts(pkg):
    L, dt = pkg.layer, pkg.data_type
    x = L.data("xs", dt.dense_vector_sub_sequence(H))
    nested = L.recurrent_group(lambda t: t, L.SubsequenceInput(x), name="nested")

    def step(x_t):
        prev = L.memory("seqmem_out", H, is_seq=True)
        return L.addto([x_t, prev], name="seqmem_out")

    seqmem = L.recurrent_group(step, L.SubsequenceInput(x), name="seqmem")
    return L.addto([nested, seqmem], name="both")


def test_parts_not_ported_yet_raise():
    """The parts that raised before the nested slice now run as in the JAX
    package: a SubsequenceInput (its identity step gives back the nested
    input, padding zeroed) and a sequence memory (a running sum of the
    subsequences), neither hoisted nor fused."""
    jout, tout = build_both(_nested_parts)
    net = TNet(TTopo([tout]))
    for g in ("nested", "seqmem"):
        plan = net._plans[g]
        assert not plan.rows and not plan.prologue and plan.epilogue is None
        assert plan.match is None
    rs = np.random.RandomState(9)
    data = rs.randn(3, 4, 5, H).astype(np.float32)
    n_sub, sub_len = np.array([4, 1, 2], np.int32), rs.randint(1, 6, size=(3, 4)).astype(np.int32)
    xs = JSeq(jnp.asarray(data), jnp.asarray(n_sub), jnp.asarray(sub_len))
    jo, to, jg, tg = outputs_both(jout, tout, {"xs": xs}, names=["nested", "both"],
                                  input_grads=("xs",))
    assert_outputs_close(jo, to)
    assert rel_l2(tg, jg) <= 1e-5
    mask = (np.arange(5)[None, None, :] < sub_len[:, :, None]) & (
        np.arange(4)[None, :, None] < n_sub[:, None, None])
    np.testing.assert_allclose(to["nested"].data, data * mask[..., None], atol=0)
