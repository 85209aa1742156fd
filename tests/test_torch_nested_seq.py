"""Nested sequences in the port against the JAX package on the CPU (f32):
the counterparts of the 14 cases of ``tests/test_nested_seq.py`` (the feeder
of nested slots, seqpool / last_seq / first_seq / expand at both nesting
levels, gradients through nested layers and a nested group, the
hierarchical RNN training, the nested group output, sequence-valued
memories), the stride forms of seqpool and last_seq / first_seq, a reverse
nested group, and the reference's nested == flat pair
(``sequence_nest_rnn.conf`` against ``sequence_rnn.conf``, built in code):
an outer group over ``SubsequenceInput`` whose step runs an inner group
booted from the outer memory, against one group over the concatenated
words.

Each case builds one topology in both packages, carries the JAX package's
parameters over, and feeds both the same numpy batch: outputs within atol
1e-5 and rtol 1e-5 (lengths and sub-lengths equal), gradients within 1e-4
relative L2 (the JAX side's op by op), the pair's nested and flat costs
within rtol 1e-5 and atol 1e-6 in each package, and the hierarchical
trainer's 20 costs within 1e-4 of the JAX package's."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from layer_grad_util import rand_batch_for
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu.core.compiler import CompiledNetwork as JNet
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu.reader import feeder as jfeeder
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.layers.recurrent_group import counters
from paddle_tpu_torch.reader import feeder as tfeeder
from paddle_tpu_torch.utils.tree import map_leaves
from test_torch_parity import (
    assert_outputs_close, build_both, carry, numpy_tree, outputs_both, rel_l2, to_port,
    train_both)

GRAD_REL = 1e-4


def _nested_batch(d=2):
    """B=2, S=3, T=4; sample 0 has 2 subsequences (3, 2), sample 1 one (4),
    as tests/test_nested_seq.py's ``_nested_batch``."""
    data = np.random.RandomState(7).randn(2, 3, 4, d).astype(np.float32)
    return JSeq(jnp.asarray(data), jnp.asarray([2, 1], jnp.int32),
                jnp.asarray([[3, 2, 0], [4, 0, 0]], jnp.int32))


def _masked_nested(seed=11):
    """A nested batch whose padding is zero, as the feeder makes it."""
    data = np.random.RandomState(seed).randn(2, 3, 4, 2).astype(np.float32)
    n_sub = np.array([3, 2], np.int32)
    sub_len = np.array([[3, 2, 4], [4, 1, 0]], np.int32)
    for b in range(2):
        for s in range(3):
            data[b, s, (sub_len[b, s] if s < n_sub[b] else 0):] = 0.0
    return JSeq(jnp.asarray(data), jnp.asarray(n_sub), jnp.asarray(sub_len))


def _check(jout, tout, jbatch, input_grads=(), grads=True, seed=0):
    jo, to, jg, tg = outputs_both(jout, tout, jbatch, seed=seed, grads=grads,
                                  input_grads=input_grads)
    assert_outputs_close(jo, to)
    if grads:
        err = rel_l2(tg, jg)
        assert err <= GRAD_REL, err
    return jo, to


# ---------------------------------------------------------------------------
# the feeder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["integer", "dense"])
def test_feeder_sub_sequence_matches_jax(kind):
    """test_feeder_integer_sub_sequence and test_feeder_dense_sub_sequence:
    the same samples through both feeders give equal tensors."""
    if kind == "integer":
        samples = [([[1, 2, 3], [4, 5]], 0), ([[6]], 2)]
        kw = {"seq_multiple": 4, "min_seq_len": 4}

        def types(pkg):
            dt = pkg.data_type
            return [("words", dt.integer_value_sub_sequence(100)), ("label", dt.integer_value(3))]
    else:
        samples = [([[[1.0, 2.0], [3.0, 4.0]], [[5.0, 6.0]]],)]
        kw = {"seq_multiple": 2, "min_seq_len": 2}

        def types(pkg):
            return [("x", pkg.data_type.dense_vector_sub_sequence(2))]

    jb = jfeeder.DataFeeder(types(paddle_tpu), **kw)(samples)
    tb = tfeeder.DataFeeder(types(paddle_tpu_torch), device="cpu", **kw)(samples)
    assert set(jb) == set(tb)
    for k in jb:
        for f in ("data", "lengths", "sub_lengths"):
            a, b = getattr(jb[k], f), getattr(tb[k], f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    name = "words" if kind == "integer" else "x"
    assert tb[name].is_nested
    assert tb[name].sub_lengths._host_lengths is not None


# ---------------------------------------------------------------------------
# the sequence layers at both levels, and their stride forms
# ---------------------------------------------------------------------------


def _pool(kind, agg):
    def build(pkg):
        L = pkg.layer
        inp = L.data("x", pkg.data_type.dense_vector_sub_sequence(2))
        return L.pooling(inp, pooling_type=kind, agg_level=agg)
    return build


@pytest.mark.parametrize("kind", ["sum", "max", "average", "sqrt_n"])
@pytest.mark.parametrize("agg", ["TO_SEQUENCE", "TO_NO_SEQUENCE"])
def test_seqpool_nested_matches_jax(kind, agg):
    """test_seqpool_nested_to_sequence / _to_no_sequence, every pool kind."""
    level = getattr(paddle_tpu.layer.AggregateLevel, agg)
    jout, tout = build_both(lambda pkg: _pool(kind, level)(pkg))
    _check(jout, tout, {"x": _nested_batch()}, input_grads=("x",))


def _select(first, agg):
    def build(pkg):
        L = pkg.layer
        inp = L.data("x", pkg.data_type.dense_vector_sub_sequence(2))
        fn = L.first_seq if first else L.last_seq
        return fn(inp, agg_level=agg)
    return build


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("agg", ["TO_SEQUENCE", "TO_NO_SEQUENCE"])
def test_last_first_seq_nested_matches_jax(first, agg):
    """test_last_first_seq_nested: per subsequence and of the whole sample."""
    level = getattr(paddle_tpu.layer.AggregateLevel, agg)
    jout, tout = build_both(_select(first, level))
    _check(jout, tout, {"x": _nested_batch()}, input_grads=("x",))


@pytest.mark.parametrize("from_seq", [False, True])
def test_expand_to_nested_matches_jax(from_seq):
    """test_expand_to_nested: FROM_NO_SEQUENCE and FROM_SEQUENCE over a
    nested pattern (the [B, S, D] source padded to the pattern's S)."""
    def build(pkg):
        L, dt = pkg.layer, pkg.data_type
        pat = L.data("pat", dt.dense_vector_sub_sequence(2))
        if from_seq:
            v = L.data("v", dt.dense_vector_sequence(2))
            level = pkg.layer.ExpandLevel.FROM_SEQUENCE
        else:
            v = L.data("v", dt.dense_vector(2))
            level = pkg.layer.ExpandLevel.FROM_NO_SEQUENCE
        return L.expand(v, pat, expand_level=level)

    jout, tout = build_both(build)
    if from_seq:
        v = JSeq(jnp.asarray(np.arange(4, dtype=np.float32).reshape(2, 2, 1).repeat(2, -1)),
                 jnp.asarray([2, 1], jnp.int32))  # S=2 < the pattern's 3: padded
    else:
        v = JSeq(jnp.asarray(np.arange(4, dtype=np.float32).reshape(2, 2)))
    jo, to = _check(jout, tout, {"pat": _nested_batch(), "v": v}, input_grads=("v",))
    assert to[jout.name].sub_lengths is not None


@pytest.mark.parametrize("kind", ["max", "average", "sum"])
def test_stride_pooling_matches_jax(kind):
    """seqpool with stride > 0: windows of 3 steps pooled into a shorter
    sequence (lengths ceil(len / 3)); an empty tail window pools to 0."""
    def build(pkg):
        L = pkg.layer
        return L.pooling(L.data("s", pkg.data_type.dense_vector_sequence(3)),
                         pooling_type=kind, stride=3)

    jout, tout = build_both(build)
    data = np.random.RandomState(3).randn(3, 7, 3).astype(np.float32)
    batch = {"s": JSeq(jnp.asarray(data), jnp.asarray([7, 3, 1], jnp.int32))}
    jo, to = _check(jout, tout, batch, input_grads=("s",))
    np.testing.assert_array_equal(to[jout.name].lengths, [3, 1, 1])


@pytest.mark.parametrize("first", [False, True])
def test_stride_selection_matches_jax(first):
    """last_seq / first_seq with stride: the last / first valid step of each
    window."""
    def build(pkg):
        L = pkg.layer
        fn = L.first_seq if first else L.last_seq
        return fn(L.data("s", pkg.data_type.dense_vector_sequence(3)), stride=2)

    jout, tout = build_both(build)
    data = np.random.RandomState(4).randn(3, 5, 3).astype(np.float32)
    _check(jout, tout, {"s": JSeq(jnp.asarray(data), jnp.asarray([5, 2, 3], jnp.int32))},
           input_grads=("s",))


# ---------------------------------------------------------------------------
# gradients through nested layers and a nested group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("agg", ["TO_SEQUENCE", "TO_NO_SEQUENCE"])
def test_nested_seqpool_grad_matches_jax(agg):
    """test_nested_seqpool_grad, on check_layer_grad's random batch (its
    padding subsequences carry nonzero lengths)."""
    level = getattr(paddle_tpu.layer.AggregateLevel, agg)

    def build(pkg):
        L = pkg.layer
        return L.pooling(L.data("x", pkg.data_type.dense_vector_sub_sequence(3)),
                         pooling_type="sum", agg_level=level)

    jout, tout = build_both(build)
    _check(jout, tout, rand_batch_for(JTopo([jout])), input_grads=("x",))


def _last_seq_group(pkg, reverse=False):
    L, A = pkg.layer, pkg.activation
    inp = L.data("x", pkg.data_type.dense_vector_sub_sequence(3))

    def step(sub):  # a plain [B, T, 3] sequence inside the group
        return L.last_seq(L.fc(sub, size=4, act=A.Tanh()))

    return L.recurrent_group(step=step, input=L.SubsequenceInput(inp), reverse=reverse)


@pytest.mark.parametrize("reverse", [False, True])
def test_nested_group_grad_matches_jax(reverse):
    """test_nested_group_grad: a group over subsequences whose step reduces
    its subsequence to a row (forward and reverse)."""
    jout, tout = build_both(lambda pkg: _last_seq_group(pkg, reverse))
    counters.clear()
    _check(jout, tout, rand_batch_for(JTopo([jout])), input_grads=("x",))
    assert counters["outer_steps"] > 0 and counters["inner_steps"] == 0


def _hier_model(pkg, vocab=30, emb=8, hidden=8, n_cls=3):
    """tests/test_nested_seq.py's ``_hier_model``."""
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    words = L.data("words", dt.integer_value_sub_sequence(vocab))
    label = L.data("label", dt.integer_value(n_cls))
    embd = L.embedding(words, size=emb)

    def outer_step(sent):
        h = L.recurrent(L.fc(sent, size=hidden, act=A.Linear()), act=A.Tanh())
        prev = L.memory(name="sent_acc", size=hidden)
        return L.fc(L.concat([L.last_seq(h), prev]), size=hidden, act=A.Tanh(),
                    name="sent_acc")

    doc = L.recurrent_group(step=outer_step, input=L.SubsequenceInput(embd))
    pred = L.fc(L.last_seq(doc), size=n_cls, act=A.Softmax())
    return L.classification_cost(input=pred, label=label)


def _hier_samples(n=40, n_cls=3, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        n_sent, label = rng.randint(1, 4), rng.randint(n_cls)
        out.append(([list(rng.randint(label * 10, label * 10 + 9, size=rng.randint(2, 6)))
                     for _ in range(n_sent)], label))
    return out


def test_hierarchical_rnn_trains_as_jax():
    """test_hierarchical_rnn_trains: 4 passes of Adam(5e-2) from the same
    parameters over the same batches; every cost within 1e-4 of the JAX
    package's, and the cost falls."""
    jcost, tcost = build_both(_hier_model)
    jparams = paddle_tpu.parameters.create(jcost, seed=0)
    samples = _hier_samples()
    jc, tc, _, _ = train_both(jcost, tcost, jparams,
                              lambda pkg: pkg.optimizer.Adam(learning_rate=5e-2), samples, 8,
                              {"words": 0, "label": 1}, num_passes=4)
    assert len(tc) == len(jc) == 20
    np.testing.assert_allclose(tc, jc, atol=1e-4, rtol=1e-4)
    assert np.mean(tc[-3:]) < np.mean(tc[:3]) * 0.8, tc


def _seq_emitting_group(pkg):
    L, A = pkg.layer, pkg.activation
    inp = L.data("x", pkg.data_type.dense_vector_sub_sequence(3))
    return L.recurrent_group(step=lambda sub: L.fc(sub, size=4, act=A.Tanh()),
                             input=L.SubsequenceInput(inp))


def test_nested_group_output_matches_jax():
    """test_nested_group_output_is_sequence: a step that returns a sequence
    gives a nested output; its padding subsequences are zero."""
    jout, tout = build_both(_seq_emitting_group)
    x = _nested_batch()
    x = JSeq(jnp.asarray(np.random.RandomState(0).randn(2, 3, 4, 3), jnp.float32),
             x.lengths, x.sub_lengths)
    jo, to = _check(jout, tout, {"x": x}, input_grads=("x",))
    o = to[jout.name]
    assert o.data.shape == (2, 3, 4, 4)
    np.testing.assert_array_equal(o.lengths, [2, 1])
    np.testing.assert_array_equal(o.sub_lengths, np.asarray(x.sub_lengths))
    np.testing.assert_allclose(o.data[1, 1], 0.0, atol=1e-6)


# ---------------------------------------------------------------------------
# sequence-valued memories
# ---------------------------------------------------------------------------


def _running_sum(pkg, boot=False, size=2):
    L = pkg.layer
    inp = L.data("x", pkg.data_type.dense_vector_sub_sequence(size))
    boot_layer = L.data("boot", pkg.data_type.dense_vector_sequence(size)) if boot else None

    def step(sub):
        prev = L.memory(name="acc", size=size, is_seq=True, boot_layer=boot_layer)
        return L.addto([sub, prev], name="acc")

    return L.recurrent_group(step=step, input=L.SubsequenceInput(inp))


def _want_running_sum(data, n_sub, sub_len, carry0):
    want = np.zeros_like(data)
    for b in range(data.shape[0]):
        acc = carry0[b].copy()
        for s in range(data.shape[1]):
            if s < n_sub[b]:
                acc = acc + data[b, s]
                w = acc.copy()
                w[sub_len[b, s]:] = 0.0
                want[b, s] = w
    return want


def test_sequence_memory_running_sum_matches_jax():
    """test_sequence_memory_running_sum: each outer step sees the previous
    step's whole output sequence; the exact running sum in numpy."""
    jout, tout = build_both(_running_sum)
    x = _masked_nested()
    jo, to = _check(jout, tout, {"x": x}, input_grads=("x",))
    data, n_sub, sub_len = (np.asarray(v) for v in (x.data, x.lengths, x.sub_lengths))
    want = _want_running_sum(data, n_sub, sub_len, np.zeros_like(data[:, 0]))
    np.testing.assert_allclose(to[jout.name].data, want, rtol=1e-5, atol=1e-5)


def test_sequence_memory_boot_from_sequence_layer_matches_jax():
    """test_sequence_memory_boot_from_sequence_layer: the first carry is an
    outer sequence layer's value."""
    jout, tout = build_both(lambda pkg: _running_sum(pkg, boot=True))
    x = _masked_nested(seed=12)
    boot = np.random.RandomState(13).randn(2, 4, 2).astype(np.float32)
    boot[1, 2:] = 0.0
    batch = {"x": x, "boot": JSeq(jnp.asarray(boot), jnp.asarray([4, 2], jnp.int32))}
    jo, to = _check(jout, tout, batch, input_grads=("x", "boot"))
    data, n_sub, sub_len = (np.asarray(v) for v in (x.data, x.lengths, x.sub_lengths))
    want = _want_running_sum(data, n_sub, sub_len, boot)
    np.testing.assert_allclose(to[jout.name].data, want, rtol=1e-5, atol=1e-5)


def test_sequence_memory_non_seq_link_raises_in_both():
    """test_sequence_memory_non_seq_link_raises: a sequence memory whose
    link is not a sequence fails in both packages, naming the cause."""
    def build(pkg):
        L = pkg.layer
        inp = L.data("x", pkg.data_type.dense_vector_sub_sequence(2))

        def step(sub):
            L.memory(name="pooled", size=2, is_seq=True)
            return L.pooling(sub, pooling_type="sum", name="pooled")

        return L.recurrent_group(step=step, input=L.SubsequenceInput(inp))

    jout, tout = build_both(build)
    jbatch = {"x": _masked_nested(seed=14)}
    jnet = JNet(JTopo([jout]))
    jparams = paddle_tpu.parameters.create(jout)
    with pytest.raises(ValueError, match="not a sequence"):
        jnet.apply(jparams.params, jbatch, state=jparams.state, train=False)
    with pytest.raises(ValueError, match="not a sequence"):
        TNet(TTopo([tout])).apply({}, to_port(jbatch), train=False)


def test_sequence_memory_grad_matches_jax():
    """test_sequence_memory_grad: gradients through the sequence carry."""
    def build(pkg):
        L, A = pkg.layer, pkg.activation
        inp = L.data("x", pkg.data_type.dense_vector_sub_sequence(3))

        def step(sub):
            prev = L.memory(name="accg", size=4, is_seq=True)
            return L.addto([L.fc(sub, size=4, act=A.Tanh()), prev], name="accg")

        grp = L.recurrent_group(step=step, input=L.SubsequenceInput(inp))
        return L.last_seq(L.pooling(grp, pooling_type="sum",
                                    agg_level=pkg.layer.AggregateLevel.TO_SEQUENCE))

    jout, tout = build_both(build)
    _check(jout, tout, rand_batch_for(JTopo([jout])), input_grads=("x",))


def test_sequence_memory_const_boot_is_rejected():
    L = paddle_tpu_torch.layer
    x = L.data("xc", paddle_tpu_torch.data_type.dense_vector_sub_sequence(2))

    def step(sub):
        L.memory(name="m", size=2, is_seq=True, boot_with_const_id=0)
        return sub

    with pytest.raises(ValueError, match="constant id"):
        L.recurrent_group(step=step, input=L.SubsequenceInput(x))


# ---------------------------------------------------------------------------
# the reference's nested == flat pair
# ---------------------------------------------------------------------------


def nest_pair(pkg, nested, vocab=10, emb=6, hidden=5, labels=3):
    """sequence_nest_rnn.conf (nested) and sequence_rnn.conf (flat) through
    the v2 DSL: the inner memory boots from the outer memory, which links
    the last state of the previous subsequence."""
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    word_t = dt.integer_value_sub_sequence(vocab) if nested else dt.integer_value_sequence(vocab)
    emb_l = L.embedding(L.data("word", word_t), size=emb, name="emb")
    if nested:
        def outer_step(x):
            outer_mem = L.memory(name="outer_rnn_state", size=hidden)

            def inner_step(y):
                inner_mem = L.memory(name="inner_rnn_state", size=hidden, boot_layer=outer_mem)
                return L.fc([y, inner_mem], size=hidden, act=A.Tanh(), bias_attr=True,
                            name="inner_rnn_state")

            inner = L.recurrent_group(step=inner_step, name="inner", input=x)
            L.last_seq(inner, name="outer_rnn_state")
            return inner

        out = L.recurrent_group(name="outer", step=outer_step, input=L.SubsequenceInput(emb_l))
    else:
        def step(y):
            mem = L.memory(name="rnn_state", size=hidden)
            return L.fc([y, mem], size=hidden, act=A.Tanh(), bias_attr=True, name="rnn_state")

        out = L.recurrent_group(name="rnn", step=step, input=emb_l)
    prob = L.fc(L.last_seq(out), size=labels, act=A.Softmax(), bias_attr=True, name="prob")
    return L.classification_cost(input=prob, label=L.data("label", dt.integer_value(labels)))


def nested_params_from_flat(flat):
    """The nested network's parameter tree holding the flat one's values,
    moved by path (rnn.rnn_state -> outer.inner.inner_rnn_state)."""
    out = {k: v for k, v in flat.items() if k != "rnn"}
    out["outer"] = {"inner": {"inner_rnn_state": flat["rnn"]["rnn_state"]}}
    return out


def nest_rows(seed=5, n=6, vocab=10):
    """The reference's two rows, then random paragraphs of 1-4 sentences of
    1-5 ids."""
    rows = [([[1, 3, 2], [4, 5, 2]], 0), ([[0, 2], [2, 5], [0, 1, 2]], 1)]
    rng = np.random.RandomState(seed)
    for _ in range(n - 2):
        rows.append(([list(map(int, rng.randint(0, vocab, size=rng.randint(1, 6))))
                      for _ in range(rng.randint(1, 5))], int(rng.randint(0, 3))))
    return rows


def test_nested_rnn_equals_flat_rnn_in_both_packages():
    """The pair's costs agree per row (rtol 1e-5, atol 1e-6) in each
    package, the port's nested network matches the JAX package's (outputs
    1e-5, gradients 1e-4 relative L2, through the two nested loops), and in
    the port the nested gradients, moved by path, match the flat ones."""
    (jn, tn) = build_both(lambda pkg: nest_pair(pkg, True))
    (jf, tf) = build_both(lambda pkg: nest_pair(pkg, False))
    rows = nest_rows()
    flat_rows = [([t for sub in r for t in sub], lab) for r, lab in rows]
    jparams_f = paddle_tpu.parameters.create(jf, seed=1)
    jparams_n = paddle_tpu.parameters.create(jn, seed=1)
    jparams_n.params = nested_params_from_flat(jparams_f.params)

    costs = {}
    for pkg, out_n, out_f in ((paddle_tpu, jn, jf), (paddle_tpu_torch, tn, tf)):
        for form, out, rr in (("nested", out_n, rows), ("flat", out_f, flat_rows)):
            topo = pkg.Topology([out])
            if pkg is paddle_tpu:
                batch = jfeeder.DataFeeder(topo.data_types())(rr)
            else:
                batch = tfeeder.DataFeeder(topo.data_types(), device="cpu")(rr)
            if pkg is paddle_tpu:
                net = JNet(topo)
                p = jparams_n.params if form == "nested" else jparams_f.params
                o = net.apply(p, batch, state={}, train=False)[0][out.name].data
                costs[("jax", form)] = np.asarray(o)
            else:
                net = TNet(topo)
                p = carry(jparams_n if form == "nested" else jparams_f).params
                o = net.apply(p, batch, train=False)[0][out.name].data
                costs[("port", form)] = o.numpy()
    for side in ("jax", "port"):
        np.testing.assert_allclose(costs[(side, "nested")], costs[(side, "flat")],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(costs[("port", "nested")], costs[("jax", "nested")],
                               rtol=1e-5, atol=1e-5)

    # gradients of the mean cost: port nested vs JAX nested, and vs port flat
    jbatch = jfeeder.DataFeeder(JTopo([jn]).data_types())(rows)
    jo, to, jg, tg = outputs_both(jn, tn, jbatch, seed=1)
    assert_outputs_close(jo, to)
    assert rel_l2(tg, jg) <= GRAD_REL
    counters.clear()
    grads = {}
    for form, out, rr in (("nested", tn, rows), ("flat", tf, flat_rows)):
        topo = TTopo([out])
        batch = tfeeder.DataFeeder(topo.data_types(), device="cpu")(rr)
        p = carry(jparams_n if form == "nested" else jparams_f).params
        leaves = map_leaves(lambda v: v.clone().requires_grad_(True), p)
        TNet(topo).cost(leaves, batch, train=False)[0].backward()
        grads[form] = numpy_tree(map_leaves(lambda v: v.grad, leaves))
    assert rel_l2(grads["nested"], nested_params_from_flat(grads["flat"])) <= 1e-5
    # the outer loop ran max n_sub steps, the inner loops each subsequence's
    n_sub = [len(r) for r, _ in rows]
    assert counters["outer_steps"] == max(n_sub)
    assert counters["inner_steps"] == sum(
        max(len(r[s]) for r, _ in rows if s < len(r)) for s in range(max(n_sub)))


def test_nested_rnn_reads_no_device_lengths():
    """The inner loops find their live range from the host columns of the
    sub-lengths the feeder attached: no lengths tensor is read back."""
    from paddle_tpu_torch.core import batch as tbatch

    _, tn = build_both(lambda pkg: nest_pair(pkg, True))
    topo = TTopo([tn])
    batch = tfeeder.DataFeeder(topo.data_types(), device="cpu")(nest_rows())
    net = TNet(topo)
    params = net.init_params(0, device="cpu")
    reads = []
    real = tbatch.host_lengths

    def counting(lengths):
        if getattr(lengths, "_host_lengths", None) is None:
            reads.append(tuple(lengths.shape))
        return real(lengths)

    mods = [tbatch] + [importlib.import_module(m) for m in (
        "paddle_tpu_torch.layers.recurrent_group", "paddle_tpu_torch.ops.rnn")]
    saved = [m.host_lengths for m in mods]
    for m in mods:
        m.host_lengths = counting
    try:
        net.apply(params, batch, train=False)
    finally:
        for m, f in zip(mods, saved):
            m.host_lengths = f
    assert reads == []


# ---------------------------------------------------------------------------
# the v1 front end: sequence_nest_rnn.conf with a nested @provider slot
# ---------------------------------------------------------------------------

_V1_NEST = """
from paddle.trainer_config_helpers import *

define_py_data_sources2("train.list", None, module="nest_provider", obj="process")
settings(batch_size=2, learning_rate=0.01)
data = data_layer(name="word", size=10)
emb = embedding_layer(input=data, size=6)

def outer_step(x):
    outer_mem = memory(name="outer_rnn_state", size=5)

    def inner_step(y):
        inner_mem = memory(name="inner_rnn_state", size=5, boot_layer=outer_mem)
        return fc_layer(input=[y, inner_mem], size=5, act=TanhActivation(), bias_attr=True,
                        name="inner_rnn_state")

    inner_rnn_output = recurrent_group(step=inner_step, name="inner", input=x)
    last_seq(input=inner_rnn_output, name="outer_rnn_state")
    return inner_rnn_output

out = recurrent_group(name="outer", step=outer_step, input=SubsequenceInput(emb))
rep = last_seq(input=out)
prob = fc_layer(size=3, input=rep, act=SoftmaxActivation(), bias_attr=True)
outputs(classification_cost(input=prob, label=data_layer(name="label", size=3)))
"""

_V1_NEST_PROVIDER = """
from paddle.trainer.PyDataProvider2 import *

ROWS = [([[1, 3, 2], [4, 5, 2]], 0), ([[0, 2], [2, 5], [0, 1, 2]], 1),
        ([[7], [8, 9, 1, 1]], 2), ([[3, 3, 3]], 1)]

@provider(input_types=[integer_value_sub_sequence(10), integer_value(3)], should_shuffle=False)
def process(settings, path):
    for row in ROWS:
        yield row
"""


def test_v1_nested_config_parses_and_trains_alike(tmp_path):
    """A v1 config with SubsequenceInput over an integer_value_sub_sequence
    @provider slot: the same Topology bytes in both packages, and one pass
    of its provider trains to the same costs (rtol 1e-5)."""
    from paddle_tpu import v1_compat as JV
    from paddle_tpu_torch import v1_compat as TV

    for name, text in (("nest.py", _V1_NEST), ("nest_provider.py", _V1_NEST_PROVIDER),
                       ("train.list", "unused\n")):
        (tmp_path / name).write_text(text)
    cfg = str(tmp_path / "nest.py")
    j, t = JV.parse_config(cfg, ""), TV.parse_config(cfg, "")
    assert t.serialize() == j.serialize()
    assert dict(t.topology.data_types())["word"] == \
        paddle_tpu_torch.data_type.integer_value_sub_sequence(10)
    jparams = paddle_tpu.parameters.create(j.topology.outputs, seed=2)
    costs = []
    for pkg, V, p, params, kw in ((paddle_tpu_torch, TV, t, carry(jparams), {"device": "cpu"}),
                                  (paddle_tpu, JV, j, jparams, {})):
        trainer = pkg.trainer.SGD(p.topology, params, V.make_optimizer(p.settings), **kw)
        got = []
        trainer.train(pkg.batch(V.make_provider_reader(p, str(tmp_path)), 2), num_passes=1,
                      feeding=p.feeding, event_handler=lambda e, g=got, m=pkg: g.append(e.cost)
                      if isinstance(e, m.event.EndIteration) else None)
        costs.append(got)
    assert len(costs[0]) == 2
    np.testing.assert_allclose(costs[0], costs[1], rtol=1e-5)
