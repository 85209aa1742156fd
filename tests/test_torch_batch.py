"""The batch contract of the port against the JAX package on the CPU (f32):

- the DataFeeder's output is numpy-equal to the JAX package's for var-len,
  nested, sparse-binary and sparse-float slots at every sequence level
  (and the padded-id form of a big-vocabulary sparse slot), with and
  without the shape ladder; the host copies of the lengths and sub-lengths
  ride the tensors;
- ``canonicalize_batch``, ``pad_batch_rows`` and ``slice_batch_rows`` agree
  on nested batches;
- fc, concat and mixed over a nested input, fc over a sparse slot (the
  multi-hot product and the gather-sum of the id form), weighted
  ``classification_cost`` and the sparse-label costs compute the JAX
  package's outputs and gradients (relative L2 1e-5), and ``Inference``
  unpads nested outputs as the JAX package does.

The cases follow ``tests/test_nested_seq.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core import batch as jbatch
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu.core.compiler import CompiledNetwork as JNet
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu.reader import feeder as jfeeder
from paddle_tpu_torch.core import batch as tbatch
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.reader import feeder as tfeeder
from paddle_tpu_torch.utils.tree import map_leaves
from test_torch_parity import build_both, carry, numpy_tree, rel_l2

REL = 1e-5
BIG = 70000  # above SPARSE_IDS_THRESHOLD: the padded-id form


def _rs(seed):
    return np.random.RandomState(seed)


def _ids(rs, dim, lo=1, hi=5):
    return sorted(rs.choice(dim, size=rs.randint(lo, hi), replace=False).tolist())


def _pairs(rs, dim):
    return [(i, float(rs.randn())) for i in _ids(rs, dim)]


def _value(kind, level, dim, rs):
    """One sample of a slot of `kind` at sequence `level` (0 plain, 1
    sequence, 2 nested)."""
    def leaf():
        if kind == "index":
            return int(rs.randint(0, dim))
        if kind == "dense":
            return rs.randn(dim).astype(np.float32).tolist()
        if kind == "binary":
            return _ids(rs, dim)
        return _pairs(rs, dim)

    if level == 0:
        return leaf()
    if level == 1:
        return [leaf() for _ in range(rs.randint(1, 7))]
    return [[leaf() for _ in range(rs.randint(1, 6))] for _ in range(rs.randint(1, 5))]


_TYPES = {
    ("index", 1): "integer_value_sequence", ("index", 2): "integer_value_sub_sequence",
    ("dense", 1): "dense_vector_sequence", ("dense", 2): "dense_vector_sub_sequence",
    ("binary", 0): "sparse_binary_vector", ("binary", 1): "sparse_binary_vector_sequence",
    ("binary", 2): "sparse_binary_vector_sub_sequence",
    ("float", 0): "sparse_float_vector", ("float", 1): "sparse_float_vector_sequence",
    ("float", 2): "sparse_float_vector_sub_sequence",
}

FEED_CASES = [(k, lv, d) for (k, lv) in _TYPES for d in (12,)] + [
    ("binary", 0, BIG), ("binary", 1, BIG), ("binary", 2, BIG)]


@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("kind,level,dim", FEED_CASES)
def test_feeder_matches_the_jax_package(kind, level, dim, ladder):
    rs = _rs(dim + level)
    samples = [(_value(kind, level, dim, rs), int(rs.randint(0, 3))) for _ in range(5)]
    name = _TYPES[(kind, level)]
    types = [("x", getattr(paddle_tpu.data_type, name)(dim)),
             ("y", paddle_tpu.data_type.integer_value(3))]
    ttypes = [("x", getattr(paddle_tpu_torch.data_type, name)(dim)),
              ("y", paddle_tpu_torch.data_type.integer_value(3))]
    kw = {"ladder": jbatch.DEFAULT_LADDER} if ladder else {}
    jb = jfeeder.DataFeeder(types, **kw)(samples)
    tb = tfeeder.DataFeeder(ttypes, device="cpu", **kw)(samples)
    for slot in ("x", "y"):
        j, t = jb[slot], tb[slot]
        assert np.array_equal(t.data.numpy(), np.asarray(j.data)), slot
        assert t.data.dtype == torch.from_numpy(np.asarray(j.data)).dtype
        assert bool(t.sparse_ids) == bool(j.sparse_ids)
        for tl, jl in ((t.lengths, j.lengths), (t.sub_lengths, j.sub_lengths)):
            assert (tl is None) == (jl is None)
            if tl is not None:
                assert np.array_equal(tl.numpy(), np.asarray(jl))
                # the host copy rides the tensor: no device read downstream
                assert np.array_equal(tl._host_lengths, tl.numpy())
    assert tb["x"].sparse_ids == (kind == "binary" and dim > tfeeder.SPARSE_IDS_THRESHOLD)


def _nested_block(seed=0, b=3, width=4):
    rs = _rs(seed)
    n_sub = np.array([2, 4, 1][:b], np.int32)
    sub_lengths = np.zeros((b, 4), np.int32)
    for i, n in enumerate(n_sub):
        sub_lengths[i, :n] = rs.randint(1, 6, size=n)
    data = rs.randn(b, 4, 8, width).astype(np.float32)
    return data, n_sub, sub_lengths


def test_nested_batch_helpers_match_the_jax_package():
    data, n_sub, sub = _nested_block()
    j = jbatch.nested_seq(data, n_sub, sub)
    t = tbatch.nested_seq(data, n_sub, sub)
    tbatch.set_host_lengths(t.sub_lengths, sub)
    assert t.is_nested and t.max_sub_len == 8
    assert np.array_equal(t.sub_mask().numpy(), np.asarray(j.sub_mask()))
    assert np.array_equal(t.masked_data().numpy(), np.asarray(j.masked_data()))
    jc = jbatch.canonicalize_batch({"x": j})["x"]
    tc = tbatch.canonicalize_batch({"x": t})["x"]
    assert tc.data.shape == (3, 4, 16, 4)
    for a, b in ((tc.data, jc.data), (tc.lengths, jc.lengths), (tc.sub_lengths, jc.sub_lengths)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    jp = jbatch.pad_batch_rows({"x": j}, 8)["x"]
    tp = tbatch.pad_batch_rows({"x": t}, 8)["x"]
    for a, b in ((tp.data, jp.data), (tp.lengths, jp.lengths), (tp.sub_lengths, jp.sub_lengths)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(tp.sub_lengths._host_lengths, tp.sub_lengths.numpy())
    ts = tbatch.slice_batch_rows({"x": tp}, 3)["x"]
    assert np.array_equal(ts.sub_lengths.numpy(), sub) and ts.is_nested


# -- layers over nested and sparse inputs --------------------------------------


def _outputs_both(jout, tout, batch_fn, seed=3):
    """Forward of both packages' topologies from the same parameters on the
    same fed batch: (JAX outputs, port outputs)."""
    jnet = JNet(JTopo(jout if isinstance(jout, list) else [jout]), compute_dtype=jnp.float32)
    tnet = TNet(TTopo(tout if isinstance(tout, list) else [tout]), compute_dtype=torch.float32)
    jparams = paddle_tpu.parameters.create(jout, seed=seed)
    jb, tb = batch_fn()
    jouts, _ = jnet.apply(jparams.params, jb, state=jparams.state, train=False)
    tp = carry(jparams)
    touts, _ = tnet.apply(tp.params, tb, state=tp.state, train=False)
    return jouts, touts


def _to_jax(batch):
    return {k: JSeq(jnp.asarray(v.data), None if v.lengths is None else jnp.asarray(v.lengths),
                    None if v.sub_lengths is None else jnp.asarray(v.sub_lengths),
                    sparse_ids=v.sparse_ids) for k, v in batch.items()}


def _fed(types_fn, samples):
    """The same samples through both packages' feeders."""
    def make():
        jtypes, ttypes = types_fn(paddle_tpu), types_fn(paddle_tpu_torch)
        jb = jfeeder.DataFeeder(jtypes)(samples)
        tb = tfeeder.DataFeeder(ttypes, device="cpu")(samples)
        return _to_jax(jb), tb
    return make


def _nested_samples(n=4, dim=6, seed=5):
    rs = _rs(seed)
    return [([rs.randn(rs.randint(2, 6), dim).astype(np.float32).tolist()
              for _ in range(rs.randint(1, 4))], int(rs.randint(0, 3))) for _ in range(n)]


def _nested_net(pkg):
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector_sub_sequence(6))
    h = L.fc(input=x, size=5, act=A.Tanh(), name="nfc")
    cat = L.concat(input=[h, x], name="ncat")
    m = L.mixed(size=4, input=[L.full_matrix_projection(cat), L.identity_projection(
        L.fc(input=cat, size=4, act=A.Linear(), name="nfc2"))], name="nmix")
    return [h, cat, m]


def test_nested_fc_concat_mixed_match_the_jax_package():
    jout, tout = build_both(_nested_net)
    types = lambda pkg: [("x", pkg.data_type.dense_vector_sub_sequence(6))]  # noqa: E731
    samples = [(s[0],) for s in _nested_samples()]
    jouts, touts = _outputs_both(jout, tout, _fed(types, samples))
    for name in ("nfc", "ncat", "nmix"):
        j, t = jouts[name], touts[name]
        assert t.is_nested and t.data.dim() == 4
        assert rel_l2(t.data, np.asarray(j.data)) <= REL, name
        assert np.array_equal(t.lengths.numpy(), np.asarray(j.lengths))
        if j.sub_lengths is not None:
            assert np.array_equal(t.sub_lengths.numpy(), np.asarray(j.sub_lengths))


def test_nested_inference_unpads_both_levels():
    jout, tout = build_both(lambda pkg: _nested_net(pkg)[0])
    jparams = paddle_tpu.parameters.create(jout, seed=2)
    samples = [(s[0],) for s in _nested_samples(n=5, seed=9)]
    want = paddle_tpu.infer(jout, jparams, samples)
    got = paddle_tpu_torch.infer(tout, carry(jparams), samples, device="cpu")
    n_rows = sum(len(sub) for s in samples for sub in s[0])
    assert got.shape == want.shape == (n_rows, 5)
    assert rel_l2(got, want) <= REL


def _sparse_net(pkg, dim, kind):
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    slot = getattr(dt, {"binary": "sparse_binary_vector", "float": "sparse_float_vector",
                        "binary_seq": "sparse_binary_vector_sequence"}[kind])(dim)
    x = L.data(name="x", type=slot)
    h = L.fc(input=x, size=8, act=A.Tanh(), name="sfc")
    if kind == "binary_seq":
        h = L.pooling(input=h, pooling_type=pkg.pooling.Sum())
    p = L.fc(input=h, size=3, act=A.Softmax())
    label = L.data(name="y", type=dt.integer_value(3))
    return L.classification_cost(input=p, label=label)


def _grads(jcost, tcost, batch_fn, seed=4):
    jnet = JNet(JTopo([jcost]), compute_dtype=jnp.float32)
    tnet = TNet(TTopo([tcost]), compute_dtype=torch.float32)
    jparams = paddle_tpu.parameters.create(jcost, seed=seed)
    jb, tb = batch_fn()
    jc, jg = jax.value_and_grad(
        lambda p: jnet.cost(p, jb, state=jparams.state, train=True)[0])(jparams.params)
    tp = carry(jparams)
    leaves = map_leaves(lambda v: v.clone().requires_grad_(True), tp.params)
    tc, _ = tnet.cost(leaves, tb, state=tp.state, train=True)
    tc.backward()
    return float(jc), tc.item(), numpy_tree(jg), numpy_tree(map_leaves(lambda v: v.grad, leaves))


@pytest.mark.parametrize("kind,dim", [("binary", 40), ("float", 40), ("binary", BIG),
                                      ("binary_seq", BIG)])
def test_sparse_fc_matches_the_jax_package(kind, dim):
    jcost, tcost = build_both(lambda pkg: _sparse_net(pkg, dim, kind))
    rs = _rs(dim)
    level = 1 if kind == "binary_seq" else 0
    samples = [(_value("float" if kind == "float" else "binary", level, dim, rs),
                int(rs.randint(0, 3))) for _ in range(6)]
    types = lambda pkg: JTopo([jcost]).data_types() if pkg is paddle_tpu \
        else TTopo([tcost]).data_types()  # noqa: E731
    jc, tc, jg, tg = _grads(jcost, tcost, _fed(types, samples))
    assert abs(tc - jc) <= REL * abs(jc)
    assert rel_l2(tg, jg) <= REL


def _weighted_net(pkg):
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector(10))
    p = L.fc(input=x, size=4, act=A.Softmax())
    y = L.data(name="y", type=dt.integer_value(4))
    w = L.data(name="w", type=dt.dense_vector(1))
    return L.classification_cost(input=p, label=y, weight=w, name="wcost")


def test_weighted_classification_cost_matches_the_jax_package():
    jcost, tcost = build_both(_weighted_net)
    assert JTopo([jcost]).serialize() == TTopo([tcost]).serialize()
    rs = _rs(11)
    samples = [(rs.randn(10).astype(np.float32), int(rs.randint(0, 4)),
                [float(rs.uniform(0.1, 2.0))]) for _ in range(7)]
    types = lambda pkg: [("x", pkg.data_type.dense_vector(10)),  # noqa: E731
                         ("y", pkg.data_type.integer_value(4)),
                         ("w", pkg.data_type.dense_vector(1))]
    jc, tc, jg, tg = _grads(jcost, tcost, _fed(types, samples))
    assert abs(tc - jc) <= REL * abs(jc)
    assert rel_l2(tg, jg) <= REL


@pytest.mark.parametrize("cost,label", [("square_error_cost", "id"),
                                        ("multi_binary_label_cross_entropy_cost", "ids"),
                                        ("multi_binary_label_cross_entropy_cost", "dense")])
def test_sparse_label_costs_match_the_jax_package(cost, label):
    width = BIG if label == "ids" else 6
    dt_name = {"id": "integer_value", "ids": "sparse_binary_vector",
               "dense": "dense_vector"}[label]

    def net(pkg):
        L, A, dt = pkg.layer, pkg.activation, pkg.data_type
        x = L.data(name="x", type=dt.dense_vector(5))
        p = L.fc(input=x, size=width, act=A.Sigmoid())
        y = L.data(name="y", type=getattr(dt, dt_name)(width))
        return getattr(L, cost)(input=p, label=y)

    jcost, tcost = build_both(net)
    rs = _rs(13)
    ys = {"id": lambda: int(rs.randint(0, width)), "ids": lambda: _ids(rs, width),
          "dense": lambda: rs.randint(0, 2, size=width).astype(np.float32)}[label]
    samples = [(rs.randn(5).astype(np.float32), ys()) for _ in range(4)]
    types = lambda pkg: [("x", pkg.data_type.dense_vector(5)),  # noqa: E731
                         ("y", getattr(pkg.data_type, dt_name)(width))]
    jc, tc, jg, tg = _grads(jcost, tcost, _fed(types, samples))
    assert abs(tc - jc) <= REL * abs(jc)
    assert rel_l2(tg, jg) <= REL
