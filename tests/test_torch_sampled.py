"""The sampled output layers (``nce``, ``hsigmoid``, ``selective_fc``), the
ranking costs (``lambda_cost``, ``rank_cost``) and the networks that carry
them, in the port against the JAX package on the CPU (f32).

Each type runs on its network of ``tests/test_layer_grad_sweep.py``
(:338-377) on the same random batch with the JAX parameters moved across:
outputs within atol 1e-5 and rtol 1e-5, gradients of parameters and float
inputs within 1e-4 relative L2, one forward case and one gradient case per
network.  nce draws its noise from another generator than ``jax.random``, so
its parity cases take a one-hot ``neg_distribution`` (both packages then
draw the same ids); they cover a plain input, a frame-wise sequence input
(the mask is the intersection of the feature's and the label's lengths) and
two feature inputs.  hsigmoid runs at ``num_classes`` 2, 3, 8, 9 and 1000,
and its class probabilities sum to 1 on small trees; selective_fc with a
dense selection and an id selection; lambda_cost on random scores and on
tied scores with integer grades (there also the gradients with respect to
the grades: the ideal DCG's sort is stable in both packages).  selective_fc without a selection fails in
both packages alike: its init sizes w from every input but the last, as
if the last were a selection, so w is [0, C] (mirrored, as ROADMAP's
reference-side observations record).

Beyond parity: the sampler's frequencies over 20,000 draws lie within 0.02
of a 20-class non-uniform distribution (a class of probability 0 is never
drawn); without a step seed nce draws from a fixed generator; and the
carriers at small widths, cost and gradients against the JAX package: the
word2vec N-gram language model of the PaddlePaddle book (4 context words,
a shared embedding, a sigmoid hidden layer) through its softmax head, an
hsigmoid head and an nce head, on windows of ``dataset.imikolov``'s
synthetic corpus, and RankNet (``rank_cost`` over a scoring network shared
by name) and LambdaRank (``lambda_cost``) on ``dataset.mq2007``'s synthetic
query lists."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from layer_grad_util import rand_batch_for
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu.core.compiler import CompiledNetwork as JNet
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu_torch.core.batch import SeqTensor as TSeq
from paddle_tpu_torch.dataset import imikolov, mq2007
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.layers import sampled
from test_torch_parity import (
    assert_outputs_close, assert_params_carry, build_both, carry, grads_both, outputs_both, rel_l2)

GRAD_REL = 1e-4


def _dense(pkg, dim=8, name="in0"):
    return pkg.layer.data(name, pkg.data_type.dense_vector(dim))


def _dense_seq(pkg, dim=8, name="seq0"):
    return pkg.layer.data(name, pkg.data_type.dense_vector_sequence(dim))


def _ids(pkg, vocab=10, name="ids0"):
    return pkg.layer.data(name, pkg.data_type.integer_value(vocab))


def _one_hot(c, k):
    return [1.0 if i == k else 0.0 for i in range(c)]


def _nce(pkg):
    return pkg.layer.nce(_dense(pkg), _ids(pkg), num_neg_samples=4,
                         neg_distribution=_one_hot(10, 3))


def _nce_seq(pkg):
    return pkg.layer.nce(_dense_seq(pkg, 6), pkg.layer.data(
        "lab", pkg.data_type.integer_value_sequence(10)), num_neg_samples=3,
        neg_distribution=_one_hot(10, 7))


def _nce_two(pkg):
    return pkg.layer.nce([_dense(pkg, 4, "a"), _dense(pkg, 6, "b")], _ids(pkg),
                         num_neg_samples=2, neg_distribution=_one_hot(10, 0))


def _hsigmoid(c):
    return lambda pkg: pkg.layer.hsigmoid(_dense(pkg), _ids(pkg, vocab=c), num_classes=c)


def _selective(kind):
    def build(pkg):
        sel = {"ids": lambda: _ids(pkg, 9, "sel"), "dense": lambda: _dense(pkg, 9, "sel"),
               "none": lambda: None}[kind]()
        return pkg.layer.selective_fc(_dense(pkg, 8, "x"), sel, size=9)
    return build


def _lambda(pkg):
    L, A = pkg.layer, pkg.activation
    return L.lambda_cost(L.fc(_dense_seq(pkg, 4), size=1, act=A.Identity()),
                         pkg.layer.data("y", pkg.data_type.dense_vector_sequence(1)))


def _rank(pkg):
    L, A = pkg.layer, pkg.activation
    return L.rank_cost(L.fc(_dense(pkg, 4, "a"), size=1, act=A.Identity()),
                       L.fc(_dense(pkg, 4, "b"), size=1, act=A.Identity()), _ids(pkg, 2, "lbl"))


def _tied_grades(jbatch):
    """Scores tied in pairs, integer grades 0-2."""
    x = np.asarray(jbatch["seq0"].data).copy()
    x[:, 1::2] = x[:, 0::2][:, : x[:, 1::2].shape[1]]
    y = np.random.RandomState(4).randint(0, 3, size=jbatch["y"].data.shape).astype(np.float32)
    jbatch["seq0"] = JSeq(jnp.asarray(x), jbatch["seq0"].lengths)
    jbatch["y"] = JSeq(jnp.asarray(y), jbatch["y"].lengths)
    return jbatch


# name -> (network, float slots whose gradients are compared, batch edit)
CASES = {
    "nce": (_nce, ("in0",), None),
    "nce_sequence": (_nce_seq, ("seq0",), None),
    "nce_two_features": (_nce_two, ("a", "b"), None),
    "hsigmoid_2": (_hsigmoid(2), ("in0",), None),
    "hsigmoid_3": (_hsigmoid(3), ("in0",), None),
    "hsigmoid_8": (_hsigmoid(8), ("in0",), None),
    "hsigmoid_9": (_hsigmoid(9), ("in0",), None),
    "hsigmoid_1000": (_hsigmoid(1000), ("in0",), None),
    "selective_fc": (_selective("ids"), ("x",), None),
    "selective_fc_dense_selection": (_selective("dense"), ("x",), lambda b: {
        **b, "sel": JSeq((b["sel"].data > 0).astype(jnp.float32))}),
    "lambda_cost": (_lambda, ("seq0",), None),
    "lambda_cost_ties": (_lambda, ("seq0", "y"), _tied_grades),
    "rank_cost": (_rank, ("a", "b"), None),
}


def _both_build(build):
    jout, tout = build_both(build)
    assert TTopo([tout]).serialize() == JTopo([jout]).serialize()
    return jout, tout, rand_batch_for(JTopo([jout]), batch_size=16, max_len=6, seed=3)


def _both(case):
    build, _, edit = CASES[case]
    jout, tout, jbatch = _both_build(build)
    return jout, tout, jbatch if edit is None else edit(jbatch)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    jout, tout, jbatch = _both(case)
    jo, to, _, _ = outputs_both(jout, tout, jbatch, seed=1, grads=False)
    assert_outputs_close(jo, to)
    assert np.isfinite(to[jout.name].data).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    jout, tout, jbatch = _both(case)
    jo, to, jg, tg = outputs_both(jout, tout, jbatch, seed=1, input_grads=CASES[case][1])
    assert_outputs_close(jo, to)
    err = rel_l2(tg, jg)
    assert err <= GRAD_REL, err


@pytest.mark.parametrize("case", ["nce", "hsigmoid_9", "selective_fc", "nce_two_features"])
def test_new_parameters_carry_by_name_and_shape(case):
    """nce w [C, D] and b [C], hsigmoid w [C-1, D] and b [C-1],
    selective_fc w [D, C]."""
    assert_params_carry(*build_both(CASES[case][0]))


def test_selective_fc_without_a_selection_fails_as_in_jax():
    jout, tout, jbatch = _both_build(_selective("none"))
    jparams = paddle_tpu.parameters.create(jout, seed=1)
    assert np.asarray(jparams.params[jout.name]["w"]).shape == (0, 9)
    assert tuple(carry(jparams).params[tout.name]["w"].shape) == (0, 9)
    with pytest.raises(TypeError, match="contracting dimensions"):
        outputs_both(jout, tout, jbatch, grads=False, jparams=jparams)
    with pytest.raises(RuntimeError, match="cannot be multiplied"):
        TNet(TTopo([tout])).apply(carry(jparams).params, {"x": TSeq(torch.ones(2, 8))},
                                  train=False)


# ---------------------------------------------------------------------------
# the sampler and the tree
# ---------------------------------------------------------------------------


def test_nce_sampler_follows_the_distribution():
    """20,000 draws by inverse CDF from a 20-class distribution with one
    class at 0: each frequency within 0.02, the empty class never drawn."""
    q = np.random.RandomState(8).uniform(0.1, 1.0, 20)
    q[5] = 0.0
    q /= q.sum()
    conf = paddle_tpu_torch.layer.nce(_dense(paddle_tpu_torch), _ids(paddle_tpu_torch, 20),
                                      neg_distribution=q.tolist()).conf
    _, cdf = sampled.noise_tables(conf, {}, torch.device("cpu"))
    ids = sampled.draw_noise(cdf, 20, (2000, 10), torch.Generator().manual_seed(3), "cpu")
    freq = torch.bincount(ids.reshape(-1), minlength=20).double().numpy() / 20000
    assert np.abs(freq - q).max() <= 0.02, freq
    assert freq[5] == 0.0
    uni = sampled.draw_noise(None, 20, (2000, 10), torch.Generator().manual_seed(3), "cpu")
    assert np.abs(torch.bincount(uni.reshape(-1), minlength=20).numpy() / 20000 - 0.05).max() \
        <= 0.02


def test_nce_noise_comes_from_the_step_seed_or_a_fixed_one():
    """Uniform noise: with no step seed two runs draw alike (a fixed-seed
    generator, never the global one); a step seed draws its own ids, the
    same again for the same seed."""
    L, dt = paddle_tpu_torch.layer, paddle_tpu_torch.data_type
    out = L.nce(L.data("x", dt.dense_vector(8)), L.data("y", dt.integer_value(50)))
    net = TNet(TTopo([out]))
    params = net.init_params(1, device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"x": TSeq(torch.randn(64, 8, generator=g)),
             "y": TSeq(torch.randint(0, 50, (64,), generator=g, dtype=torch.int32))}

    def cost(rng):
        return net.apply(params, batch, train=True, rng=rng)[0][out.name].data

    torch.manual_seed(123)
    a = cost(None)
    torch.manual_seed(456)
    assert torch.equal(cost(None), a)
    assert torch.equal(cost(7), cost(7))
    assert not torch.equal(cost(7), cost(8))


@pytest.mark.parametrize("c", [2, 3, 6, 9])
def test_hsigmoid_class_probabilities_total_one(c):
    """tests/test_sampled_misc.py:64: the tree's class probabilities
    exp(-cost) over every class sum to 1."""
    L, dt = paddle_tpu_torch.layer, paddle_tpu_torch.data_type
    out = L.hsigmoid(L.data("x", dt.dense_vector(5)), L.data("lab", dt.integer_value(c)),
                     num_classes=c)
    net = TNet(TTopo([out]))
    params = net.init_params(1, device="cpu")
    params[out.name]["b"] = torch.randn(c - 1, generator=torch.Generator().manual_seed(2))
    feat = torch.randn(1, 5, generator=torch.Generator().manual_seed(0)).expand(c, 5)
    batch = {"x": TSeq(feat.contiguous()), "lab": TSeq(torch.arange(c, dtype=torch.int32))}
    cost = net.apply(params, batch, train=False)[0][out.name].data[:, 0]
    assert abs(float(torch.exp(-cost.double()).sum()) - 1.0) < 1e-5


def test_hsigmoid_paths_walk_the_tree():
    """num_classes 5: class c's code is c + 5; its path visits the internal
    nodes of the code's prefixes (node = prefix - 1) and takes the next
    bit of the code at each."""
    node, bit, valid = sampled.path_codes(torch.arange(5), 5)
    want = {0: ([0, 1], [0, 1]), 1: ([0, 2], [1, 0]), 2: ([0, 2], [1, 1]),
            3: ([0, 1, 3], [0, 0, 0]), 4: ([0, 1, 3], [0, 0, 1])}
    for c, (nodes, bits) in want.items():
        n = int(valid[c].sum())
        assert node[c, :n].tolist() == nodes and bit[c, :n].tolist() == bits, c


def test_hsigmoid_path_length_is_the_exact_bit_length():
    """The path length is bit_length(code) - 1, which is the JAX package's
    floor(log2(code + 0.5)) in f32 for every code below 2^20; codes around
    every power of two up to 2^24."""
    codes = np.asarray(sorted({(1 << k) + d for k in range(1, 25) for d in (-2, -1, 0, 1)}
                              - {0}), np.int64)
    for c in (2, 3, 1000, 1 << 19):
        lab = codes[(codes >= c) & (codes < 2 * c)] - c
        _, _, valid = sampled.path_codes(torch.from_numpy(lab), c)
        got = valid.sum(dim=1).numpy()
        want = np.asarray([int(x).bit_length() - 1 for x in lab + c])
        np.testing.assert_array_equal(got, want)
        jax_len = np.asarray(jnp.floor(jnp.log2(jnp.asarray(lab + c, jnp.float32) + 0.5)))
        np.testing.assert_array_equal(got, jax_len.astype(np.int64))


# ---------------------------------------------------------------------------
# the carriers at small widths
# ---------------------------------------------------------------------------

NGRAM_EMB, NGRAM_HIDDEN = 8, 16


def ngram_lm(pkg, head, dict_size):
    """The word2vec N-gram model of the PaddlePaddle book: four context
    words through one shared embedding, concat, fc(sigmoid), then a head
    over the dictionary."""
    L, A, dt, attr = pkg.layer, pkg.activation, pkg.data_type, pkg.attr
    words = [L.data(f"w{i}", dt.integer_value(dict_size)) for i in range(4)]
    nxt = L.data("next", dt.integer_value(dict_size))
    embs = [L.embedding(w, size=NGRAM_EMB, param_attr=attr.ParamAttr(name="_proj"))
            for w in words]
    hidden = L.fc(L.concat(embs), size=NGRAM_HIDDEN, act=A.Sigmoid())
    if head == "softmax":
        return L.classification_cost(L.fc(hidden, size=dict_size, act=A.Softmax()), nxt)
    if head == "hsigmoid":
        return L.hsigmoid(hidden, nxt, num_classes=dict_size)
    return L.nce(hidden, nxt, num_classes=dict_size, neg_distribution=_one_hot(dict_size, 11))


@pytest.fixture(scope="module")
def ngram_windows():
    word_idx = imikolov.build_dict()
    windows = list(itertools.islice(imikolov.train(word_idx, 5)(), 32))
    return len(word_idx), np.asarray(windows, np.int32)


@pytest.mark.parametrize("head", ["softmax", "hsigmoid", "nce"])
def test_ngram_lm_matches_jax(head, ngram_windows):
    dict_size, win = ngram_windows
    jcost, tcost = build_both(lambda pkg: ngram_lm(pkg, head, dict_size))
    assert TTopo([tcost]).serialize() == JTopo([jcost]).serialize()
    jparams = paddle_tpu.parameters.create(jcost, seed=5)
    arrays = {f"w{i}": (win[:, i], None) for i in range(4)}
    arrays["next"] = (win[:, 4], None)
    jc, tc, jg, tg = grads_both(jcost, tcost, jparams, arrays)
    assert abs(tc - jc) <= 1e-5 * abs(jc)
    err = rel_l2(tg, jg)
    assert err <= GRAD_REL, err


def _scorer(pkg, x, hidden):
    """RankNet's scoring network, its parameters shared by name."""
    L, A, attr = pkg.layer, pkg.activation, pkg.attr
    h = L.fc(x, size=hidden, act=A.Tanh(), param_attr=attr.ParamAttr(name="_h.w"),
             bias_attr=attr.ParamAttr(name="_h.b"))
    return L.fc(h, size=1, act=A.Identity(), param_attr=attr.ParamAttr(name="_s.w"),
                bias_attr=attr.ParamAttr(name="_s.b"))


def ranknet(pkg, dim):
    L, dt = pkg.layer, pkg.data_type
    left = _scorer(pkg, L.data("left", dt.dense_vector(dim)), 10)
    right = _scorer(pkg, L.data("right", dt.dense_vector(dim)), 10)
    return L.rank_cost(left, right, L.data("label", dt.dense_vector(1)))


def lambdarank(pkg, dim):
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    x = L.data("docs", dt.dense_vector_sequence(dim))
    h = L.fc(L.fc(x, size=16, act=A.Tanh()), size=4, act=A.Tanh())
    score = L.fc(h, size=1, act=A.Identity())
    return L.lambda_cost(score, L.data("grades", dt.dense_vector_sequence(1)), NDCG_num=6)


def test_ranknet_matches_jax():
    mq = mq2007
    pairs = list(itertools.islice(mq.train("pairwise")(), 24))
    arrays = {"label": (np.asarray([[p[0]] for p in pairs], np.float32), None),
              "left": (np.stack([p[1] for p in pairs]).astype(np.float32), None),
              "right": (np.stack([p[2] for p in pairs]).astype(np.float32), None)}
    jcost, tcost = build_both(lambda pkg: ranknet(pkg, mq.FEATURE_DIM))
    assert TNet(TTopo([tcost])).named_parameters() == JNet(JTopo([jcost])).named_parameters()
    jparams = paddle_tpu.parameters.create(jcost, seed=6)
    jc, tc, jg, tg = grads_both(jcost, tcost, jparams, arrays)
    assert abs(tc - jc) <= 1e-5 * abs(jc)
    err = rel_l2(tg, jg)
    assert err <= GRAD_REL, err


def test_lambdarank_matches_jax():
    """Ragged query lists: the first 3-8 documents of each synthetic
    list."""
    mq = mq2007
    lists = list(itertools.islice(mq.train("listwise")(), 8))
    lens = np.asarray([3, 8, 5, 8, 4, 6, 7, 8], np.int32)
    t = int(lens.max())
    docs = np.zeros((len(lists), t, mq.FEATURE_DIM), np.float32)
    grades = np.zeros((len(lists), t, 1), np.float32)
    for i, (labels, feats) in enumerate(lists):
        docs[i, :lens[i]] = np.stack(feats)[:lens[i]]
        grades[i, :lens[i], 0] = labels[:lens[i]]
    jcost, tcost = build_both(lambda pkg: lambdarank(pkg, mq.FEATURE_DIM))
    jparams = paddle_tpu.parameters.create(jcost, seed=7)
    jc, tc, jg, tg = grads_both(jcost, tcost, jparams, {"docs": (docs, lens),
                                                         "grades": (grades, lens)})
    assert jc > 0 and abs(tc - jc) <= 1e-5 * abs(jc)
    err = rel_l2(tg, jg)
    assert err <= GRAD_REL, err
