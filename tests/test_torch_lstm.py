"""The port's LSTM and simple-RNN cores (``paddle_tpu_torch/ops/rnn.py``:
``LstmCore`` and ``RnnCore``, autograd Functions with hand-written
backwards), the layers and networks built on them, and ``mixed``, against
the JAX package on the CPU.

- the cores: the cases of tests/test_rnn_cores.py (LSTM: peepholes x
  reverse x ragged; simple RNN: reverse x ragged) through both packages'
  ``lstm_scan`` / ``simple_rnn_scan``, outputs, ``h_last``/``c_last`` and
  every gradient, in float64 (relative 1e-9) and float32 (relative 1e-5);
  other activations; the early exit against the full loop; a
  finite-difference check of each core in float64;
- the layers (``lstmemory`` with and without bias, ``recurrent`` forward and
  reverse, ``lstm_step`` in a recurrent_group with its ``@cell`` memory,
  ``mixed`` with each projection kind and a trans_full_matrix projection
  sharing an fc's weight by name) and the networks (``simple_lstm``,
  ``lstmemory_group``, ``simple_gru``, ``gru_group``,
  ``bidirectional_lstm``/``_gru``): JAX parameters carried by path, float32
  outputs and gradients within 1e-5 relative L2;
- the network of tests/configs/demo_text_lstm.py through both v2 DSLs
  (dropout off): one step's cost and gradients within 1e-5, a 5-step Adam
  trajectory within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core.compiler import CompiledNetwork as JNet
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu.ops import rnn as jrnn
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.utils.flags import reset_flags, set_flag
from paddle_tpu_torch.utils.tree import map_leaves

from test_torch_parity import (
    batch_both, build_both, carry, grads_both, numpy_tree, rel_l2, train_both)

TOL = {np.float64: 1e-9, np.float32: 1e-5}


@pytest.fixture(autouse=True)
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)
    reset_flags()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _both_grads(jfn, tfn, args):
    """(JAX value, JAX grads, port value, port grads) of scalar functions of
    the same numpy arguments."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, ts)
    return float(jv), [np.asarray(g) for g in jg], tv.item(), [g.numpy() for g in tg]


def _assert_both(res, names, tol):
    jv, jg, tv, tg = res
    assert abs(tv - jv) <= tol * max(abs(jv), 1.0), (tv, jv)
    for a, b, name in zip(tg, jg, names):
        assert _rel(a, b) <= tol, (name, _rel(a, b))


# ---------------------------------------------------------------------------
# the LSTM core
# ---------------------------------------------------------------------------

LSTM_KEYS = ("gates", "w_h", "bias", "h0", "c0", "w_ci", "w_cf", "w_co")


def _lstm_case(dtype, seed=0, b=3, t=7, h=5):
    rng = np.random.RandomState(seed)
    return [x.astype(dtype) for x in (
        rng.randn(b, t, 4 * h), rng.randn(h, 4 * h) * 0.3, rng.randn(4 * h) * 0.1,
        rng.randn(b, h) * 0.5, rng.randn(b, h) * 0.5,
        rng.randn(h) * 0.2, rng.randn(h) * 0.2, rng.randn(h) * 0.2)]


def _lstm_loss(pkg, lengths, reverse, peephole, acts, w):
    """Scalar loss of a package's lstm_scan over (gates, w_h, bias, h0, c0,
    w_ci, w_cf, w_co): every output element weighted differently (`w`, at
    the arguments' dtype), plus the final states."""
    mod, lib = (jrnn, jnp) if pkg == "jax" else (trnn, torch)
    conv = jnp.asarray if pkg == "jax" else torch.tensor

    def loss(gates, w_h, bias, h0, c0, *peep):
        peep = peep if peephole else (None, None, None)
        hs, (hl, cl) = mod.lstm_scan(
            gates, w_h, bias, *peep, None if lengths is None else conv(lengths),
            gate_act=acts[0], act=acts[1], state_act=acts[2], reverse=reverse, h0=h0, c0=c0)
        return lib.sum(hs.reshape(-1) * conv(w)) + lib.sum(hl * 1.7) + lib.sum(cl * 0.6)

    return loss


def _lstm_both(args, lengths, reverse, peephole, acts=("sigmoid", "tanh", "tanh")):
    w = np.cos(np.arange(args[0].size // 4)).astype(args[0].dtype)
    return _both_grads(_lstm_loss("jax", lengths, reverse, peephole, acts, w),
                       _lstm_loss("torch", lengths, reverse, peephole, acts, w),
                       args if peephole else args[:5])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("peephole", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_lstm_core_matches_jax(dtype, peephole, reverse, ragged):
    lengths = np.array([7, 4, 2], np.int32) if ragged else None
    res = _lstm_both(_lstm_case(dtype), lengths, reverse, peephole)
    _assert_both(res, LSTM_KEYS if peephole else LSTM_KEYS[:5], TOL[dtype])


@pytest.mark.parametrize("acts", [
    ("relu", "stanh", "softrelu"), ("tanh", "identity", "sigmoid"),
    ("sigmoid", "relu", "tanh"), ("sigmoid", "softmax", "tanh")])
def test_lstm_core_other_activations_match_jax(acts):
    lengths = np.array([5, 7, 3], np.int32)
    _assert_both(_lstm_both(_lstm_case(np.float64, seed=4), lengths, False, True, acts),
                 LSTM_KEYS, 1e-9)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_early_exit_runs_only_live_steps(reverse):
    """Every row shorter than the padded T: the loop runs max(len) steps,
    and values, final states and gradients equal the full loop's."""
    args = _lstm_case(np.float64, seed=2, t=9)
    lengths = np.array([3, 6, 1], np.int32)
    out = {}
    for early in (True, False):
        set_flag("scan_early_exit", early)
        trnn.counters.clear()
        _, _, tv, tg = _lstm_both(args, lengths, reverse, True)
        out[early] = (tv, tg, dict(trnn.counters))
    assert out[True][2]["lstm_steps"] == 6 and out[True][2]["lstm_skipped"] == 3
    assert out[False][2]["lstm_steps"] == 9
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-14)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)


def test_lstm_core_finite_diff():
    """The written-out backward against finite differences in float64, with
    peepholes (the output gate on the new cell), a ragged reverse batch and
    boot states."""
    args = [torch.tensor(a, requires_grad=True) for a in _lstm_case(np.float64, seed=5, t=5)]
    lengths = torch.tensor([5, 2, 3])

    def f(gates, w_h, bias, h0, c0, w_ci, w_cf, w_co):
        hs, (hl, cl) = trnn.lstm_scan(gates, w_h, bias, w_ci, w_cf, w_co, lengths,
                                      reverse=True, h0=h0, c0=c0)
        return (hs ** 2).mean() + (hl * cl).sum()

    assert torch.autograd.gradcheck(f, args, eps=1e-6, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the simple-RNN core
# ---------------------------------------------------------------------------


def _rnn_both(args, lengths, reverse, act="tanh"):
    w = np.cos(np.arange(args[0].size))

    def jloss(x, w_h, bias, h0):
        hs, hl = jrnn.simple_rnn_scan(x, w_h, bias,
                                      None if lengths is None else jnp.asarray(lengths),
                                      act=act, reverse=reverse, h0=h0)
        return jnp.sum(hs.reshape(-1) * w.astype(x.dtype)) + jnp.sum(hl * 1.3)

    def tloss(x, w_h, bias, h0):
        hs, hl = trnn.simple_rnn_scan(x, w_h, bias,
                                      None if lengths is None else torch.tensor(lengths),
                                      act=act, reverse=reverse, h0=h0)
        return (hs.reshape(-1) * torch.from_numpy(w).to(x.dtype)).sum() + (hl * 1.3).sum()

    return _both_grads(jloss, tloss, args)


def _rnn_case(dtype, seed=1, b=3, t=6, h=4):
    rng = np.random.RandomState(seed)
    return [x.astype(dtype) for x in (rng.randn(b, t, h), rng.randn(h, h) * 0.4,
                                      rng.randn(h) * 0.1, rng.randn(b, h) * 0.5)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_rnn_core_matches_jax(dtype, reverse, ragged):
    lengths = np.array([6, 3, 1], np.int32) if ragged else None
    _assert_both(_rnn_both(_rnn_case(dtype), lengths, reverse), ("x", "w_h", "bias", "h0"),
                 TOL[dtype])


@pytest.mark.parametrize("act", ["relu", "stanh", "sigmoid", "softmax"])
def test_rnn_core_other_activations_match_jax(act):
    _assert_both(_rnn_both(_rnn_case(np.float64, seed=3), np.array([4, 6, 2], np.int32),
                           True, act), ("x", "w_h", "bias", "h0"), 1e-9)


@pytest.mark.parametrize("reverse", [False, True])
def test_rnn_early_exit_runs_only_live_steps(reverse):
    args = _rnn_case(np.float64, seed=2, t=8)
    lengths = np.array([2, 5, 1], np.int32)
    out = {}
    for early in (True, False):
        set_flag("scan_early_exit", early)
        trnn.counters.clear()
        _, _, tv, tg = _rnn_both(args, lengths, reverse)
        out[early] = (tv, tg, dict(trnn.counters))
    assert out[True][2]["rnn_steps"] == 5 and out[True][2]["rnn_skipped"] == 3
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-14)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)


def test_rnn_core_finite_diff():
    args = [torch.tensor(a, requires_grad=True) for a in _rnn_case(np.float64, seed=6)]
    lengths = torch.tensor([6, 1, 4])

    def f(x, w_h, bias, h0):
        hs, hl = trnn.simple_rnn_scan(x, w_h, bias, lengths, h0=h0)
        return (hs ** 2).mean() + hl.sum()

    assert torch.autograd.gradcheck(f, args, eps=1e-6, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# layers and networks against the JAX package, on carried parameters
# ---------------------------------------------------------------------------

B, T, D = 3, 7, 8
LENGTHS = np.array([5, 7, 2], np.int32)


def _seq_batch(seed=0, lengths=LENGTHS, dim=D):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lengths), T, dim).astype(np.float32)
    return {"x": (x, lengths.copy())}


def outputs_and_grads(jout, tout, arrays, seed=1):
    """Float32 output of one layer in both packages from the same (carried)
    parameters, and the gradients of sum(output * fixed weights) with
    respect to every parameter: (JAX out, port out, JAX grads, port
    grads)."""
    jax.config.update("jax_enable_x64", False)
    jparams = paddle_tpu.parameters.create(jout, seed=seed)
    jnet = JNet(JTopo([jout]), compute_dtype=jnp.float32)
    tnet = TNet(TTopo([tout]), compute_dtype=torch.float32)
    jb, tb = batch_both(arrays)
    shape = jnet.apply(jparams.params, jb, state=jparams.state, train=False)[0][
        jout.name].data.shape
    w = np.cos(np.arange(int(np.prod(shape)))).reshape(shape).astype(np.float32)

    def jloss(p):
        o = jnet.apply(p, jb, state=jparams.state, train=False)[0][jout.name].data
        return jnp.sum(o * w), o

    (_, jo), jg = jax.value_and_grad(jloss, has_aux=True)(jparams.params)
    carried = carry(jparams)
    leaves = map_leaves(lambda v: v.clone().requires_grad_(True), carried.params)
    to = tnet.apply(leaves, tb, state=carried.state, train=False)[0][tout.name].data
    (to * torch.from_numpy(w)).sum().backward()
    tg = map_leaves(lambda v: v.grad, leaves)
    return np.asarray(jo), to.detach().numpy(), numpy_tree(jg), numpy_tree(tg)


def _assert_layer_parity(fn, arrays=None, bar=1e-5):
    jout, tout = build_both(fn)
    jo, to, jg, tg = outputs_and_grads(jout, tout, arrays or _seq_batch())
    assert to.shape == jo.shape
    assert _rel(to, jo) <= bar, _rel(to, jo)
    assert set(tg) == set(jg)
    err = rel_l2(tg, jg)
    assert err <= bar, err
    return jg


def _x(pkg, dim=D):
    return pkg.layer.data("x", pkg.data_type.dense_vector_sequence(dim))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstmemory_layer_matches_jax(bias, reverse):
    def net(pkg):
        L = pkg.layer
        proj = L.fc(_x(pkg), size=4 * 6, act=pkg.activation.Identity(), bias_attr=False,
                    name="proj")
        return L.lstmemory(proj, size=6, reverse=reverse, bias_attr=bias, name="lstm")

    grads = _assert_layer_parity(net)
    want = {"w_h", "b", "w_ci", "w_cf", "w_co"} if bias else {"w_h"}
    assert set(grads["lstm"]) == want


@pytest.mark.parametrize("reverse", [False, True])
def test_recurrent_layer_matches_jax(reverse):
    def net(pkg):
        L = pkg.layer
        proj = L.fc(_x(pkg), size=6, act=pkg.activation.Linear(), name="proj")
        return L.recurrent(proj, act=pkg.activation.Tanh(), reverse=reverse, name="rnn")

    grads = _assert_layer_parity(net)
    assert set(grads["rnn"]) == {"w_h", "b"}


@pytest.mark.parametrize("recurrent_weight", [True, False])
def test_lstm_step_in_recurrent_group_matches_jax(recurrent_weight):
    """lstm_step inside a recurrent_group, its cell fed back through
    memory(name='<step>@cell'): the group resolves the side-output link."""

    def net(pkg):
        L = pkg.layer

        def step(x):
            h_mem = L.memory(name="cell_step", size=5)
            c_mem = L.memory(name="cell_step@cell", size=5)
            gates = L.fc(x, size=20, act=pkg.activation.Identity(), name="gates")
            return L.lstm_step(gates, h_mem, c_mem, size=5, name="cell_step",
                               recurrent_weight=recurrent_weight)

        return L.recurrent_group(step=step, input=_x(pkg), name="group")

    grads = _assert_layer_parity(net)
    assert ("w_h" in grads["group"]["cell_step"]) == recurrent_weight
    _, tout = build_both(net)
    links = [m.attrs["link"] for m in tout.conf.attrs["_memories"]]
    assert links == ["cell_step", "cell_step@cell"]


def _dense(pkg, dim=D, name="x"):
    return pkg.layer.data(name, pkg.data_type.dense_vector(dim))


_PROJECTIONS = {
    "full_matrix": lambda pkg: pkg.layer.full_matrix_projection(_dense(pkg), size=6),
    "trans_full_matrix": lambda pkg: pkg.layer.trans_full_matrix_projection(_dense(pkg), size=6),
    "table": lambda pkg: pkg.layer.table_projection(
        pkg.layer.data("ids", pkg.data_type.integer_value(12)), size=6),
    "identity": lambda pkg: pkg.layer.identity_projection(_dense(pkg, 6)),
    "identity_offset": lambda pkg: pkg.layer.identity_projection(_dense(pkg), offset=2, size=6),
    "slice": lambda pkg: pkg.layer.slice_projection(_dense(pkg), [(0, 2), (4, 8)]),
    "scaling": lambda pkg: pkg.layer.scaling_projection(_dense(pkg, 6)),
    "dotmul": lambda pkg: pkg.layer.dotmul_projection(_dense(pkg, 6)),
}


def _dense_arrays(dim=D):
    rng = np.random.RandomState(3)
    return {"x": (rng.randn(4, dim).astype(np.float32), None),
            "ids": (np.array([0, 11, 5, 12], np.int32), None)}  # 12: out of range, zero row


@pytest.mark.parametrize("kind", sorted(_PROJECTIONS))
def test_mixed_projection_matches_jax(kind):
    def net(pkg):
        return pkg.layer.mixed(size=6, input=_PROJECTIONS[kind](pkg), act=pkg.activation.Tanh(),
                               bias_attr=True, name="mix")

    arrays = _dense_arrays(6 if kind in ("identity", "scaling", "dotmul") else D)
    if kind != "table":
        arrays.pop("ids")
    else:
        arrays.pop("x")
    grads = _assert_layer_parity(net, arrays)
    weighted = kind in ("full_matrix", "trans_full_matrix", "table", "scaling", "dotmul")
    assert set(grads["mix"]) == ({"p0_w", "b"} if weighted else {"b"})


def test_mixed_many_projections_and_builder_match_jax():
    """Several terms over a sequence and a plain input, built with the v1
    ``with mixed() as m: m += ...`` form."""

    def net(pkg):
        L = pkg.layer
        x = _x(pkg)
        with L.mixed(size=6, act=pkg.activation.Sigmoid(), bias_attr=True, name="mix") as m:
            m += L.full_matrix_projection(x, size=6)
            m += L.identity_projection(x, offset=1, size=6)
            m += L.dotmul_projection(L.fc(x, size=6, name="pre"))
            m += L.scaling_projection(L.fc(x, size=6, name="pre2"))
        return m

    grads = _assert_layer_parity(net)
    assert set(grads["mix"]) == {"p0_w", "p2_w", "p3_w", "b"}


def test_trans_full_matrix_shares_an_fc_weight_by_name():
    """An fc [D, S] and a trans_full_matrix projection [S -> D] naming the
    same parameter: one tensor, both uses' gradients summed."""

    def net(pkg):
        L, attr = pkg.layer, pkg.attr
        h = L.fc(_x(pkg), size=5, act=pkg.activation.Tanh(), bias_attr=False,
                 param_attr=attr.ParamAttr(name="tied"), name="enc")
        return L.mixed(size=D, input=L.trans_full_matrix_projection(
            h, size=D, param_attr=attr.ParamAttr(name="tied")), name="dec")

    grads = _assert_layer_parity(net)
    assert "enc" in grads and "dec" not in grads
    _, tout = build_both(net)
    assert TNet(TTopo([tout])).named_parameters() == {"tied": "enc.w0"}


_NETWORKS = {
    "simple_lstm": lambda pkg: pkg.networks.simple_lstm(_x(pkg), 5, name="net"),
    "simple_lstm_reverse": lambda pkg: pkg.networks.simple_lstm(_x(pkg), 5, reverse=True,
                                                                name="net"),
    "lstmemory_group": lambda pkg: pkg.networks.lstmemory_group(
        pkg.layer.fc(_x(pkg), size=20, act=pkg.activation.Identity(), name="proj"), size=5,
        name="net"),
    "lstmemory_group_reverse": lambda pkg: pkg.networks.lstmemory_group(
        pkg.layer.fc(_x(pkg), size=20, act=pkg.activation.Identity(), name="proj"), size=5,
        reverse=True, name="net"),
    "simple_gru": lambda pkg: pkg.networks.simple_gru(_x(pkg), 5, name="net"),
    "gru_group": lambda pkg: pkg.networks.gru_group(
        pkg.layer.fc(_x(pkg), size=15, act=pkg.activation.Identity(), name="proj"), size=5,
        name="net"),
    "bidirectional_lstm": lambda pkg: pkg.networks.bidirectional_lstm(_x(pkg), 4, name="net"),
    "bidirectional_lstm_seq": lambda pkg: pkg.networks.bidirectional_lstm(
        _x(pkg), 4, name="net", return_seq=True),
    "bidirectional_gru": lambda pkg: pkg.networks.bidirectional_gru(_x(pkg), 4, name="net"),
    "bidirectional_gru_seq": lambda pkg: pkg.networks.bidirectional_gru(
        _x(pkg), 4, name="net", return_seq=True),
    "bidirectional_lstm_concat": lambda pkg: pkg.networks.bidirectional_lstm(
        _x(pkg), 4, return_concat=False),
}


@pytest.mark.parametrize("name", sorted(_NETWORKS))
def test_network_matches_jax(name):
    # a row shorter than the rest and the padded T (the early exit runs)
    _assert_layer_parity(_NETWORKS[name], _seq_batch(lengths=np.array([5, 6, 2], np.int32)))


def test_lstmemory_groups_share_named_parameters():
    """Two lstmemory_groups naming the same param_attr and lstm_bias_attr
    share the projection weight and the step bias (JAX networks.py
    :349-351), per parameter."""

    def net(pkg):
        L, attr, nets = pkg.layer, pkg.attr, pkg.networks
        proj = L.fc(_x(pkg), size=20, act=pkg.activation.Identity(), name="proj")
        kw = dict(size=5, param_attr=attr.ParamAttr(name="w_rec"),
                  lstm_bias_attr=attr.ParamAttr(name="b_rec"))
        a = nets.lstmemory_group(proj, name="ga", **kw)
        b = nets.lstmemory_group(proj, name="gb", reverse=True, **kw)
        return L.addto([a, b], name="sum")

    grads = _assert_layer_parity(net)
    assert "gb" not in grads  # every gb parameter lives at ga
    _, tout = build_both(net)
    assert TNet(TTopo([tout])).named_parameters() == {
        "w_rec": "ga.ga_unit_input_recurrent.p1_w", "b_rec": "ga.ga_unit.b"}


# ---------------------------------------------------------------------------
# the demo_text_lstm.py network
# ---------------------------------------------------------------------------

DICT = 100


def text_lstm(pkg):
    """tests/configs/demo_text_lstm.py through the v2 DSL with explicit
    names, its dropout left out: embedding 32 -> simple_lstm 32 -> max
    pooling -> fc 32 tanh -> fc 2 softmax -> classification cost."""
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    words = L.data(name="word", type=dt.integer_value_sequence(DICT))
    emb = L.embedding(words, size=32, name="emb")
    lstm = pkg.networks.simple_lstm(emb, 32, name="lstm")
    pooled = L.pooling(lstm, pooling_type=pkg.pooling.Max(), name="pool")
    hidden = L.fc(pooled, size=32, act=A.Tanh(), name="hidden")
    predict = L.fc(hidden, size=2, act=A.Softmax(), name="predict")
    label = L.data(name="label", type=dt.integer_value(2))
    return L.classification_cost(input=predict, label=label, name="cost")


def text_samples(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, DICT, size=int(rng.randint(3, 20)))
        out.append((list(ids), int(ids.sum() % 2)))
    return out


def _text_batch(samples):
    t = max(len(s[0]) for s in samples)
    ids = np.zeros((len(samples), t), np.int32)
    for i, s in enumerate(samples):
        ids[i, : len(s[0])] = s[0]
    lengths = np.array([len(s[0]) for s in samples], np.int32)
    return {"word": (ids, lengths), "label": (np.array([s[1] for s in samples], np.int32), None)}


def test_demo_text_lstm_gradients_match_jax():
    jax.config.update("jax_enable_x64", False)
    jcost, tcost = build_both(text_lstm)
    jparams = paddle_tpu.parameters.create(jcost, seed=7)
    jc, tc, jg, tg = grads_both(jcost, tcost, jparams, _text_batch(text_samples(16, 1)))
    err = rel_l2(tg, jg)
    print(f"demo_text_lstm: cost {tc} vs {jc}; gradients relative L2 {err:.3e} (bar 1e-5)")
    assert abs(tc - jc) <= 1e-5 * abs(jc)
    assert err <= 1e-5


def test_demo_text_lstm_adam_trajectory_matches_jax():
    jax.config.update("jax_enable_x64", False)
    jcost, tcost = build_both(text_lstm)
    jparams = paddle_tpu.parameters.create(jcost, seed=8)
    jcosts, tcosts, jtr, ttr = train_both(
        jcost, tcost, jparams, lambda pkg: pkg.optimizer.Adam(learning_rate=2e-3),
        text_samples(80, 2), 16, {"word": 0, "label": 1})
    assert len(jcosts) == len(tcosts) == 5
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-4)
    assert rel_l2(ttr.parameters.params, jtr.parameters.params) <= 1e-4


# ---------------------------------------------------------------------------
# the v1 tar across the packages
# ---------------------------------------------------------------------------


def _tar_net(pkg):
    """lstmemory with its named peepholes, recurrent, a mixed layer with two
    weighted projections and an lstmemory_group sharing named parameters."""
    L, attr = pkg.layer, pkg.attr
    x = _x(pkg)
    lstm = pkg.networks.simple_lstm(x, 4, name="lstm")
    rnn = L.recurrent(L.fc(x, size=4, name="rproj"), name="rnn")
    mix = L.mixed(size=4, input=[L.full_matrix_projection(lstm), L.dotmul_projection(rnn)],
                  bias_attr=True, name="mix")
    group = pkg.networks.lstmemory_group(
        L.fc(mix, size=16, act=pkg.activation.Identity(), name="gproj"), size=4, name="grp",
        param_attr=attr.ParamAttr(name="grp_w"))
    return L.last_seq(group, name="out")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tar_carries_the_slice_parameters_across_packages(writer):
    import io

    jax.config.update("jax_enable_x64", False)
    jout, tout = build_both(_tar_net)
    jparams = paddle_tpu.parameters.create(jout, seed=4)
    tparams = carry(jparams, tout)
    names = list(jparams.names())
    assert tparams.names() == names
    assert {"lstm.w_ci", "lstm.w_cf", "lstm.w_co", "rnn.w_h", "rnn.b", "mix.p0_w", "mix.p1_w",
            "grp.grp_unit_input_recurrent.p1_w"} <= set(names)
    rng = np.random.RandomState(9)
    src, dst = (jparams, tparams) if writer == "jax" else (tparams, jparams)
    for name in names:
        src.set(name, rng.randn(*np.shape(src.get(name))).astype(np.float32))
    buf = io.BytesIO()
    src.to_tar(buf)
    buf.seek(0)
    dst.from_tar(buf)
    for name in names:
        assert np.array_equal(np.asarray(dst.get(name)), np.asarray(src.get(name))), name
    other = io.BytesIO()
    dst.to_tar(other)
    assert other.getvalue() == buf.getvalue()
    # both packages now compute from the same numbers
    jb, tb = batch_both(_seq_batch())
    want = JNet(JTopo([jout])).apply(jparams.params, jb, train=False)[0]["out"].data
    got = TNet(TTopo([tout])).apply(tparams.params, tb, train=False)[0]["out"].data
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5
