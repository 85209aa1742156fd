"""The shared parity helper of the port's tests, and tests of its own.

Other ``tests/test_torch_*.py`` files import it (``tests/`` has no
``__init__.py``, so pytest's prepend import mode puts this directory on the
path).  The helper builds one topology in both packages, carries the JAX
package's parameters and layer state into the port with
``parameters.from_numpy``, feeds both the same numpy batch, and compares
outputs, gradients and trajectories (``outputs_both`` takes any JAX batch,
nested ones included, and the gradients of float input slots too).

Trees may nest (a recurrent group's parameters sit one level deeper).

Its own tests: parameters carried over are bit-exact by name in both
directions; with ``train=False`` a topology with dropout and error
clipping computes the same forward in both packages (f32, atol 1e-5: the
same arithmetic in another summation order); and the demo MLP's one-step
gradients agree (relative L2 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu.core.compiler import CompiledNetwork as JNet
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu.core.topology import reset_auto_names as j_reset
from paddle_tpu_torch.core.batch import SeqTensor as TSeq
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.core.topology import reset_auto_names as t_reset
from paddle_tpu_torch.utils.tree import map_leaves

MLP_FEEDING = {"pixel": 0, "label": 1}


# ---------------------------------------------------------------------------
# the helper
# ---------------------------------------------------------------------------


def build_both(fn):
    """fn(package) in the JAX package, then in the port, from the same
    auto-name counters; returns (JAX result, port result)."""
    j_reset()
    t_reset()
    jres = fn(paddle_tpu)
    tres = fn(paddle_tpu_torch)
    return jres, tres


def numpy_tree(tree):
    """A JAX or port tree ({layer: {key: array}}, one level deeper inside a
    recurrent group) as float32 ndarrays (a copy)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = numpy_tree(v)
            continue
        if torch.is_tensor(v):
            v = v.detach().float().cpu().numpy()
        out[k] = np.array(v, dtype=np.float32)
    return out


def flat_leaves(tree, prefix=""):
    """{dotted path: leaf} of a nested tree."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat_leaves(v, name))
        else:
            out[name] = v
    return out


def carry(jparams, output=None):
    """The port's Parameters holding the JAX Parameters' values and state;
    with `output` (a port layer), bound to the port's network of that
    layer's topology, as ``parameters.create`` binds them (the generator
    and the engine read the network)."""
    tparams = paddle_tpu_torch.parameters.from_numpy(
        numpy_tree(jparams.params), numpy_tree(jparams.state), device="cpu")
    if output is not None:
        tparams.network = TNet(TTopo([output]))
    return tparams


def rel_l2(got, want) -> float:
    """|got - want| / |want| over every leaf of two trees (or two
    arrays)."""
    if not isinstance(want, dict):
        got, want = {"x": got}, {"x": want}
    got, want = flat_leaves(numpy_tree(got)), flat_leaves(numpy_tree(want))
    assert set(got) == set(want)
    d2 = sum(float(((got[k].astype(np.float64) - want[k]) ** 2).sum()) for k in want)
    n2 = sum(float((want[k].astype(np.float64) ** 2).sum()) for k in want)
    return (d2 / max(n2, 1e-300)) ** 0.5


def assert_trees_equal(got, want):
    """Bit-exact equality of two trees."""
    got, want = flat_leaves(numpy_tree(got)), flat_leaves(numpy_tree(want))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def batch_both(arrays):
    """{slot: (data, lengths or None)} numpy arrays as a JAX batch and a port
    batch."""
    jb, tb = {}, {}
    for name, (data, lengths) in arrays.items():
        jb[name] = JSeq(jnp.asarray(data), None if lengths is None else jnp.asarray(lengths))
        tb[name] = TSeq(torch.from_numpy(np.array(data)),
                        None if lengths is None else torch.from_numpy(np.array(lengths)))
    return jb, tb


def grads_both(jcost, tcost, jparams, batch_arrays, *, state=None, train=True, jit=False):
    """(JAX cost, port cost, JAX grads, port grads) of the mean cost on one
    batch from the same parameters (the JAX gradient op by op, or jitted
    with `jit`)."""
    jnet = JNet(JTopo([jcost]), compute_dtype=jnp.float32)
    tnet = TNet(TTopo([tcost]), compute_dtype=torch.float32)
    jb, tb = batch_both(batch_arrays)
    jstate = jparams.state if state is None else state

    def loss(p):
        return jnet.cost(p, jb, state=jstate, train=train)[0]

    vg = jax.value_and_grad(loss)
    jc, jg = (jax.jit(vg) if jit else vg)(jparams.params)
    carried = carry(jparams)
    leaves = map_leaves(lambda v: v.clone().requires_grad_(True), carried.params)
    tc, _ = tnet.cost(leaves, tb, state=carried.state, train=train)
    tc.backward()
    tg = map_leaves(lambda v: v.grad, leaves)
    return float(jc), tc.item(), numpy_tree(jg), numpy_tree(tg)


def to_port(jbatch):
    """A JAX batch ({slot: SeqTensor}) as a port batch of CPU tensors
    (data, lengths and sub-lengths copied)."""

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))

    return {k: TSeq(t(v.data), t(v.lengths), t(v.sub_lengths)) for k, v in jbatch.items()}


def outputs_both(jout, tout, jbatch, *, seed=0, names=None, grads=True, input_grads=(),
                 jparams=None, jit=False):
    """The named outputs (default: jout's) of one topology in both packages
    on the same batch and parameters (f32, train=False; `jparams`, the JAX
    package's Parameters, else ones created from `seed`), and, with
    `grads`, the gradients of sum(output * w) over every output (w a fixed
    cosine pattern) with respect to the parameters and the float slots in
    `input_grads`, the JAX side's op by op (jitted with `jit`).  Returns
    (JAX outputs, port outputs, JAX gradients, port gradients): outputs as {name: SeqTensor}
    of numpy arrays, gradients as {"params": tree, slot: array}."""
    names = names or [jout.name]
    jnet = JNet(JTopo([jout]), compute_dtype=jnp.float32)
    tnet = TNet(TTopo([tout]), compute_dtype=torch.float32)
    if jparams is None:
        jparams = paddle_tpu.parameters.create(jout, seed=seed)
    tb = to_port(jbatch)
    jfwd = lambda p, b: jnet.apply(p, b, state=jparams.state, train=False)[0]  # noqa: E731
    jouts = (jax.jit(jfwd) if jit else jfwd)(jparams.params, jbatch)

    def np_seq(s):
        def a(x):
            if x is None:
                return None
            return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)
        return JSeq(a(s.data), a(s.lengths), a(s.sub_lengths))

    jo = {n: np_seq(jouts[n]) for n in names}
    carried = carry(jparams)
    if not grads:
        touts = tnet.apply(carried.params, tb, state=carried.state, train=False)[0]
        return jo, {n: np_seq(touts[n]) for n in names}, None, None
    ws = {n: np.cos(np.arange(jo[n].data.size)).reshape(jo[n].data.shape).astype(np.float32)
          for n in names}

    def jloss(p, xs):
        b = dict(jbatch)
        for k, x in xs.items():
            b[k] = JSeq(x, jbatch[k].lengths, jbatch[k].sub_lengths)
        o = jnet.apply(p, b, state=jparams.state, train=False)[0]
        return sum(jnp.sum(o[n].data * ws[n]) for n in names)

    jxs = {k: jbatch[k].data for k in input_grads}
    jgrad = jax.grad(jloss, argnums=(0, 1))
    jgp, jgx = (jax.jit(jgrad) if jit else jgrad)(jparams.params, jxs)
    leaves = map_leaves(lambda v: v.clone().requires_grad_(True), carried.params)
    for k in input_grads:
        tb[k].data.requires_grad_(True)
    touts = tnet.apply(leaves, tb, state=carried.state, train=False)[0]
    loss = sum((touts[n].data * torch.from_numpy(ws[n])).sum() for n in names)
    loss.backward()
    tg = {"params": map_leaves(lambda v: torch.zeros_like(v) if v.grad is None else v.grad,
                               leaves)}
    jg = {"params": numpy_tree(jgp)}
    for k in input_grads:
        tg[k] = tb[k].data.grad
        jg[k] = np.asarray(jgx[k])
    return jo, {n: np_seq(touts[n]) for n in names}, jg, tg


def assert_outputs_close(jo, to, atol=1e-5, rtol=1e-5):
    """Port outputs against the JAX package's: data within atol + rtol,
    lengths and sub-lengths equal."""
    for n in jo:
        np.testing.assert_allclose(to[n].data, jo[n].data, atol=atol, rtol=rtol, err_msg=n)
        for f in ("lengths", "sub_lengths"):
            a, b = getattr(to[n], f), getattr(jo[n], f)
            assert (a is None) == (b is None), (n, f)
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{n} {f}")


def assert_grads_close(jg, tg, rtol=1e-5, atol=1e-6):
    """Each gradient leaf within `rtol` and `atol` times its largest |g| (a
    gradient sums many terms: an element that cancels to near 0 keeps the
    rounding of its terms, which scale with the leaf)."""
    jl, tl = flat_leaves(numpy_tree(jg)), flat_leaves(numpy_tree(tg))
    assert set(tl) == set(jl)
    for k in jl:
        scale = max(float(np.abs(jl[k]).max()), 1.0)
        np.testing.assert_allclose(tl[k], jl[k], rtol=rtol, atol=atol * scale, err_msg=k)


def jax_params_from_port_init(jout, tout, seed):
    """JAX Parameters of `jout`'s network holding the port's initial values
    for `tout` (the JAX package's own init compiles one random draw per
    shape, about a second each on the CPU)."""
    params, state = TNet(TTopo([tout])).init(seed=seed, device="cpu")
    as_jax = lambda tree: {l: {k: jnp.asarray(v.numpy()) for k, v in p.items()}  # noqa: E731
                           for l, p in tree.items()}
    return paddle_tpu.parameters.Parameters(JNet(JTopo([jout])), as_jax(params), as_jax(state))


def assert_params_carry(jout, tout, seed=2):
    """The port's own parameters and layer state of `tout`'s network have
    the names and shapes of the JAX package's for `jout`'s, and the mover
    carries the JAX ones bit for bit."""
    assert TNet(TTopo([tout])).named_parameters() == JNet(JTopo([jout])).named_parameters()
    jparams = paddle_tpu.parameters.create(jout, seed=seed)
    tparams, tstate = TNet(TTopo([tout])).init(seed=seed, device="cpu")

    def shapes(tree):
        return {k: v.shape for k, v in flat_leaves(numpy_tree(tree)).items()}

    assert shapes(tparams) == shapes(jparams.params)
    assert shapes(tstate) == shapes(jparams.state)
    got = flat_leaves(numpy_tree(carry(jparams).params))
    for k, v in flat_leaves(numpy_tree(jparams.params)).items():
        assert np.array_equal(got[k], v), k


def demo_mlp(pkg, hidden=(128, 64), classes=10, pixels=784):
    """The network of tests/configs/demo_mnist_mlp.py through a package's
    v2 DSL: pixel -> fc relu -> fc relu -> fc softmax, classification
    cost.  Returns (cost, prediction)."""
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    img = L.data(name="pixel", type=dt.dense_vector(pixels))
    h = img
    for size in hidden:
        h = L.fc(input=h, size=size, act=A.Relu())
    predict = L.fc(input=h, size=classes, act=A.Softmax())
    label = L.data(name="label", type=dt.integer_value(classes))
    return L.classification_cost(input=predict, label=label), predict


def mlp_samples(n, seed, classes=10, pixels=784):
    """n (pixels, label) samples from N(0, 1), each labelled by the argmax of
    a fixed random projection (learnable, so a trajectory's cost falls)."""
    proj = np.random.RandomState(1234).randn(pixels, classes)
    x = np.random.RandomState(seed).randn(n, pixels).astype(np.float32)
    labels = np.argmax(x @ proj, axis=1)
    return [(x[i], int(labels[i])) for i in range(n)]


def mlp_batch(samples):
    """A demo-MLP batch as {slot: (data, None)} arrays."""
    return {"pixel": (np.stack([s[0] for s in samples]), None),
            "label": (np.asarray([s[1] for s in samples], np.int32), None)}


def train_both(jcost, tcost, jparams, make_optimizer, samples, batch_size, feeding,
               num_passes=1, **train_kw):
    """SGD.train in both packages from the same parameters and batches;
    returns (JAX costs, port costs, JAX trainer, port trainer)."""
    reader = lambda: iter(samples)  # noqa: E731
    out = []
    for pkg, cost, params, kw in (
            (paddle_tpu, jcost, jparams, {}),
            (paddle_tpu_torch, tcost, carry(jparams), {"device": "cpu"})):
        costs = []
        trainer = pkg.trainer.SGD(cost=cost, parameters=params,
                                  update_equation=make_optimizer(pkg), **kw)
        trainer.train(pkg.batch(reader, batch_size), num_passes=num_passes, feeding=feeding,
                      event_handler=lambda e, c=costs, p=pkg: c.append(e.cost)
                      if isinstance(e, p.event.EndIteration) else None, **train_kw)
        out.append((costs, trainer))
    return out[0][0], out[1][0], out[0][1], out[1][1]


# ---------------------------------------------------------------------------
# its own tests
# ---------------------------------------------------------------------------


def test_carried_parameters_are_bit_exact_by_name():
    (jcost, _), (tcost, _) = build_both(demo_mlp)
    jparams = paddle_tpu.parameters.create(jcost, seed=3)
    tparams = carry(jparams)
    tparams.network = TNet(TTopo([tcost]))
    assert tparams.names() == list(jparams.names())
    for name in jparams.names():
        assert np.array_equal(tparams.get(name), jparams.get(name)), name
    # and back: the port's values set into the JAX package's parameters
    rng = np.random.RandomState(0)
    for name in tparams.names():
        tparams.set(name, rng.randn(*tparams.get(name).shape).astype(np.float32))
        jparams.set(name, tparams.get(name))
        assert np.array_equal(np.asarray(jparams.get(name)), tparams.get(name)), name


def _dropout_net(pkg):
    L, A, dt, attr = pkg.layer, pkg.activation, pkg.data_type, pkg.attr
    x = L.data(name="x", type=dt.dense_vector(12))
    h = L.fc(input=x, size=16, act=A.Tanh(),
             layer_attr=attr.ExtraAttr(drop_rate=0.3, error_clipping_threshold=0.01))
    h = L.dropout(h, dropout_rate=0.5)
    return L.fc(input=h, size=5, act=A.Softmax(), name="out")


def test_eval_mode_ignores_dropout_and_error_clip():
    jout, tout = build_both(_dropout_net)
    jparams = paddle_tpu.parameters.create(jout, seed=1)
    jb, tb = batch_both({"x": (np.random.RandomState(2).randn(6, 12).astype(np.float32), None)})
    jnet = JNet(JTopo([jout]), compute_dtype=jnp.float32)
    tnet = TNet(TTopo([tout]), compute_dtype=torch.float32)
    assert TTopo([tout]).serialize() == JTopo([jout]).serialize()
    want = np.asarray(jnet.apply(jparams.params, jb, train=False,
                                 rng=jax.random.PRNGKey(0))[0]["out"].data)
    for rng in (None, 7):
        got = tnet.apply(carry(jparams).params, tb, train=False, rng=rng)[0]["out"].data
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_demo_mlp_gradients_match_jax():
    (jcost, _), (tcost, _) = build_both(demo_mlp)
    jparams = paddle_tpu.parameters.create(jcost, seed=4)
    jc, tc, jg, tg = grads_both(jcost, tcost, jparams, mlp_batch(mlp_samples(16, 5)))
    err = rel_l2(tg, jg)
    print(f"demo MLP: cost {tc} vs {jc}; gradients relative L2 {err:.3e} (bar 1e-5)")
    assert abs(tc - jc) <= 1e-5 * abs(jc)
    assert err <= 1e-5
