"""LeNet and the ResNet family through the port against the JAX package on the
CPU, from the same parameters and batch-norm state (carried over with
``parameters.from_numpy``) and the same numpy batches.

- LeNet at 28x28 (MNIST, 10 classes) and ResNet-18 at the flagship's shape
  (``__graft_entry__.py``: 32x32, 16 classes), B = 4: the forward outputs,
  the gradient of every leaf, the new batch-norm state, and three
  ``trainer.SGD`` Momentum(0.01, 0.9) steps (costs, final state, and the
  test cost with global statistics).  At bench.py's rate 0.1 this batch of
  4 drives ResNet-18's cost from 3.3 to 18 in three steps, a divergence that
  amplifies rounding in either package past any useful bar.
  f32: the same arithmetic in another summation order, so outputs, costs
  and states within 1e-4 relative and the gradients within 1e-4 relative
  L2 over all leaves.  The reference gradient is JAX's op by op: its jitted
  gradient of ResNet-18 here is 4.1e-3 (relative L2) away from an f64
  evaluation of the same function, the op-by-op one and the port's 5e-6.
  bf16 compute: both packages round every layer's output to bf16 (2^-9
  relative), so 2e-2 on the probabilities and states, and 5e-2 on the
  costs, which after two updates carry the gradients' spread.  The bf16
  gradients of ResNet-18 at this batch are ill-conditioned (the last
  stage's batch norm sees 16 values per channel): the JAX package's own
  jitted and op-by-op bf16 gradients differ by 0.36 relative L2, and each
  lies about 0.32 from the f32 gradient, so the bar there is 0.5; LeNet has
  no batch norm and its bar is 1e-2 (the JAX package's jitted and op-by-op
  bf16 gradients differ by 2.5e-3).  After three bf16 steps the JAX
  package's own jitted and op-by-op runs end with batch-norm states up to
  0.136 apart (relative L2 of the worst layer's mean or var) and third
  costs 1.9% apart, so the bf16 trajectory's final states are held within
  0.25.
- ResNet-50 (bottleneck blocks) forward at 32x32, 10 classes, B = 2 (f32):
  probabilities within 1e-4, and the new state of its 53 batch norms within
  1e-3 relative (summation order through three times ResNet-18's depth).
- ``Topology.serialize()`` of ``lenet_cost()`` and ``resnet_cost(depth=50)``
  is byte-identical to the JAX package's.
- ``Inference.infer`` serves with the state as global statistics, as the
  JAX package's does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core import compiler as jcompiler
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu.core.topology import reset_auto_names as j_reset
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch.core import compiler as tcompiler
from paddle_tpu_torch.core.batch import SeqTensor as TSeq
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.core.topology import reset_auto_names as t_reset
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet
from test_torch_parity import carry, numpy_tree, rel_l2

B = 4
# model: (JAX cost fn, port cost fn, kwargs, data slot, pixels, classes)
MODELS = {
    "lenet": (jlenet.lenet_cost, tlenet.lenet_cost, {}, "pixel", 28 * 28, 10),
    "resnet18": (jresnet.resnet_cost, tresnet.resnet_cost,
                 dict(depth=18, class_num=16, img_size=32), "image", 3 * 32 * 32, 16),
    "resnet50": (jresnet.resnet_cost, tresnet.resnet_cost,
                 dict(depth=50, class_num=10, img_size=32), "image", 3 * 32 * 32, 10),
}
# (output, state, cost) tolerances per compute dtype, relative
TOL = {
    "float32": dict(out=1e-4, state=1e-4, cost=1e-4),
    "bfloat16": dict(out=2e-2, state=2e-2, cost=5e-2),
}
BF16_TRAJECTORY_STATE = 0.25
# gradients: relative L2 over all leaves
GRAD_TOL = {("lenet", "float32"): 1e-4, ("resnet18", "float32"): 1e-4,
            ("lenet", "bfloat16"): 1e-2, ("resnet18", "bfloat16"): 0.5}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def compute_dtype():
    """Sets both packages' default compute dtype; restores it afterwards."""
    prev = jcompiler.get_default_compute_dtype(), tcompiler.get_default_compute_dtype()

    def set_(name):
        jcompiler.set_default_compute_dtype(DTYPES[name][0])
        tcompiler.set_default_compute_dtype(DTYPES[name][1])

    yield set_
    jcompiler.set_default_compute_dtype(prev[0])
    tcompiler.set_default_compute_dtype(prev[1])


def _both(model):
    """(JAX cost, JAX predict, port cost, port predict, JAX Parameters, the
    port's carried Parameters)."""
    jfn, tfn, kw = MODELS[model][:3]
    j_reset()
    t_reset()
    jcost, jpred = jfn(**kw)
    tcost, tpred = tfn(**kw)
    jparams = paddle_tpu.parameters.create(jcost, seed=5)
    carried = carry(jparams)
    return jcost, jpred, tcost, tpred, jparams, carried


def _samples(model, n, seed):
    _, _, _, _, pixels, classes = MODELS[model]
    rng = np.random.RandomState(seed)
    return [(rng.randn(pixels).astype(np.float32), int(rng.randint(classes)))
            for _ in range(n)]


def _batch(model, samples, seq, as_array):
    slot = MODELS[model][3]
    img = np.stack([s[0] for s in samples])
    lab = np.asarray([s[1] for s in samples], np.int32)
    return {slot: seq(as_array(img)), "label": seq(as_array(lab))}


def _assert_states_close(got, want, tol):
    assert set(got) == set(want)
    for layer in want:
        for key in ("mean", "var"):
            g = got[layer][key].float().numpy()
            w = np.asarray(want[layer][key], np.float32)
            assert rel_l2(g, w) <= tol, (layer, key, rel_l2(g, w))


@pytest.mark.parametrize("model,dtype", [
    ("lenet", "float32"), ("resnet18", "float32"),
    ("lenet", "bfloat16"), ("resnet18", "bfloat16"),
])
def test_forward_gradients_and_state_match_jax(model, dtype):
    jcost, jpred, tcost, tpred, jparams, carried = _both(model)
    jnet = jcompiler.CompiledNetwork(JTopo([jcost]), compute_dtype=DTYPES[dtype][0])
    tnet = tcompiler.CompiledNetwork(TTopo([tcost]), compute_dtype=DTYPES[dtype][1])
    samples = _samples(model, B, seed=0)
    jbatch = _batch(model, samples, JSeq, jnp.asarray)
    tbatch = _batch(model, samples, TSeq, torch.from_numpy)

    def jloss(p):
        c, (outs, st) = jnet.cost(p, jbatch, state=jparams.state, train=True)
        return c, (outs[jpred.name].data, st)

    grad_fn = jax.value_and_grad(jloss, has_aux=True)
    if (model, dtype) != ("resnet18", "float32"):
        # op by op only where XLA's jitted gradient strays (see above)
        grad_fn = jax.jit(grad_fn)
    (jc, (jprob, jst)), jg = grad_fn(jparams.params)
    leaves = {k: {kk: v.clone().requires_grad_(True) for kk, v in p.items()}
              for k, p in carried.params.items()}
    tc, (touts, tst) = tnet.cost(leaves, tbatch, state=carried.state, train=True)
    tc.backward()
    tol = TOL[dtype]

    prob = touts[tpred.name].data.detach().float().numpy()
    jprob = np.asarray(jprob, np.float32)
    assert prob.shape == jprob.shape == (B, MODELS[model][5])
    assert np.abs(prob - jprob).max() <= tol["out"] * max(np.abs(jprob).max(), 1.0)
    assert abs(tc.item() - float(jc)) <= tol["cost"] * abs(float(jc))
    names = [(k, kk) for k in jg for kk in jg[k]]
    assert {(k, kk) for k in leaves for kk in leaves[k]} == set(names)
    diff2 = sum(float(((leaves[k][kk].grad.double() - torch.from_numpy(
        np.asarray(jg[k][kk], np.float64))) ** 2).sum()) for k, kk in names)
    norm2 = sum(float((np.asarray(jg[k][kk], np.float64) ** 2).sum()) for k, kk in names)
    assert (diff2 / norm2) ** 0.5 <= GRAD_TOL[model, dtype], (diff2 / norm2) ** 0.5
    _assert_states_close(tst, jst, tol["state"])
    if model != "lenet":
        # every batch norm moved its statistics
        assert len(tst) == 20 and all(
            not torch.equal(tst[n]["mean"], carried.state[n]["mean"]) for n in tst)


@pytest.mark.parametrize("model,dtype", [
    ("lenet", "float32"), ("resnet18", "float32"), ("resnet18", "bfloat16"),
])
def test_sgd_trajectory_matches_jax(model, dtype, compute_dtype):
    compute_dtype(dtype)
    jcost, _, tcost, _, jparams, carried = _both(model)
    samples = _samples(model, 3 * B, seed=1)
    feeding = {MODELS[model][3]: 0, "label": 1}

    def reader():
        yield from samples

    def run(pkg, cost, params, **kw):
        costs = []
        trainer = pkg.trainer.SGD(
            cost=cost, parameters=params,
            update_equation=pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9), **kw)
        trainer.train(pkg.batch(reader, B), num_passes=1, feeding=feeding,
                      event_handler=lambda e: costs.append(e.cost)
                      if isinstance(e, pkg.event.EndIteration) else None)
        return costs, trainer.test(pkg.batch(reader, B), feeding=feeding).cost

    want, want_test = run(paddle_tpu, jcost, jparams)
    got, got_test = run(paddle_tpu_torch, tcost, carried, device="cpu")
    tol = TOL[dtype]
    assert len(got) == len(want) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol["cost"])
    np.testing.assert_allclose(got_test, want_test, rtol=tol["cost"])
    _assert_states_close(carried.state, jparams.state,
                         BF16_TRAJECTORY_STATE if dtype == "bfloat16" else tol["state"])
    assert carried.network is not None  # the trainer adopted the trees


def test_resnet50_forward_matches_jax():
    jcost, jpred, tcost, tpred, jparams, carried = _both("resnet50")
    jnet = jcompiler.CompiledNetwork(JTopo([jcost]), compute_dtype=jnp.float32)
    tnet = tcompiler.CompiledNetwork(TTopo([tcost]), compute_dtype=torch.float32)
    samples = _samples("resnet50", 2, seed=2)
    jouts, jst = jax.jit(lambda p, s, b: jnet.apply(p, b, state=s, train=True))(
        jparams.params, jparams.state, _batch("resnet50", samples, JSeq, jnp.asarray))
    touts, tst = tnet.apply(carried.params, _batch("resnet50", samples, TSeq, torch.from_numpy),
                            state=carried.state, train=True)
    assert len(tst) == 53  # 49 conv_bn + 4 projection shortcuts
    jprob = np.asarray(jouts[jpred.name].data)
    prob = touts[tpred.name].data.detach().numpy()
    assert prob.shape == (2, 10)
    assert np.abs(prob - jprob).max() <= 1e-4
    _assert_states_close(tst, jst, 1e-3)


@pytest.mark.parametrize("model", ["lenet", "resnet50"])
def test_topology_serializes_like_jax(model):
    jfn, tfn = MODELS[model][:2]
    kw = {} if model == "lenet" else {"depth": 50}
    j_reset()
    t_reset()
    assert TTopo(tfn(**kw)[0]).serialize() == JTopo(jfn(**kw)[0]).serialize()


def test_inference_uses_the_state_as_global_statistics():
    """Inference.infer on ResNet-18 with a moved state (as after training)
    agrees with the JAX package's infer from the same trees, and differs
    from the batch-statistics forward."""
    _, jpred, _, tpred, jparams, carried = _both("resnet18")
    rng = np.random.RandomState(3)
    moved = {k: {"mean": rng.randn(*v["mean"].shape).astype(np.float32) * 0.1,
                 "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
             for k, v in numpy_tree(jparams.state).items()}
    jparams.state = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in moved.items()}
    carried = paddle_tpu_torch.parameters.from_numpy(
        numpy_tree(jparams.params), moved, device="cpu")
    samples = [(s[0],) for s in _samples("resnet18", 3, seed=4)]
    want = paddle_tpu.infer(output_layer=jpred, parameters=jparams, input=samples)
    got = paddle_tpu_torch.infer(tpred, carried, samples, device="cpu")
    assert got.shape == want.shape == (3, 16)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    tnet = tcompiler.CompiledNetwork(TTopo([tpred]), compute_dtype=torch.float32)
    batch_stats, _ = tnet.apply(carried.params, {"image": TSeq(torch.from_numpy(
        np.stack([s[0] for s in samples])))})
    assert np.abs(batch_stats[tpred.name].data.numpy() - got).max() > 1e-3
