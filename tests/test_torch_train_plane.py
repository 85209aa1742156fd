"""The rest of the port's ``trainer/step.py`` and ``CompileShapeCache``
against the JAX package on the CPU, on one sequence network (embedding,
last_seq, fc) and the same batches, f32:

- ``make_bucketed_train_step`` pads every batch to the shape ladder and
  counts it: three steps on batches of padded lengths 8, 8 and 24 give the
  JAX package's costs (relative 1e-5), parameters (relative L2 1e-5) and
  cache counters (2 shapes, 1 hit, 2 misses, the same ``global_stats``
  names);
- ``make_grad_step``'s gradients and cost match (relative L2 1e-5) and
  update nothing;
- ``make_forward_fn`` returns the selected outputs' data (atol 1e-6);
- ``make_train_carry``/``split_train_carry`` carry the four folds;
- ``fetch_metrics`` moves every metric in one piece and keeps dtypes;
- the epoch program and mesh arguments still refuse a device mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu.core.compiler import CompiledNetwork as JNet
from paddle_tpu.core.compiler import CompileShapeCache as JCache
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu.trainer import step as jstep
from paddle_tpu.utils.timers import StatSet as JStatSet
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.compiler import CompileShapeCache
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.trainer import step as tstep
from paddle_tpu_torch.utils.timers import StatSet
from test_torch_parity import batch_both, build_both, carry, numpy_tree, rel_l2

V = 30


def _seq_net(pkg):
    w = pkg.layer.data("w", pkg.data_type.integer_value_sequence(V))
    pooled = pkg.layer.last_seq(pkg.layer.embedding(w, size=8))
    pred = pkg.layer.fc(pooled, size=3, act=pkg.activation.Softmax())
    y = pkg.layer.data("y", pkg.data_type.integer_value(3))
    return pkg.layer.classification_cost(input=pred, label=y), pred


def _arrays(seed, b, t):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, t + 1, size=b).astype(np.int32)
    ids = np.zeros((b, t), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(1, V, size=n)
    return {"w": (ids, lens), "y": (rng.randint(0, 3, b).astype(np.int32), None)}


@pytest.fixture(scope="module")
def nets():
    (jcost, jpred), (tcost, tpred) = build_both(_seq_net)
    jparams = paddle_tpu.parameters.create(jcost, seed=3)
    return jcost, jpred, tcost, tpred, jparams


def test_bucketed_step_and_shape_cache_match_jax(nets):
    jcost, _, tcost, _, jparams = nets
    jnet, tnet = JNet(JTopo([jcost])), TNet(TTopo([tcost]))
    jopt = paddle_tpu.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    topt = P.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    jstats, tstats = JStatSet(), StatSet()
    jfn, jc = jstep.make_bucketed_train_step(jnet, jopt, cache=JCache("bucket", stats=jstats))
    tfn, tc = tstep.make_bucketed_train_step(tnet, topt, cache=CompileShapeCache(
        "bucket", stats=tstats))
    tp = carry(jparams)
    tparams, tstate, topt_state = tp.params, tp.state, topt.init(tp.params)
    jp = jax.tree_util.tree_map(jnp.array, jparams.params)
    js, jo = jparams.state, jopt.init(jp)
    for seed, t in ((0, 8), (1, 8), (2, 24)):
        jb, tb = batch_both(_arrays(seed, 4, t))
        jp, js, jo, jm = jfn(jp, js, jo, jb, jax.random.PRNGKey(0))
        tparams, tstate, topt_state, tm = tfn(tparams, tstate, topt_state, tb, 0)
        np.testing.assert_allclose(float(tm["cost"]), float(jm["cost"]), rtol=1e-5)
    assert rel_l2(tparams, numpy_tree(jax.device_get(jp))) < 1e-5
    assert (tc.n_shapes, tc.hits, tc.misses) == (jc.n_shapes, jc.hits, jc.misses) == (2, 1, 2)
    assert tc.summary() == jc.summary()
    assert tstats.count("bucket/compile_miss") == jstats.count("bucket/compile_miss") == 2
    assert tstats.count("bucket/compile_hit") == jstats.count("bucket/compile_hit") == 1
    assert sorted(k[0][1][1] for k in tc.shapes) == [16, 32]  # ladder rungs of T


def test_grad_step_matches_jax_and_updates_nothing(nets):
    jcost, _, tcost, _, jparams = nets
    jnet, tnet = JNet(JTopo([jcost])), TNet(TTopo([tcost]))
    jb, tb = batch_both(_arrays(4, 6, 16))
    jg, jc = jstep.make_grad_step(jnet)(jparams.params, jparams.state, jb, jax.random.PRNGKey(1))
    tp = carry(jparams)
    before = numpy_tree(tp.params)
    tg, tc = tstep.make_grad_step(tnet)(tp.params, tp.state, tb, 1)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-6)
    assert rel_l2(tg, numpy_tree(jax.device_get(jg))) < 1e-5
    assert rel_l2(tp.params, before) == 0.0
    with pytest.raises(NotImplementedError, match="mesh"):
        tstep.make_grad_step(tnet, mesh=object())


def test_forward_fn_matches_jax(nets):
    jcost, jpred, tcost, tpred, jparams = nets
    jnet = JNet(JTopo([jcost]))
    tnet = TNet(TTopo([tcost]))
    jb, tb = batch_both(_arrays(5, 4, 16))
    names = [tpred.name]
    jout = jstep.make_forward_fn(jnet, names)(jparams.params, jparams.state, jb)
    tp = carry(jparams)
    tout = tstep.make_forward_fn(tnet, names)(tp.params, tp.state, tb)
    assert set(tout) == set(jout) == set(names)
    np.testing.assert_allclose(tout[tpred.name].numpy(), np.asarray(jout[jpred.name]), atol=1e-6)
    assert not tout[tpred.name].requires_grad
    # the default is the topology's outputs
    assert set(tstep.make_forward_fn(tnet)(tp.params, tp.state, tb)) == set(
        tnet.topology.output_names)


def test_train_carry_and_fetch_metrics(nets):
    _, _, tcost, _, jparams = nets
    tp = carry(jparams)
    gen = torch.Generator().manual_seed(3)
    c = tstep.make_train_carry(tp.params, tp.state, {"step": 0}, gen)
    assert {"health_min", "skipped", "cost_sum", "ok_steps"} <= set(c)
    assert float(c["health_min"]) == 1.0 and float(c["skipped"]) == 0.0
    assert c["cost_sum"].dtype == torch.float32 and c["cost_sum"].dim() == 0
    p, s, o, g = tstep.split_train_carry(c)
    assert p is tp.params and s is tp.state and o == {"step": 0} and g is gen
    m = {"cost": torch.tensor(1.5), "n": torch.tensor([3, 4], dtype=torch.int64), "x": 2.0}
    assert tstep.fetch_metrics(m) is m  # host values pass through
    with pytest.raises(NotImplementedError, match="mesh"):
        tstep.make_epoch_program(TNet(TTopo([tcost])), P.optimizer.Adam(), mesh=object())
