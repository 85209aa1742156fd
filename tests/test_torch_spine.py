"""The training spine of the port against the JAX package on the CPU (f32):

- dropout, by statistics and never by random stream: the kept share lies
  within 5 sigma of 1 - rate in both packages, kept values equal the
  undropped ones divided by the keep probability exactly (bf16 too, with
  the mask drawn after the activation and the cast), the same seed gives
  the same mask and the next seed another, and ``train=False`` or no seed
  leaves the output untouched;
- error clipping: the gradients equal the JAX package's (relative L2 1e-5)
  and differ from the unclipped ones;
- name-shared parameters (whole-layer, per-key, and an intra-layer
  duplicate): the same params tree, the same ``named_parameters()`` and
  the same gradients (relative L2 1e-5);
- the divergence sentinel: a NaN batch is a skipped step with parameters,
  layer state and optimizer state bit-identical, in both packages, with
  the same ``health`` and, over a multi-step call, the same
  ``skipped_steps``; ``SGD.train`` reports the step's NaN cost and leaves it
  out of the pass mean in both;
- ``make_multi_train_step`` equals K single steps bit for bit;
- ``trainer.test`` inside an ``EndPass`` handler on a small ResNet-18 sees
  the moved batch-norm state and matches the JAX package's (relative 1e-5,
  f32, the same steps' batch statistics in another summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core.compiler import CompiledNetwork as JNet
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu.trainer import step as jstep
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.trainer import step as tstep
from test_torch_parity import (
    assert_trees_equal, batch_both, build_both, carry, demo_mlp, grads_both, mlp_batch,
    mlp_samples, numpy_tree, rel_l2, train_both)

GRAD_REL = 1e-5

# -- dropout -----------------------------------------------------------------

DROP_B, DROP_IN, DROP_W, RATE = 64, 32, 512, 0.2


def _drop_net(pkg):
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector(DROP_IN))
    return L.fc(input=x, size=DROP_W, act=A.Sigmoid(), name="h",
                layer_attr=pkg.attr.ExtraAttr(drop_rate=RATE))


def _kept_share_ok(mask, what):
    n, keep = mask.size, 1.0 - RATE
    share = float(mask.mean())
    sigma = (keep * RATE / n) ** 0.5
    print(f"{what}: kept share {share:.5f}, 1 - rate {keep}, |d| = "
          f"{abs(share - keep) / sigma:.2f} sigma (bar 5)")
    assert abs(share - keep) <= 5 * sigma


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_statistics_and_scaling(dtype):
    jout, tout = build_both(_drop_net)
    jparams = paddle_tpu.parameters.create(jout, seed=1)
    x = np.random.RandomState(0).randn(DROP_B, DROP_IN).astype(np.float32)
    jb, tb = batch_both({"x": (x, None)})
    tdt = getattr(torch, dtype)
    tnet = TNet(TTopo([tout]), compute_dtype=tdt)
    params = carry(jparams).params
    keep = 1.0 - RATE

    def port(train, rng):
        return tnet.apply(params, tb, train=train, rng=rng)[0]["h"].data

    plain = port(False, None)
    assert plain.dtype == tdt
    assert torch.equal(port(True, None), plain)  # no seed: no dropout
    a, a2, b = port(True, 11), port(True, 11), port(True, 12)
    mask = a != 0
    assert torch.equal(a, a2) and not torch.equal(mask, b != 0)
    assert (plain != 0).all()  # sigmoid: a zero is a dropped value
    _kept_share_ok(mask.numpy(), f"port {dtype}")
    # kept values are the undropped ones divided by keep, in the output's dtype
    assert torch.equal(a[mask], (plain / keep)[mask])
    assert torch.equal(port(False, 11), plain)

    jnet = JNet(JTopo([jout]), compute_dtype=getattr(jnp, dtype))
    jplain = np.asarray(jnet.apply(jparams.params, jb, train=False)[0]["h"].data, np.float32)
    ja = np.asarray(jnet.apply(jparams.params, jb, train=True,
                               rng=jax.random.PRNGKey(3))[0]["h"].data, np.float32)
    _kept_share_ok(ja != 0, f"JAX {dtype}")
    np.testing.assert_allclose(plain.float().numpy(), jplain,
                               atol=1e-5 if dtype == "float32" else 1e-2)


def test_dropout_runs_in_training_with_fresh_masks():
    """SGD draws a new seed per step: two steps on one batch drop different
    units, and the DSL's dropout layer serializes like the JAX package's."""
    def net(pkg):
        L, A, dt = pkg.layer, pkg.activation, pkg.data_type
        x = L.data(name="pixel", type=dt.dense_vector(20))
        h = L.dropout(L.fc(input=x, size=32, act=A.Relu()), dropout_rate=0.5)
        pred = L.fc(input=h, size=4, act=A.Softmax())
        lab = L.data(name="label", type=dt.integer_value(4))
        return L.classification_cost(input=pred, label=lab), pred

    (jcost, _), (tcost, _) = build_both(net)
    assert TTopo([tcost]).serialize() == JTopo([jcost]).serialize()
    params = paddle_tpu_torch.parameters.create(tcost, seed=0, device="cpu")
    trainer = paddle_tpu_torch.trainer.SGD(
        tcost, params, paddle_tpu_torch.optimizer.Momentum(learning_rate=0.0), device="cpu")
    samples = mlp_samples(8, 1, classes=4, pixels=20)
    costs = []
    trainer.train(paddle_tpu_torch.batch(lambda: iter(samples * 2), 8),
                  feeding={"pixel": 0, "label": 1},
                  event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, paddle_tpu_torch.event.EndIteration) else None)
    assert len(costs) == 2 and costs[0] != costs[1]  # lr 0: only the masks differ


# -- error clipping ------------------------------------------------------------


def _clip_net(pkg, threshold):
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector(8))
    attr = pkg.attr.ExtraAttr(error_clipping_threshold=threshold) if threshold else None
    h = L.fc(input=x, size=16, act=A.Tanh(), layer_attr=attr)
    pred = L.fc(input=h, size=4, act=A.Softmax())
    lab = L.data(name="label", type=dt.integer_value(4))
    return L.classification_cost(input=pred, label=lab)


def test_error_clip_gradients_match_jax():
    rng = np.random.RandomState(0)
    arrays = {"x": (rng.randn(16, 8).astype(np.float32), None),
              "label": (rng.randint(0, 4, size=16).astype(np.int32), None)}
    grads = {}
    for t in (0.0, 2e-3):
        jcost, tcost = build_both(lambda pkg: _clip_net(pkg, t))
        jparams = paddle_tpu.parameters.create(jcost, seed=2)
        _, _, jg, tg = grads_both(jcost, tcost, jparams, arrays)
        err = rel_l2(tg, jg)
        print(f"error clip {t}: gradients relative L2 {err:.3e} (bar {GRAD_REL})")
        assert err <= GRAD_REL
        grads[t] = tg
    assert rel_l2(grads[2e-3], grads[0.0]) > 1e-2  # the clip binds


# -- name-shared parameters ------------------------------------------------------


def _shared_net(pkg, kind):
    L, A, dt, PA = pkg.layer, pkg.activation, pkg.data_type, pkg.attr.ParamAttr
    lab = L.data(name="label", type=dt.integer_value(4))
    if kind == "whole_layer":
        a = L.data(name="a", type=dt.integer_value(10))
        b = L.data(name="b", type=dt.integer_value(10))
        ea = L.embedding(input=a, size=8, param_attr=PA(name="table"))
        eb = L.embedding(input=b, size=8, param_attr=PA(name="table"))
        h = L.addto(input=[ea, eb], act=A.Tanh())
    elif kind == "per_key":
        x = L.data(name="a", type=dt.dense_vector(8))
        h = L.fc(input=x, size=8, act=A.Tanh(), param_attr=PA(name="w_shared"))
        h = L.fc(input=h, size=8, act=A.Tanh(), param_attr=PA(name="w_shared"),
                 bias_attr=PA(name="b_shared"))
        h = L.fc(input=h, size=8, act=A.Tanh(), bias_attr=PA(name="b_shared"))
    else:  # intra_layer: fc(param_attr=[p, p]) over two inputs
        x = L.data(name="a", type=dt.dense_vector(8))
        y = L.data(name="b", type=dt.dense_vector(8))
        h = L.fc(input=[x, y], size=8, act=A.Tanh(), param_attr=[PA(name="p"), PA(name="p")])
    pred = L.fc(input=h, size=4, act=A.Softmax())
    return L.classification_cost(input=pred, label=lab)


@pytest.mark.parametrize("kind", ["whole_layer", "per_key", "intra_layer"])
def test_shared_parameters_match_jax(kind):
    jcost, tcost = build_both(lambda pkg: _shared_net(pkg, kind))
    jnet, tnet = JNet(JTopo([jcost])), TNet(TTopo([tcost]))
    assert tnet.named_parameters() == jnet.named_parameters()
    assert tnet.named_parameters()  # the topology does share
    jparams = paddle_tpu.parameters.create(jcost, seed=3)
    tparams = paddle_tpu_torch.parameters.create(tcost, seed=3, device="cpu")
    assert {(k, kk, tuple(v.shape)) for k, p in tparams.params.items() for kk, v in p.items()} \
        == {(k, kk, tuple(v.shape)) for k, p in jparams.params.items() for kk, v in p.items()}
    rng = np.random.RandomState(4)
    if kind == "whole_layer":
        arrays = {"a": (rng.randint(0, 10, size=12).astype(np.int32), None),
                  "b": (rng.randint(0, 10, size=12).astype(np.int32), None)}
    else:
        arrays = {"a": (rng.randn(12, 8).astype(np.float32), None),
                  "b": (rng.randn(12, 8).astype(np.float32), None)}
        if kind == "per_key":
            del arrays["b"]
    arrays["label"] = (rng.randint(0, 4, size=12).astype(np.int32), None)
    _, _, jg, tg = grads_both(jcost, tcost, jparams, arrays)
    err = rel_l2(tg, jg)
    print(f"shared {kind}: gradients relative L2 {err:.3e} (bar {GRAD_REL})")
    assert err <= GRAD_REL
    # the global names resolve to the same values in both
    tcarried = carry(jparams)
    tcarried.network = tnet
    for gname in jnet.named_parameters():
        assert np.array_equal(tcarried.get(gname), np.asarray(jparams.get(gname))), gname


# -- the divergence sentinel ------------------------------------------------------


def _small_mlp(pkg):
    return demo_mlp(pkg, hidden=(16,), classes=4, pixels=20)


def _mlp_arrays(seed, nan=False):
    arrays = mlp_batch(mlp_samples(8, seed, classes=4, pixels=20))
    if nan:
        arrays["pixel"][0][3, 5] = np.nan
    return arrays


def _nets_and_params():
    (jcost, _), (tcost, _) = build_both(_small_mlp)
    jnet, tnet = JNet(JTopo([jcost])), TNet(TTopo([tcost]))
    jparams = paddle_tpu.parameters.create(jcost, seed=5)
    return jnet, tnet, jparams


def _opts():
    return (paddle_tpu.optimizer.Momentum(learning_rate=0.1, momentum=0.9),
            paddle_tpu_torch.optimizer.Momentum(learning_rate=0.1, momentum=0.9))


def test_nan_batch_is_a_skipped_step_in_both_packages():
    jnet, tnet, jparams = _nets_and_params()
    jopt, topt = _opts()
    jfn = jstep.make_train_step(jnet, jopt)
    tfn = tstep.make_train_step(tnet, topt)
    jp, js, jo = jparams.params, {}, jopt.init(jparams.params)
    tp = carry(jparams).params
    ts, to = {}, topt.init(tp)
    for seed, nan in ((0, False), (1, True), (2, False)):
        jb, tb = batch_both(_mlp_arrays(seed, nan))
        before = numpy_tree(tp), numpy_tree(to["m"]), to["step"]
        jbefore = numpy_tree(jp)
        jp, js, jo, jm = jfn(jp, js, jo, jb, jax.random.PRNGKey(seed))
        tp, ts, to, tm = tfn(tp, ts, to, tb, seed)
        assert float(tm["health"]) == float(jm["health"]) == (0.0 if nan else 1.0)
        if nan:
            assert_trees_equal(tp, before[0])
            assert_trees_equal(to["m"], before[1])
            assert to["step"] == before[2] == int(jo["step"]) == 1
            assert_trees_equal(numpy_tree(jp), jbefore)
            assert not np.isfinite(float(tm["cost"])) and not np.isfinite(float(tm["grad_norm"]))
        else:
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        assert rel_l2(tp, numpy_tree(jp)) <= GRAD_REL
    assert to["step"] == int(jo["step"]) == 2


def test_multi_step_folds_health_and_skips_like_jax():
    jnet, tnet, jparams = _nets_and_params()
    jopt, topt = _opts()
    arrays = [_mlp_arrays(s, nan=(s == 1)) for s in range(3)]
    stacked = {k: (np.stack([a[k][0] for a in arrays]), None) for k in arrays[0]}
    jb, tb = batch_both(stacked)
    jfn = jstep.make_multi_train_step(jnet, jopt, 3)
    tfn = tstep.make_multi_train_step(tnet, topt, 3)
    tp = carry(jparams).params  # before the JAX step donates the arrays
    jp, _, jo, jm = jfn(jparams.params, {}, jopt.init(jparams.params), jb, jax.random.PRNGKey(0))
    tp, _, to, tm = tfn(tp, {}, topt.init(tp), tb, 0)
    assert float(tm["health"]) == float(jm["health"]) == 0.0
    assert float(tm["skipped_steps"]) == float(jm["skipped_steps"]) == 1.0
    assert to["step"] == int(jo["step"]) == 2
    assert rel_l2(tp, numpy_tree(jp)) <= GRAD_REL


def test_multi_train_step_equals_single_steps():
    """Dropout on, so the per-step seeds matter too."""
    def net(pkg):
        L, A, dt = pkg.layer, pkg.activation, pkg.data_type
        x = L.data(name="pixel", type=dt.dense_vector(20))
        h = L.fc(input=x, size=16, act=A.Relu(), layer_attr=pkg.attr.ExtraAttr(drop_rate=0.3))
        pred = L.fc(input=h, size=4, act=A.Softmax())
        lab = L.data(name="label", type=dt.integer_value(4))
        return L.classification_cost(input=pred, label=lab)

    _, tcost = build_both(net)
    tnet = TNet(TTopo([tcost]))
    arrays = [_mlp_arrays(s) for s in range(3)]
    stacked = {k: (np.stack([a[k][0] for a in arrays]), None) for k in arrays[0]}
    opt = paddle_tpu_torch.optimizer.Adam(learning_rate=0.01)
    p0 = tnet.init_params(1, device="cpu")
    clone = lambda t: {k: {kk: v.clone() for kk, v in p.items()} for k, p in t.items()}  # noqa: E731
    multi = tstep.make_multi_train_step(tnet, opt, 3)
    mp, _, mo, mm = multi(clone(p0), {}, opt.init(p0), batch_both(stacked)[1], 42)
    single = tstep.make_train_step(tnet, opt)
    sp, so = clone(p0), opt.init(p0)
    gen = torch.Generator().manual_seed(42)
    for a in arrays:
        sp, _, so, sm = single(sp, {}, so, batch_both(a)[1], tstep.draw_seed(gen))
    assert_trees_equal(mp, numpy_tree(sp))
    assert_trees_equal(mo["m"], numpy_tree(so["m"]))
    assert float(mm["cost"]) == float(sm["cost"])
    assert float(mm["health"]) == 1.0 and float(mm["skipped_steps"]) == 0.0


def test_sgd_reports_a_skipped_nan_step_like_jax():
    (jcost, _), (tcost, _) = build_both(_small_mlp)
    jparams = paddle_tpu.parameters.create(jcost, seed=6)
    samples = mlp_samples(24, 2, classes=4, pixels=20)
    samples[11] = (np.full(20, np.nan, np.float32), samples[11][1])

    def make(pkg):
        return pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9)

    want, got, jtr, ttr = train_both(jcost, tcost, jparams, make, samples, 8,
                                     {"pixel": 0, "label": 1})
    assert np.isnan(got[1]) and np.isnan(want[1])
    np.testing.assert_allclose([got[0], got[2]], [want[0], want[2]], rtol=1e-5)
    assert rel_l2(ttr.parameters.params, numpy_tree(jtr.parameters.params)) <= GRAD_REL
    assert ttr._opt_state["step"] == int(jtr._opt_state["step"]) == 2


# -- the repair: EndPass sees the trained layer state -----------------------------

RN_B, RN_IMG, RN_CLASSES = 4, 16, 4
# The state is what the repair concerns, so the weights stay put: with a
# rate, the JAX package's jitted f32 gradient of ResNet-18 (4.1e-3 from f64,
# tests/test_torch_resnet.py) moves the weights apart, and a test forward
# through 20 batch norms on two steps' moving statistics amplifies that
# to 3% in the first pass's test cost.
RN_LR = 0.0


def test_test_inside_end_pass_sees_the_trained_state():
    def net(pkg):
        from importlib import import_module

        resnet = import_module(f"{pkg.__name__}.models.resnet")
        return resnet.resnet_cost(depth=18, class_num=RN_CLASSES, img_size=RN_IMG)

    (jcost, _), (tcost, _) = build_both(net)
    jparams = paddle_tpu.parameters.create(jcost, seed=7)
    rng = np.random.RandomState(8)
    samples = [(rng.randn(3 * RN_IMG * RN_IMG).astype(np.float32), int(rng.randint(RN_CLASSES)))
               for _ in range(3 * RN_B)]
    train, held = samples[: 2 * RN_B], samples[2 * RN_B:]
    feeding = {"image": 0, "label": 1}
    first_bn = next(n for n, c in JTopo([jcost]).layers.items() if c.type == "batch_norm")
    seen = {}
    for pkg, params, kw in ((paddle_tpu, jparams, {}),
                            (paddle_tpu_torch, carry(jparams), {"device": "cpu"})):
        trainer = pkg.trainer.SGD(
            cost=jcost if pkg is paddle_tpu else tcost, parameters=params,
            update_equation=pkg.optimizer.Momentum(learning_rate=RN_LR, momentum=0.9), **kw)
        log = []

        def on_event(e, pkg=pkg, trainer=trainer, log=log):
            if isinstance(e, pkg.event.EndPass):
                mean = numpy_tree(trainer.parameters.state)[first_bn]["mean"]
                test = trainer.test(pkg.batch(lambda: iter(held), RN_B), feeding=feeding)
                log.append((float(np.abs(mean).sum()), test.cost))

        trainer.train(pkg.batch(lambda: iter(train), RN_B), num_passes=2, feeding=feeding,
                      event_handler=on_event)
        after = float(np.abs(numpy_tree(trainer.parameters.state)[first_bn]["mean"]).sum())
        seen[pkg.__name__] = (log, after)
    (jlog, jafter), (tlog, tafter) = seen["paddle_tpu"], seen["paddle_tpu_torch"]
    print(f"EndPass (sum|moving mean| of {first_bn}, test cost): port {tlog}, JAX {jlog}; "
          f"after train: port {tafter}, JAX {jafter}")
    assert all(m > 0 for m, _ in tlog) and tlog[-1][0] == tafter
    np.testing.assert_allclose([m for m, _ in tlog], [m for m, _ in jlog], rtol=1e-5)
    np.testing.assert_allclose([c for _, c in tlog], [c for _, c in jlog], rtol=1e-5)
