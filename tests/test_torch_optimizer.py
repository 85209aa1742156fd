"""The port's optimizers (paddle_tpu_torch/optimizer) against the JAX package's
(paddle_tpu/optimizer).

- Three updates of the same numpy trees: all eight rules (Momentum plain and
  Nesterov, SparseMomentum, AdaGrad, AdaDelta, RMSProp, DecayedAdaGrad, Adam,
  AdaMax), each with a constant schedule, with L2 plus elementwise clipping,
  and with a poly schedule.  f32 on both sides, the same arithmetic in place
  of new arrays: parameters and slots (of the same names) agree at atol
  1e-6.
- 20 steps of trainer.SGD on the demo MLP (tests/configs/demo_mnist_mlp.py
  through each package's v2 DSL) from the same parameters and batches, one
  case per rule: every step's cost within 1e-5 relative of the JAX
  package's, and the parameters within 1e-4 relative L2 at the end (f32;
  the GEMMs sum in another order, which the 20 updates carry)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import optimizer as topt
from test_torch_parity import (
    MLP_FEEDING, build_both, demo_mlp, mlp_samples, numpy_tree, rel_l2, train_both)

ATOL = 1e-6
SHAPES = {"fc": {"w0": (4, 3), "b": (3,)}, "emb": {"w": (5, 2)}}

OPTIMIZERS = {
    "momentum": ("Momentum", dict(momentum=0.9)),
    "nesterov": ("Momentum", dict(momentum=0.9, nesterov=True)),
    "adam": ("Adam", dict()),
    "sparse_momentum": ("SparseMomentum", dict()),
    "adagrad": ("AdaGrad", dict()),
    "adadelta": ("AdaDelta", dict()),
    "rmsprop": ("RMSProp", dict()),
    "decayed_adagrad": ("DecayedAdaGrad", dict()),
    "adamax": ("AdaMax", dict()),
}
SETTINGS = {
    "constant": lambda pkg: dict(learning_rate=0.05),
    "l2_clip": lambda pkg: dict(
        learning_rate=0.05, regularization=pkg.L2Regularization(rate=0.01),
        gradient_clipping_threshold=0.5,
    ),
    "poly": lambda pkg: dict(
        learning_rate=0.05, learning_rate_schedule="poly",
        learning_rate_decay_a=0.5, learning_rate_decay_b=0.75,
    ),
}


def _tree(rng, scale=1.0):
    return {
        layer: {k: (scale * rng.randn(*s)).astype(np.float32) for k, s in p.items()}
        for layer, p in SHAPES.items()
    }


def _make(pkg, opt, setting):
    cls, kw = OPTIMIZERS[opt]
    return getattr(pkg, cls)(**kw, **SETTINGS[setting](pkg))


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_updates_match_jax(opt, setting):
    rng = np.random.RandomState(0)
    start = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jo, to = _make(jopt, opt, setting), _make(topt, opt, setting)
    jp = {l: {k: jnp.asarray(v) for k, v in p.items()} for l, p in start.items()}
    tp = {l: {k: torch.tensor(v) for k, v in p.items()} for l, p in start.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update({l: {k: jnp.asarray(v) for k, v in p.items()} for l, p in g.items()}, js, jp)
        tp_out, ts = to.update({l: {k: torch.tensor(v) for k, v in p.items()} for l, p in g.items()}, ts, tp)
        assert tp_out is tp  # updated in place
        for layer, p in tp.items():
            for key, v in p.items():
                np.testing.assert_allclose(
                    v.numpy(), np.asarray(jp[layer][key]), atol=ATOL, err_msg=f"{layer}.{key}"
                )
                for slot in to.slot_names():
                    np.testing.assert_allclose(
                        ts[slot][layer][key].numpy(), np.asarray(js[slot][layer][key]),
                        atol=ATOL, err_msg=f"{slot} of {layer}.{key}",
                    )
    assert ts["step"] == int(js["step"]) == 3


def test_schedules_match_jax():
    for name, a, b, args in [
        ("poly", 0.5, 0.75, ""), ("exp", 0.5, 4.0, ""), ("discexp", 0.5, 4.0, ""),
        ("linear", 0.1, 0.2, ""), ("manual", 0, 0, "2:1.0,5:0.5,9:0.1"),
        ("caffe_poly", 0, 2.0, ""),
    ]:
        js = jopt.make_schedule(name, a, b, 10.0, args)
        ts = topt.make_schedule(name, a, b, 10.0, args)
        for step in range(12):
            np.testing.assert_allclose(
                ts(float(step)), float(js(jnp.float32(step))), rtol=1e-6, err_msg=f"{name}@{step}"
            )
    assert topt.schedule_counter_unit("pass_manual") == "pass"
    with pytest.raises(ValueError):
        topt.parse_lr_args("3")


# the demo MLP's 20-step trajectories: each rule at a rate that moves the
# cost over 20 steps of 16 samples without diverging
TRAJECTORY = {
    "Momentum": dict(learning_rate=0.05, momentum=0.9),
    "SparseMomentum": dict(learning_rate=0.05),
    "AdaGrad": dict(learning_rate=0.01),
    "AdaDelta": dict(learning_rate=1.0),
    "RMSProp": dict(learning_rate=1e-3),
    "DecayedAdaGrad": dict(learning_rate=1e-3),
    "Adam": dict(learning_rate=3e-3),
    "AdaMax": dict(learning_rate=5e-3),
}
TRAJ_STEPS, TRAJ_B = 20, 16
TRAJ_COST_RTOL, TRAJ_PARAM_REL = 1e-5, 1e-4


@pytest.mark.parametrize("rule", sorted(TRAJECTORY))
def test_demo_mlp_trajectory_matches_jax(rule):
    (jcost, _), (tcost, _) = build_both(demo_mlp)
    import paddle_tpu

    jparams = paddle_tpu.parameters.create(jcost, seed=2)
    want, got, jtrainer, ttrainer = train_both(
        jcost, tcost, jparams,
        lambda pkg: getattr(pkg.optimizer, rule)(**TRAJECTORY[rule]),
        mlp_samples(TRAJ_STEPS * TRAJ_B, seed=3), TRAJ_B, MLP_FEEDING)
    assert len(got) == len(want) == TRAJ_STEPS
    worst = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    drift = rel_l2(ttrainer.parameters.params, numpy_tree(jtrainer.parameters.params))
    print(f"{rule}: costs {want[0]:.4f} -> {want[-1]:.4f}; worst relative cost difference "
          f"{worst:.3e} (bar {TRAJ_COST_RTOL}); final parameters relative L2 {drift:.3e} "
          f"(bar {TRAJ_PARAM_REL})")
    assert np.mean(want[-5:]) < np.mean(want[:5])  # the rule learns
    assert worst <= TRAJ_COST_RTOL
    assert drift <= TRAJ_PARAM_REL
    assert ttrainer._opt_state["step"] == int(jtrainer._opt_state["step"]) == TRAJ_STEPS
