"""The port's optimizers (paddle_tpu_torch/optimizer) against the JAX package's
(paddle_tpu/optimizer) over three updates of the same numpy trees: Momentum
(plain and Nesterov) and Adam, each with a constant schedule, with L2 plus
elementwise clipping, and with a poly schedule.  f32 on both sides, the same
arithmetic in place of new arrays: parameters and slots agree at atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import optimizer as topt

ATOL = 1e-6
SHAPES = {"fc": {"w0": (4, 3), "b": (3,)}, "emb": {"w": (5, 2)}}

OPTIMIZERS = {
    "momentum": ("Momentum", dict(momentum=0.9)),
    "nesterov": ("Momentum", dict(momentum=0.9, nesterov=True)),
    "adam": ("Adam", dict()),
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
