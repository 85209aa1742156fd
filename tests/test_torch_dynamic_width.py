"""Dynamic-width consumers (fc / matrix projections over a whole-minibatch
trans) in the port, against the JAX package's ``tests/test_dynamic_width.py``
on the CPU (f32):

- trans -> fc -> sum cost trains at batches 7, 100 and 160: the first batch
  resolves the fc weight to [batch, size] and the pass-mean cost falls;
- the full-matrix projection resolves too; a batch equal to the static width
  keeps the init weights; a weight restored at another batch size raises;
- ``SGD.test`` on a fresh trainer resolves first, and ``use_bucketing`` with
  dynamic widths raises when the feeder is made;
- a weight the JAX package resolved at batch 7, imported into the port, is
  left alone by the port's resolve, and one pass gives the JAX package's
  costs within 1e-5 relative.

The port draws its own init (torch generators), so the twin of the JAX
package's "cost falls" check compares the pass means of the first and the
last pass (the same rows) rather than the first and the last batch (other
rows).
"""

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.core.compiler import CompiledNetwork
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.utils import flags as tflags
from test_torch_parity import build_both, numpy_tree

FALL = 0.1  # the pass-mean cost must fall by more than this over 3 passes
REL = 1e-5  # JAX-resolved weight: the port's costs vs the JAX package's


def _trans_fc(pkg, width=12, size=4):
    L, A = pkg.layer, pkg.activation
    x = L.data("x", pkg.data_type.dense_vector(width))
    h = L.fc(L.trans(x), size=size, act=A.Tanh(), name="dynfc")
    return pkg.layer.sum_cost(h)


def _rows(batch, width=12, n_batches=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(width).astype(np.float32),) for _ in range(batch * n_batches)]


def _train(trainer, pkg, rows, batch, passes):
    costs, means = [], []

    def handler(e):
        if isinstance(e, pkg.event.EndIteration):
            costs.append(e.cost)
        elif isinstance(e, pkg.event.EndPass):
            means.append(e.evaluator["mean_cost"])

    trainer.train(reader=pkg.batch(lambda: iter(rows), batch, drop_last=True),
                  num_passes=passes, event_handler=handler, async_load_data=False)
    return costs, means


@pytest.mark.parametrize("batch", [7, 100, 160])
def test_trans_fc_trains_at_any_batch(batch):
    _, cost = build_both(_trans_fc)
    params = P.parameters.create(cost, device="cpu")
    assert tuple(params.params["dynfc"]["w0"].shape) == (12, 4)  # the static shape
    trainer = P.trainer.SGD(cost=cost, parameters=params,
                            update_equation=P.optimizer.Momentum(learning_rate=0.05),
                            device="cpu")
    costs, means = _train(trainer, P, _rows(batch), batch, 3)
    assert tuple(trainer.parameters.params["dynfc"]["w0"].shape) == (batch, 4)
    assert len(costs) == 12 and all(np.isfinite(costs))
    assert means[-1] < means[0] - FALL, means


def _mixed(pkg):
    L = pkg.layer
    x = L.data("x", pkg.data_type.dense_vector(10))
    return L.mixed(size=3, input=L.full_matrix_projection(L.trans(x)), name="dynmix")


def test_matrix_projection_resolves_too():
    _, m = build_both(_mixed)
    net = CompiledNetwork(Topology([m]))
    assert net.has_dynamic_widths
    params, state = net.init(0, device="cpu")
    assert tuple(params["dynmix"]["p0_w"].shape) == (10, 3)
    b = 6
    batch = {"x": SeqTensor(torch.randn(b, 10))}
    params, changed = net.resolve_dynamic_widths(params, batch)
    assert changed
    assert tuple(params["dynmix"]["p0_w"].shape) == (b, 3)
    outs, _ = net.apply(params, batch, state=state, train=False)
    assert tuple(outs["dynmix"].data.shape) == (10, 3)  # [D rows, size]


def _static(pkg):
    L, A = pkg.layer, pkg.activation
    x = L.data("x", pkg.data_type.dense_vector(8))
    return L.fc(L.trans(x), size=2, act=A.Identity(), name="f")


def test_static_batch_still_uses_init_weights():
    _, h = build_both(_static)
    net = CompiledNetwork(Topology([h]))
    params = net.init_params(0, device="cpu")
    p2, changed = net.resolve_dynamic_widths(params, {"x": SeqTensor(torch.zeros(8, 8))})
    assert not changed
    assert p2["f"]["w0"] is params["f"]["w0"]


def test_restored_other_batch_weights_raise_not_redraw():
    _, h = build_both(_static)
    net = CompiledNetwork(Topology([h]))
    params = net.init_params(0, device="cpu")
    params["f"]["w0"] = torch.zeros(20, 2)  # a checkpoint trained at batch 20
    with pytest.raises(ValueError, match="different batch size"):
        net.resolve_dynamic_widths(params, {"x": SeqTensor(torch.zeros(6, 8))})


def test_redraw_is_deterministic_and_seeded_per_layer():
    _, h = build_both(_static)
    net = CompiledNetwork(Topology([h]))
    batch = {"x": SeqTensor(torch.zeros(5, 8))}
    a, _ = net.resolve_dynamic_widths(net.init_params(0, device="cpu"), batch)
    b, _ = net.resolve_dynamic_widths(net.init_params(0, device="cpu"), batch)
    c, _ = net.resolve_dynamic_widths(net.init_params(0, device="cpu"), batch, seed=1)
    assert torch.equal(a["f"]["w0"], b["f"]["w0"])
    assert not torch.equal(a["f"]["w0"], c["f"]["w0"])


def test_sgd_test_on_a_fresh_trainer_resolves_first():
    _, cost = build_both(_trans_fc)
    trainer = P.trainer.SGD(cost=cost, parameters=P.parameters.create(cost, device="cpu"),
                            update_equation=P.optimizer.Momentum(learning_rate=0.05),
                            device="cpu")
    rows = _rows(7, n_batches=2)
    res = trainer.test(P.batch(lambda: iter(rows), 7, drop_last=True), async_load_data=False)
    assert np.isfinite(res.cost)
    assert tuple(trainer.parameters.params["dynfc"]["w0"].shape) == (7, 4)
    # the trainer then trains at that batch size
    costs, _ = _train(trainer, P, rows, 7, 1)
    assert len(costs) == 2 and all(np.isfinite(costs))


def test_bucketing_with_dynamic_widths_raises():
    _, cost = build_both(_trans_fc)
    trainer = P.trainer.SGD(cost=cost, parameters=P.parameters.create(cost, device="cpu"),
                            update_equation=P.optimizer.Momentum(learning_rate=0.05),
                            device="cpu")
    tflags.set_flag("use_bucketing", True)
    try:
        with pytest.raises(ValueError, match="use_bucketing is incompatible"):
            trainer.train(P.batch(lambda: iter(_rows(7)), 7, drop_last=True), num_passes=1)
    finally:
        tflags.set_flag("use_bucketing", False)


def test_jax_resolved_weight_gives_jax_costs():
    """The JAX package resolves w0 at batch 7; the port imports it, leaves
    it alone, and one pass of Momentum gives the JAX package's costs."""
    jcost, tcost = build_both(_trans_fc)
    batch, rows = 7, _rows(7)
    jparams = paddle_tpu.parameters.create(jcost)
    jtrainer = paddle_tpu.trainer.SGD(
        cost=jcost, parameters=jparams,
        update_equation=paddle_tpu.optimizer.Momentum(learning_rate=0.05))
    jb = {"x": JSeq(np.stack([r[0] for r in rows[:batch]]))}
    resolved, changed = jtrainer.network.resolve_dynamic_widths(jparams.params, jb)
    assert changed and resolved["dynfc"]["w0"].shape == (batch, 4)
    jparams.params = resolved
    jtrainer._opt_state = jtrainer.optimizer.init(resolved)
    imported = numpy_tree(resolved)  # before the JAX step donates its inputs

    tparams = P.parameters.from_numpy(imported, {}, device="cpu")
    ttrainer = P.trainer.SGD(cost=tcost, parameters=tparams,
                             update_equation=P.optimizer.Momentum(learning_rate=0.05),
                             device="cpu")
    w_before = ttrainer.parameters.params["dynfc"]["w0"]
    same, changed = ttrainer.network.resolve_dynamic_widths(
        ttrainer.parameters.params, {"x": SeqTensor(torch.zeros(batch, 12))})
    assert not changed and same["dynfc"]["w0"] is w_before

    jcosts, _ = _train(jtrainer, paddle_tpu, rows, batch, 1)
    tcosts, _ = _train(ttrainer, P, rows, batch, 1)
    assert len(tcosts) == len(jcosts) == 4
    np.testing.assert_allclose(tcosts, jcosts, rtol=REL, atol=0)
