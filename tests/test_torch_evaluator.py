"""The port's evaluators (paddle_tpu_torch/evaluator.py) against the JAX
package's over a two-batch pass, from the same parameters and batches (f32):
classification_error, sum and column_sum (over plain and sequence inputs),
auc, precision_recall (all classes and one positive label) and pnpair, as
``trainer.test`` finalizes them and as ``EndIteration`` and ``EndPass``
carry them in ``train`` (learning rate 0, so both passes see the same
predictions).  Values agree within 1e-6 relative (sums of f32 values in
another order).  The printers print and accumulate nothing."""

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from test_torch_parity import build_both, carry

B, N_BATCHES = 8, 2
REL = 1e-6
FEEDING = {"x": 0, "label": 1, "blabel": 2, "qid": 3, "xs": 4}


def _net(pkg):
    L, A, dt, E = pkg.layer, pkg.activation, pkg.data_type, pkg.evaluator
    x = L.data(name="x", type=dt.dense_vector(8))
    lab = L.data(name="label", type=dt.integer_value(3))
    blab = L.data(name="blabel", type=dt.integer_value(2))
    qid = L.data(name="qid", type=dt.integer_value(4))
    xs = L.data(name="xs", type=dt.dense_vector_sequence(4))
    pred = L.fc(input=x, size=3, act=A.Softmax(), name="pred")
    bpred = L.fc(input=x, size=2, act=A.Softmax(), name="bpred")
    score = L.fc(input=x, size=1, act=A.Identity(), name="score")
    cost = L.classification_cost(input=pred, label=lab)
    evaluators = [
        E.classification_error_evaluator(pred, lab, name="err"),
        E.sum_evaluator(pred, name="sum"),
        E.sum_evaluator(xs, name="seqsum"),
        E.column_sum_evaluator(pred, name="colsum"),
        E.column_sum_evaluator(xs, name="seqcolsum"),
        E.auc_evaluator(bpred, blab, name="auc"),
        E.precision_recall_evaluator(pred, lab, name="pr"),
        E.precision_recall_evaluator(pred, lab, positive_label=1, name="pr1"),
        E.pnpair_evaluator(score, lab, qid, name="pnpair"),
    ]
    return cost, [cost, bpred, score], evaluators


def _samples(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = int(rng.randint(1, 6))
        out.append((rng.randn(8).astype(np.float32), int(rng.randint(3)), int(rng.randint(2)),
                    int(rng.randint(4)), [rng.randn(4).astype(np.float32) for _ in range(t)]))
    return out


def _trainer(pkg, cost, params, evaluators):
    kw = {"device": "cpu"} if pkg is paddle_tpu_torch else {}
    return pkg.trainer.SGD(cost=cost, parameters=params, evaluators=evaluators,
                           update_equation=pkg.optimizer.Momentum(learning_rate=0.0), **kw)


def _assert_results_equal(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        assert abs(got[k] - want[k]) <= REL * max(abs(want[k]), 1.0), (k, got[k], want[k])


def test_evaluators_match_jax_over_a_two_batch_pass():
    (jcost, jouts, jevs), (tcost, touts, tevs) = build_both(_net)
    jparams = paddle_tpu.parameters.create(jouts, seed=4)
    samples = _samples(B * N_BATCHES, 5)
    reader = lambda: iter(samples)  # noqa: E731
    results = {}
    for pkg, cost, params, evs in ((paddle_tpu, jcost, jparams, jevs),
                                   (paddle_tpu_torch, tcost, carry(jparams), tevs)):
        trainer = _trainer(pkg, cost, params, evs)
        tested = trainer.test(pkg.batch(reader, B), feeding=FEEDING)
        events = []
        trainer.train(pkg.batch(reader, B), feeding=FEEDING, event_handler=lambda e, p=pkg:
                      events.append(dict(e.evaluator))
                      if isinstance(e, (p.event.EndIteration, p.event.EndPass)) else None)
        results[pkg.__name__] = (tested.evaluator, tested.cost, events)
    (jt, jc, jev), (tt, tc, tev) = results["paddle_tpu"], results["paddle_tpu_torch"]
    print("test() evaluators, port:", tt)
    print("test() evaluators, JAX: ", jt)
    assert {"err", "sum", "seqsum", "auc", "pr.F1", "pr1.recall", "pnpair",
            "colsum[2]", "seqcolsum[3]"} <= set(tt)
    _assert_results_equal(tt, jt)
    assert abs(tc - jc) <= REL * abs(jc)
    assert len(tev) == len(jev) == N_BATCHES + 1  # two EndIteration, one EndPass
    for got, want in zip(tev, jev):
        _assert_results_equal(got, want)
    # the pass's EndPass equals test() over the same data (the rate is 0)
    assert {k: v for k, v in tev[-1].items() if k != "mean_cost"} == {
        k: v for k, v in tt.items() if k != "classification_error"}


def test_printers_print_and_accumulate_nothing(capsys):
    L, A, dt, E = (paddle_tpu_torch.layer, paddle_tpu_torch.activation,
                   paddle_tpu_torch.data_type, paddle_tpu_torch.evaluator)
    x = L.data(name="x", type=dt.dense_vector(8))
    lab = L.data(name="label", type=dt.integer_value(3))
    pred = L.fc(input=x, size=3, act=A.Softmax(), name="pred")
    cost = L.classification_cost(input=pred, label=lab)
    evs = [E.value_printer_evaluator(pred, name="vp"), E.maxid_printer_evaluator(pred, name="mp"),
           E.classification_error_printer_evaluator(pred, lab, name="cep"),
           E.gradient_printer_evaluator(pred, name="gp")]
    trainer = _trainer(paddle_tpu_torch, cost,
                       paddle_tpu_torch.parameters.create(cost, seed=1, device="cpu"), evs)
    samples = [(s[0], s[1]) for s in _samples(B, 6)]
    res = trainer.test(paddle_tpu_torch.batch(lambda: iter(samples), B),
                       feeding={"x": 0, "label": 1})
    out = capsys.readouterr().out
    for name in ("vp ", "mp ", "cep: [", "gp forward-norm"):
        assert name in out, out
    assert set(res.evaluator) == {"classification_error"}
    cep = out.split("cep: [")[1].split("]")[0].split()
    assert len(cep) == B and set(cep) <= {"0", "1"}
    assert np.mean([int(v) for v in cep]) == pytest.approx(res.evaluator["classification_error"])
