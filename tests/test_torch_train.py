"""Training through the port against the JAX package on the small Transformer
(d_model 32, 2 heads, 2+2 layers, d_ff 64, vocab 50), f32 on the CPU, from the
same parameters and batches.

With sequence lengths 100-128 and one source and one target of length 128 in
every batch, every slot pads to T = 128, where the port routes all six
attention layers through ``flash_attention_diff`` (the plain forward and the
plain backward on the CPU) while the JAX package runs dense (its flash gate
is TPU-only).  Both are f32 and differ in summation order only:
gradients agree per leaf within 1e-4 * max|g_jax|, and five Momentum steps
give the same costs within rtol 1e-4."""

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core import compiler as jcompiler
from paddle_tpu.core.topology import reset_auto_names
from paddle_tpu.models.transformer import transformer_cost as j_transformer_cost
from paddle_tpu.reader.feeder import DataFeeder as JFeeder
from paddle_tpu_torch.core import compiler as tcompiler
from paddle_tpu_torch.models.transformer import transformer_cost as t_transformer_cost
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.reader.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.utils import flags as tflags

FEEDING = {"src_word": 0, "trg_word": 1, "trg_next": 2}
V = 50
SMALL = dict(d_model=32, n_heads=2, n_layers=2, d_ff=64)
GRAD_REL = 1e-4
COST_RTOL = 1e-4


@pytest.fixture
def f32_flash():
    prev_j, prev_t = jcompiler.get_default_compute_dtype(), tcompiler.get_default_compute_dtype()
    jcompiler.set_default_compute_dtype(None)
    tcompiler.set_default_compute_dtype(None)
    tflags.set_flag("use_flash_attention", True)
    yield
    jcompiler.set_default_compute_dtype(prev_j)
    tcompiler.set_default_compute_dtype(prev_t)
    tflags.reset_flags()


def _samples(n, seed):
    """n (src, trg, trg_next) samples with lengths in 100-128; every fourth
    (from the first) has a source and a target of length 128, so each batch
    of 4 pads to 128."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        ns, nt = (128, 128) if i % 4 == 0 else rng.randint(100, 129, size=2)
        trg = list(rng.randint(2, V, size=nt))
        out.append((list(rng.randint(2, V, size=ns)), [0] + trg[:-1], trg))
    return out


def _both_models():
    reset_auto_names()
    jcost, _ = j_transformer_cost(V, V, **SMALL)
    tcost, _ = t_transformer_cost(V, V, **SMALL)
    jparams = paddle_tpu.parameters.create(jcost, seed=5)
    tree = {k: {kk: np.asarray(vv) for kk, vv in p.items()} for k, p in jparams.params.items()}
    return jcost, tcost, jparams, tree


def test_transformer_gradients_match_jax(f32_flash, monkeypatch):
    import jax

    jcost, tcost, jparams, tree = _both_models()
    samples = _samples(4, seed=0)
    jnet = jparams.network
    jbatch = JFeeder(jnet.topology.data_types(), FEEDING)(samples)
    assert jbatch["src_word"].data.shape[1] == jbatch["trg_word"].data.shape[1] == 128
    jgrads = jax.jit(jax.grad(lambda p: jnet.cost(p, jbatch, train=True)[0]))(jparams.params)

    tnet = tcompiler.CompiledNetwork(paddle_tpu_torch.topology.Topology(tcost))
    tbatch = TFeeder(tnet.topology.data_types(), FEEDING, device="cpu")(samples)
    leaves = {
        k: {kk: torch.tensor(vv, requires_grad=True) for kk, vv in p.items()}
        for k, p in tree.items()
    }
    calls = []
    plain_bwd = tfa.flash_attention_bwd_reference
    monkeypatch.setattr(
        tfa, "flash_attention_bwd_reference",
        lambda *a, **k: calls.append(1) or plain_bwd(*a, **k),
    )
    cost, _ = tnet.cost(leaves, tbatch, train=True)
    cost.backward()
    # 2 encoder self + 2 decoder causal self + 2 cross attention backwards
    assert len(calls) == 6
    assert tfa.flash_attention_bwd.dq_launches == tfa.flash_attention_bwd.dkv_launches == 0
    for layer, p in leaves.items():
        for key, v in p.items():
            want = np.asarray(jgrads[layer][key])
            bar = GRAD_REL * np.abs(want).max()
            np.testing.assert_allclose(
                v.grad.numpy(), want, rtol=0, atol=bar, err_msg=f"{layer}.{key}"
            )


def test_sgd_momentum_costs_match_jax(f32_flash):
    jcost, tcost, jparams, tree = _both_models()
    samples = _samples(20, seed=1)

    def reader():
        yield from samples

    def run(pkg, cost, params, **kw):
        costs = []
        trainer = pkg.trainer.SGD(
            cost=cost, parameters=params,
            update_equation=pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9),
            **kw,
        )
        trainer.train(
            pkg.batch(reader, 4), num_passes=1, feeding=FEEDING,
            event_handler=lambda e: costs.append(e.cost)
            if isinstance(e, pkg.event.EndIteration) else None,
        )
        return costs

    want = run(paddle_tpu, jcost, jparams)
    tparams = paddle_tpu_torch.parameters.from_numpy(tree, device="cpu")
    got = run(paddle_tpu_torch, tcost, tparams, device="cpu")
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=COST_RTOL)
    assert tparams.network is not None  # the trainer adopted the tree


def test_transformer_trains_on_copy_task():
    """The port's mirror of tests/test_transformer.py's copy task: Adam(3e-3)
    brings the last costs below 0.6 x the first."""
    V_, BOS, EOS = 14, 0, 1
    cost, _ = t_transformer_cost(V_, V_, d_model=32, n_heads=4, n_layers=2, d_ff=64)
    params = paddle_tpu_torch.parameters.create(cost, seed=0, device="cpu")
    trainer = paddle_tpu_torch.trainer.SGD(
        cost=cost, parameters=params,
        update_equation=paddle_tpu_torch.optimizer.Adam(learning_rate=3e-3),
        device="cpu",
    )
    rng = np.random.RandomState(0)

    def reader():
        for _ in range(160):
            s = list(rng.randint(2, V_, size=rng.randint(2, 6)))
            yield s, [BOS] + s, s + [EOS]

    costs, passes = [], []
    trainer.train(
        reader=paddle_tpu_torch.batch(reader, 16),
        num_passes=10,
        event_handler=lambda e: costs.append(e.cost)
        if isinstance(e, paddle_tpu_torch.event.EndIteration)
        else passes.append(e.evaluator["mean_cost"])
        if isinstance(e, paddle_tpu_torch.event.EndPass) else None,
        feeding=FEEDING,
    )
    assert len(costs) == 100 and len(passes) == 10
    assert np.mean(costs[-5:]) < 0.6 * np.mean(costs[:5]), (costs[:5], costs[-5:])
    result = trainer.test(paddle_tpu_torch.batch(reader, 16), feeding=FEEDING)
    assert np.isfinite(result.cost) and 0.0 <= result.metrics["classification_error"] <= 1.0
