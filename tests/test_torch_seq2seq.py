"""The attention NMT model (``models/seq2seq.py`` seq2seq_cost) in the port
against the JAX package, on the CPU, at vocab 50, word width 16 and hidden
width 16, in f32:

- the topology serializes identically and the parameter trees have the same
  paths and shapes (a recurrent group's parameters nest one level deeper);
- the cost agrees to 1e-5 relative and every gradient to 1e-4 relative L2,
  the JAX package's parameters carried over by path;
- three Momentum steps through ``SGD.train`` over ``token_budget_batch``
  with the ``use_bucketing`` feeder agree to 1e-4 (costs, and the trained
  parameters in relative L2);
- ``reader.bucketing.token_budget_batch`` yields the JAX package's batches,
  numpy-equal, on bench.py's bench_nmt corpus generator; the shape ladder
  helpers agree; the flag ladders the SGD feeder;
- padding to another rung, and the scans' early exit, change no number;
- under bf16 compute the recurrences' carries stay bf16;
- a parameter tar and a full-state checkpoint of the nested tree load across
  the packages bit for bit."""

import io

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import checkpoint as jckpt
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu.reader import bucketing as jbucket
from paddle_tpu_torch import checkpoint as tckpt
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.reader import bucketing as tbucket
from paddle_tpu_torch.utils.tree import leaf_paths, map_leaves
from test_torch_parity import (
    assert_trees_equal, batch_both, build_both, carry, flat_leaves, grads_both, numpy_tree,
    rel_l2)

V, WORD, HID = 50, 16, 16
FEEDING = {"src_word": 0, "trg_word": 1, "trg_next": 2}


@pytest.fixture(autouse=True)
def _flags():
    yield
    paddle_tpu_torch.flags.reset_flags()
    paddle_tpu.utils.flags.reset_flags()


def _model(pkg, vocab=V, word=WORD, hidden=HID):
    from paddle_tpu.models import seq2seq as jmod
    from paddle_tpu_torch.models import seq2seq as tmod

    return (jmod if pkg is paddle_tpu else tmod).seq2seq_cost(vocab, vocab, word, hidden)


def _corpus(n, seed, vocab=V, min_len=8, max_len=50):
    """bench.py bench_nmt's generator: lengths min_len..max_len drawn
    beta(2, 3), ids uniform in [1, vocab)."""
    rng = np.random.RandomState(seed)
    lens = (min_len + np.floor((max_len - min_len + 1) * rng.beta(2.0, 3.0, n))).astype(int)
    return [tuple([int(t) for t in rng.randint(1, vocab, size=int(n_))] for _ in range(3))
            for n_ in lens]


def _batch_arrays(samples, t):
    out = {}
    for k, name in enumerate(FEEDING):
        lens = np.asarray([len(s[k]) for s in samples], np.int32)
        arr = np.zeros((len(samples), t), np.int32)
        for i, s in enumerate(samples):
            arr[i, :len(s[k])] = s[k]
        out[name] = (arr, lens)
    return out


@pytest.fixture(scope="module")
def both():
    (jcost, jdec), (tcost, tdec) = build_both(_model)
    return jcost, tcost, paddle_tpu.parameters.create(jcost, seed=3)


def test_topology_and_parameter_tree_match_jax(both):
    jcost, tcost, jparams = both
    assert TTopo([tcost]).serialize() == JTopo([jcost]).serialize()
    tparams = TNet(TTopo([tcost])).init_params(0, "cpu")
    want = {k: v.shape for k, v in flat_leaves(numpy_tree(jparams.params)).items()}
    assert {".".join(p): tuple(v.shape) for p, v in leaf_paths(tparams)} == want
    assert want["decoder.dec_state.w_h"] == (HID, 2 * HID)


def test_cost_and_gradients_match_jax(both):
    jcost, tcost, jparams = both
    arrays = _batch_arrays(_corpus(6, 1, max_len=20), 32)
    jc, tc, jg, tg = grads_both(jcost, tcost, jparams, arrays, state={})
    err = rel_l2(tg, jg)
    print(f"seq2seq: cost {tc} vs {jc}; gradients relative L2 {err:.3e} (bar 1e-4)")
    assert abs(tc - jc) <= 1e-5 * abs(jc)
    assert err <= 1e-4


def _train(pkg, cost, params, samples, budget, **kw):
    pkg_flags = paddle_tpu_torch.flags if pkg is paddle_tpu_torch else paddle_tpu.utils.flags
    pkg_flags.set_flag("use_bucketing", True)
    bucket = tbucket if pkg is paddle_tpu_torch else jbucket
    trainer = pkg.trainer.SGD(cost=cost, parameters=params, update_equation=pkg.optimizer.Momentum(
        learning_rate=0.01, momentum=0.9), **kw)
    costs = []
    reader = bucket.token_budget_batch(lambda: iter(samples), token_budget=budget, seed=4)
    trainer.train(reader, feeding=FEEDING, event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, pkg.event.EndIteration) else None)
    return costs, trainer


def test_three_momentum_steps_match_jax(both):
    jcost, tcost, jparams = both
    samples = _corpus(24, 2, max_len=30)
    budget = 8 * 32  # 3 batches: 8 rows at rung 32, or 16 at rung 16
    jcosts, jtrainer = _train(paddle_tpu, jcost, paddle_tpu.parameters.create(jcost, seed=3),
                              samples, budget)
    tcosts, ttrainer = _train(paddle_tpu_torch, tcost, carry(jparams), samples, budget,
                              device="cpu")
    assert len(tcosts) == len(jcosts) == 3
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-4)
    drift = rel_l2(ttrainer.parameters.params, numpy_tree(jtrainer.parameters.params))
    assert drift <= 1e-4


def test_token_budget_batch_matches_jax():
    samples = _corpus(4096, 0, vocab=30000)
    for kw in ({"token_budget": 128 * 64}, {"batch_size": 64, "window": 512},
               {"token_budget": 4096, "drop_last": True, "shuffle_batches": False}):
        got = list(tbucket.token_budget_batch(lambda: iter(samples), **kw)())
        want = list(jbucket.token_budget_batch(lambda: iter(samples), **kw)())
        assert len(got) == len(want) > 10
        for g, w in zip(got, want):
            assert g == w


def test_shape_ladder_helpers_match_jax():
    from paddle_tpu.core import batch as jbatch
    from paddle_tpu_torch.core import batch as tbatch

    assert tbatch.shape_ladder() == jbatch.shape_ladder() == tbatch.DEFAULT_LADDER
    assert tbatch.shape_ladder(8, 4) == jbatch.shape_ladder(8, 4)
    arrays = _batch_arrays(_corpus(3, 5, max_len=20), 20)
    jb, tb = batch_both(arrays)
    jc, tcan = jbatch.canonicalize_batch(jb), tbatch.canonicalize_batch(tb)
    for name in arrays:
        assert np.array_equal(tcan[name].data.numpy(), np.asarray(jc[name].data))
        assert tcan[name].lengths is tb[name].lengths
    assert tbatch.batch_shape_key(tcan) == tuple(
        (n, s, d.replace("int32", "torch.int32")) for n, s, d in jbatch.batch_shape_key(jc))


def test_use_bucketing_flag_ladders_the_sgd_feeder(both):
    _, tcost, _ = both
    trainer = paddle_tpu_torch.trainer.SGD(
        tcost, None, paddle_tpu_torch.optimizer.Momentum(learning_rate=0.1), device="cpu")
    sample = [([1] * 50, [1] * 50, [1] * 50)]
    assert trainer._make_feeder(FEEDING)(sample)["src_word"].data.shape == (1, 56)
    paddle_tpu_torch.flags.set_flag("use_bucketing", True)
    assert trainer._make_feeder(FEEDING)(sample)["src_word"].data.shape == (1, 64)


def _step_once(tcost, jparams, arrays):
    from paddle_tpu_torch.trainer.step import make_train_step

    net = TNet(TTopo([tcost]))
    opt = paddle_tpu_torch.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    params = carry(jparams).params
    _, tb = batch_both(arrays)
    params, _, _, m = make_train_step(net, opt)(params, {}, opt.init(params), tb, 11)
    return float(m["cost"]), numpy_tree(params)


def test_padding_and_early_exit_change_no_number(both):
    """The same batch padded to rung 16 and to rung 32, and with the early
    exit on and off, gives the same cost and the same updated parameters."""
    _, tcost, jparams = both
    samples = _corpus(4, 7, max_len=14)
    c16, p16 = _step_once(tcost, jparams, _batch_arrays(samples, 16))
    c32, p32 = _step_once(tcost, jparams, _batch_arrays(samples, 32))
    paddle_tpu_torch.flags.set_flag("scan_early_exit", False)
    c_full, p_full = _step_once(tcost, jparams, _batch_arrays(samples, 32))
    assert np.isfinite(c16) and abs(c16 - c32) < 1e-5 and abs(c32 - c_full) < 1e-5
    assert rel_l2(p16, p32) < 1e-6 and rel_l2(p_full, p32) < 1e-6


def test_bf16_carries_stay_bf16(both, monkeypatch):
    from paddle_tpu_torch.ops import rnn

    _, tcost, jparams = both
    seen = []
    for core in (rnn.GruCore, rnn.AttGruCore):
        orig = core.forward

        def spy(ctx, *a, _orig=orig, _name=core.__name__):
            out = _orig(ctx, *a)
            seen.append((_name, a[0].dtype, out[0].dtype, out[1].dtype))
            return out

        monkeypatch.setattr(core, "forward", staticmethod(spy))
    net = TNet(TTopo([tcost]), compute_dtype="bfloat16")
    _, tb = batch_both(_batch_arrays(_corpus(4, 8, max_len=20), 32))
    leaves = map_leaves(lambda v: v.clone().requires_grad_(True), carry(jparams).params)
    cost, (outs, _) = net.cost(leaves, tb)
    cost.backward()
    assert [s[0] for s in seen] == ["GruCore", "GruCore", "AttGruCore"]
    assert all(d == torch.bfloat16 for s in seen for d in s[1:])
    assert outs["decoder@logits"].data.dtype == torch.bfloat16
    assert all(v.grad.dtype == torch.float32 and torch.isfinite(v.grad).all()
               for _, v in leaf_paths(leaves))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tar_loads_across_packages(both, writer):
    jcost, tcost, _ = both
    jparams = paddle_tpu.parameters.create(jcost, seed=6)
    tparams = paddle_tpu_torch.parameters.create(tcost, seed=6, device="cpu")
    src, dst = (jparams, tparams) if writer == "jax" else (tparams, jparams)
    rng = np.random.RandomState(9)
    for name in src.names():
        src.set(name, rng.randn(*np.shape(src.get(name))).astype(np.float32))
    assert sorted(src.names()) == sorted(dst.names())
    buf = io.BytesIO()
    src.to_tar(buf)
    buf.seek(0)
    dst.from_tar(buf)
    for name in src.names():
        assert np.array_equal(np.asarray(dst.get(name)), np.asarray(src.get(name))), name
    other = io.BytesIO()
    dst.to_tar(other)
    assert other.getvalue() == buf.getvalue()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages(both, tmp_path, writer):
    jcost, tcost, jparams = both
    samples = _corpus(16, 3, max_len=14)
    jtrainer = paddle_tpu.trainer.SGD(jcost, paddle_tpu.parameters.create(jcost, seed=3),
                                      paddle_tpu.optimizer.Momentum(momentum=0.9, learning_rate=0.01))
    ttrainer = paddle_tpu_torch.trainer.SGD(
        tcost, carry(jparams), paddle_tpu_torch.optimizer.Momentum(momentum=0.9, learning_rate=0.01),
        device="cpu")
    (wt, wck), (rt, rck) = ((jtrainer, jckpt), (ttrainer, tckpt))
    if writer == "port":
        (wt, wck), (rt, rck) = (rt, rck), (wt, wck)
    wpkg = paddle_tpu if wt is jtrainer else paddle_tpu_torch
    wt.train(wpkg.batch(lambda: iter(samples), 8), feeding=FEEDING)
    wt.save_checkpoint(wck.CheckpointManager(str(tmp_path)), step=2)
    assert rt.restore_checkpoint(rck.CheckpointManager(str(tmp_path)))
    assert_trees_equal(rt.parameters.params, numpy_tree(wt.parameters.params))
    assert_trees_equal(rt._opt_state["m"], numpy_tree(wt._opt_state["m"]))
    assert int(rt._opt_state["step"]) == 2
    assert "dec_state" in rt.parameters.params["decoder"]
