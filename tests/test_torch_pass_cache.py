"""The port's device-resident pass cache, data echo and whole-pass epoch
program (paddle_tpu_torch/reader/pass_cache.py, trainer/step.py
``make_epoch_program``, ``SGD.train``'s feed switch) on the CPU: the cases of
``tests/test_pass_cache.py`` and ``tests/test_epoch_program.py``, and the
JAX package as the reference.

- capture, seal and replay hold the same batch objects; an overflow of the
  budget streams; echo repeats pass 1 only; an abandoned capture starts
  afresh; the order is a permutation reproducible from the seed and
  different across passes (it cannot be ``jax.random``'s stream), capture
  order with shuffling off; ``sample_shuffle`` moves every slot's rows
  together;
- cached == streamed in the same order, bit for bit; a cached trajectory
  with shuffling off lies within 1e-6 (relative, f32) of the JAX package's
  from the same parameters, and a cached batch's bytes are unchanged after
  two passes of training on it;
- the whole-pass program == the stepwise loop bit for bit: parameters,
  EndIteration costs, EndPass metrics, the generator, and the sentinel's
  skips of a NaN batch; one dispatch per cached pass; each fallback warns;
- the carry folds health, skips and the healthy cost as the JAX program's.
"""

import logging

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu_torch.core.batch import SeqTensor, batch_shape_key
from paddle_tpu_torch.core.topology import reset_auto_names
from paddle_tpu_torch.reader.pass_cache import PassCache, batch_nbytes
from paddle_tpu_torch.utils.flags import reset_flags, set_flag
from paddle_tpu_torch.utils.timers import global_stats
from test_torch_parity import build_both, carry, numpy_tree, rel_l2


@pytest.fixture(autouse=True)
def _clean():
    global_stats.reset()
    yield
    reset_flags()
    global_stats.reset()


def _batch(seed=0, b=4, d=6):
    rng = np.random.RandomState(seed)
    return {"x": SeqTensor(torch.from_numpy(rng.randn(b, d).astype(np.float32))),
            "y": SeqTensor(torch.from_numpy(rng.randint(0, 3, b).astype(np.int32)))}


# ---------------------------------------------------------------------------
# PassCache alone
# ---------------------------------------------------------------------------


def test_capture_seal_replay_roundtrip():
    cache = PassCache(seed=3)
    batches = [_batch(i) for i in range(5)]
    assert list(cache.capture(iter(batches))) == batches
    assert cache.ready and cache.n_batches == 5
    assert cache.nbytes == sum(batch_nbytes(b) for b in batches) == 5 * (4 * 6 * 4 + 4 * 4)
    assert sorted(map(id, cache.epoch(1))) == sorted(map(id, batches))
    s = cache.summary()
    assert s["n_batches"] == 5 and s["ready"] and s["n_buckets"] == 1


def test_epoch_order_reproducible_and_per_pass():
    batches = [_batch(i) for i in range(8)]
    a, b = PassCache(seed=7), PassCache(seed=7)
    for x in batches:
        a.observe(x)
        b.observe(x)
    a.seal(), b.seal()
    assert a.epoch_order(1) == b.epoch_order(1) == a.epoch_order(1)
    assert sorted(a.epoch_order(1)) == list(range(8))
    assert a.epoch_order(1) != a.epoch_order(2)
    assert PassCache(seed=8)._generator(1).initial_seed() != a._generator(1).initial_seed()
    assert a.epoch_perm(2).tolist() == a.epoch_order(2) and a.epoch_perm(2).device.type == "cpu"
    c = PassCache(seed=7, shuffle=False)
    for x in batches:
        c.observe(x)
    c.seal()
    assert c.epoch_order(1) == list(range(8))


def test_budget_overflow_falls_back_to_streaming(caplog):
    batches = [_batch(i) for i in range(4)]
    per = batch_nbytes(batches[0])
    cache = PassCache(hbm_budget_bytes=2 * per + per // 2)
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch.pass_cache"):
        assert list(cache.capture(iter(batches))) == batches
    assert not cache.active and not cache.ready and cache.n_batches == 0 and cache.nbytes == 0
    assert any("falling back to streaming" in r.message for r in caplog.records)


def test_echo_and_abandoned_capture():
    batches = [_batch(i) for i in range(3)]
    cache = PassCache(echo_factor=3)
    consumed = list(cache.capture(iter(batches)))
    assert len(consumed) == 9
    for i, b in enumerate(batches):
        assert all(x is b for x in consumed[3 * i:3 * i + 3])
    assert cache.ready and cache.n_batches == 3
    fresh = PassCache()
    gen = fresh.capture(iter([_batch(0), _batch(1)]))
    next(gen)
    gen.close()
    assert not fresh.ready and fresh.n_batches == 1
    list(fresh.capture(iter([_batch(2), _batch(3)])))
    assert fresh.ready and fresh.n_batches == 2


def test_sample_shuffle_moves_every_slot_together():
    b, d = 8, 4
    data = np.arange(b * d, dtype=np.float32).reshape(b, d)
    lens = np.arange(b, dtype=np.int32) + 1
    from paddle_tpu_torch.core.batch import host_lengths, set_host_lengths

    lt = set_host_lengths(torch.from_numpy(lens), lens)
    batch = {"w": SeqTensor(torch.from_numpy(data), lt),
             "y": SeqTensor(torch.arange(b, dtype=torch.int32))}
    cache = PassCache(seed=5, sample_shuffle=True)
    cache.observe(batch)
    cache.seal()
    (out,) = list(cache.epoch(2))
    y = out["y"].data.numpy()
    assert sorted(y.tolist()) == list(range(b)) and y.tolist() != list(range(b))
    for row, sid in enumerate(y):
        np.testing.assert_array_equal(out["w"].data[row].numpy(), data[sid])
        assert out["w"].lengths[row] == lens[sid]
    np.testing.assert_array_equal(host_lengths(out["w"].lengths), lens[y])
    assert torch.equal(batch["y"].data, torch.arange(b, dtype=torch.int32))  # untouched
    c2 = PassCache(seed=5, sample_shuffle=True)
    c2.observe(batch)
    c2.seal()
    np.testing.assert_array_equal(list(c2.epoch(2))[0]["y"].data.numpy(), y)


def test_stacked_and_stacked_pass():
    cache = PassCache(seed=1)
    batches = [_batch(i) for i in range(4)]
    list(cache.capture(iter(batches)))
    st = cache.stacked()
    assert st["x"].data.shape == (4, 4, 6) and cache.stacked() is st
    order = cache.epoch_order(3)
    sp = cache.stacked_pass(3)
    for j, i in enumerate(order):
        assert torch.equal(sp["x"].data[j], batches[i]["x"].data)
    assert cache.fits_stacked()
    cache.budget = 2 * cache.nbytes - 1
    assert not cache.fits_stacked()


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _dense(pkg):
    x = pkg.layer.data("x", pkg.data_type.dense_vector(6))
    h = pkg.layer.fc(x, size=8, act=pkg.activation.Relu())
    pred = pkg.layer.fc(h, size=3, act=pkg.activation.Softmax())
    y = pkg.layer.data("y", pkg.data_type.integer_value(3))
    return pkg.layer.classification_cost(input=pred, label=y)


def _samples(n=16, seed=0, nan_at=None):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        v = rng.randn(6).astype(np.float32)
        if nan_at is not None and i == nan_at:
            v[2] = np.nan
        out.append((v, int(rng.randint(3))))
    return out


def _trainer(seed=0):
    reset_auto_names()
    cost = _dense(P)
    return P.trainer.SGD(cost=cost, parameters=P.parameters.create(cost, seed=0, device="cpu"),
                         seed=seed, update_equation=P.optimizer.Adam(learning_rate=1e-2),
                         device="cpu")


def _train(reader, num_passes, collect=None, whole=False, cache=True, **kw):
    set_flag("cache_pass_in_mem", cache)
    set_flag("whole_pass_program", whole)
    tr = _trainer()
    tr.train(reader=reader, num_passes=num_passes, event_handler=collect or (lambda e: None),
             async_load_data=False, **kw)
    return tr


def _params_equal(a, b):
    for name in a.parameters.params:
        for k, v in a.parameters.params[name].items():
            assert torch.equal(v, b.parameters.params[name][k]), f"{name}.{k}"


def test_cached_equals_streamed_in_the_same_order():
    samples = _samples(16)
    batches = [samples[i:i + 4] for i in range(0, 16, 4)]
    cached = _train(P.batch(lambda: iter(samples), 4), 3)
    cache = cached._pass_cache
    assert cache.ready and cache.n_batches == 4
    orders = [cache.epoch_order(p) for p in (1, 2)]
    calls = {"n": 0}

    def replay_reader():
        i = calls["n"]
        calls["n"] += 1
        for bi in (list(range(4)) if i == 0 else orders[i - 1]):
            yield from batches[bi]

    streamed = _train(P.batch(replay_reader, 4), 3, cache=False)
    assert streamed._pass_cache is None
    _params_equal(cached, streamed)


def test_cached_trajectory_near_jax_and_cached_bytes_unchanged():
    """Shuffling off (the reader's ``cache_pass_shuffle`` tag): both
    packages replay in capture order, so their trajectories compare."""
    from paddle_tpu.utils import flags as jflags

    jcost, tcost = build_both(_dense)
    jparams = paddle_tpu.parameters.create(jcost, seed=2)
    tparams = carry(jparams)
    samples = _samples(16, seed=4)
    out = []
    try:
        for pkg, cost, params, kw in ((paddle_tpu, jcost, jparams, {}),
                                      (P, tcost, tparams, {"device": "cpu"})):
            reader = pkg.batch(lambda: iter(samples), 4)
            reader.cache_pass_in_mem, reader.cache_pass_shuffle = True, False
            tr = pkg.trainer.SGD(cost=cost, parameters=params, **kw,
                                 update_equation=pkg.optimizer.Adam(learning_rate=1e-2))
            costs = []
            tr.train(reader, num_passes=3, async_load_data=False,
                     event_handler=lambda e, c=costs, p=pkg: c.append(e.cost)
                     if isinstance(e, p.event.EndIteration) else None)
            out.append((costs, tr))
    finally:
        jflags.reset_flags()
    (jc, jt), (tc, tt) = out
    assert len(tc) == 12 and tt._pass_cache.ready and not tt._pass_cache.shuffle
    assert jt._pass_cache.ready
    np.testing.assert_allclose(tc, jc, rtol=1e-6)
    assert rel_l2(tt.parameters.params, numpy_tree(jt.parameters.params)) < 1e-6
    # the cache holds references: two passes of training on them wrote nothing
    first = tt._pass_cache._batches[0]
    np.testing.assert_array_equal(first["x"].data.numpy(), np.stack([s[0] for s in samples[:4]]))


def test_overflow_streams_every_pass(caplog):
    set_flag("pass_cache_hbm_budget_mb", 0)
    events = []
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch.pass_cache"):
        tr = _train(P.batch(lambda: iter(_samples(16)), 4), 2,
                    collect=lambda e: events.append(e)
                    if isinstance(e, P.event.EndIteration) else None)
    assert any("falling back to streaming" in r.message for r in caplog.records)
    assert tr._pass_cache is not None and not tr._pass_cache.active
    assert len(events) == 8


def test_echo_on_the_first_pass_only_and_single_pass_retains_nothing():
    set_flag("data_echo_factor", 2)
    events = []
    tr = _train(P.batch(lambda: iter(_samples(16)), 4), 2,
                collect=lambda e: events.append(e.batch_id)
                if isinstance(e, P.event.EndIteration) else None)
    assert len(events) == 12 and tr._pass_cache.n_batches == 4
    events.clear()
    tr = _train(P.batch(lambda: iter(_samples(16)), 4), 1,
                collect=lambda e: events.append(e.batch_id)
                if isinstance(e, P.event.EndIteration) else None)
    assert tr._pass_cache is None and len(events) == 8


def test_cache_reused_across_train_calls_with_the_same_reader():
    set_flag("cache_pass_in_mem", True)
    tr = _trainer()
    rd = P.batch(lambda: iter(_samples(16)), 4)
    tr.train(reader=rd, num_passes=2, async_load_data=False)
    first = tr._pass_cache
    assert first.ready and first.n_batches == 4
    tr.train(reader=rd, num_passes=1, async_load_data=False)
    assert tr._pass_cache is first
    tr.train(reader=P.batch(lambda: iter(_samples(16)), 4), num_passes=2, async_load_data=False)
    assert tr._pass_cache is not first and not first.active and first.n_batches == 0


def test_cache_composes_with_bucketing_and_provider_tags():
    from paddle_tpu_torch.data_provider import CacheType, integer_value, provider
    from paddle_tpu_torch.reader.bucketing import token_budget_batch

    reset_auto_names()
    w = P.layer.data("w", P.data_type.integer_value_sequence(30))
    pooled = P.layer.last_seq(P.layer.embedding(w, size=4))
    pred = P.layer.fc(pooled, size=2, act=P.activation.Softmax())
    y = P.layer.data("y", P.data_type.integer_value(2))
    cost = P.layer.classification_cost(input=pred, label=y)
    rng = np.random.RandomState(1)
    samples = [([int(t) for t in rng.randint(1, 30, size=n)], int(n % 2))
               for n in rng.randint(2, 60, size=64)]
    set_flag("cache_pass_in_mem", True)
    set_flag("use_bucketing", True)
    tr = P.trainer.SGD(cost=cost, parameters=P.parameters.create(cost, seed=0, device="cpu"),
                       update_equation=P.optimizer.Adam(learning_rate=1e-2), device="cpu")
    tr.train(reader=token_budget_batch(lambda: iter(samples), token_budget=128, drop_last=True),
             num_passes=3, async_load_data=False)
    cache = tr._pass_cache
    assert cache.ready and cache.n_buckets > 1
    assert sorted(map(batch_shape_key, cache._batches)) == sorted(
        map(batch_shape_key, cache.epoch(2)))
    assert tr.compile_cache.n_shapes == cache.n_buckets

    @provider(input_types=[integer_value(4)], cache=CacheType.CACHE_PASS_IN_MEM,
              should_shuffle=False)
    def proc(settings, f):
        yield (0,)

    rd = proc()
    assert rd.cache_pass_in_mem and rd.cache_pass_shuffle is False
    for wrapped in (P.batch(rd, 2), token_budget_batch(rd, token_budget=8)):
        assert wrapped.cache_pass_in_mem and wrapped.cache_pass_shuffle is False


# ---------------------------------------------------------------------------
# the whole-pass epoch program
# ---------------------------------------------------------------------------


def _both(samples=None, num_passes=3, batch_size=4):
    s = samples if samples is not None else _samples()
    evs = {}
    trs = {}
    for whole in (False, True):
        ev = []
        global_stats.reset()
        trs[whole] = _train(P.batch(lambda: iter(s), batch_size), num_passes,
                            collect=ev.append, whole=whole)
        evs[whole] = ev
    return trs, evs


def _iters(ev):
    return [(e.pass_id, e.batch_id, e.cost) for e in ev if isinstance(e, P.event.EndIteration)]


def test_whole_pass_bit_exact_params_events_and_end_pass():
    trs, evs = _both()
    _params_equal(trs[False], trs[True])
    assert _iters(evs[False]) == _iters(evs[True]) and len(_iters(evs[True])) == 12
    assert global_stats.count("epoch_program/dispatches") == 2
    assert torch.equal(trs[False]._rng.get_state(), trs[True]._rng.get_state())
    assert trs[False]._step_count == trs[True]._step_count == 12
    ep = {w: [e.evaluator for e in evs[w] if isinstance(e, P.event.EndPass)] for w in evs}
    assert ep[False] == ep[True] and len(ep[True]) == 3


def test_whole_pass_sentinel_skips_match_stepwise():
    trs, evs = _both(_samples(nan_at=5))
    _params_equal(trs[False], trs[True])
    ia, ib = _iters(evs[False]), _iters(evs[True])
    assert len(ia) == len(ib) == 12
    for (pa, ba, ca), (pb, bb, cb) in zip(ia, ib):
        assert (pa, ba) == (pb, bb) and ((ca == cb) or (np.isnan(ca) and np.isnan(cb)))
    assert sum(np.isnan(c) for _, _, c in ib) == 3
    # each cached pass with the poisoned batch ran once on the device, then
    # stepwise from its start
    assert global_stats.count("epoch_program/replayed") == 2
    ep = [e.evaluator["mean_cost"] for e in evs[True] if isinstance(e, P.event.EndPass)]
    assert ep == [e.evaluator["mean_cost"] for e in evs[False] if isinstance(e, P.event.EndPass)]
    assert all(np.isfinite(ep))


def test_one_dispatch_per_cached_pass():
    _train(P.batch(lambda: iter(_samples()), 4), 5, whole=True)
    assert global_stats.count("epoch_program/dispatches") == 4
    assert global_stats.count("epoch_program/steps") == 16


def _warned(caplog, text):
    return any(text in r.getMessage() for r in caplog.records)


def test_each_fallback_warns(caplog, tmp_path):
    with caplog.at_level("WARNING", logger="paddle_tpu_torch.trainer"):
        a = _train(P.batch(lambda: iter(_samples(18)), 4), 3, whole=True)  # 4+4+4+4+2 rows
    assert global_stats.count("epoch_program/dispatches") == 0 and _warned(caplog, "shape buckets")
    b = _train(P.batch(lambda: iter(_samples(18)), 4), 3)
    _params_equal(a, b)
    caplog.clear()
    with caplog.at_level("WARNING", logger="paddle_tpu_torch.trainer"):
        _train(P.batch(lambda: iter(_samples()), 4), 3, whole=True,
               checkpoint_dir=str(tmp_path / "ck"))
    assert global_stats.count("epoch_program/dispatches") == 0
    assert _warned(caplog, "checkpoint/rollback")
    caplog.clear()
    with caplog.at_level("WARNING", logger="paddle_tpu_torch.trainer"):
        _train(P.batch(lambda: iter(_samples()), 4), 2, whole=True, cache=False)
    assert _warned(caplog, "no device-resident pass cache")
    caplog.clear()
    set_flag("cache_pass_in_mem", True)
    set_flag("whole_pass_program", True)
    tr = _trainer()

    def shrink(e):
        if isinstance(e, P.event.EndPass) and e.pass_id == 0:
            tr._pass_cache.budget = tr._pass_cache.nbytes * 2 - 1
        if isinstance(e, P.event.EndPass) and e.pass_id == 1:
            tr._pass_cache.budget = None
            tr._pass_cache.sample_shuffle = True

    with caplog.at_level("WARNING", logger="paddle_tpu_torch.trainer"):
        tr.train(reader=P.batch(lambda: iter(_samples()), 4), num_passes=3,
                 event_handler=shrink, async_load_data=False)
    assert global_stats.count("epoch_program/dispatches") == 0
    assert _warned(caplog, "stacked copy would exceed")


def test_sample_shuffle_falls_back(caplog):
    set_flag("cache_pass_in_mem", True)
    set_flag("whole_pass_program", True)
    tr = _trainer()

    def shuffle_rows(e):
        if isinstance(e, P.event.EndPass) and e.pass_id == 0:
            tr._pass_cache.sample_shuffle = True

    with caplog.at_level("WARNING", logger="paddle_tpu_torch.trainer"):
        tr.train(reader=P.batch(lambda: iter(_samples()), 4), num_passes=2,
                 event_handler=shuffle_rows, async_load_data=False)
    assert global_stats.count("epoch_program/dispatches") == 0 and _warned(caplog, "sample_shuffle")


def test_carry_folds_health_and_cost():
    from paddle_tpu_torch.trainer.step import make_epoch_program, make_train_carry

    reset_auto_names()
    cost = _dense(P)
    net = P.CompiledNetwork(P.Topology([cost]))
    opt = P.optimizer.Adam(learning_rate=1e-2)
    params, state = net.init(seed=0, device="cpu")
    opt_state = opt.init(params)
    rng = np.random.RandomState(0)
    xs = rng.randn(4, 4, 6).astype(np.float32)
    xs[2, 0, 0] = np.nan
    stacked = {"x": SeqTensor(torch.from_numpy(xs)),
               "y": SeqTensor(torch.from_numpy(rng.randint(0, 3, (4, 4)).astype(np.int32)))}
    prog = make_epoch_program(net, opt)
    carry_ = make_train_carry(params, state, opt_state, torch.Generator().manual_seed(7))
    carry_, ms = prog(carry_, stacked, torch.arange(4))
    assert float(carry_["skipped"]) == 1.0 and float(carry_["health_min"]) == 0.0
    assert float(carry_["ok_steps"]) == 3.0
    healthy = [float(c) for c, h in zip(ms["cost"], ms["health"]) if h >= 0.5]
    np.testing.assert_allclose(float(carry_["cost_sum"]), sum(healthy), rtol=1e-6)
    assert np.isnan(float(ms["cost"][2])) and ms["cost"].shape == (4,)
    for leaf in carry_["params"].values():
        for v in leaf.values():
            assert torch.isfinite(v).all()  # the skipped step kept the old values
