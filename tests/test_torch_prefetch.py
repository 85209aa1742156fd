"""The port's asynchronous feeding (paddle_tpu_torch/reader/prefetch.py, the
feeder's staging and SGD's ``async_load_data``) on the CPU, against the JAX
package:

- the cases of ``tests/test_prefetch.py`` on the port's ``prefetch``: order,
  errors raised again on the consumer (the reader's, the prepare's), a
  close that frees a blocked worker, overlap of feed and consumer, sticky
  terminal states;
- ``SGD.train`` and ``SGD.test`` with ``async_load_data`` on and off are
  bit-identical (f32), the default is on, and the trajectory lies within
  1e-6 (relative) of the JAX package's from carried-over parameters;
- a failure of the feed on the worker is raised by ``train``;
- ``DataFeeder.stage`` on the CPU pins nothing and equals the inline feed;
- the uint8 ``feed_dtype`` feed stays uint8 in the batch, trains, and
  ``infer`` normalises as the train path does (f32, 1e-6).
The staging on the card (pinned memory, the side stream, the event) is held
by ``chip_smoke.py`` phase 22 and by the ``cuda``-marked test here."""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.reader.feeder import DataFeeder, StagedBatch
from paddle_tpu_torch.reader.prefetch import DevicePrefetcher, prefetch
from test_torch_parity import assert_trees_equal, build_both, carry, numpy_tree, rel_l2


def test_prefetch_preserves_order_and_terminates():
    assert list(prefetch(range(100), lambda x: x * 2)) == [2 * i for i in range(100)]


def test_prefetch_raises_reader_and_prepare_errors_on_the_consumer():
    def bad():
        yield 1
        yield 2
        raise RuntimeError("reader boom")

    it = prefetch(bad())
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="reader boom"):
        next(it)

    def prepare(x):
        if x == 3:
            raise ValueError("prepare boom")
        return x

    got = []
    with pytest.raises(ValueError, match="prepare boom"):
        for v in prefetch(range(10), prepare):
            got.append(v)
    assert got == [0, 1, 2]


def test_prefetch_close_unblocks_stuck_worker():
    n_before = threading.active_count()
    pf = DevicePrefetcher(iter(range(10_000)), depth=2)
    assert next(pf) == 0
    pf.close()
    deadline = time.time() + 5
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= n_before


def test_prefetch_overlaps_feed_with_consumer_work():
    """Feed cost F and consumer cost C per batch: the wall time nears
    max(F, C) * n, not (F + C) * n."""
    n, f, c = 10, 0.03, 0.03

    def slow_reader():
        for i in range(n):
            time.sleep(f)
            yield i

    t0 = time.perf_counter()
    got = []
    pf = DevicePrefetcher(slow_reader())
    for v in pf:
        time.sleep(c)
        got.append(v)
    wall = time.perf_counter() - t0
    assert got == list(range(n))
    assert wall < (f + c) * n - 0.4 * n * min(f, c), wall
    assert pf.wait_s < n * f  # the consumer waited less than the whole feed


def test_prefetch_terminal_states_are_sticky():
    pf = DevicePrefetcher(iter([1, 2]))
    assert list(pf) == [1, 2]
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()

    def bad():
        yield 1
        raise RuntimeError("boom")

    pf2 = DevicePrefetcher(bad())
    assert next(pf2) == 1
    for _ in range(3):
        with pytest.raises(RuntimeError, match="boom"):
            next(pf2)
    pf2.close()


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _regression(pkg):
    x = pkg.layer.data("x", pkg.data_type.dense_vector(8))
    y = pkg.layer.data("y", pkg.data_type.dense_vector(1))
    pred = pkg.layer.fc(x, size=1, act=pkg.activation.Identity())
    return pkg.layer.square_error_cost(input=pred, label=y)


def _reg_samples(n=24, seed=5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8).astype(np.float32), np.array([rng.randn()], np.float32))
            for _ in range(n)]


def _port_run(tcost, jparams, async_load, samples, **kw):
    trainer = paddle_tpu_torch.trainer.SGD(
        cost=tcost, parameters=carry(jparams),
        update_equation=paddle_tpu_torch.optimizer.Momentum(learning_rate=1e-3), device="cpu")
    costs = []
    reader = paddle_tpu_torch.batch(lambda: iter(samples), 8)
    trainer.train(reader, num_passes=2, async_load_data=async_load, **kw,
                  event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, paddle_tpu_torch.event.EndIteration) else None)
    return trainer, costs


def test_async_feed_is_bit_identical_to_inline_and_near_jax():
    jcost, tcost = build_both(_regression)
    jparams = paddle_tpu.parameters.create(jcost, seed=4)
    samples = _reg_samples()
    t_async, c_async = _port_run(tcost, jparams, True, samples)
    t_sync, c_sync = _port_run(tcost, jparams, False, samples)
    assert c_async == c_sync and len(c_async) == 6
    assert_trees_equal(t_async.parameters.params, numpy_tree(t_sync.parameters.params))
    # the JAX package's trajectory from the same parameters, f32
    jt = paddle_tpu.trainer.SGD(cost=jcost, parameters=jparams,
                                update_equation=paddle_tpu.optimizer.Momentum(learning_rate=1e-3))
    jc = []
    jt.train(paddle_tpu.batch(lambda: iter(samples), 8), num_passes=2,
             event_handler=lambda e: jc.append(e.cost)
             if isinstance(e, paddle_tpu.event.EndIteration) else None)
    np.testing.assert_allclose(c_async, jc, rtol=1e-6)
    assert rel_l2(t_async.parameters.params, numpy_tree(jt.parameters.params)) < 1e-6
    # test() fed both ways agrees bit for bit
    reader = paddle_tpu_torch.batch(lambda: iter(samples), 8)
    a = t_async.test(reader, async_load_data=True)
    b = t_async.test(reader, async_load_data=False)
    assert a.cost == b.cost and a.metrics == b.metrics


def test_async_is_the_default_like_the_jax_package():
    import inspect

    for fn in (paddle_tpu_torch.trainer.SGD.train, paddle_tpu_torch.trainer.SGD.test):
        assert inspect.signature(fn).parameters["async_load_data"].default is True
    for fn in (paddle_tpu.trainer.SGD.train, paddle_tpu.trainer.SGD.test):
        assert inspect.signature(fn).parameters["async_load_data"].default is True


def test_worker_failure_is_raised_by_train():
    _, tcost = build_both(_regression)
    trainer = paddle_tpu_torch.trainer.SGD(
        cost=tcost, update_equation=paddle_tpu_torch.optimizer.Momentum(learning_rate=1e-3),
        device="cpu")

    def bad_reader():
        yield _reg_samples(4)
        raise IOError("truncated input")

    with pytest.raises(IOError, match="truncated input"):
        trainer.train(bad_reader, async_load_data=True)
    # a sample the converter cannot take fails on the worker too
    with pytest.raises(ValueError):
        trainer.train(lambda: iter([[(np.zeros(3, np.float32),)]]), async_load_data=True)


def test_stage_on_the_cpu_equals_the_inline_feed():
    _, tcost = build_both(_regression)
    types = paddle_tpu_torch.Topology(tcost).data_types()
    feeder = DataFeeder(types, device="cpu")
    samples = _reg_samples(4)
    staged = feeder.stage(samples)
    inline = feeder(samples)
    assert isinstance(staged, StagedBatch) and staged.ready is None
    assert DataFeeder.consume(staged) is staged
    for name in inline:
        assert torch.equal(staged[name].data, inline[name].data)
        assert not staged[name].data.is_pinned()


def _uint8_net(pkg, dim=12):
    x = pkg.layer.data("img", pkg.data_type.dense_vector(dim), feed_dtype="uint8",
                       feed_scale=1 / 255.0, feed_shift=-0.5)
    lbl = pkg.layer.data("lbl", pkg.data_type.integer_value(3))
    fc = pkg.layer.fc(input=x, size=3, act=pkg.activation.Softmax())
    return pkg.layer.classification_cost(input=fc, label=lbl), fc


def test_uint8_feed_trains_and_infer_matches_the_train_path():
    (jcost, _), (tcost, tfc) = build_both(_uint8_net)
    jparams = paddle_tpu.parameters.create(jcost, seed=0)
    trainer = paddle_tpu_torch.trainer.SGD(
        cost=tcost, parameters=carry(jparams),
        update_equation=paddle_tpu_torch.optimizer.Momentum(learning_rate=0.5, momentum=0.9),
        device="cpu")
    rng = np.random.RandomState(0)
    pix = rng.randint(0, 256, (24, 12), dtype=np.uint8)
    rows = [(pix[i], int(pix[i, 0]) % 3) for i in range(24)]
    batch = trainer._make_feeder(None).stage(rows)
    assert batch["img"].data.dtype == torch.uint8 and batch["lbl"].data.dtype == torch.int32
    costs = []
    trainer.train(paddle_tpu_torch.batch(lambda: iter(rows), 8), num_passes=30,
                  event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, paddle_tpu_torch.event.EndIteration) else None)
    assert costs[-1] < 0.9 * costs[0], (costs[0], costs[-1])
    # the device-side values are the normalised floats
    outs, _ = trainer.network.apply(trainer.parameters.params, batch,
                                    state=trainer.parameters.state, train=False)
    want = pix[:24].astype(np.float32) / 255.0 - 0.5
    np.testing.assert_allclose(outs["img"].data.numpy(), want, rtol=1e-6, atol=1e-6)
    # infer feeds the same wire dtype and normalises on the device
    probs = paddle_tpu_torch.infer(output_layer=tfc, parameters=trainer.parameters,
                                   input=[(r[0],) for r in rows[:8]], device="cpu")
    w = trainer.parameters.params[tfc.name]["w0"].numpy()
    b = trainer.parameters.params[tfc.name]["b"].numpy()
    logits = want[:8] @ w + b
    ref = np.exp(logits - logits.max(1, keepdims=True))
    ref /= ref.sum(1, keepdims=True)
    np.testing.assert_allclose(np.asarray(probs), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_staging_on_the_card_uses_pinned_memory_and_a_side_stream():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: staging on the card")
    _, tcost = build_both(_regression)
    feeder = DataFeeder(paddle_tpu_torch.Topology(tcost).data_types(), device="cuda")
    samples = _reg_samples(8)
    staged = feeder.stage(samples)
    assert staged.ready is not None and feeder._stream != torch.cuda.current_stream()
    DataFeeder.consume(staged)
    inline = feeder(samples)
    for name in inline:
        assert torch.equal(staged[name].data, inline[name].data)
