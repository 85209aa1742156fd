"""Saving and loading through the port against the JAX package, on a small
network with batch-norm state (fc -> batch norm -> fc softmax):

- the v1 parameter tar written by either package loads in the other, bit
  for bit, by instance (``params.from_tar(f)``) and through the class's
  topology-free ``DetachedParameters.merge_into``; the two packages write
  the same bytes;
- v1 parameter dirs (one binary file per parameter) round-trip across the
  packages, bit for bit;
- a ``CheckpointManager`` step written by either package's trainer restores
  in the other's: params, layer state and optimizer state bit for bit, the
  step count, and the same next costs (f32, within 1e-5 relative);
- retention keeps the newest ``max_to_keep`` steps; a truncated or
  CRC-failing newest step makes ``restore_latest`` fall back; asynchronous
  saves restore like synchronous ones;
- ``SGD.train(save_dir=...)`` writes the reference's pass dirs at its
  cadence, and ``save_pass``/``load_pass`` round-trip (and load in the JAX
  package);
- a trainer restored from ``save_checkpoint`` (dropout on, so the
  generator's state matters) continues bit for bit like the uninterrupted
  one;
- global parameter names resolve as in the JAX package, and
  ``from_tar_new`` builds parameters from a tar."""

import io
import os

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import checkpoint as jckpt
from paddle_tpu_torch import checkpoint as tckpt
from test_torch_parity import assert_trees_equal, build_both, carry, numpy_tree

FEEDING = {"x": 0, "label": 1}
B = 8


def _bn_net(pkg, drop_rate=0.0):
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector(12))
    lab = L.data(name="label", type=dt.integer_value(4))
    attr = pkg.attr.ExtraAttr(drop_rate=drop_rate) if drop_rate else None
    h = L.fc(input=x, size=16, act=A.Relu(), layer_attr=attr)
    h = L.batch_norm(input=h, act=A.Identity())
    pred = L.fc(input=h, size=4, act=A.Softmax())
    return L.classification_cost(input=pred, label=lab), pred


def _samples(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(12).astype(np.float32), int(rng.randint(4))) for _ in range(n)]


def _trainer(pkg, cost, params, **kw):
    opt = pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    if pkg is paddle_tpu_torch:
        kw["device"] = "cpu"
    return pkg.trainer.SGD(cost=cost, parameters=params, update_equation=opt, **kw)


def _train(pkg, trainer, samples, **kw):
    costs = []
    trainer.train(pkg.batch(lambda: iter(samples), B), feeding=FEEDING,
                  event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, pkg.event.EndIteration) else None, **kw)
    return costs


@pytest.fixture
def nets():
    (jcost, _), (tcost, _) = build_both(_bn_net)
    jparams = paddle_tpu.parameters.create(jcost, seed=1)
    tparams = carry(jparams)
    tparams.network = paddle_tpu_torch.CompiledNetwork(paddle_tpu_torch.Topology(tcost))
    return jcost, tcost, jparams, tparams


# -- the tar -----------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tar_loads_in_the_other_package(nets, writer):
    jcost, tcost, jparams, tparams = nets
    rng = np.random.RandomState(5)
    src, dst = (jparams, tparams) if writer == "jax" else (tparams, jparams)
    for name in src.names():
        src.set(name, rng.randn(*np.shape(src.get(name))).astype(np.float32))
    buf = io.BytesIO()
    src.to_tar(buf)
    # instance form: merge into existing parameters
    buf.seek(0)
    dst.from_tar(buf)
    for name in src.names():
        assert np.array_equal(np.asarray(dst.get(name)), np.asarray(src.get(name))), name
    # class form: a topology-free bag, merged by name
    buf.seek(0)
    dst_pkg = paddle_tpu if writer == "port" else paddle_tpu_torch
    detached = dst_pkg.parameters.Parameters.from_tar(buf)
    assert sorted(detached.names()) == sorted(src.names())
    fresh = (paddle_tpu.parameters.create(jcost, seed=9) if writer == "port" else
             paddle_tpu_torch.parameters.create(tcost, seed=9, device="cpu"))
    detached.merge_into(fresh)
    for name in src.names():
        assert np.array_equal(np.asarray(fresh.get(name)), np.asarray(src.get(name))), name
    # the same values give the same bytes from either package
    other = io.BytesIO()
    dst.to_tar(other)
    assert other.getvalue() == buf.getvalue()


def test_detached_tar_serves_and_trains_in_the_port(nets):
    jcost, tcost, jparams, tparams = nets
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    detached = paddle_tpu_torch.parameters.Parameters.from_tar(buf)
    samples = [(x,) for x, _ in _samples(3, 2)]
    _, tpred = build_both(_bn_net)[1]  # the same layer names again
    got = paddle_tpu_torch.infer(tpred, detached, samples, device="cpu")
    want = paddle_tpu_torch.infer(tpred, tparams, samples, device="cpu")
    assert np.array_equal(got, want)
    trainer = _trainer(paddle_tpu_torch, tcost, detached)
    assert_trees_equal(trainer.parameters.params, jparams.params)


# -- v1 parameter dirs ---------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parameter_dir_round_trips(nets, tmp_path, writer):
    _, _, jparams, tparams = nets
    rng = np.random.RandomState(6)
    src, dst = (jparams, tparams) if writer == "jax" else (tparams, jparams)
    save, load = ((jckpt.save_parameter_dir, tckpt.load_parameter_dir) if writer == "jax"
                  else (tckpt.save_parameter_dir, jckpt.load_parameter_dir))
    for name in src.names():
        src.set(name, rng.randn(*np.shape(src.get(name))).astype(np.float32))
    save(src, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == sorted(src.names())
    load(dst, str(tmp_path))
    for name in src.names():
        assert np.array_equal(np.asarray(dst.get(name)), np.asarray(src.get(name))), name


# -- full-state checkpoints ----------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_in_the_other_package(nets, tmp_path, writer):
    jcost, tcost, jparams, tparams = nets
    pkgs = {"jax": (paddle_tpu, jcost, jparams, jckpt), "port": (paddle_tpu_torch, tcost, tparams, tckpt)}
    reader_name = "port" if writer == "jax" else "jax"
    wpkg, wcost, wparams, wck = pkgs[writer]
    rpkg, rcost, _, rck = pkgs[reader_name]
    samples = _samples(5 * B, 3)
    wtrainer = _trainer(wpkg, wcost, wparams)
    _train(wpkg, wtrainer, samples[: 3 * B])
    wtrainer.save_checkpoint(wck.CheckpointManager(str(tmp_path)), step=3)

    fresh = (paddle_tpu.parameters.create(rcost, seed=8) if rpkg is paddle_tpu
             else paddle_tpu_torch.parameters.create(rcost, seed=8, device="cpu"))
    rtrainer = _trainer(rpkg, rcost, fresh)
    assert rtrainer.restore_checkpoint(rck.CheckpointManager(str(tmp_path)))
    assert_trees_equal(rtrainer.parameters.params, numpy_tree(wtrainer.parameters.params))
    assert_trees_equal(rtrainer.parameters.state, numpy_tree(wtrainer.parameters.state))
    assert_trees_equal(rtrainer._opt_state["m"], numpy_tree(wtrainer._opt_state["m"]))
    assert int(rtrainer._opt_state["step"]) == int(wtrainer._opt_state["step"]) == 3
    assert rtrainer._step_count == 3
    # and both go on from there alike
    want = _train(wpkg, wtrainer, samples[3 * B:])
    got = _train(rpkg, rtrainer, samples[3 * B:])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_retention_and_fallback_past_a_torn_or_corrupt_step(tmp_path):
    man = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    tree = {"a": {"w": np.arange(6, dtype=np.float32)}, "step": 0}
    for step in (1, 2, 3, 4):
        man.save(step, {**tree, "step": step}, extra={"n": step})
    assert man.all_steps() == [3, 4] and man.latest_step() == 4
    assert man.meta(4)["extra"] == {"n": 4}
    # the newest step truncated: restore_latest falls back to step 3
    path = os.path.join(str(tmp_path), "ckpt-00000004", "state.npz")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(IOError):
        man.restore(4, tree)
    step, got, extra = man.restore_latest(tree)
    assert step == 3 and got["step"] == 3 and extra == {"n": 3}
    assert np.array_equal(got["a"]["w"], tree["a"]["w"])
    # a flipped byte in step 3 (its CRC fails) leaves nothing restorable
    path = os.path.join(str(tmp_path), "ckpt-00000003", "state.npz")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    assert man.restore_latest(tree) is None


def test_async_save_restores_like_a_sync_save(nets, tmp_path):
    _, tcost, _, tparams = nets
    trainer = _trainer(paddle_tpu_torch, tcost, tparams)
    _train(paddle_tpu_torch, trainer, _samples(2 * B, 4))
    man = tckpt.CheckpointManager(str(tmp_path / "a"))
    trainer.save_checkpoint(man, async_=True)
    before = numpy_tree(trainer.parameters.params)
    # training on while the write runs must not change what it writes
    _train(paddle_tpu_torch, trainer, _samples(B, 5))
    man.wait()
    restored = _trainer(paddle_tpu_torch, tcost,
                        paddle_tpu_torch.parameters.create(tcost, seed=3, device="cpu"))
    assert restored.restore_checkpoint(man)
    assert_trees_equal(restored.parameters.params, before)
    assert restored._step_count == 2


def test_restored_trainer_continues_bit_for_bit(tmp_path):
    """Dropout on: the restored generator must draw the same masks."""
    _, (tcost, _) = build_both(lambda pkg: _bn_net(pkg, drop_rate=0.3))
    samples = _samples(6 * B, 7)
    a = _trainer(paddle_tpu_torch, tcost,
                 paddle_tpu_torch.parameters.create(tcost, seed=2, device="cpu"), seed=4)
    _train(paddle_tpu_torch, a, samples[: 2 * B])
    man = tckpt.CheckpointManager(str(tmp_path))
    a.save_checkpoint(man)
    want = _train(paddle_tpu_torch, a, samples[2 * B:])
    b = _trainer(paddle_tpu_torch, tcost,
                 paddle_tpu_torch.parameters.create(tcost, seed=9, device="cpu"), seed=5)
    assert b.restore_checkpoint(man)
    got = _train(paddle_tpu_torch, b, samples[2 * B:])
    assert got == want
    assert_trees_equal(b.parameters.params, numpy_tree(a.parameters.params))


# -- pass dirs -------------------------------------------------------------------


def test_train_writes_pass_dirs_and_load_pass_round_trips(nets, tmp_path):
    jcost, tcost, jparams, tparams = nets
    trainer = _trainer(paddle_tpu_torch, tcost, tparams)
    samples = _samples(4 * B, 8)
    trainer.train(paddle_tpu_torch.batch(lambda: iter(samples), B), num_passes=2,
                  feeding=FEEDING, save_dir=str(tmp_path), saving_period=1,
                  saving_period_by_batches=2, start_pass=3)
    assert sorted(os.listdir(tmp_path)) == [
        "pass-00003", "pass-00003-batch-2", "pass-00003-batch-4",
        "pass-00004", "pass-00004-batch-2", "pass-00004-batch-4"]
    d = tmp_path / "pass-00004"
    assert sorted(os.listdir(d)) == sorted(trainer.parameters.names() + ["params.tar"])
    trained = numpy_tree(trainer.parameters.params)
    fresh = _trainer(paddle_tpu_torch, tcost,
                     paddle_tpu_torch.parameters.create(tcost, seed=6, device="cpu"))
    fresh.load_pass(str(tmp_path), 4)
    assert_trees_equal(fresh.parameters.params, trained)
    jtrainer = _trainer(paddle_tpu, jcost, paddle_tpu.parameters.create(jcost, seed=6))
    jtrainer.load_pass(str(tmp_path), 4)
    assert_trees_equal(numpy_tree(jtrainer.parameters.params), trained)
    with open(d / "params.tar", "rb") as f:
        detached = paddle_tpu.parameters.Parameters.from_tar(f)
    for name in trainer.parameters.names():
        assert np.array_equal(detached.get(name), trainer.parameters.get(name))


def test_checkpoint_dir_is_not_ported_yet(nets, tmp_path):
    _, tcost, _, tparams = nets
    trainer = _trainer(paddle_tpu_torch, tcost, tparams)
    reader = paddle_tpu_torch.batch(lambda: iter(_samples(B, 1)), B)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        trainer.train(reader, feeding=FEEDING, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        trainer.train(reader, feeding=FEEDING, resume=True)


def test_named_access_and_tar_misuse_like_jax():
    """Global names resolve as in the JAX package (a whole-layer name to the
    layer's one leaf), ``from_tar_new`` builds parameters from a tar, and the
    class-level ``from_tar`` refuses a Parameters object."""
    def net(pkg):
        L, dt, PA = pkg.layer, pkg.data_type, pkg.attr.ParamAttr
        a = L.data(name="a", type=dt.integer_value(10))
        b = L.data(name="b", type=dt.integer_value(10))
        ea = L.embedding(input=a, size=4, param_attr=PA(name="table"))
        eb = L.embedding(input=b, size=4, param_attr=PA(name="table"))
        return L.addto(input=[ea, eb])

    jout, tout = build_both(net)
    jparams = paddle_tpu.parameters.create(jout, seed=2)
    tparams = carry(jparams)
    tnet = paddle_tpu_torch.CompiledNetwork(paddle_tpu_torch.Topology(tout))
    tparams.network = tnet
    assert np.array_equal(tparams.get("table"), np.asarray(jparams.get("table")))
    tparams.set("table", np.ones((10, 4), np.float32))
    owner = tnet.named_parameters()["table"]
    assert owner == jparams.network.named_parameters()["table"]
    assert np.array_equal(tparams.get(f"{owner}.w"), np.ones((10, 4)))
    with pytest.raises(KeyError):
        tparams.get("no_such_parameter")
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    built = paddle_tpu_torch.parameters.Parameters.from_tar_new(tnet, buf, device="cpu")
    assert_trees_equal(built.params, numpy_tree(jparams.params))
    with pytest.raises(TypeError, match="static constructor"):
        paddle_tpu_torch.parameters.Parameters.from_tar(tparams)
