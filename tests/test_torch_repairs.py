"""Repairs of the port's user surface against the JAX package on the CPU (f32):

- static pruning: an fc(16 -> 4) whose ParamAttr carries
  ``HookAttr("pruning", 0.75)``, trained for one pass of 4 batches with
  Momentum(0.1, 0.9) from the JAX package's parameters, leaves the JAX
  package's zero pattern in ``w0`` (0.75 of it) and its parameters (relative
  L2 1e-5); ``build_prune_masks`` keeps the largest magnitudes;
- ``init`` takes the reference's ``use_gpu``, ``use_tpu`` and
  ``trainer_count`` and records them, ignores unknown names, and keeps the
  card as the device; ``use_pallas_attention`` is an alias of
  ``use_flash_attention``;
- ``init`` takes the JAX package's positional order (use_tpu,
  trainer_count, seed, compute_dtype); ``init(check_nans=True)`` (by
  argument or environment) arms the NaN trap, under which a step that makes
  a NaN raises ``FloatingPointError`` and changes no parameter, and
  ``enable_nan_checks(False)`` takes it off the dispatch stack;
- the top level binds every module the JAX package's binds, except those
  of ROADMAP Queue 1 items 6 and 7 (a fresh process diffs the names), and
  ``paddle.dataset.mnist.train`` resolves without a submodule import;
- ``SGD.train(checkpoint_dir=...)`` trains and writes a checkpoint,
  ``SGD.elastic_model`` gives the elastic trainer's model, and the
  not-ported messages of ``serving.ServingScheduler``,
  ``launcher.init_cluster`` and the CLI's other subcommands name their
  roadmap items (4, 6, 7);
- the sentinel and a firing chaos point dump the obs flight recorder, as
  the JAX package's do, and every chaos point but the serving ones is
  consulted somewhere in the port;
- two threads committing one sharded checkpoint step at once (the workers
  of an in-process elastic fleet) neither raise nor tear the manifest;
- ``model.save_model(master=...)`` and ``reader.creator.cloud_reader``
  work against the JAX package on the same master (one save grant; two
  readers split the shards);
- ``SGD(is_local=...)`` (ignored, as in the JAX package),
  ``SGD.train(show_parameter_stats_period=..., async_load_data=...)`` and
  ``SGD.test(async_load_data=...)`` are accepted; ``async_load_data=True``
  runs and equals ``False`` bit for bit (costs, parameters, test result).
"""

import logging

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.trainer import step as tstep
from test_torch_parity import build_both, carry, numpy_tree, rel_l2

RATIO = 0.75


def _pruned_net(pkg):
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector(16))
    y = L.fc(input=x, size=4, act=A.Softmax(), name="pruned",
             param_attr=pkg.attr.ParamAttr(update_hooks=pkg.attr.HookAttr("pruning", RATIO)))
    label = L.data(name="label", type=dt.integer_value(4))
    return L.classification_cost(input=y, label=label)


def _samples(n=32, seed=7):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 16).astype(np.float32)
    return [(x[i], int(rs.randint(0, 4))) for i in range(n)]


def test_pruning_matches_the_jax_package():
    jcost, tcost = build_both(_pruned_net)
    jparams = paddle_tpu.parameters.create(jcost, seed=3)
    samples = _samples()
    reader = lambda: iter(samples)  # noqa: E731
    trained = []
    for pkg, cost, params, kw in ((paddle_tpu, jcost, jparams, {}),
                                  (paddle_tpu_torch, tcost, carry(jparams), {"device": "cpu"})):
        trainer = pkg.trainer.SGD(cost=cost, parameters=params, update_equation=pkg.optimizer
                                  .Momentum(learning_rate=0.1, momentum=0.9), **kw)
        trainer.train(pkg.batch(reader, 8), num_passes=1, feeding={"x": 0, "label": 1})
        trained.append(numpy_tree(trainer.parameters.params))
    jp, tp = trained
    jzero, tzero = jp["pruned"]["w0"] == 0, tp["pruned"]["w0"] == 0
    assert jzero.mean() == RATIO and np.array_equal(tzero, jzero)
    err = rel_l2(tp, jp)
    print(f"pruned fc after 4 steps: zero share {tzero.mean()}, relative L2 {err:.3g}")
    assert err <= 1e-5


def test_prune_masks_keep_the_largest_initial_magnitudes():
    cost = _pruned_net(paddle_tpu_torch)
    net = TNet(TTopo([cost]))
    params = net.init_params(seed=0, device="cpu")
    masks = tstep.build_prune_masks(net, params)
    w = params["pruned"]["w0"]
    keep = masks["pruned"]["w0"].bool()
    assert keep.float().mean().item() == 1 - RATIO
    assert w.abs()[keep].min() >= w.abs()[~keep].max()
    assert bool(masks["pruned"]["b"].eq(1).all())  # biases are not pruned
    tstep.apply_prune_masks(params, masks)
    assert (params["pruned"]["w0"] == 0).float().mean().item() == RATIO
    assert tstep.build_prune_masks(TNet(TTopo([paddle_tpu_torch.layer.fc(
        input=paddle_tpu_torch.layer.data(
            name="z", type=paddle_tpu_torch.data_type.dense_vector(3)), size=2)])),
        {}) is None


def test_init_takes_the_reference_arguments():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-CUDA error cannot show")
    from paddle_tpu_torch.core import device as tdevice

    flags = paddle_tpu_torch.flags
    saved = dict(flags._VALUES)
    try:
        # use_gpu=False does not move the port to the CPU: the default device
        # stays the card, which this machine lacks
        with pytest.raises(RuntimeError, match="device='cpu'"):
            paddle_tpu_torch.init(use_gpu=False, trainer_count=1)
        paddle_tpu_torch.init(device="cpu", use_gpu=False, use_tpu=True, trainer_count=2,
                              no_such_flag=3)
        assert flags.get_flag("use_gpu") is False and flags.get_flag("trainer_count") == 2
        assert flags.get_flag("use_tpu") is True
        with pytest.raises(KeyError):
            flags.get_flag("no_such_flag")
    finally:
        tdevice._default_device = "cuda"
        flags._VALUES.clear()
        flags._VALUES.update(saved)


def test_pallas_attention_alias():
    flags = paddle_tpu_torch.flags
    saved = dict(flags._VALUES)
    try:
        flags.set_flag("use_pallas_attention", True)
        assert flags.get_flag("use_flash_attention") is True
        assert flags.get_flag("use_pallas_attention") is True
        flags.set_flag("use_flash_attention", False)
        assert flags.get_flag("use_pallas_attention") is False
    finally:
        flags._VALUES.clear()
        flags._VALUES.update(saved)


def test_sgd_takes_the_reference_arguments(caplog):
    cost = _pruned_net(paddle_tpu_torch)
    opt = paddle_tpu_torch.optimizer.Momentum(learning_rate=0.1)
    samples = _samples(16)
    reader = paddle_tpu_torch.batch(lambda: iter(samples), 8)
    trainer = paddle_tpu_torch.trainer.SGD(cost, update_equation=opt, is_local=True,
                                           device="cpu")
    with caplog.at_level(logging.INFO, logger="paddle_tpu_torch.trainer"):
        trainer.train(reader, feeding={"x": 0, "label": 1}, show_parameter_stats_period=1,
                      async_load_data=False)
    stats = [r.getMessage() for r in caplog.records if "parameter stats" in r.getMessage()]
    assert len(stats) == 2 and "pruned.w0" in stats[0]
    assert np.isfinite(trainer.test(reader, feeding={"x": 0, "label": 1},
                                    async_load_data=False).cost)
    # feeding on the prefetch thread equals the inline feed bit for bit
    runs = []
    for async_load in (True, False):
        t = paddle_tpu_torch.trainer.SGD(cost, parameters=paddle_tpu_torch.parameters.create(
            cost, seed=2, device="cpu"), update_equation=paddle_tpu_torch.optimizer.Momentum(
                learning_rate=0.1), device="cpu")
        costs = []
        t.train(reader, feeding={"x": 0, "label": 1}, async_load_data=async_load,
                event_handler=lambda e, c=costs: c.append(e.cost)
                if isinstance(e, paddle_tpu_torch.event.EndIteration) else None)
        runs.append((costs, t, t.test(reader, feeding={"x": 0, "label": 1},
                                      async_load_data=async_load)))
    (ca, ta, ra), (cb, tb, rb) = runs
    assert ca == cb and len(ca) == 2 and (ra.cost, ra.metrics) == (rb.cost, rb.metrics)
    for name in ta.parameters.names():
        assert np.array_equal(ta.parameters.get(name), tb.parameters.get(name)), name
    # training is always local, as in the JAX package
    assert paddle_tpu_torch.trainer.SGD(cost, update_equation=opt, is_local=False,
                                        device="cpu").device.type == "cpu"


def test_init_takes_the_jax_positional_order():
    from paddle_tpu_torch.core import device as tdevice

    flags = paddle_tpu_torch.flags
    saved = dict(flags._VALUES)
    try:
        paddle_tpu_torch.init(False, 1, device="cpu")
        assert flags.get_flag("use_tpu") is False and flags.get_flag("trainer_count") == 1
        paddle_tpu_torch.init(True, 2, 7, "float32", device="cpu")
        assert flags.get_flag("use_tpu") is True and flags.get_flag("trainer_count") == 2
        assert flags.get_flag("seed") == 7 and tdevice._default_device == "cpu"
    finally:
        tdevice._default_device = "cuda"
        flags._VALUES.clear()
        flags._VALUES.update(saved)


def test_check_nans_raises_and_changes_nothing(monkeypatch):
    import numpy as np
    import torch
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    from paddle_tpu_torch.core import device as tdevice

    profiler = paddle_tpu_torch.profiler
    flags = paddle_tpu_torch.flags
    saved = dict(flags._VALUES)
    try:
        assert flags.get_flag("check_nans") is False and _get_current_dispatch_mode() is None
        paddle_tpu_torch.init(device="cpu", seed=11, check_nans=True)
        assert profiler.active_trap() is not None
        assert _get_current_dispatch_mode() is profiler.active_trap()
        cost = _pruned_net(paddle_tpu_torch)
        trainer = paddle_tpu_torch.trainer.SGD(
            cost, update_equation=paddle_tpu_torch.optimizer.Momentum(learning_rate=0.1),
            device="cpu")
        before = {k: v.clone() for k, v in trainer.parameters.params["pruned"].items()}
        rows = _samples(8)
        rows[3] = (np.full_like(rows[3][0], np.nan), rows[3][1])
        with pytest.raises(FloatingPointError, match="forward of layer 'pruned'"):
            trainer.train(paddle_tpu_torch.batch(lambda: iter(rows), 8),
                          feeding={"x": 0, "label": 1})
        for k, v in trainer.parameters.params["pruned"].items():
            assert torch.equal(v, before[k])
        profiler.enable_nan_checks(False)
        assert _get_current_dispatch_mode() is None and profiler.active_trap() is None
        flags._VALUES.clear()
        flags._VALUES.update(saved)
        monkeypatch.setenv("PADDLE_TPU_TORCH_CHECK_NANS", "1")
        paddle_tpu_torch.init(device="cpu")
        assert profiler.active_trap() is not None
    finally:
        profiler.enable_nan_checks(False)
        tdevice._default_device = "cuda"
        flags._VALUES.clear()
        flags._VALUES.update(saved)


# top-level names of the JAX package the port does not bind yet, each with
# the ROADMAP Queue 1 item that ports it
NOT_YET_BOUND = {"parallel": 6}

_TOP_LEVEL = """
import json, sys
import paddle_tpu_torch as paddle
mnist_train = paddle.dataset.mnist.train  # no submodule import before this
import paddle_tpu
public = lambda m: sorted(n for n in dir(m) if not n.startswith("_"))
print(json.dumps([public(paddle_tpu), public(paddle), callable(mnist_train)]))
"""


def test_top_level_binds_the_jax_package_names():
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _TOP_LEVEL], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    jax_names, port_names, mnist_ok = json.loads(proc.stdout.strip().splitlines()[-1])
    missing = set(jax_names) - set(port_names)
    assert missing == set(NOT_YET_BOUND), sorted(missing ^ set(NOT_YET_BOUND))
    assert {"dataset", "v1_compat", "image", "io", "model", "plot", "master", "master_journal",
            "master_wire", "obs", "launcher"} <= set(port_names)
    assert mnist_ok


def test_not_ported_messages_name_their_items(tmp_path):
    cost = _pruned_net(paddle_tpu_torch)
    trainer = paddle_tpu_torch.trainer.SGD(
        cost, update_equation=paddle_tpu_torch.optimizer.Momentum(learning_rate=0.1),
        device="cpu")
    reader = paddle_tpu_torch.batch(lambda: iter(_samples(8)), 8)
    # checkpoint_dir is ported: it trains and writes the anchor and pass-end
    # checkpoints
    ck = str(tmp_path / "ck")
    trainer.train(reader, feeding={"x": 0, "label": 1}, checkpoint_dir=ck)
    manager = paddle_tpu_torch.checkpoint.CheckpointManager(ck)
    assert manager.all_steps() == [0, 1]
    assert manager.meta(1)["extra"]["pass_id"] == 1
    # elastic_model is ported: the trainer as an elastic worker's model
    from paddle_tpu_torch import cli as tcli
    from paddle_tpu_torch.trainer.elastic import TrainerTaskModel

    model = trainer.elastic_model(lambda rec: rec)
    assert isinstance(model, TrainerTaskModel) and model.state()["params"] is \
        trainer.parameters.params
    with pytest.raises(NotImplementedError, match=r"init_cluster .*Queue 1 item 6\)"):
        paddle_tpu_torch.launcher.init_cluster()
    # the interleaving explorer is ported: a small clean batch exits 0
    assert tcli.main(["explore", "--model", "ha", "--schedules", "5"]) == 0
    # the serving plane is ported: the scheduler and the CLI's serve and route
    from paddle_tpu_torch import serving

    assert serving.ServingScheduler.__module__ == "paddle_tpu_torch.serving.scheduler"
    assert tcli._COMMANDS["serve"] is tcli.cmd_serve
    assert tcli._COMMANDS["route"] is tcli.cmd_route



def test_sentinel_and_chaos_dump_the_flight_recorder(tmp_path, monkeypatch):
    import json

    from paddle_tpu_torch import obs
    from paddle_tpu_torch.robustness import chaos
    from paddle_tpu_torch.robustness.sentinel import DivergenceSentinel

    monkeypatch.setattr(obs.tracer, "_export_dir", str(tmp_path))
    path = tmp_path / f"flight-{obs.tracer.pid}.json"
    sentinel = DivergenceSentinel(skip_limit=2)
    assert sentinel.observe(float("nan"), False) == "skip"
    assert sentinel.observe(float("nan"), False) == "diverged"
    reason = json.loads(path.read_text())["otherData"]["reason"]
    assert reason.startswith("sentinel-divergence")
    path.unlink()
    try:
        chaos.arm("worker_hang@2")
        assert not chaos.fire("worker_hang") and not path.exists()
        assert chaos.fire("worker_hang")
        assert json.loads(path.read_text())["otherData"]["reason"] == "chaos:worker_hang@2"
    finally:
        chaos.disarm()


def test_every_chaos_point_but_serving_is_consulted():
    import os
    import re

    from paddle_tpu_torch.robustness import chaos

    root = os.path.dirname(paddle_tpu_torch.__file__)
    consulted = set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    src = fh.read()
                consulted |= set(re.findall(r"fire\(\s*[\"']([a-z_]+)[\"']", src))
    # the serving scheduler consults nan_request and serve_slow_client too
    assert chaos.KNOWN_POINTS - consulted == set()
    assert "nothing in the port consults" not in chaos.__doc__


def test_concurrent_commits_of_one_step_from_threads(tmp_path):
    """Two threads of one process (the workers of an in-process fleet)
    commit the same sharded step at once: neither raises, and the manifest
    restores.  Before the repair both wrote one pid-named temporary file,
    and the second rename found it gone."""
    import threading

    from paddle_tpu_torch.checkpoint import CheckpointManager

    d = str(tmp_path)
    errors = []
    for step in range(1, 41):
        for i in range(2):
            CheckpointManager(d).save_shard(step, i, 2, {"w": np.full(64, step, np.float32)})
        barrier = threading.Barrier(2)

        def commit(step=step):
            barrier.wait()
            try:
                assert CheckpointManager(d).commit(step, 2, extra={"pass_id": step})
            except Exception as exc:  # noqa: BLE001 — collected and asserted below
                errors.append(repr(exc))

        threads = [threading.Thread(target=commit) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert errors == []
    step, tree, extra = CheckpointManager(d).restore_latest({"w": np.zeros(64, np.float32)})
    assert step == 40 and extra["pass_id"] == 40 and np.all(tree["w"] == 40)


def test_save_model_and_cloud_reader_share_a_master_with_the_jax_package(tmp_path):
    """save_model(master=...) and cloud_reader, which raised before the
    master plane was ported, against the JAX package on the same master:
    a JAX trainer and a port trainer ask one port master for the save and
    exactly one wins; a JAX reader and a port reader lease from one JAX
    master and split its shards between them."""
    import threading

    from paddle_tpu import master as jmaster
    from paddle_tpu import model as jmodel
    from paddle_tpu.reader import creator as jcreator
    from paddle_tpu_torch import master as tmaster
    from paddle_tpu_torch import model as tmodel
    from paddle_tpu_torch.reader import creator as tcreator

    jparams = paddle_tpu.parameters.create(_pruned_net(paddle_tpu), seed=3)
    tparams = paddle_tpu_torch.parameters.create(_pruned_net(paddle_tpu_torch), seed=3,
                                                 device="cpu")
    srv = tmaster.Server(tmaster.Service())
    try:
        saved = [jmodel.save_model(jparams, str(tmp_path / "j"), master=srv.address),
                 tmodel.save_model(tparams, str(tmp_path / "t"), master=srv.address)]
    finally:
        srv.close()
    assert saved[0] is not None and saved[1] is None  # one grant per window

    from paddle_tpu_torch.dataset import common as tcommon

    samples = [(np.arange(i, i + 3, dtype=np.float32), i) for i in range(40)]
    tcommon.convert(str(tmp_path / "d"), lambda: iter(samples), 5, "shard")
    pattern = str(tmp_path / "d" / "shard-*")
    srv = jmaster.Server(jmaster.Service(chunks_per_task=1, auto_rotate=False))
    got = {}
    try:
        def read(name, creator):
            got[name] = list(creator.cloud_reader(pattern, srv.address, buf_size=1)())

        threads = [threading.Thread(target=read, args=(n, c))
                   for n, c in (("jax", jcreator), ("port", tcreator))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        srv.close()
    labels = sorted(int(s[1]) for s in got["jax"] + got["port"])
    assert labels == list(range(40))


def test_generation_step_products_do_not_depend_on_the_padded_extent():
    """Repair (found on the card by chip_smoke.py phase 24a.1): the fused
    generation step took its attention scores as one product over all B * S
    rows, and cuBLAS rounds a row by M, so a short request decoded in a
    batch padded to a long prompt's page rung left the one-shot path.  Every
    product of the step now has the same shape whatever S."""
    from torch.overrides import TorchFunctionMode

    from paddle_tpu_torch.ops.rnn import attention_gru_step

    class Shapes(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ("matmul", "__matmul__", "mm", "mv", "addmm",
                                                  "bmm"):
                self.seen.add(tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor)))
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(0)
    b, h, e, p = 4, 6, 10, 5
    w1, v = torch.randn(h, p + 2 * h, generator=g), torch.randn(p, generator=g)
    w_ctx, w_c = torch.randn(e, 3 * h, generator=g), torch.randn(h, h, generator=g)
    xg, h0 = torch.randn(b, 3 * h, generator=g), torch.randn(b, h, generator=g)
    shapes, outs = [], []
    for s in (16, 512):
        enc, ep = torch.randn(b, s, e, generator=g), torch.randn(b, s, p, generator=g)
        enc[:, :16], ep[:, :16] = outs[0][1] if outs else (enc[:, :16], ep[:, :16])
        emask = torch.arange(s)[None, :] < torch.tensor([16, 9, 3, 12])[:, None]
        with Shapes() as mode:
            out = attention_gru_step(xg, h0, enc, ep, emask, w1, v, w_ctx, w_c)
        shapes.append(mode.seen)
        outs.append((out, (enc[:, :16].clone(), ep[:, :16].clone())))
    assert shapes[0] == shapes[1], shapes
    assert torch.equal(outs[0][0], outs[1][0])
