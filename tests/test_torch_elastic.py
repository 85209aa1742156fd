"""The port's elastic trainer against the JAX package's.

In-process fleets (one thread per worker, one ``master.Service``) of the
port's ``ElasticWorker`` over ``NumpyLinearModel`` end bit-identical at N
= 1, 2 and 4, to each other and to the JAX package's fleet on the same
records; so does a mixed fleet (a JAX worker and a port worker under one
master, of either package), and so do quantized-gradient fleets at N = 1
and 2.  Sharded manifests written by either package's fleet restore in the
other's ``CheckpointManager``.  ``TrainerTaskModel`` over the ``mlp`` of
``_build_model`` on the CPU, from the JAX parameters, gives one task's
gradients within 1e-5 (relative L2, f32) and a 2-pass trajectory within
1e-4.  One subprocess drill (2 numpy workers, ``kill_worker@2``) ends
equal to the clean run; the other process drills are in
``test_torch_elastic_e2e.py`` (slow)."""

import os
import signal
import threading
import time

import numpy as np
import pytest

from paddle_tpu import master as jmaster
from paddle_tpu.checkpoint import CheckpointManager as JCkpt
from paddle_tpu.io import recordio as jrecordio
from paddle_tpu.trainer import elastic as jel
from paddle_tpu_torch import launcher, master as tmaster
from paddle_tpu_torch.checkpoint import CheckpointManager as TCkpt
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.master_ha import HAMaster
from paddle_tpu_torch.ops import quantize as tq
from paddle_tpu_torch.trainer import elastic as tel
from paddle_tpu_torch.utils import flags as tflags
from test_torch_parity import numpy_tree, rel_l2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 8


def _regression(path, n=96, seed=0):
    """Records [x..., y] of float32: 24 chunks of 4, so 12 tasks at
    chunks_per_task 2."""
    rng = np.random.RandomState(seed)
    w_true = rng.randn(DIM).astype(np.float32)
    recs = []
    for _ in range(n):
        x = rng.randn(DIM).astype(np.float32)
        recs.append(np.concatenate([x, [np.float32(np.tanh(x @ w_true))]]).astype(np.float32)
                    .tobytes())
    jrecordio.write_records(path, iter(recs), max_chunk_records=4)


def _classes(path, n=64, seed=7):
    rng = np.random.RandomState(seed)
    centers = rng.randn(4, DIM).astype(np.float32) * 2.0
    recs = [np.concatenate([(centers[i % 4] + 0.3 * rng.randn(DIM)).astype(np.float32),
                            [np.float32(i % 4)]]).astype(np.float32).tobytes()
            for i in range(n)]
    jrecordio.write_records(path, iter(recs), max_chunk_records=4)


def _service(mmod, d, data):
    svc = mmod.Service(snapshot_path=os.path.join(d, "snap.json"), chunks_per_task=2,
                       auto_rotate=False, snapshot_min_interval_s=0.0, worker_timeout_s=60.0)
    svc.set_dataset([data])
    return svc


def _run_threads(workers, passes):
    results, errors = {}, []

    def run(w):
        try:
            results[w.worker_id] = w.run(passes)
        except Exception as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(w,)) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert set(results) == {w.worker_id for w in workers}
    return results


def _fleet(tmp_path, tag, emods, passes=3, quantized=False, ckpt_mod=None, make_model=None,
           server_mod=None):
    """A fleet of len(emods) workers, worker i from elastic module
    emods[i], under one master of `server_mod` (in-process Service, or
    over a Server when the fleet mixes packages).  Returns (results, final
    model states by worker, checkpoint dir)."""
    d = str(tmp_path / tag)
    os.makedirs(d)
    data = os.path.join(d, "data.rio")
    _regression(data)
    mmod = server_mod or (tmaster if emods[0] is tel else jmaster)
    svc = _service(mmod, d, data)
    srv = mmod.Server(svc) if server_mod is not None else None
    ck = os.path.join(d, "ck")
    workers = []
    for i, emod in enumerate(emods):
        cmod = tmaster if emod is tel else jmaster
        client = cmod.Client(srv.address if srv else svc)
        model = (make_model or (lambda e: e.NumpyLinearModel(DIM, lr=0.2, hidden=6, seed=3)))(emod)
        manager = None if ckpt_mod is None else ckpt_mod(ck)
        workers.append(emod.ElasticWorker(client, f"w{i}", model, manager=manager,
                                          poll_s=0.002, min_workers=len(emods),
                                          quantized_grads=quantized))
    try:
        results = _run_threads(workers, passes)
    finally:
        if srv is not None:
            srv.close()
    return results, {w.worker_id: w.model.state() for w in workers}, ck


def _assert_states_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    res, states, _ = _fleet(tmp_path_factory.mktemp("jref"), "jax", [jel])
    return res["w0"]["pass_costs"], states["w0"]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_port_fleet_is_bit_identical_at_every_n_and_to_jax(tmp_path, jax_reference, n):
    costs_ref, state_ref = jax_reference
    results, states, _ = _fleet(tmp_path, f"n{n}", [tel] * n)
    assert sum(r["tasks_done"] for r in results.values()) == 12 * 3
    for wid, state in states.items():
        _assert_states_equal(state, state_ref)
        assert results[wid]["pass_costs"] == costs_ref
    assert costs_ref[-1] < costs_ref[0]


@pytest.mark.parametrize("server_mod", [tmaster, jmaster], ids=["port-master", "jax-master"])
def test_mixed_fleet_is_bit_identical(tmp_path, jax_reference, server_mod):
    """One JAX worker and one port worker lease from one master over the
    wire and reduce each other's contributions."""
    costs_ref, state_ref = jax_reference
    results, states, _ = _fleet(tmp_path, "mixed", [jel, tel], server_mod=server_mod)
    assert all(r["tasks_done"] > 0 for r in results.values())
    for wid, state in states.items():
        _assert_states_equal(state, state_ref)
        assert results[wid]["pass_costs"] == costs_ref


def test_quantized_fleets_match_across_n_and_packages(tmp_path):
    def wide(emod):
        return emod.NumpyLinearModel(DIM, lr=0.2, hidden=128, seed=3)

    r1, s1, _ = _fleet(tmp_path, "q1", [tel], quantized=True, make_model=wide)
    r2, s2, _ = _fleet(tmp_path, "q2", [tel, tel], quantized=True, make_model=wide)
    rj, sj, _ = _fleet(tmp_path, "qj", [jel], quantized=True, make_model=wide)
    rf, _, _ = _fleet(tmp_path, "f1", [tel], quantized=False, passes=1, make_model=wide)
    for state in list(s2.values()) + [sj["w0"]]:
        _assert_states_equal(state, s1["w0"])
    assert r2["w1"]["pass_costs"] == r1["w0"]["pass_costs"] == rj["w0"]["pass_costs"]
    assert r1["w0"]["quantized_grads"] and not rf["w0"]["quantized_grads"]
    # the int8 payload of a pass is under a third of the f32 one
    per_pass_q = r1["w0"]["grad_payload_bytes"] / 3
    assert per_pass_q < rf["w0"]["grad_payload_bytes"] / 3


def test_quantizer_and_reduction_bytes_equal_jax():
    from paddle_tpu.ops import quantize as jq

    rng = np.random.RandomState(5)
    tree = {"fc": {"w": rng.randn(37, 11).astype(np.float32), "b": rng.randn(11).astype(np.float32)},
            "s": np.float32(0.5)}
    qt, qj = tq.quantize_tree(tree, 64), jq.quantize_tree(tree, 64)
    for k in ("q", "s"):
        assert np.array_equal(qt["fc"]["w"][k], qj["fc"]["w"][k])
    assert tq.tree_wire_bytes(qt) == jq.tree_wire_bytes(qj)
    results = {t: {"grads": qt if t % 2 else tree, "cost": 0.25 * t, "rows": 3 + t}
               for t in (4, 0, 2, 1)}
    mt, ct, nt = tel.reduce_results(results)
    mj, cj, nj = jel.reduce_results(results)
    assert (ct, nt) == (cj, nj)
    for path in (("fc", "w"), ("fc", "b"), ("s",)):
        a, b = mt, mj
        for k in path:
            a, b = a[k], b[k]
        assert np.array_equal(a, b)
    with pytest.raises(NotImplementedError, match="item 6"):
        tq.quantized_psum(None, "data")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sharded_manifest_restores_in_the_other_package(tmp_path, writer):
    emod, wckpt, rckpt = (tel, TCkpt, JCkpt) if writer == "port" else (jel, JCkpt, TCkpt)
    _, states, ck = _fleet(tmp_path, writer, [emod, emod], passes=2, ckpt_mod=wckpt)
    restored = rckpt(ck).restore_latest(tel.NumpyLinearModel(DIM, hidden=6, seed=3).state())
    assert restored is not None
    step, tree, extra = restored
    assert step == 2 and extra["pass_id"] == 1
    _assert_states_equal(tree, states["w0"])


@pytest.fixture
def cpu_default():
    """``_build_model('mlp')`` calls ``init(device=...)`` as a worker process
    does; give the process-wide default device and flags back after."""
    saved = dict(tflags._VALUES)
    yield
    tdevice._default_device = "cuda"
    tflags._VALUES.clear()
    tflags._VALUES.update(saved)


def _mlp_pair():
    margs = {"dim": str(DIM), "classes": "4", "hidden": "16", "lr": "0.1"}
    jm = jel._build_model("mlp", margs, 5)
    tm = tel._build_model("mlp", {**margs, "device": "cpu"}, 5)
    import paddle_tpu_torch

    t = tm._t
    t.parameters.params = paddle_tpu_torch.parameters.from_numpy(
        numpy_tree(jm._t.parameters.params), device="cpu").params
    t._opt_state = t.optimizer.init(t.parameters.params)
    return jm, tm


def test_trainer_task_model_matches_jax(tmp_path, cpu_default):
    data = str(tmp_path / "c.rio")
    _classes(data)
    with jrecordio.Reader(data) as r:
        recs = list(r)[:16]
    jm, tm = _mlp_pair()
    jg, jcost, jrows = jm.task_grad(recs, 0, 3)
    tg, tcost, trows = tm.task_grad(recs, 0, 3)
    assert jrows == trows == 16
    assert all(v.dtype == np.float32 for layer in tg.values() for v in layer.values())
    assert rel_l2(tg, jg) <= 1e-5
    assert abs(tcost - jcost) <= 1e-5 * abs(jcost)
    # two passes through in-process fleets of one worker each
    finals = []
    for tag, emod, mmod, model in (("j", jel, jmaster, jm), ("t", tel, tmaster, tm)):
        d = str(tmp_path / tag)
        os.makedirs(d)
        svc = _service(mmod, d, data)
        w = emod.ElasticWorker(mmod.Client(svc), "w0", model, poll_s=0.002)
        res = w.run(2)
        assert res["tasks_done"] == 16
        finals.append((res["pass_costs"], numpy_tree(model._t.parameters.params)))
    (jc, jp), (tc, tp) = finals
    assert rel_l2(tp, jp) <= 1e-4
    assert np.allclose(tc, jc, rtol=1e-4)
    assert tc[-1] < tc[0]
    # state()/load() are the trainer's full state
    state = tm.state()
    assert set(state) == {"params", "state", "opt_state", "rng"}
    tm.load(state, {"step_count": 7})
    assert tm._t._step_count == 7


def test_task_seed_depends_on_task_not_worker():
    assert tel.task_seed(1, 2, 3) == tel.task_seed(1, 2, 3)
    assert len({tel.task_seed(1, p, t) for p in range(3) for t in range(5)}) == 15
    assert 0 <= tel.task_seed(9, 9, 9) < 2**62


def test_oversize_contribution_fails_at_once_naming_the_flag(tmp_path):
    """An f32 contribution over the frame bound is a configuration error:
    the worker raises naming rpc_max_message_mb instead of retrying."""
    d = str(tmp_path)
    data = os.path.join(d, "data.rio")
    _regression(data)
    svc = _service(tmaster, d, data)
    srv = tmaster.Server(svc)
    try:
        client = tmaster.Client(srv.address, max_message_bytes=4096)

        class Big(tel.NumpyLinearModel):
            def task_grad(self, records, pass_id, task_id):
                _, cost, rows = super().task_grad(records, pass_id, task_id)
                return {"w": np.zeros(4096, np.float32)}, cost, rows

        w = tel.ElasticWorker(client, "w0", Big(DIM), poll_s=0.002, rpc_retry_window_s=60.0)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rpc_max_message_mb"):
            w.run(1)
        assert time.monotonic() - t0 < 10.0
    finally:
        srv.close()


def test_kill_worker_drill_matches_the_clean_fleet(tmp_path):
    """Two worker processes (numpy model) under an in-process HA master;
    one is SIGKILLed holding its 2nd lease.  Its leases requeue to the
    survivor and the committed manifest equals a clean in-process
    fleet's."""
    _, clean, _ = _fleet(tmp_path, "clean", [tel, tel], passes=2,
                         make_model=lambda e: e.NumpyLinearModel(DIM, lr=0.2))
    d = str(tmp_path / "drill")
    os.makedirs(d)
    data = os.path.join(d, "data.rio")
    _regression(data)
    ha = HAMaster(os.path.join(d, "ha"), [data], owner_id="test", lease_timeout=2.0,
                  chunks_per_task=2, timeout_s=30.0, worker_timeout_s=1.5,
                  snapshot_min_interval_s=0.0, auto_rotate=False)
    ha.start()
    try:
        assert ha.wait_leader(30)
        env = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               "OMP_NUM_THREADS": "1"}
        extra = {0: dict(env), 1: dict(env, PADDLE_TPU_TORCH_CHAOS="kill_worker@2")}
        codes = []
        rc = launcher.launch(
            ["localhost"] * 2, "127.0.0.1:0", "-m",
            ["paddle_tpu_torch.trainer.elastic", "--dir", os.path.join(d, "ha"),
             "--num-passes", "2", "--model", "numpy", "--model-arg", f"dim={DIM}",
             "--model-arg", "lr=0.2", "--min-workers", "2", "--poll-s", "0.01",
             "--checkpoint-dir", os.path.join(d, "ck")],
            elastic=True, extra_env=extra, exit_codes=codes)
        stats = ha.service.stats()
    finally:
        ha.stop()
    assert rc == 0 and codes == [0, -signal.SIGKILL]
    assert stats["fail_events"] >= 1 and stats["n_discarded"] == 0
    step, tree, _ = TCkpt(os.path.join(d, "ck")).restore_latest(
        tel.NumpyLinearModel(DIM).state())
    assert step == 2
    _assert_states_equal(tree, clean["w0"])
