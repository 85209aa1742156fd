"""The port's elastic fleets as real worker processes, with real SIGKILLs
and torn state: the drills of the JAX package's ``test_elastic_e2e.py`` on
``python -m paddle_tpu_torch.trainer.elastic`` workers (numpy model, and
the ``mlp`` trainer model on the CPU) under an in-process port HA master.

Kill -9 one of N mid-pass (holding a shard lease): its registry lease
expires, its shard leases requeue to survivors, the pass fence releases
over the live membership, and the final parameters equal an uninterrupted
run's bit for bit (and an N=1 run's).  A hung worker is pruned and
rejoins; a stopped fleet resumes from its committed manifest; the CLI's
master serves a worker.

Every test spawns several Python processes (each imports torch), so the
file is marked slow, as the JAX package's is: tier-1 runs ``-m "not
slow"``; run it with ``python -m pytest tests/test_torch_elastic_e2e.py``."""

import json
import os
import signal
import sys

import numpy as np
import pytest

from paddle_tpu_torch import launcher
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.io import recordio
from paddle_tpu_torch.master_ha import HAMaster
from paddle_tpu_torch.trainer.elastic import NumpyLinearModel

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 8


def _write_dataset(path, n=96, seed=0):
    """Deterministic regression records [x..., y] — 24 chunks at 4
    records/chunk => 12 tasks at chunks_per_task=2."""
    rng = np.random.RandomState(seed)
    w_true = rng.randn(DIM).astype(np.float32)
    recs = []
    for _ in range(n):
        x = rng.randn(DIM).astype(np.float32)
        recs.append(
            np.concatenate([x, [np.float32(x @ w_true)]])
            .astype(np.float32).tobytes()
        )
    recordio.write_records(path, iter(recs), max_chunk_records=4)


def _start_master(d, data, **kw):
    kw.setdefault("lease_timeout", 2.0)
    kw.setdefault("chunks_per_task", 2)
    kw.setdefault("timeout_s", 30.0)
    # wide enough that a scheduling stall on a loaded 2-core box never
    # spuriously prunes a healthy worker (the clean run asserts
    # fail_events == 0), small enough that a real death costs seconds
    kw.setdefault("worker_timeout_s", 3.0)
    kw.setdefault("snapshot_min_interval_s", 0.0)
    ha = HAMaster(
        os.path.join(d, "ha"), [data], owner_id="test-master",
        auto_rotate=False, **kw,
    )
    ha.start()
    assert ha.wait_leader(30)
    return ha


def _worker_args(d, num_passes, n, extra=()):
    """One argv serves the whole fleet: the worker id comes from the
    launcher's PADDLE_TPU_TORCH_PROCESS_ID env and the stats path expands
    {worker}.  --min-workers=n gang-starts the fleet: python boot skew on
    a loaded box must not let the first worker race through whole (tiny)
    passes alone before its peers register."""
    return [
        "paddle_tpu_torch.trainer.elastic",
        "--dir", os.path.join(d, "ha"),
        "--num-passes", str(num_passes), "--model", "numpy",
        "--model-arg", f"dim={DIM}", "--model-arg", "lr=0.2",
        "--min-workers", str(n),
        "--checkpoint-dir", os.path.join(d, "ck"),
        "--stats-out", os.path.join(d, "stats-{worker}.json"),
        *extra,
    ]


def _run_fleet(d, n, num_passes=3, chaos=None, master_kw=None, extra=()):
    """Launch n elastic worker processes through launcher.launch(elastic=
    True) — "python -m paddle_tpu_torch.trainer.elastic" per local host entry;
    returns (rc, exit_codes, master stats, restored params, worker
    stats)."""
    os.makedirs(d, exist_ok=True)
    data = os.path.join(d, "data.rio")
    if not os.path.exists(data):
        _write_dataset(data)
    ha = _start_master(d, data, **(master_kw or {}))
    try:
        base_env = {
                        "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        }
        extra_env = {i: dict(base_env) for i in range(n)}
        for i, spec in (chaos or {}).items():
            extra_env[i].update(spec)
        codes: list = []
        # the "-m module" spelling rides the launcher's [python, script,
        # *args] command shape unchanged
        rc = launcher.launch(
            ["localhost"] * n, "127.0.0.1:0", "-m",
            _worker_args(d, num_passes, n, extra=extra),
            elastic=True, extra_env=extra_env, exit_codes=codes,
        )
        stats = ha.service.stats() if ha.service else None
    finally:
        ha.stop()
    worker_stats = {}
    for i in range(n):
        p = os.path.join(d, f"stats-w{i}.json")
        if os.path.exists(p):
            with open(p) as f:
                worker_stats[i] = json.load(f)
    mgr = CheckpointManager(os.path.join(d, "ck"))
    restored = mgr.restore_latest(NumpyLinearModel(DIM).state())
    return rc, codes, stats, restored, worker_stats


def test_kill_one_of_four_mid_pass_matches_uninterrupted_bitwise(tmp_path):
    """The headline acceptance: N=4, kill -9 worker 2 as it takes its 1st
    task (HOLDING the shard lease, mid-pass — @1 so the drill fires even
    when scheduling skew makes the victim a straggler that never reaches a
    2nd lease).  Its leases requeue to survivors after one lease timeout
    (fail_events >= 1), the pass completes, and the final committed params
    equal the uninterrupted N=4 run's bit-for-bit."""
    rc1, codes1, st1, res1, ws1 = _run_fleet(str(tmp_path / "clean"), 4)
    assert rc1 == 0 and codes1 == [0, 0, 0, 0]
    assert st1["fail_events"] == 0
    assert res1 is not None

    rc2, codes2, st2, res2, ws2 = _run_fleet(
        str(tmp_path / "killed"), 4,
        chaos={2: {"PADDLE_TPU_TORCH_CHAOS": "kill_worker@1"}},
    )
    assert rc2 == 0  # elastic: the job survives the kill
    assert codes2[2] == -signal.SIGKILL  # died hard, no cleanup
    assert sum(1 for c in codes2 if c == 0) == 3  # every survivor finished
    assert 2 not in ws2  # the dead worker never wrote its summary
    assert st2["fail_events"] >= 1  # the lease-timeout requeue happened
    assert st2["n_discarded"] == 0  # requeue, not discard
    assert st2["pass_id"] == st1["pass_id"]  # the pass(es) completed

    step1, tree1, _ = res1
    step2, tree2, _ = res2
    assert step1 == step2 == 3
    assert np.array_equal(tree1["w"], tree2["w"])
    assert np.array_equal(tree1["b"], tree2["b"])
    # and the cost trajectories agree wherever both logged them
    costs1 = ws1[0]["pass_costs"]
    for i, ws in ws2.items():
        tail = ws["pass_costs"]
        assert tail == costs1[len(costs1) - len(tail):], f"worker {i}"


def test_single_worker_matches_fleet_bitwise(tmp_path):
    """N-invariance: the task-ordered reduction makes N=1 and N=4 runs
    bit-identical — the property that lets membership change freely."""
    _, codes1, _, res1, _ = _run_fleet(str(tmp_path / "n1"), 1)
    _, codes4, _, res4, _ = _run_fleet(str(tmp_path / "n4"), 4)
    assert codes1 == [0] and codes4 == [0, 0, 0, 0]
    assert np.array_equal(res1[1]["w"], res4[1]["w"])
    assert np.array_equal(res1[1]["b"], res4[1]["b"])


def test_worker_hang_is_pruned_then_rejoins(tmp_path):
    """A stalled-but-alive worker (full-process freeze, heartbeats
    included): its leases expire and the fleet finishes without it; on
    waking, its stale acks are rejected by epoch and it catches the fleet
    back up (retained results / committed manifest) instead of forking the
    trajectory."""
    rc, codes, st, res, ws = _run_fleet(
        str(tmp_path / "hang"), 3, num_passes=2,
        chaos={1: {"PADDLE_TPU_TORCH_CHAOS": "worker_hang@1",
                   "PADDLE_TPU_TORCH_CHAOS_HANG_SECS": "6"}},
    )
    assert codes == [0, 0, 0], codes  # the hung worker still exits clean
    assert st["fail_events"] >= 1  # its held lease walked the requeue path
    _, codes_ref, _, res_ref, _ = _run_fleet(
        str(tmp_path / "ref"), 3, num_passes=2
    )
    assert codes_ref == [0, 0, 0]
    assert np.array_equal(res[1]["w"], res_ref[1]["w"])
    # the hung worker observed its zombie ack being rejected OR returned
    # its stale lease gracefully — either way it reports rejoining
    assert 1 in ws


def test_sharded_resume_reproduces_uninterrupted_trajectory(tmp_path):
    """Stop the whole cluster at a pass boundary, restart with --resume:
    the master recovers its queues from the snapshot, workers restore the
    latest committed manifest, and the remaining passes' costs and final
    params are bit-for-bit the uninterrupted run's."""
    # uninterrupted reference: 4 passes in one go
    _, codes_a, _, res_a, ws_a = _run_fleet(
        str(tmp_path / "ref"), 2, num_passes=4
    )
    assert codes_a == [0, 0]
    ref_costs = ws_a[0]["pass_costs"]
    assert len(ref_costs) == 4

    # phase 1: 2 passes, clean stop
    d = str(tmp_path / "resumed")
    _, codes_b, _, _, _ = _run_fleet(d, 2, num_passes=2)
    assert codes_b == [0, 0]

    # phase 2: same dirs, --resume, 2 more passes (master recovers its
    # snapshot; workers restore the manifest and rotate past pass 1)
    _, codes_c, _, _, ws_c = _run_fleet(
        d, 2, num_passes=4, extra=("--resume",)
    )
    assert codes_c == [0, 0]
    resumed = ws_c[0]
    # the resumed phase logged exactly the tail passes, bit-for-bit
    assert resumed["pass_costs"] == ref_costs[2:]
    mgr = CheckpointManager(os.path.join(d, "ck"))
    step, tree, _ = mgr.restore_latest(NumpyLinearModel(DIM).state())
    assert step == 4
    assert np.array_equal(tree["w"], res_a[1]["w"])
    assert np.array_equal(tree["b"], res_a[1]["b"])


def test_cli_master_candidate_serves_and_stops(tmp_path):
    """`python -m paddle_tpu_torch master` runs an HA candidate: it wins the lease, prints
    LEADER with its endpoint, serves an elastic worker, and exits 0 on
    SIGTERM."""
    import subprocess
    import time

    d = str(tmp_path)
    data = os.path.join(d, "data.rio")
    _write_dataset(data)
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "master",
         "--dir", os.path.join(d, "ha"), "--patterns", data,
         "--chunks-per-task", "2", "--worker-timeout-s", "5"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        from paddle_tpu_torch.master_ha import discover_endpoint

        deadline = time.time() + 60
        while time.time() < deadline:
            if discover_endpoint(os.path.join(d, "ha")) is not None:
                break
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            time.sleep(0.2)
        else:
            pytest.fail("no leader endpoint appeared")
        # a worker trains one pass against the CLI-served master
        rc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.trainer.elastic",
             "--dir", os.path.join(d, "ha"), "--num-passes", "1",
             "--model", "numpy", "--model-arg", f"dim={DIM}"],
            env=env, capture_output=True, text=True, timeout=120,
        )
        assert rc.returncode == 0, rc.stderr[-2000:]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert "LEADER" in out


def test_trainer_fleet_two_workers_matches_single(tmp_path):
    """The real training stack across processes: make_grad_step +
    Momentum optimizer (SGD.elastic_model) on a paddle
    MLP, 2 worker processes vs 1 — final params and per-pass costs must be
    bit-identical (pass-synchronous reduction is membership-invariant)."""
    import subprocess

    def fleet(tag, n):
        d = str(tmp_path / tag)
        os.makedirs(d)
        data = os.path.join(d, "data.rio")
        rng = np.random.RandomState(7)
        centers = rng.randn(4, DIM).astype(np.float32) * 2.0
        recs = []
        for i in range(64):
            v = (centers[i % 4] + 0.3 * rng.randn(DIM)).astype(np.float32)
            recs.append(
                np.concatenate([v, [np.float32(i % 4)]])
                .astype(np.float32).tobytes()
            )
        recordio.write_records(data, iter(recs), max_chunk_records=4)
        ha = _start_master(d, data, timeout_s=120.0, worker_timeout_s=20.0)
        try:
            env = dict(os.environ,
                       PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs = [
                subprocess.Popen(
                    [sys.executable, "-m", "paddle_tpu_torch.trainer.elastic",
                     "--dir", os.path.join(d, "ha"),
                     "--worker-id", f"w{i}", "--num-passes", "2",
                     "--model", "mlp", "--seed", "5",
                     "--model-arg", f"dim={DIM}", "--model-arg", "classes=4",
                     "--model-arg", "hidden=16", "--model-arg", "lr=0.1",
                     "--model-arg", "device=cpu",
                     "--min-workers", str(n),
                     "--stats-out", os.path.join(d, f"stats{i}.json")],
                    env=env,
                )
                for i in range(n)
            ]
            assert [p.wait() for p in procs] == [0] * n
        finally:
            ha.stop()
        with open(os.path.join(d, "stats0.json")) as f:
            return json.load(f)["pass_costs"]

    costs1 = fleet("n1", 1)
    costs2 = fleet("n2", 2)
    assert costs1 == costs2
    assert costs1[-1] < costs1[0]  # and it actually learns
