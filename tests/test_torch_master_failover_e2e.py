"""The port's master failover as real processes: kill -9 the leader
master (``python -m paddle_tpu_torch master --chaos kill_master@8``)
mid-pass under a live 4-worker fleet, the drill of the JAX package's
``test_master_failover_e2e.py``.

The leader journals every queue transition before acking it; an
in-process standby tails snapshot + journal into a live replica and takes
over warm: task leases and result payloads intact, the workers ride
through the bounce, the pass completes with zero recomputed tasks, and the
final parameters equal an uninterrupted 4-worker run's and an N=1 run's
bit for bit.

Every test spawns several Python processes, so the file is marked slow,
as the JAX package's is (tier-1 runs ``-m "not slow"``)."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.io import recordio
from paddle_tpu_torch.master_ha import HAMaster, discover_endpoint
from paddle_tpu_torch.trainer.elastic import NumpyLinearModel

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 8
TASKS_PER_PASS = 12  # 96 records / 4 per chunk = 24 chunks at 2/task
PASSES = 2

# one service-kw set shared by every master candidate in a drill: the
# standby must replay the leader's journal into an identically-configured
# replica.  lease_timeout is WIDE on purpose: a scheduling stall on a
# loaded 2-core box must never let the standby steal leadership from a
# HEALTHY leader mid-drill (renew runs every lease_timeout/3) — the
# dual-leader window would re-serve tasks the deposed side already acked
# and break the zero-recompute accounting this drill exists to prove
MASTER_KW = dict(chunks_per_task=2, timeout_s=30.0, worker_timeout_s=10.0,
                 auto_rotate=False, lease_timeout=6.0)


def _write_dataset(path, n=96, seed=0):
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


def _env():
    # one BLAS thread per spawned process: 6 processes on a small box must
    # not starve the leader's renew thread into a spurious lease expiry
    return dict(
        os.environ, OMP_NUM_THREADS="1",
        OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1",
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )


def _spawn_workers(d, n):
    return [
        subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.trainer.elastic",
             "--dir", os.path.join(d, "ha"), "--worker-id", f"w{i}",
             "--num-passes", str(PASSES), "--model", "numpy",
             "--model-arg", f"dim={DIM}", "--model-arg", "lr=0.2",
             "--min-workers", str(n),
             "--checkpoint-dir", os.path.join(d, "ck"),
             "--stats-out", os.path.join(d, "stats-{worker}.json")],
            env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )
        for i in range(n)
    ]


def _collect(d, n, procs):
    # communicate() drains stderr WHILE waiting: a worker riding a long
    # bounce logs a retry line per backoff step, and a never-read PIPE
    # blocks it at ~64KB — wait()-then-read would deadlock the drill
    errs = {}
    rcs = []
    for i, p in enumerate(procs):
        _out, err = p.communicate(timeout=180)
        rcs.append(p.returncode)
        errs[i] = err.decode()[-2000:]
    stats = {}
    for i in range(n):
        p = os.path.join(d, f"stats-w{i}.json")
        if os.path.exists(p):
            with open(p) as f:
                stats[i] = json.load(f)
    restored = CheckpointManager(os.path.join(d, "ck")).restore_latest(
        NumpyLinearModel(DIM).state()
    )
    return rcs, errs, stats, restored


def _run_clean(d, n):
    """Uninterrupted reference fleet against an in-process HA master."""
    os.makedirs(d, exist_ok=True)
    data = os.path.join(d, "data.rio")
    _write_dataset(data)
    ha = HAMaster(os.path.join(d, "ha"), [data], owner_id="ref", **MASTER_KW)
    ha.start()
    assert ha.wait_leader(30)
    try:
        rcs, errs, stats, restored = _collect(d, n, _spawn_workers(d, n))
        master_stats = ha.service.stats() if ha.service else None
    finally:
        ha.stop()
    assert rcs == [0] * n, errs
    return stats, restored, master_stats


def test_kill_leader_mid_pass_warm_takeover_zero_recompute(tmp_path):
    """The headline acceptance drill."""
    # -- references: uninterrupted N=4 and N=1 ---------------------------
    stats4, res4, mst4 = _run_clean(str(tmp_path / "clean4"), 4)
    assert mst4["fail_events"] == 0 and res4 is not None
    stats1, res1, _ = _run_clean(str(tmp_path / "clean1"), 1)

    # -- the drill: subprocess leader armed to die at the 8th ack --------
    d = str(tmp_path / "killed")
    os.makedirs(d)
    data = os.path.join(d, "data.rio")
    _write_dataset(data)
    hadir = os.path.join(d, "ha")
    leader = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "master",
         "--dir", hadir, "--patterns", data,
         "--chunks-per-task", "2", "--timeout-s", "30",
         "--worker-timeout-s", "10", "--lease-timeout", "6",
         "--chaos", "kill_master@8"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    standby = HAMaster(hadir, [data], owner_id="standby", **MASTER_KW)
    procs = []
    try:
        deadline = time.time() + 60
        while discover_endpoint(hadir) is None:
            assert leader.poll() is None, leader.stdout.read()[-2000:]
            assert time.time() < deadline, "no leader endpoint appeared"
            time.sleep(0.1)
        standby.start()
        # the takeover must be WARM: wait until the standby's replica has
        # loaded the leader's journal-anchored snapshot before any worker
        # does real work
        deadline = time.time() + 20
        while standby._replica is None:
            assert time.time() < deadline, "standby never built a replica"
            time.sleep(0.05)

        procs = _spawn_workers(d, 4)
        t_kill = None
        deadline = time.time() + 120
        while leader.poll() is None:
            assert time.time() < deadline, "kill_master chaos never fired"
            time.sleep(0.01)
        t_kill = time.time()
        assert leader.returncode == -signal.SIGKILL  # chaos killed it hard

        rcs, errs, stats, restored = _collect(d, 4, procs)
        assert rcs == [0, 0, 0, 0], errs  # the fleet rode through the bounce
        assert standby.is_leader.is_set()
        takeover = standby.last_takeover
        t_takeover = takeover["t_leader"] - t_kill
        master_stats = standby.service.stats()
        jdir = os.path.dirname(standby.service.snapshot_path)
        snap = json.load(open(standby.service.snapshot_path))
        jpath = os.path.join(jdir, snap["journal_file"])
    finally:
        standby.stop()
        if leader.poll() is None:
            leader.kill()
        leader.communicate()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    # -- warm takeover, bounded replay, zero recompute -------------------
    assert takeover["warm"] is True
    assert takeover["replayed_records"] > 0
    assert t_takeover < 30.0  # lease timeout + campaign + replay, not a hang
    # every task of every pass was computed EXACTLY once fleet-wide: the
    # journal preserved finished results AND in-flight leases, so nothing
    # recomputed (a recompute would add an extra accepted ack somewhere)
    total_acks = sum(s["tasks_done"] for s in stats.values())
    assert total_acks == TASKS_PER_PASS * PASSES
    assert master_stats["fail_events"] == 0  # no lease ever expired
    # every pass completed: the queue state matches the uninterrupted
    # run's (the final pass's boundary is deliberately never rotated)
    assert master_stats["pass_id"] == mst4["pass_id"]
    assert master_stats["n_done"] == TASKS_PER_PASS
    assert master_stats["n_todo"] == 0 and master_stats["n_pending"] == 0

    # -- bit-for-bit params vs uninterrupted N=4 and N=1 -----------------
    assert restored is not None
    for ref in (res4, res1):
        assert np.array_equal(restored[1]["w"], ref[1]["w"])
        assert np.array_equal(restored[1]["b"], ref[1]["b"])
    # cost trajectories agree wherever both logged them
    ref_costs = stats4[0]["pass_costs"]
    for i, s in stats.items():
        tail = s["pass_costs"]
        assert tail == ref_costs[len(ref_costs) - len(tail):], f"worker {i}"

    # -- and the surviving journal generation lints clean ----------------
    from paddle_tpu_torch.master_journal import verify_journal

    assert verify_journal(jpath) == []


def test_cli_master_stats_out_records_takeover(tmp_path):
    """`python -m paddle_tpu_torch master --stats-out`: each leadership assumption appends
    one JSON line with the warm/cold flag, replayed-record count and
    takeover span — the observables the failover bench commits."""
    d = str(tmp_path)
    data = os.path.join(d, "data.rio")
    _write_dataset(data)
    stats_path = os.path.join(d, "master-stats.jsonl")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "master",
         "--dir", os.path.join(d, "ha"), "--patterns", data,
         "--chunks-per-task", "2", "--lease-timeout", "1",
         "--stats-out", stats_path],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    try:
        deadline = time.time() + 60
        while not os.path.exists(stats_path):
            assert proc.poll() is None, proc.stdout.read()[-2000:]
            assert time.time() < deadline, "no takeover stats appeared"
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-2000:]
    rec = json.loads(open(stats_path).readline())
    assert rec["warm"] is False  # first leader of a fresh cluster: cold
    assert rec["replayed_records"] == 0
    assert rec["takeover_s"] >= 0 and "t_leader" in rec
