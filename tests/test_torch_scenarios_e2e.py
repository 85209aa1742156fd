"""The port's scenario drills over real process fleets (slow), twins of
tests/test_scenarios_e2e.py: chaos fired under live mixed train+serve
traffic, and the ``serve`` SIGTERM graceful-drain contract.

An elastic fleet trains over the HA master plane while this process serves
open-loop deadline traffic on a CPU engine; SIGKILL one worker, then the
leader master, and assert recovery, final parameters bit-identical to the
unfaulted reference, zero recomputed tasks for the master bounce, and a
serving ledger of served/shed/timeout only.  The serving-fleet drills (a
kill and a rolling restart of ``serve --register --device cpu`` engine
processes) run through ``run_scenario`` too.  These spawn process fleets,
so the whole module is slow-marked (tests/test_torch_hygiene.py checks the
mark)."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from paddle_tpu_torch.robustness import scenarios

pytestmark = pytest.mark.slow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fleet_chaos_kill_worker_and_master_under_live_traffic(tmp_path):
    """One unfaulted reference fleet, then both fleet faults, sharing the
    reference and the prewarmed CPU serving engine."""
    ref = scenarios.fleet_reference(str(tmp_path / "reference"))
    engine = scenarios.make_serving_engine(seed=0, device="cpu")

    worker = scenarios.run_fleet_chaos(str(tmp_path), kill="kill_worker", reference=ref,
                                       engine=engine)
    assert worker["train_params_bit_identical"], worker
    assert worker["only_shed_or_timeout_failed"], worker
    assert worker["master_fail_events"] >= 1  # the lease requeue happened
    assert worker["recovery_after_fault_s"] < 120.0
    assert worker["passed"], worker

    master = scenarios.run_fleet_chaos(str(tmp_path), kill="kill_master", reference=ref,
                                       engine=engine)
    assert master["train_params_bit_identical"], master
    assert master["only_shed_or_timeout_failed"], master
    assert master["zero_recomputed_tasks"], master
    assert master["master_fail_events"] == 0
    assert master["takeover"]["warm"] is True
    assert master["takeover"]["replayed_records"] > 0
    assert master["recovery_after_fault_s"] < 30.0
    assert master["passed"], master


@pytest.mark.parametrize("name", ["fleet_serving", "fleet_rolling_restart"])
def test_serving_fleet_drills_on_cpu_engines(tmp_path, name):
    r = scenarios.run_scenario(name, workdir=str(tmp_path), device="cpu")
    assert r["double_served"] == 0, r
    assert sum(r["statuses"].values()) == r["n_offered"]
    assert r["passed"], r


def _spawn_serve(extra, n=400, rate=3.0):
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", "--device", "cpu",
         "--src-vocab", "50", "--trg-vocab", "50", "--word-dim", "8",
         "--hidden-dim", "12", "--max-length", "8",
         "--synthetic", str(n), "--rate", str(rate), *extra],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def test_serve_sigterm_drains_clean_and_exits_zero():
    """SIGTERM mid-traffic: stop admitting, finish every in-flight request,
    exit 0, with zero 'unfinished' and drained_clean in the summary."""
    p = _spawn_serve(["--deadline-s", "30"])
    lines = []
    deadline = time.time() + 180
    try:
        while time.time() < deadline:
            line = p.stdout.readline()
            if not line:
                break
            lines.append(line)
            if sum(1 for ln in lines if '"req"' in ln) >= 3:
                break
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=120)
        lines += out.splitlines()
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate(timeout=30)
    assert p.returncode == 0, "".join(lines)[-2000:]
    summary = json.loads([ln for ln in lines if '"drained_clean"' in ln][-1])
    assert summary["drained_clean"] is True
    assert summary["unfinished"] == 0
    assert summary["served"] >= 3
    for ln in lines:
        if '"req"' in ln:
            rec = json.loads(ln)
            assert rec["status"] in ("served", "shed", "rejected", "timeout"), rec


def test_serve_second_sigterm_still_kills():
    """The first signal drains, a second falls through to the default
    handler: a wedged drain can always be killed."""
    p = _spawn_serve([], n=10_000, rate=2.0)
    try:
        deadline = time.time() + 180
        got = False
        while time.time() < deadline:
            line = p.stdout.readline()
            if not line:
                break
            if '"req"' in line:
                got = True
                break
        assert got, "server never served a request"
        p.send_signal(signal.SIGTERM)
        p.send_signal(signal.SIGTERM)
        p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate(timeout=30)
    assert p.returncode is not None
