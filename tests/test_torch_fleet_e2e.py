"""The port's fleet drill over real processes (slow): a port ``Router`` in
this process over two ``python -m paddle_tpu_torch serve --register
--device cpu`` engine processes (the tiny NMT from one parameter tar), the
counterpart of tests/test_fleet_serving_e2e.py's scenarios: requests through
``FleetClient`` are served once each with a single engine's tokens; one
engine SIGKILLed under load, its lease pruned, every request finalized in
exactly one terminal status; the survivor drained clean and exiting 0 on
SIGTERM.  Engine processes and wall-clock traffic, so the module is
slow-marked, as the JAX package's drills are."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu_torch
from paddle_tpu_torch.core.topology import reset_auto_names
from paddle_tpu_torch.models.seq2seq import Seq2SeqGenerator, seq2seq_cost
from paddle_tpu_torch.serving import FleetClient, Request, Router, ServingEngine
from paddle_tpu_torch.serving.scheduler import TERMINAL_STATUSES

pytestmark = pytest.mark.slow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, E, H, MAXLEN, SEED = 40, 12, 16, 8, 7


def test_fleet_of_engine_processes_survives_a_kill_and_drains(tmp_path):
    reset_auto_names()
    cost, _ = seq2seq_cost(V, V, word_dim=E, hidden_dim=H)
    params = paddle_tpu_torch.parameters.create(cost, seed=SEED, device="cpu")
    tar = str(tmp_path / "params.tar")
    with open(tar, "wb") as f:
        params.to_tar(f)
    gen = Seq2SeqGenerator(params, V, V, word_dim=E, hidden_dim=H, bos_id=0, eos_id=1,
                           max_length=MAXLEN, device="cpu")
    single = ServingEngine(gen, max_slots=4, hbm_budget_mb=1, max_new_tokens=MAXLEN, device="cpu")

    router = Router(address=("127.0.0.1", 0), lease_timeout_s=3.0, stats_poll_s=0.1,
                    journal_path=str(tmp_path / "journal.jsonl"))
    host, port = router.address
    args = ["--register", f"{host}:{port}", "--model", tar, "--src-vocab", str(V), "--trg-vocab",
            str(V), "--word-dim", str(E), "--hidden-dim", str(H), "--max-length", str(MAXLEN),
            "--max-new-tokens", str(MAXLEN), "--max-slots", "4", "--hbm-budget-mb", "1",
            "--seed", str(SEED), "--device", "cpu"]
    procs = {}
    try:
        for i in range(2):
            procs[f"eng{i}"] = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch", "serve", *args, "--engine-id",
                 f"eng{i}"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        deadline = time.time() + 120
        while router.live_engines() != ["eng0", "eng1"]:
            assert time.time() < deadline, "the engines never registered"
            time.sleep(0.05)
        rng = np.random.RandomState(3)
        srcs = [rng.randint(2, V, size=rng.randint(3, 20)).tolist() for _ in range(24)]
        fc = FleetClient(router.address)
        try:
            reqs = [fc.submit(Request(s, MAXLEN, req_id=f"a{i}")) for i, s in enumerate(srcs)]
            for r in reqs:
                assert r.wait(120), r
            for r in reqs:
                assert r.status == "served" and r.tokens == single.reference_decode(
                    r.src_ids, MAXLEN), r.req_id
            served = router.fleet_stats()["engines"]
            assert all(e["served"] > 0 for e in served.values()), served

            kill = []
            for i, s in enumerate(srcs):
                kill.append(fc.submit(Request(s, MAXLEN, req_id=f"k{i}")))
                if i == 6:
                    procs["eng1"].send_signal(signal.SIGKILL)
                time.sleep(0.01)
            for r in kill:
                assert r.wait(120), r
            assert all(r.status in TERMINAL_STATUSES for r in kill)
            for r in kill:
                if r.status == "served":
                    assert r.tokens == single.reference_decode(r.src_ids, MAXLEN), r.req_id
            deadline = time.time() + 30
            while router.live_engines() != ["eng0"]:
                assert time.time() < deadline, "the dead engine was never pruned"
                time.sleep(0.05)
        finally:
            fc.close()
        ledger = router.fleet_stats()["ledger"]
        assert sum(ledger.values()) == 48 and router.duplicates_discarded == 0
        assert router.drain_engine("eng0", timeout_s=60.0) is True
        procs["eng0"].send_signal(signal.SIGTERM)
        assert procs["eng0"].wait(60) == 0, procs["eng0"].stdout.read()[-3000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(30)
        router.close()
