"""The port's master plane against the JAX package's: a journal written by
either package's ``Service`` replays in the other's to the same queues,
results, registry and fences; a JAX ``Client`` leases from a port
``Server`` and the reverse; the HA plane's endpoint discovery and
leadership files are shared; and the port's master modules import no
torch."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu import master as jmaster
from paddle_tpu import master_ha as jha
from paddle_tpu.io import recordio as jrecordio
from paddle_tpu_torch import master as tmaster
from paddle_tpu_torch import master_ha as tha

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _service(mod, tmp_path, **kw):
    data = str(tmp_path / "d.rio")
    if not os.path.exists(data):
        jrecordio.write_records(data, (f"{i}".encode() for i in range(80)),
                                max_chunk_records=10)
    kw.setdefault("journal", True)
    svc = mod.Service(snapshot_path=str(tmp_path / "snap.json"), chunks_per_task=2,
                      auto_rotate=False, journal_fsync=False, clock=_Clock(), **kw)
    svc.set_dataset([data])
    return svc


def _twin(mod, tmp_path):
    return mod.Service(snapshot_path=str(tmp_path / "snap.json"), chunks_per_task=2,
                       auto_rotate=False, journal=True, journal_fsync=False, clock=_Clock())


def _workload(svc):
    """Leases, a failure, a graceful return, registry join and leave,
    finishes with numpy results, fence arrivals and a release, a rotation
    and a mid-pass-1 lease: every record type the live plane emits."""
    for w in ("w0", "w1", "w2"):
        svc.register_worker(w)
    served = {}
    for w in ("w0", "w1", "w2"):
        got = svc.get_task(w)
        served[w] = (got["task"]["task_id"], got["epoch"])
    svc.task_failed(*served["w1"])
    svc.task_returned(*served["w2"])
    svc.deregister_worker("w2")
    tid, ep = served["w0"]
    svc.task_finished(tid, ep, {"g": np.arange(4, dtype=np.float32) + tid, "rows": 10})
    while True:
        got = svc.get_task("w0")
        if got in (None, "wait"):
            break
        tid = got["task"]["task_id"]
        svc.task_finished(tid, got["epoch"],
                          {"g": np.arange(4, dtype=np.float32) + tid, "rows": 10})
    svc.fence_arrive("pass-0", "w0", {"ckpt": True})
    svc.fence_arrive("pass-0", "w1", {"ckpt": False})
    assert svc.fence_status("pass-0")["released"]
    svc.start_new_pass(1)
    assert svc.get_task("w0") not in (None, "wait")


def _fingerprint(svc):
    with svc._lock:
        return {
            "pass_id": svc.pass_id,
            "todo": sorted((t.task_id, t.epoch) for t in svc.todo),
            "pending": sorted((tid, e[0].epoch, e[2]) for tid, e in svc.pending.items()),
            "done": sorted((t.task_id, t.epoch) for t in svc.done),
            "discarded": sorted(t.task_id for t in svc.discarded),
            "fail_events": svc.fail_events,
            "workers": sorted(svc.workers),
            "pass_done": dict(svc._pass_done),
            "fences": {fid: (sorted(f["arrived"]), f["released"])
                       for fid, f in svc.fences.items()},
        }


def _results(svc):
    return {p: {tid: (r["g"].tobytes(), r["rows"]) for tid, r in m.items()}
            for p, m in svc.results.items()}


@pytest.mark.parametrize("writer,reader", [(jmaster, tmaster), (tmaster, jmaster)],
                         ids=["jax-journal-port-replays", "port-journal-jax-replays"])
def test_journal_replays_across_packages(tmp_path, writer, reader):
    svc = _service(writer, tmp_path)
    _workload(svc)
    live, results = _fingerprint(svc), _results(svc)
    svc.fence()  # deposed: the recovering leader owns the files now
    twin = _twin(reader, tmp_path)
    assert twin.replayed_records > 0
    assert _fingerprint(twin) == live
    assert _results(twin) == results
    # and the recovered master goes on: it finishes pass 1 and rotates
    twin.register_worker("w0")
    while True:
        got = twin.get_task("w0")
        if got in (None, "wait"):
            break
        twin.task_finished(got["task"]["task_id"], got["epoch"], {"g": np.zeros(4), "rows": 1})
    assert twin.stats()["n_todo"] == 0


def test_compacted_snapshot_recovers_across_packages(tmp_path):
    svc = _service(tmaster, tmp_path, journal_compact_every=3)
    _workload(svc)
    assert svc._journal_gen > 1  # compaction happened
    live, results = _fingerprint(svc), _results(svc)
    svc.fence()
    twin = _twin(jmaster, tmp_path)
    assert _fingerprint(twin) == live and _results(twin) == results


@pytest.mark.parametrize("server_mod,client_mod", [(tmaster, jmaster), (jmaster, tmaster)],
                         ids=["jax-client-port-server", "port-client-jax-server"])
def test_client_and_server_interoperate(tmp_path, server_mod, client_mod):
    data = str(tmp_path / "d.rio")
    recs = [f"rec{i}".encode() for i in range(30)]
    jrecordio.write_records(data, iter(recs), max_chunk_records=5)
    svc = server_mod.Service(snapshot_path=str(tmp_path / "snap.json"), chunks_per_task=1,
                             auto_rotate=False)
    srv = server_mod.Server(svc)
    try:
        client = client_mod.Client(srv.address, trainer_id="t0")
        client.set_dataset([data])
        got = []
        while True:
            rec = client.next_record()
            if rec is None:
                break
            got.append(rec)
        assert sorted(got) == sorted(recs)
        # the cluster plane over the wire: registry, a lease with a numpy
        # result, a fence, the per-pass result map
        info = client.register_worker("w0")
        assert info["workers"] == ["w0"]
        assert client.start_new_pass(1) == 1
        lease = client.get_task("w0")
        tid = lease["task"]["task_id"]
        assert client.task_finished(tid, lease["epoch"], {"g": np.arange(3, dtype=np.float32)}, 1)
        res = client.pass_results(1)["results"]
        assert np.array_equal(res[tid]["g"], np.arange(3, dtype=np.float32))
        view = client.fence_arrive("f", "w0", {"ckpt": False})
        assert view["released"]
        assert client.request_save_model(5.0) is True
        client.close()
    finally:
        srv.close()


def test_ha_endpoint_and_leader_are_shared(tmp_path):
    """A port HAMaster publishes an endpoint the JAX HAClient follows, and a
    JAX HAMaster's leadership file keeps a port candidate standing by."""
    data = str(tmp_path / "d.rio")
    jrecordio.write_records(data, (f"{i}".encode() for i in range(8)), max_chunk_records=2)
    d = str(tmp_path / "ha")
    leader = tha.HAMaster(d, [data], owner_id="port-leader", lease_timeout=2.0,
                          chunks_per_task=1, auto_rotate=False, snapshot_min_interval_s=0.0)
    leader.start()
    try:
        assert leader.wait_leader(30)
        assert jha.discover_endpoint(d) == tha.discover_endpoint(d)
        jc = jha.HAClient(d, timeout=10.0)
        assert jc.register_worker("wj")["workers"] == ["wj"]
        assert jc.stats()["n_todo"] == 4
        standby = jha.HAMaster(d, [data], owner_id="jax-standby", lease_timeout=2.0,
                               chunks_per_task=1, auto_rotate=False)
        standby.start()
        try:
            assert not standby.is_leader.is_set()
        finally:
            standby.stop()
        jc.close()
    finally:
        leader.stop()


_NO_TORCH = """
import importlib, os, sys, types
sys.modules["torch"] = None
sys.modules["jax"] = None
sys.modules["paddle_tpu"] = None
# load the modules without the packages' __init__ files (which bind the
# whole port, torch included), as a master process would need them
for pkg in ("paddle_tpu_torch", "paddle_tpu_torch.robustness", "paddle_tpu_torch.ops",
            "paddle_tpu_torch.io", "paddle_tpu_torch.utils", "paddle_tpu_torch.analysis"):
    m = types.ModuleType(pkg)
    m.__path__ = [os.path.join(os.getcwd(), *pkg.split("."))]
    sys.modules[pkg] = m
for name in ("master", "master_ha", "master_journal", "master_wire", "obs", "obs.merge",
             "obs.metrics", "robustness.netem", "robustness.chaos",
             "analysis.lock_sanitizer", "ops.quantize", "launcher"):
    importlib.import_module("paddle_tpu_torch." + name)
svc = sys.modules["paddle_tpu_torch.master"].Service()
print("ok", svc.stats()["pass_id"])
"""


def test_master_side_modules_import_no_torch():
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH], cwd=ROOT, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok 0"


def test_master_stats_and_snapshot_are_json(tmp_path):
    """The snapshot file the two packages share is plain JSON of the same
    shape."""
    for mod, tag in ((jmaster, "j"), (tmaster, "t")):
        d = tmp_path / tag
        d.mkdir()
        _service(mod, d, journal=False, snapshot_min_interval_s=0.0)._snapshot(force=True)
    with open(tmp_path / "j" / "snap.json") as f:
        js = json.load(f)
    with open(tmp_path / "t" / "snap.json") as f:
        ts = json.load(f)
    assert sorted(js) == sorted(ts)
    assert js["todo"] == [{**t, "chunks": [{**c, "path": c["path"].replace("/t/", "/j/")}
                                             for c in t["chunks"]]} for t in ts["todo"]]


def test_server_close_returns_when_its_accept_loop_already_ended(tmp_path):
    """``Server.close`` sets the stop flag, then dials its own listener to
    wake the accept loop.  When the loop saw the flag between two accepts
    it has already returned, and nobody answers that dial's auth
    handshake: the wake-up is bounded, so ``close`` returns (before the
    bound, an xdist worker hung in it for good).  The close runs on a
    thread here so a regression fails instead of hanging the run."""
    import threading

    srv = tmaster.Server(_service(tmaster, tmp_path))
    srv._stop = True
    tmaster.Client(srv.address, call_timeout_s=5.0).close()  # the loop wakes, sees the flag
    srv._thread.join(5.0)
    assert not srv._thread.is_alive()
    closer = threading.Thread(target=srv.close, daemon=True)
    closer.start()
    closer.join(tmaster._WAKE_DIAL_S + 10.0)
    assert not closer.is_alive(), "Server.close hung on its wake-up dial"
