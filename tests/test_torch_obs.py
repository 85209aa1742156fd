"""The port's obs plane against the JAX package's: spans, instants and the
flight-recorder dump have the same schema; ``obs.merge`` of either package
takes both packages' files and the two merges agree; an RPC from a JAX
client to a port server pairs across the two timelines; and the stats line and
the Prometheus exposition read alike."""

import json
import os

from paddle_tpu import master as jmaster
from paddle_tpu import obs as jobs
from paddle_tpu.obs import merge as jmerge
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu.utils.timers import StatSet as JStatSet
from paddle_tpu_torch import master as tmaster
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.obs import merge as tmerge
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.utils.timers import StatSet as TStatSet


class _Clock:
    def __init__(self):
        self.t = 10.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _drive(tracer, role):
    tracer.role = role
    with tracer.span("fence", cat="trainer", fence="pass-0"):
        tracer.instant("elastic/lease", cat="trainer", task=3, epoch=0, p=0)
        with tracer.span("elastic/compute", cat="trainer", task=3, p=0):
            pass
    tracer.instant("done", cat="host")


def _normalized(obj):
    """The trace object with the process-specific values (pid, tid, clock
    anchor, trace id) blanked."""
    evs = [{**e, "pid": 0, "tid": 0, **({"args": {"name": "x"}} if e["ph"] == "M" else {})}
           for e in obj["traceEvents"]]
    other = {k: ("*" if k in ("pid", "trace_id", "clock_anchor") else v)
             for k, v in obj["otherData"].items()}
    return {"traceEvents": evs, "otherData": other}


def test_trace_and_flight_dump_share_the_schema(tmp_path):
    objs = []
    for mod, tag in ((jobs, "j"), (tobs, "t")):
        tr = mod.Tracer(clock=_Clock(), ring_events=64)
        tr._recording = True
        _drive(tr, "worker")
        d = tmp_path / tag
        tr.configure(trace_dir=str(d), install_sigusr1=False)
        path = tr.flight_dump("chaos:kill_worker@2")
        assert os.path.basename(path) == f"flight-{tr.pid}.json"
        with open(path) as f:
            flight = json.load(f)
        assert flight["otherData"]["reason"] == "chaos:kill_worker@2"
        objs.append((tr.trace_object(), flight))
    (jt, jf), (tt, tf) = objs
    assert _normalized(jt) == _normalized(tt)
    assert _normalized(jf) == _normalized(tf)
    assert jmerge.validate_trace(tt) == [] and tmerge.validate_trace(jt) == []


def _with_pid(obj, pid, role):
    obj = json.loads(json.dumps(obj))
    obj["otherData"]["pid"] = pid
    obj["otherData"]["role"] = role
    for e in obj["traceEvents"]:
        e["pid"] = pid
    return obj


def test_merge_takes_both_packages_and_pairs_their_rpcs(tmp_path):
    """A JAX client calls a port server in one process; each package's
    tracer records its half.  Given distinct pids, either package's merge
    pairs the two halves by rpc id and the two merges are equal."""
    for mod in (jobs, tobs):
        mod.tracer.reset()
        mod.tracer._recording = True
    svc = tmaster.Service(snapshot_path=str(tmp_path / "snap.json"))
    srv = tmaster.Server(svc)
    try:
        client = jmaster.Client(srv.address)
        for _ in range(3):
            client.stats()
        client.close()
    finally:
        srv.close()
    jobj = _with_pid(jobs.tracer.trace_object(), 101, "worker")
    tobj = _with_pid(tobs.tracer.trace_object(), 202, "master")
    assert any(e["name"].startswith("rpc_call:") for e in jobj["traceEvents"])
    assert any(e["name"].startswith("rpc:") for e in tobj["traceEvents"])
    for i, obj in enumerate((jobj, tobj)):
        with open(tmp_path / f"trace-r-{i}.json", "w") as f:
            json.dump(obj, f)
    jm, _ = jmerge.merge_dir(str(tmp_path), out_path=str(tmp_path / "jm.json"))
    tm, _ = tmerge.merge_dir(str(tmp_path), out_path=str(tmp_path / "tm.json"))
    assert jm == tm
    assert tm["otherData"]["rpc_pair_edges"]["101->202"] >= 3
    assert tm["otherData"]["roles"] == {"101": "worker", "202": "master"}


def test_stats_line_and_prometheus_exposition_read_alike(tmp_path):
    rec = {"worker_id": "w0", "pass_costs": [0.5, 0.25], "busy_s": 1.5}
    for mod, tag in ((jobs, "j"), (tobs, "t")):
        assert mod.write_stats_json(str(tmp_path / f"{tag}.json"), rec)
    assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()
    texts = []
    for mod, stats in ((jmetrics, JStatSet()), (tmetrics, TStatSet())):
        stats.incr("wire_bytes_sent", 7)
        stats.observe("lock_held/master", 0.25)
        texts.append(mod.render_prometheus(stats))
    assert texts[1].replace("paddle_tpu_torch_", "paddle_tpu_") == texts[0]

