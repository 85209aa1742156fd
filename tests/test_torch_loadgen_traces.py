"""The port's open-loop load generator (``paddle_tpu_torch/reader/loadgen.py``)
and ``.ptt`` request traces (``paddle_tpu_torch/robustness/traces.py``), both
numpy-only, on the CPU: the twins of tests/test_traces.py's trace cases
(byte-identical round trip, torn and corrupt files rejected, arrival
statistics, replayed identity and rendezvous targets, cancels, speed-up)
and of tests/test_serving.py's loadgen cases; and the two packages side by
side: one seed gives the JAX package's arrival schedule, sources and
sessions exactly, and a trace written by either package is byte-identical
to the other's and replays in it with the same identities."""

import numpy as np
import pytest

from paddle_tpu_torch.reader.loadgen import OpenLoopLoadGen, PrefixMixer
from paddle_tpu_torch.robustness.traces import (
    TraceError,
    TraceReplayLoadGen,
    TraceWriter,
    arrival_stats,
    read_trace,
    serialize_trace,
)
from paddle_tpu_torch.serving import Request
from paddle_tpu_torch.serving.router import affinity_key, rendezvous_pick


def _virtual_clock():
    now = [0.0]
    return (lambda: now[0]), (lambda s: now.__setitem__(0, now[0] + s))


def _write_trace(path, reqs_with_offsets, meta=None, cancels=()):
    clock, _ = _virtual_clock()
    with TraceWriter(str(path), meta=meta or {"test": 1},
                     clock=clock) as w:
        for off, r in reqs_with_offsets:
            w.record_request(r, offset_s=off)
        for off, rid, reason in cancels:
            w.record_cancel(rid, offset_s=off, reason=reason)
    return str(path)


def _stats_for(tmp_path, process, n=600, rate=50.0):
    gen = OpenLoopLoadGen(rate, n, lambda i: i, process=process, seed=9)
    recs = [{"ev": "req", "o": round(a, 6), "id": f"r{i}", "src": [2]}
            for i, a in enumerate(gen.arrivals)]
    q = tmp_path / f"{process}.ptt"
    q.write_text(serialize_trace(recs, {"process": process}))
    return arrival_stats(read_trace(str(q)))


def _record_live_window(tmp_path, n=12):
    """Drive a live loadgen window (virtual clock) and record it."""
    mixer = PrefixMixer(50, pool_size=3, prefix_frac=0.6, seed=4,
                        sessions=4)
    live = [Request(mixer.source(i), req_id=f"live{i}") for i in range(n)]
    clock, sleep = _virtual_clock()
    gen = OpenLoopLoadGen(
        100.0, n, lambda i: live[i], process="poisson", seed=2,
        deadline_s=0.4, session_of=mixer.session_of,
        priority_of=lambda i: 0 if i % 3 == 0 else 2,
        clock=clock, sleep=sleep,
    )
    w = TraceWriter(str(tmp_path / "live.ptt"), clock=clock)
    gen.run(lambda r: (w.record_request(r), r)[-1])
    w.close()
    return live, read_trace(str(tmp_path / "live.ptt"))


def test_trace_roundtrip_byte_identity(tmp_path):
    reqs = [
        Request([2, 3, 4], 6, req_id="a", deadline_s=0.25,
                session_id="sess0", priority=0),
        Request([5, 6], req_id="b"),
    ]
    p = _write_trace(tmp_path / "t.ptt",
                     [(0.0, reqs[0]), (0.125, reqs[1])],
                     cancels=[(0.5, "a", "client gave up")])
    raw = open(p, "rb").read()
    trace = read_trace(p)
    # byte identity: what the reader validated re-serializes to EXACTLY
    # the recorded file — a committed trace artifact is stable
    assert trace.serialize().encode() == raw
    assert len(trace) == 3
    (r0, r1), (c0,) = trace.requests(), trace.cancels()
    assert r0["id"] == "a" and r0["src"] == [2, 3, 4] and r0["mnt"] == 6
    assert r0["dl"] == 0.25 and r0["sess"] == "sess0" and r0["prio"] == 0
    assert r1["prio"] == 1 and r1["sess"] is None  # defaults recorded
    assert c0["id"] == "a" and c0["reason"] == "client gave up"
    # meta survives
    assert trace.meta == {"test": 1}


def test_trace_rejects_torn_truncated_and_corrupt(tmp_path):
    reqs = [(0.0, Request([2, 3], req_id="a")),
            (0.1, Request([4], req_id="b"))]
    p = _write_trace(tmp_path / "ok.ptt", reqs)
    lines = open(p).read().splitlines()

    def _variant(name, content):
        q = tmp_path / name
        q.write_text(content)
        with pytest.raises(TraceError) as ei:
            read_trace(str(q))
        return str(ei.value)

    # writer never closed (crash mid-run): no footer
    assert "footer" in _variant("nofoot.ptt",
                                "\n".join(lines[:-1]) + "\n")
    # crash mid-record: last line has no newline
    assert "newline" in _variant("torn.ptt", "\n".join(lines))
    # one flipped record byte: per-line crc catches it
    bad = lines[1][:10] + ("0" if lines[1][10] != "0" else "1") + lines[1][11:]
    assert "crc" in _variant(
        "flip.ptt", "\n".join([lines[0], bad, *lines[2:]]) + "\n")
    # a dropped record: footer count catches it
    assert "truncated" in _variant(
        "short.ptt", "\n".join([lines[0], lines[1], lines[-1]]) + "\n")
    # not a trace at all / wrong version
    assert "header" in _variant("junk.ptt", "hello\n")
    assert "version" in _variant(
        "vers.ptt",
        '#ptt1 {"meta":{},"version":999}\n' + "\n".join(lines[1:]) + "\n")


def test_trace_rejects_nonmonotonic_offsets(tmp_path):
    text = serialize_trace(
        [{"ev": "req", "o": 0.5, "id": "a", "src": [2]},
         {"ev": "req", "o": 0.1, "id": "b", "src": [3]}], {})
    q = tmp_path / "mono.ptt"
    q.write_text(text)
    with pytest.raises(TraceError, match="monotonic"):
        read_trace(str(q))


def test_writer_refuses_after_close(tmp_path):
    w = TraceWriter(str(tmp_path / "c.ptt"))
    w.record_request(Request([2]))
    w.close()
    with pytest.raises(TraceError, match="closed"):
        w.record_request(Request([3]))


def test_arrival_stats_reconstruct_each_process(tmp_path):
    """A recorded day carries its arrival process's signature: the rate
    comes back near nominal and the gap CV separates uniform (~0),
    poisson (~1) and burst (overdispersed) — the realism evidence that a
    replayed trace offers the RECORDED process, not a relabeled one."""
    uni = _stats_for(tmp_path, "uniform")
    poi = _stats_for(tmp_path, "poisson")
    bur = _stats_for(tmp_path, "burst")
    for s in (uni, poi, bur):
        assert s["n"] == 600
        assert 0.6 * 50.0 < s["rate_rps"] < 1.6 * 50.0, s
    assert uni["cv"] == pytest.approx(0.0, abs=1e-6)
    assert 0.7 < poi["cv"] < 1.3, poi
    assert bur["cv"] > poi["cv"] * 1.1, (bur, poi)


def test_replay_reproduces_recorded_identity_and_rendezvous(tmp_path):
    live, trace = _record_live_window(tmp_path)
    clock, sleep = _virtual_clock()
    replayed = TraceReplayLoadGen(trace, clock=clock, sleep=sleep).run(
        lambda r: r)
    assert len(replayed) == len(live)
    engines = ["engine-a", "engine-b", "engine-c"]
    for a, b in zip(live, replayed):
        assert b.req_id == a.req_id
        assert b.src_ids == a.src_ids
        assert b.deadline_s == a.deadline_s
        assert b.session_id == a.session_id
        assert b.priority == a.priority
        # the affinity key and the rendezvous target both pin: the
        # replayed day lands on the SAME engines the recorded day did
        ka = affinity_key(a.src_ids, a.session_id)
        kb = affinity_key(b.src_ids, b.session_id)
        assert ka == kb
        if ka is not None:
            assert (rendezvous_pick(ka, engines)
                    == rendezvous_pick(kb, engines))


def test_live_loadgen_never_clobbers_replayed_identity(tmp_path):
    """The stamp-if-absent regression: replay-built
    requests passed through a DIFFERENTLY-configured live loadgen keep
    their recorded deadline and session — the live RNG must not
    re-derive affinity keys a recorded day already fixed."""
    live, trace = _record_live_window(tmp_path)
    clock, sleep = _virtual_clock()
    replayed = TraceReplayLoadGen(trace, clock=clock, sleep=sleep).run(
        lambda r: r)
    clock2, sleep2 = _virtual_clock()
    out = OpenLoopLoadGen(
        100.0, len(replayed), lambda i: replayed[i], process="uniform",
        deadline_s=99.0, session_of=lambda i: "sessCLOBBER",
        clock=clock2, sleep=sleep2,
    ).run(lambda r: r)
    assert [r.session_id for r in out] == [a.session_id for a in live]
    assert [r.deadline_s for r in out] == [a.deadline_s for a in live]


def test_replay_fires_cancels_at_recorded_offsets(tmp_path):
    p = _write_trace(
        tmp_path / "c.ptt",
        [(0.0, Request([2, 3], req_id="a")),
         (0.1, Request([4, 5], req_id="b"))],
        cancels=[(0.2, "a", "deadline blown")])
    clock, sleep = _virtual_clock()
    submitted, canceled = [], []
    TraceReplayLoadGen(read_trace(p), clock=clock, sleep=sleep).run(
        submitted.append,
        cancel=lambda rid, reason: canceled.append((rid, reason, clock())))
    assert [r.req_id for r in submitted] == ["a", "b"]
    assert canceled == [("a", "deadline blown", pytest.approx(0.2))]


def test_replay_speedup_compresses_the_clock(tmp_path):
    _, trace = _record_live_window(tmp_path)
    clock, sleep = _virtual_clock()
    gen = TraceReplayLoadGen(trace, speedup=4.0, clock=clock, sleep=sleep)
    gen.run(lambda r: r)
    span = float(trace.records[-1]["o"])
    assert clock() == pytest.approx(span / 4.0, rel=1e-3)
    assert gen.offered_duration_s == pytest.approx(span / 4.0)


def test_loadgen_open_loop_arrivals_independent_of_completion():
    # virtual clock: sleep() advances it; submit() takes 0.4s of "service
    # time" — open loop means arrival TIMES still follow the schedule
    now = [0.0]

    def clock():
        return now[0]

    def sleep(s):
        now[0] += s

    gen = OpenLoopLoadGen(
        10.0, 5, lambda i: i, process="uniform", clock=clock, sleep=sleep
    )
    times = []

    def submit(i):
        times.append((i, clock()))
        now[0] += 0.4  # a slow server mustn't throttle the arrival clock
        return i

    gen.run(submit)
    assert [i for i, _ in times] == [0, 1, 2, 3, 4]
    # uniform at 10 req/s: scheduled arrivals at 0.1, 0.2, ...; service
    # time pushes the clock PAST later arrivals, which then fire with no
    # extra wait (the queueing shows up at the server, not the generator)
    assert times[0][1] == pytest.approx(0.1, abs=1e-6)
    assert times[1][1] == pytest.approx(0.5, abs=1e-6)


def test_loadgen_deterministic_schedule():
    a = OpenLoopLoadGen(5.0, 8, lambda i: i, seed=3).arrivals
    b = OpenLoopLoadGen(5.0, 8, lambda i: i, seed=3).arrivals
    c = OpenLoopLoadGen(5.0, 8, lambda i: i, seed=4).arrivals
    assert a == b != c
    with pytest.raises(ValueError):
        OpenLoopLoadGen(0.0, 1, lambda i: i)
    with pytest.raises(ValueError):
        OpenLoopLoadGen(1.0, 1, lambda i: i, process="bursty")


def test_loadgen_burst_process_mean_rate_and_burstiness():
    """Burst arrivals: seeded-deterministic, long-run mean close to the
    nominal rate, and gap dispersion strictly above the plain-Poisson
    floor (the bursts are real, not relabeled exponentials)."""
    n, rate = 4000, 20.0
    g1 = OpenLoopLoadGen(rate, n, lambda i: i, process="burst", seed=7)
    g2 = OpenLoopLoadGen(rate, n, lambda i: i, process="burst", seed=7)
    assert g1.arrivals == g2.arrivals
    mean_rate = n / g1.arrivals[-1]
    assert 0.7 * rate < mean_rate < 1.4 * rate, mean_rate
    gaps = np.diff([0.0] + g1.arrivals)
    pois = np.diff(
        [0.0] + OpenLoopLoadGen(rate, n, lambda i: i, seed=7).arrivals
    )
    # exponential gaps have CV ~= 1; a two-state modulated process is
    # overdispersed
    cv_burst = gaps.std() / gaps.mean()
    cv_pois = pois.std() / pois.mean()
    assert cv_burst > cv_pois * 1.1, (cv_burst, cv_pois)
    with pytest.raises(ValueError):
        OpenLoopLoadGen(1.0, 4, lambda i: i, process="burst",
                        burst_factor=5.0, burst_fraction=0.5)


def test_loadgen_stamps_deadlines_and_honors_stop():
    class Req:
        deadline_s = None

    now = [0.0]
    gen = OpenLoopLoadGen(
        10.0, 6, lambda i: Req(), process="uniform", deadline_s=1.5,
        clock=lambda: now[0], sleep=lambda s: now.__setitem__(0, now[0] + s),
    )
    seen = []
    out = gen.run(seen.append, stop=lambda: len(seen) >= 3)
    assert len(out) == len(seen) == 3  # stop truncated the schedule
    assert all(r.deadline_s == 1.5 for r in seen)


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("process", ["poisson", "uniform", "burst"])
def test_loadgen_schedule_equals_jax(process):
    from paddle_tpu.reader.loadgen import OpenLoopLoadGen as JLoadGen

    for seed in (0, 3):
        kw = dict(seed=seed, process=process)
        assert (OpenLoopLoadGen(7.5, 200, lambda i: i, **kw).arrivals
                == JLoadGen(7.5, 200, lambda i: i, **kw).arrivals)


def test_prefix_mixer_equals_jax():
    from paddle_tpu.reader.loadgen import PrefixMixer as JMixer

    kw = dict(pool_size=4, prefix_frac=0.6, prefix_tokens=16, tail_tokens=10, dup_frac=0.5,
              seed=4, sessions=5)
    t, j = PrefixMixer(30000, **kw), JMixer(30000, **kw)
    assert [list(p) for p in t.pool] == [list(p) for p in j.pool]
    assert [t.source(i) for i in range(64)] == [j.source(i) for i in range(64)]
    assert [t.session_of(i) for i in range(64)] == [j.session_of(i) for i in range(64)]


def _mixed_workload(make):
    reqs = [make([2, 3, 4, 5], 6, req_id="a", deadline_s=0.5, session_id="s1", priority=0),
            make(list(range(2, 40)), None, req_id="b"),
            make([7] * 17, 3, req_id="c", deadline_s=2.0, priority=2)]
    return [(0.01 * (i + 1), r) for i, r in enumerate(reqs)]


@pytest.mark.parametrize("writer_pkg", ["torch", "jax"])
def test_trace_written_by_either_package_replays_in_the_other(tmp_path, writer_pkg):
    from paddle_tpu.robustness import traces as jtraces
    from paddle_tpu.serving import Request as JRequest

    paths = {}
    for pkg, writer, make in (("torch", TraceWriter, Request),
                              ("jax", jtraces.TraceWriter, JRequest)):
        clock, _ = _virtual_clock()
        paths[pkg] = str(tmp_path / f"{pkg}.ptt")
        with writer(paths[pkg], meta={"test": 1}, clock=clock) as w:
            for off, r in _mixed_workload(make):
                w.record_request(r, offset_s=off)
            w.record_cancel("b", offset_s=0.05, reason="client gave up")
    with open(paths["torch"], "rb") as f, open(paths["jax"], "rb") as g:
        assert f.read() == g.read()
    path = paths[writer_pkg]
    for read, replay, make in ((read_trace, TraceReplayLoadGen, Request),
                               (jtraces.read_trace, jtraces.TraceReplayLoadGen, JRequest)):
        tr = read(path)
        clock, sleep = _virtual_clock()
        got, cancels = [], []
        replay(tr, clock=clock, sleep=sleep).run(
            got.append, cancel=lambda rid, reason: cancels.append(rid))
        assert [(r.req_id, r.src_ids, r.max_new_tokens, r.deadline_s, r.session_id, r.priority)
                for r in got] == [
            ("a", [2, 3, 4, 5], 6, 0.5, "s1", 0), ("b", list(range(2, 40)), None, None, None, 1),
            ("c", [7] * 17, 3, 2.0, None, 2)]
        assert cancels == ["b"]
