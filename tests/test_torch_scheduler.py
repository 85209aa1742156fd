"""The port's serving scheduler (``paddle_tpu_torch/serving/scheduler.py``)
on the CPU, at tests/test_serving.py's tiny NMT (vocab 20, word width 8,
hidden 12) over the JAX package's seeded parameters: the twins of that
file's scheduler cases (serves and rejects, a crashed loop strands no
client, callbacks off the step thread, a timed-out ``generate`` cancels,
backpressure, deadlines and shedding, drain, chunked prefill through the
scheduler, priority classes and their gauges), each served request's
tokens held to the port's one-shot ``reference_decode``; the chaos drills
of tests/test_serving_e2e.py (``nan_request`` is rejected while the batch
keeps stepping, ``serve_slow_client`` stalls only delivery); and the
scheduler's run over the port engine against the JAX scheduler's over the
JAX engine, token for token."""

import threading
import time

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core.topology import reset_auto_names
from paddle_tpu_torch.models.seq2seq import Seq2SeqGenerator, seq2seq_cost
from paddle_tpu_torch.robustness import chaos
from paddle_tpu_torch.serving import Request, ServingEngine, ServingScheduler
from test_torch_parity import carry

V, E, H = 20, 8, 12
BOS, EOS = 0, 1
MAXLEN = 8


@pytest.fixture(autouse=True)
def _flags():
    yield
    chaos.disarm()
    paddle_tpu_torch.flags.reset_flags()


def _gen_kw():
    return dict(word_dim=E, hidden_dim=H, bos_id=BOS, eos_id=EOS, max_length=MAXLEN)


@pytest.fixture(scope="module")
def jparams():
    from paddle_tpu.core.topology import reset_auto_names as j_reset
    from paddle_tpu.models.seq2seq import seq2seq_cost as j_cost

    j_reset()
    cost, _ = j_cost(V, V, word_dim=E, hidden_dim=H)
    return paddle_tpu.parameters.create(cost, seed=5)


@pytest.fixture(scope="module")
def small_gen(jparams):
    reset_auto_names()
    cost, _ = seq2seq_cost(V, V, word_dim=E, hidden_dim=H)
    return Seq2SeqGenerator(carry(jparams, cost), V, V, device="cpu", **_gen_kw())


def make_engine(small_gen, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("hbm_budget_mb", 1)
    kw.setdefault("max_new_tokens", MAXLEN)
    return ServingEngine(small_gen, device="cpu", **kw)


def srcs_of(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, V, size=n).tolist() for n in lengths]


def _no_leaked_serve_threads():
    return not [t for t in threading.enumerate() if t.name.startswith("paddle-serve")]


# ---------------------------------------------------------------------------
# the twins of tests/test_serving.py's scheduler cases
# ---------------------------------------------------------------------------


def test_scheduler_serves_and_rejects(small_gen):
    eng = make_engine(small_gen)
    with ServingScheduler(eng) as sched:
        good = [sched.submit(Request(s)) for s in srcs_of(5, (3, 7, 2))]
        bad = [
            sched.submit(Request([])),  # empty
            sched.submit(Request([2, V + 5])),  # out of vocab
            sched.submit(Request([2, 3], max_new_tokens=0)),  # bad cap
            sched.submit(Request([2, 3], max_new_tokens="5")),  # non-numeric
            sched.submit(Request([2, 3], max_new_tokens=float("nan"))),
            sched.submit(Request([2, float("nan"), 3])),  # poisoned
            sched.submit(Request(list(range(2, 2 + 10_000)) * 2)),  # too long
        ]
        for r in good + bad:
            assert r.wait(60), r
        for r in good:
            assert r.error is None
            assert r.result() == eng.reference_decode(r.src_ids, MAXLEN)
            assert r.t_submit <= r.t_admit <= r.t_done
        for r in bad:
            assert r.error is not None
            with pytest.raises(RuntimeError):
                r.result()
    # closed: no thread leaks, further submits refused
    assert not [
        t for t in threading.enumerate() if t.name.startswith("paddle-serve")
    ]
    with pytest.raises(RuntimeError):
        sched.submit(Request([2, 3]))
    sched.close()  # idempotent


def test_scheduler_loop_crash_strands_no_client(small_gen, monkeypatch):
    """An engine bug must fail LOUDLY: every outstanding request finalizes
    with the crash error (wait() unblocks) and further submits raise —
    never a silently dead daemon thread with clients parked forever."""
    eng = make_engine(small_gen)
    monkeypatch.setattr(
        eng, "step", lambda: (_ for _ in ()).throw(RuntimeError("boom"))
    )
    sched = ServingScheduler(eng)
    try:
        r = sched.submit(Request([2, 3, 4]))
        assert r.wait(30), "client stranded by a crashed step loop"
        assert r.error is not None and "crashed" in r.error
        for _ in range(200):  # the loop marks itself closed
            try:
                sched.submit(Request([2, 3]))
                threading.Event().wait(0.01)
            except RuntimeError:
                break
        else:
            pytest.fail("submit still accepted after loop crash")
    finally:
        sched.close()


def test_scheduler_callback_runs_off_step_thread(small_gen):
    eng = make_engine(small_gen)
    seen = []

    def cb(r):
        seen.append((r.req_id, threading.current_thread().name))

    with ServingScheduler(eng) as sched:
        r = sched.submit(Request([2, 3, 4], callback=cb))
        assert r.wait(60)
        # wait() unblocked by the STEP thread; the callback lands on the
        # delivery thread shortly after
        for _ in range(200):
            if seen:
                break
            threading.Event().wait(0.01)
    assert seen and seen[0][1] == "paddle-serve-deliver"


def test_generate_timeout_cancels_and_frees_pages(small_gen):
    """The orphaned-slot regression: a timed-out ``generate()`` must CANCEL
    its in-flight request — pages_in_use returns to 0 instead of the slot
    decoding to max_new_tokens for nobody."""
    import time as _time

    eng = make_engine(small_gen)
    sched = ServingScheduler(eng)
    try:
        with pytest.raises(TimeoutError):
            sched.generate([2, 3, 4], timeout=0.0)
        deadline = _time.perf_counter() + 10.0
        while _time.perf_counter() < deadline:
            if (eng.pages.n_used == 0 and eng.n_live == 0
                    and eng.n_free_slots == eng.max_slots):
                break
            threading.Event().wait(0.01)
        assert eng.pages.n_used == 0, eng.pages.summary()
        assert eng.n_live == 0 and eng.n_free_slots == eng.max_slots
        # the canceled request burned nothing and the plane still serves
        assert sched.generate([2, 3, 4], timeout=60.0) == (
            eng.reference_decode([2, 3, 4], MAXLEN)
        )
    finally:
        sched.close()


def test_cancel_by_req_id(small_gen):
    eng = make_engine(small_gen)
    with ServingScheduler(eng) as sched:
        r = sched.submit(Request(srcs_of(11, (6,))[0]))
        sched.cancel(r.req_id, reason="timeout: operator cancel")
        assert r.wait(10)
        assert r.status in ("timeout", "served")  # raced completion is fine
    assert eng.pages.n_used == 0


def test_queue_limit_backpressure_rejects_immediately(small_gen):
    eng = make_engine(small_gen)
    with ServingScheduler(eng, queue_limit=2) as sched:
        reqs = [sched.submit(Request(s)) for s in srcs_of(12, (5,) * 30)]
        for r in reqs:
            assert r.wait(60)
        statuses = [r.status for r in reqs]
        assert statuses.count("rejected") > 0
        assert set(statuses) <= {"served", "rejected"}
        for r in reqs:
            if r.status == "rejected":
                assert "queue full" in r.error
                assert r.tokens == []


def test_deadline_stamped_and_shed_statuses_disjoint(small_gen):
    """An effectively-zero deadline sheds everything the sweep sees; the
    ledger stays disjoint over served/shed/timeout."""
    eng = make_engine(small_gen)
    with ServingScheduler(eng) as sched:
        # calibrate the EWMA so the shed predictor is live
        sched.generate([2, 3, 4])
        reqs = [
            sched.submit(Request(s, deadline_s=1e-4))
            for s in srcs_of(13, (5,) * 12)
        ]
        for r in reqs:
            assert r.wait(60)
            assert r.t_deadline is not None
        assert all(r.status in ("shed", "timeout") for r in reqs), [
            r.status for r in reqs
        ]
        assert any(r.status == "shed" for r in reqs)
    assert eng.pages.n_used == 0


def test_scheduler_shed_verdict_uses_predictor(small_gen):
    """Deterministic predictor unit: with a calibrated EWMA, an infeasible
    deadline sheds and a generous one admits."""
    eng = make_engine(small_gen)
    sched = ServingScheduler(eng)
    sched.close()  # predictor methods are pure reads after close
    sched._rung_token_s = {4: 0.01}  # 10 ms/token at the full house
    sched._ewma_tokens = 8.0         # 80 ms expected service
    now = 1000.0
    tight = Request([2, 3], deadline_s=0.05)
    tight.t_submit, tight.t_deadline = now, now + 0.05
    verdict = sched._shed_verdict(tight, n_ahead=4, now=now)
    assert verdict is not None and verdict.startswith("shed:")
    wide = Request([2, 3], deadline_s=10.0)
    wide.t_submit, wide.t_deadline = now, now + 10.0
    assert sched._shed_verdict(wide, n_ahead=4, now=now) is None
    # uncalibrated predictor never sheds blind
    sched._rung_token_s = {}
    assert sched._shed_verdict(tight, n_ahead=100, now=now) is None


def test_drain_finishes_in_flight_and_refuses_new(small_gen):
    eng = make_engine(small_gen)
    sched = ServingScheduler(eng)
    reqs = [sched.submit(Request(s)) for s in srcs_of(14, (4,) * 6)]
    assert sched.drain(60.0) is True
    assert all(r.status == "served" for r in reqs)
    for r in reqs:
        assert r.result() == eng.reference_decode(r.src_ids, MAXLEN)
    with pytest.raises(RuntimeError):
        sched.submit(Request([2, 3]))
    assert not [
        t for t in threading.enumerate() if t.name.startswith("paddle-serve")
    ]


def test_chunked_prefill_through_scheduler(small_gen):
    eng = make_engine(small_gen, prefill_chunk_tokens=16, hbm_budget_mb=4)
    srcs = srcs_of(23, (40, 4, 25, 6))
    with ServingScheduler(eng) as sched:
        reqs = [sched.submit(Request(s)) for s in srcs]
        for r in reqs:
            assert r.wait(120), r
        for r in reqs:
            assert r.result() == eng.reference_decode(r.src_ids, MAXLEN)


def test_parse_class_spec_grammar():
    from paddle_tpu_torch.serving.scheduler import _parse_class_spec

    assert _parse_class_spec("0:0.25,2:1.5") == {0: 0.25, 2: 1.5}
    assert _parse_class_spec(" 1:2 ") == {1: 2.0}
    assert _parse_class_spec("") == {}
    assert _parse_class_spec(None) == {}


def test_request_priority_default_and_class_label():
    assert Request([2, 3]).priority == 1
    assert Request([2, 3]).class_label == "p1"
    assert Request([2, 3], priority=0).class_label == "p0"
    assert Request([2, 3], priority=7).class_label == "p7"


def test_eff_priority_aging_promotes(small_gen):
    eng = make_engine(small_gen)
    sched = ServingScheduler(eng, priority_aging_s=2.0)
    sched.close()
    r = Request([2, 3], priority=4)
    r.t_submit = 100.0
    assert sched._eff_priority(r, 100.0) == pytest.approx(4.0)
    # 4 seconds of wait at 2 s/level promote two levels
    assert sched._eff_priority(r, 104.0) == pytest.approx(2.0)
    # aging off: pure strict priority (starvation is explicit)
    sched.priority_aging_s = 0.0
    assert sched._eff_priority(r, 104.0) == pytest.approx(4.0)


def test_n_ahead_counts_the_priority_queue_not_the_backlog(small_gen):
    """A high-priority arrival is judged against ITS queue: waiting
    batch requests do not count ahead of it, but earlier same-class
    submits do (stable FIFO within a class)."""
    eng = make_engine(small_gen)
    sched = ServingScheduler(eng, priority_aging_s=0.0)
    sched.close()
    now = 50.0

    def req(prio, t):
        r = Request([2, 3], priority=prio)
        r.t_submit = t
        return r

    batch = [req(2, 10.0), req(2, 11.0), req(2, 12.0)]
    high = req(0, 13.0)
    # the admission loop judges a request against the OTHER waiters
    assert sched._n_ahead_of(high, batch, now) == 0
    assert sched._n_ahead_of(
        batch[0], [batch[1], batch[2], high], now) == 1  # just high
    assert sched._n_ahead_of(
        batch[2], [batch[0], batch[1], high], now) == 3


def test_class_shed_slack_sheds_batch_first(small_gen):
    """With a calibrated predictor and a borderline deadline, the batch
    class (slack > 1, sheds early) is refused while the interactive
    class (slack < 1, holds longer) admits — low classes shed FIRST at
    the same offered deadline, by construction."""
    eng = make_engine(small_gen)
    sched = ServingScheduler(eng, class_shed_slack={0: 0.25, 2: 4.0})
    sched.close()
    sched._rung_token_s = {4: 0.01}  # est service 0.08 s at full house
    sched._ewma_tokens = 8.0
    now = 1000.0

    def req(prio, deadline):
        r = Request([2, 3], priority=prio, deadline_s=deadline)
        r.t_submit, r.t_deadline = now, now + deadline
        return r

    # per-class shed floor = 0.08 * 1.5 * slack: p0 -> 0.03s, p2 -> 0.48s
    assert sched._shed_verdict(req(0, 0.2), n_ahead=0, now=now) is None
    v = sched._shed_verdict(req(2, 0.2), n_ahead=0, now=now)
    assert v is not None and v.startswith("shed:")
    # an unconfigured class falls back to slack 1.0 (0.12s floor)
    assert sched._shed_verdict(req(1, 0.2), n_ahead=0, now=now) is None


def test_priority_dequeue_order_end_to_end(small_gen):
    """Strict-priority dequeue through the REAL engine: with one slot
    occupied, a later-submitted interactive request is served before the
    earlier batch backlog; ties within a class stay FIFO."""
    eng = make_engine(small_gen, max_slots=1)
    sched = ServingScheduler(eng)
    order = []
    note = lambda r: order.append(r.req_id)  # noqa: E731
    blocker = sched.submit(Request(srcs_of(31, (4,))[0], req_id="blk"))
    lows = [
        Request(s, priority=5, req_id=f"low{i}", callback=note)
        for i, s in enumerate(srcs_of(32, (4, 4)))
    ]
    high = Request(srcs_of(33, (4,))[0], priority=0, req_id="hi",
                   callback=note)
    for r in lows:
        sched.submit(r)
    sched.submit(high)
    for r in [blocker, *lows, high]:
        assert r.wait(60.0), r
    sched.close()
    assert order == ["hi", "low0", "low1"]
    assert all(r.status == "served" for r in [blocker, *lows, high])


def test_finalize_counts_per_class_ledger(small_gen):
    from paddle_tpu_torch.utils.timers import StatSet

    stats = StatSet()
    eng = make_engine(small_gen)
    sched = ServingScheduler(eng, stats=stats)
    a = sched.submit(Request(srcs_of(34, (4,))[0], priority=0))
    b = sched.submit(Request(srcs_of(35, (4,))[0]))
    assert a.wait(60.0) and b.wait(60.0)
    sched.close()
    s = stats.summary()
    # EVERY status lands in the class ledger, served included — the
    # class-labeled paddle_tpu_serving_requests_total series' source
    assert s["serving/class/p0/served"]["count"] == 1
    assert s["serving/class/p1/served"]["count"] == 1


def test_class_gauges_register_and_unregister(small_gen):
    from paddle_tpu_torch.obs.metrics import _registry

    eng = make_engine(small_gen)
    sched = ServingScheduler(eng)
    # a blocker holds the slot so a priority-stamped waiter sits in the
    # queue long enough for the step loop to snapshot its class
    blk = sched.submit(Request(srcs_of(36, (4,))[0]))
    for _ in range(40):
        sched.submit(Request(srcs_of(37, (4,))[0], priority=3,
                             deadline_s=60.0))
        keys = set(_registry.snapshot())
        if any("paddle_tpu_serving_class_queue_depth" in k
               and 'class="p3"' in k for k in keys):
            break
        blk.wait(0.05)
    else:
        pytest.fail("per-class gauges never registered")
    sched.close()
    keys = set(_registry.snapshot())
    assert not any("paddle_tpu_serving_class_queue_depth" in k
                   and 'class="p3"' in k for k in keys), keys
    assert not any("paddle_tpu_serving_class_predicted_wait" in k
                   and 'class="p3"' in k for k in keys), keys


# ---------------------------------------------------------------------------
# chaos drills (tests/test_serving_e2e.py) and the JAX scheduler
# ---------------------------------------------------------------------------


def test_chaos_nan_request_rejected_without_stalling(small_gen):
    """The 3rd submission is poisoned in flight: it is rejected with an
    error result and every other request completes with the one-shot
    path's tokens, promptly."""
    eng = make_engine(small_gen, max_slots=8, hbm_budget_mb=2)
    chaos.arm("nan_request@3")
    t0 = time.perf_counter()
    with ServingScheduler(eng) as sched:
        reqs = [sched.submit(Request(s)) for s in srcs_of(5, (6,) * 8)]
        for r in reqs:
            assert r.wait(60), r
    wall = time.perf_counter() - t0
    assert _no_leaked_serve_threads()
    poisoned = [r for r in reqs if r.error is not None]
    assert poisoned == [reqs[2]] and "non-integral" in poisoned[0].error
    for r in reqs[:2] + reqs[3:]:
        assert r.result() == eng.reference_decode(r.src_ids, MAXLEN)
    assert wall < 30.0, wall


def test_chaos_slow_client_stalls_only_delivery(small_gen, monkeypatch):
    """A callback frozen for 2 s blocks neither the decode loop nor the
    other clients' wait(): only delivery serializes behind it."""
    monkeypatch.setenv("PADDLE_TPU_TORCH_CHAOS_HANG_SECS", "2")
    eng = make_engine(small_gen, max_slots=8, hbm_budget_mb=2)
    chaos.arm("serve_slow_client@1")
    delivered = []
    with ServingScheduler(eng) as sched:
        reqs = [sched.submit(Request(s, callback=delivered.append))
                for s in srcs_of(6, (5,) * 6)]
        t0 = time.perf_counter()
        for r in reqs:
            assert r.wait(60), r
        assert time.perf_counter() - t0 < 2.0
    assert _no_leaked_serve_threads()
    assert len(delivered) == 6
    for r in reqs:
        assert r.result() == eng.reference_decode(r.src_ids, MAXLEN)


def test_scheduler_tokens_equal_the_jax_scheduler(small_gen, jparams):
    """The same requests (one of them past the chunk bound) through each
    package's scheduler over its own engine, with chunked prefill, the
    prefix cache and speculative decoding on: the same statuses and
    tokens."""
    from paddle_tpu.models.seq2seq import Seq2SeqGenerator as JGen
    from paddle_tpu.serving import Request as JRequest
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu.serving import ServingScheduler as JScheduler

    arms = dict(max_slots=4, hbm_budget_mb=4, max_new_tokens=MAXLEN, prefill_chunk_tokens=16,
                prefix_cache=True, spec_decode=True)
    srcs = srcs_of(40, (40, 4, 9, 4)) + srcs_of(40, (40, 4))
    runs = []
    for eng, sched_cls, make in (
            (JEngine(JGen(jparams, V, V, **_gen_kw()), **arms), JScheduler, JRequest),
            (make_engine(small_gen, **arms), ServingScheduler, Request)):
        with sched_cls(eng) as sched:
            reqs = [sched.submit(make(s)) for s in srcs]
            for r in reqs:
                assert r.wait(120), r
        runs.append([(r.status, r.tokens) for r in reqs])
    assert runs[0] == runs[1]
    assert all(status == "served" for status, _ in runs[1])
