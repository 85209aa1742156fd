"""The port's fleet router (``paddle_tpu_torch/serving/router.py``) on the
CPU: the twins of tests/test_router.py's policy cases (least-predicted-wait
choice, affinity keys and rendezvous movement, slack, drain-aware
exclusion, lease expiry, the zero-double-serve ledger and its journal,
frontend validation, the autoscaler hook) in-process with fake engines;
and the two packages on one wire: ``affinity_key`` and ``rendezvous_pick``
give the JAX package's answers, a journal written by either package's
router refuses re-serve in the other's, and an in-process socket fleet (a
router of either package over one port and one JAX ``EngineAgent``, each
over a real scheduler and engine on the same weights) serves every request
with the tokens of a single engine."""

import threading

import pytest

from paddle_tpu_torch.serving.router import (
    Router,
    affinity_key,
    rendezvous_pick,
)


class FakeClock:
    def __init__(self, now=0.0):
        self.now = float(now)

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += float(dt)


class FakeEngineClient:
    """Scripted engine data-plane client: behavior keyed on the engine's
    fake address (the router never cares what is behind the dial)."""

    def __init__(self, book, address):
        self._book = book
        self._addr = (str(address[0]), int(address[1]))

    def serve(self, req_id, src_ids, max_new_tokens=None, deadline_s=None,
              beam_size=None, session_id=None, priority=None):
        self._book.setdefault("serves", []).append((self._addr, str(req_id)))
        fn = self._book.get("serve")
        if fn is not None:
            return fn(self._addr, req_id, src_ids)
        return {
            "req_id": str(req_id), "status": "served",
            "tokens": [7, 8, 9], "error": None,
            "engine": f"fake@{self._addr[1]}",
        }

    def stats(self):
        return dict(self._book.get("stats", {}).get(self._addr, {}))

    def drain(self, timeout_s):
        self._book.setdefault("drains", []).append(self._addr)
        return True

    def ping(self):
        return "pong"

    def close(self):
        pass


def make_router(book, clk, **kw):
    kw.setdefault("address", None)
    kw.setdefault("stats_poll_s", 3600.0)  # poll thread idles: units script
    kw.setdefault("lease_timeout_s", 2.0)  # h.stats directly
    kw.setdefault("sleep", lambda s: clk.advance(s))
    return Router(
        clock=clk,
        client_factory=lambda addr, timeout: FakeEngineClient(book, addr),
        **kw,
    )


def set_stats(router, engine_id, **st):
    with router._lock:
        router._engines[engine_id].stats = st


@pytest.fixture(autouse=True)
def _no_leaked_router_threads():
    before = {t for t in threading.enumerate()}
    yield
    leaked = [
        t for t in threading.enumerate()
        if t not in before and t.name.startswith("paddle-") and t.is_alive()
    ]
    assert not leaked, f"leaked router threads: {[t.name for t in leaked]}"


# -- routing policy ---------------------------------------------------------

def test_least_predicted_wait_choice():
    clk = FakeClock()
    r = make_router({}, clk, affinity=False)
    try:
        for i, e in enumerate(("a", "b", "c")):
            r.register_engine(e, "127.0.0.1", 9000 + i)
        set_stats(r, "a", predicted_wait_s=0.5, est_service_s=0.1,
                  max_slots=2)
        set_stats(r, "b", predicted_wait_s=0.05, est_service_s=0.1,
                  max_slots=2)
        set_stats(r, "c", predicted_wait_s=0.2, est_service_s=0.1,
                  max_slots=2)
        assert r.pick_engine() == "b"
        # router-side in-flight amortized over slots covers poll staleness:
        # 12 in flight on b -> 0.05 + 12*0.1/2 = 0.65 > c's 0.2, a's 0.5
        with r._lock:
            r._engines["b"].inflight = 12
        assert r.pick_engine() == "c"
        # exclusion (the re-route `tried` set) falls through to the next
        assert r.pick_engine(exclude=("c",)) == "a"
    finally:
        r.close()


def test_affinity_key_stability():
    blk = 16
    head = list(range(2, 2 + blk))  # one whole block
    k1 = affinity_key(head + [30, 31], None, blk)
    k2 = affinity_key(head + [40, 41, 42], None, blk)
    k3 = affinity_key(head + [30, 31], None, blk)
    # the key hashes WHOLE blocks only: same head-block => same key,
    # whatever the sub-block tail — exactly the prefix-cache share unit
    assert k1 == k2 == k3
    assert affinity_key([9] * blk + [1], None, blk) != k1
    # a session id overrides the content hash (conversation stickiness)
    assert affinity_key(head, "u1", blk) == "sess:u1"
    # sub-block prompts still key deterministically
    assert affinity_key([2, 3], None, blk) == affinity_key([2, 3], None, blk)


def test_rendezvous_minimal_movement():
    keys = [f"k{i}" for i in range(100)]
    old = ["e0", "e1", "e2"]
    before = {k: rendezvous_pick(k, old) for k in keys}
    # stable under permutation of the candidate list
    assert all(
        rendezvous_pick(k, ["e2", "e0", "e1"]) == before[k] for k in keys
    )
    after = {k: rendezvous_pick(k, old + ["e3"]) for k in keys}
    moved = [k for k in keys if after[k] != before[k]]
    # rendezvous hashing: every moved key moved TO the new engine, and
    # roughly 1/4 of the keyspace moved (not a full reshuffle)
    assert moved and all(after[k] == "e3" for k in moved)
    assert len(moved) < 50


def test_affinity_respects_slack():
    clk = FakeClock()
    r = make_router({}, clk, affinity=True, affinity_slack_s=0.25)
    try:
        r.register_engine("a", "127.0.0.1", 9000)
        r.register_engine("b", "127.0.0.1", 9001)
        key = "sess:pin"
        pref = rendezvous_pick(key, ["a", "b"])
        other = "b" if pref == "a" else "a"
        # within slack: affinity wins even when the other engine is idler
        set_stats(r, pref, predicted_wait_s=0.2, est_service_s=0.0,
                  max_slots=1)
        set_stats(r, other, predicted_wait_s=0.0, est_service_s=0.0,
                  max_slots=1)
        assert r.pick_engine(key) == pref
        # beyond slack: load wins over stickiness
        set_stats(r, pref, predicted_wait_s=10.0, est_service_s=0.0,
                  max_slots=1)
        assert r.pick_engine(key) == other
    finally:
        r.close()


def test_drain_aware_exclusion():
    clk = FakeClock()
    book = {}
    r = make_router(book, clk, affinity=False)
    try:
        r.register_engine("a", "127.0.0.1", 9000)
        r.register_engine("b", "127.0.0.1", 9001)
        with r._lock:
            r._engines["a"].draining = True
        assert r.pick_engine() == "b"
        assert r.pick_engine(exclude=("b",)) is None  # draining never picked
        # the full drain protocol: forwarded over the wire, then deregistered
        assert r.drain_engine("b") is True
        assert book["drains"] == [("127.0.0.1", 9001)]
        assert r.pick_engine() is None
    finally:
        r.close()


def test_lease_expiry_removal():
    clk = FakeClock()
    r = make_router({}, clk, lease_timeout_s=2.0)
    try:
        r.register_engine("a", "127.0.0.1", 9000)
        r.register_engine("b", "127.0.0.1", 9001)
        clk.advance(1.0)
        assert r.heartbeat("a") is True  # renews to t=3.0
        clk.advance(1.5)  # t=2.5: b's lease (t=2.0) expired, a's holds
        assert r.live_engines() == ["a"]
        # an expired engine's heartbeat is refused — it must re-register
        assert r.heartbeat("b") is False
        ack = r.register_engine("b", "127.0.0.1", 9001)
        assert "b" in ack["engines"] and r.live_engines() == ["a", "b"]
    finally:
        r.close()


# -- the zero-double-serve ledger -------------------------------------------

def test_zero_double_serve_on_duplicate_delivery():
    clk = FakeClock()
    book = {}
    r = make_router(book, clk, affinity=False)
    try:
        r.register_engine("a", "127.0.0.1", 9000)
        first = r.serve("r1", [2, 3, 4])
        assert first["status"] == "served" and first["tokens"] == [7, 8, 9]
        # an at-least-once client retry re-delivers the SAME req_id: the
        # ledger returns the original record, flagged, without a second
        # engine dispatch
        again = r.serve("r1", [2, 3, 4])
        assert again["duplicate"] is True
        assert again["tokens"] == [7, 8, 9] and again["status"] == "served"
        assert [rid for _, rid in book["serves"]] == ["r1"]
        ledger = r.fleet_stats()["ledger"]
        assert ledger["served"] == 1 and sum(ledger.values()) == 1
    finally:
        r.close()


def test_duplicate_result_delivery_discarded():
    clk = FakeClock()
    r = make_router({}, clk)
    try:
        one = r._finalize("rq", "served", tokens=[1, 2], engine="a")
        assert one["tokens"] == [1, 2] and "duplicate" not in one
        # a re-route race delivers a SECOND terminal result for the same
        # id: first writer wins, the late copy is counted and discarded
        two = r._finalize("rq", "served", tokens=[9, 9], engine="b")
        assert two["duplicate"] is True and two["tokens"] == [1, 2]
        assert two["engine"] == "a"
        assert r.duplicates_discarded == 1
        assert r.fleet_stats()["ledger"]["served"] == 1
    finally:
        r.close()


def test_journal_failover_refuses_double_serve(tmp_path):
    journal = str(tmp_path / "journal.jsonl")
    clk = FakeClock()
    book = {}
    r1 = make_router(book, clk, journal_path=journal)
    try:
        r1.register_engine("a", "127.0.0.1", 9000)
        assert r1.serve("r1", [2, 3])["status"] == "served"
    finally:
        r1.close()
    # HA failover: a fresh incarnation recovers the ledger from the journal
    r2 = make_router(book, clk, journal_path=journal)
    try:
        r2.register_engine("a", "127.0.0.1", 9000)
        dup = r2.serve("r1", [2, 3])
        assert dup["duplicate"] is True and dup["status"] == "served"
        assert "recovered" in dup["error"]
        # only the original pre-failover dispatch ever reached an engine
        assert [rid for _, rid in book["serves"]] == ["r1"]
        fresh = r2.serve("r2", [2, 3])
        assert fresh["status"] == "served" and "duplicate" not in fresh
    finally:
        r2.close()


def test_frontend_validation_rejects_before_network():
    clk = FakeClock()
    book = {}
    r = make_router(book, clk)
    try:
        r.register_engine("a", "127.0.0.1", 9000)
        bad = [
            r.serve("v1", "not-a-token-list"),
            r.serve("v2", [2, -5, 3]),
            r.serve("v3", [2, 3], max_new_tokens=0),
            r.serve("v4", [2, 3], deadline_s=-1.0),
            r.serve("v5", [2, 3], beam_size=0),
        ]
        assert all(b["status"] == "rejected" for b in bad)
        assert book.get("serves", []) == []  # no network hop was paid
        ledger = r.fleet_stats()["ledger"]
        assert ledger["rejected"] == 5 and sum(ledger.values()) == 5
    finally:
        r.close()


def test_autoscaler_hook_spawn_and_retire():
    clk = FakeClock(100.0)
    # the scale decisions, not the lease plane, are under test: a lease
    # long enough that the virtual-clock jumps never expire anyone
    r = make_router({}, clk, lease_timeout_s=1000.0)
    try:
        r.register_engine("a", "127.0.0.1", 9000)
        calls = []
        r.set_autoscaler(
            spawn=lambda router: calls.append("spawn"),
            retire=lambda router, e: calls.append(f"retire:{e}"),
            shed_rate_threshold=0.5, window_s=5.0, min_engines=1,
            max_engines=4, cooldown_s=1.0,
        )
        # sustained shed rate above threshold -> spawn
        with r._lock:
            r._shed_times.extend([clk.now - 0.5] * 4)
        assert r.maybe_autoscale() == "spawn"
        assert calls == ["spawn"]
        # cooldown gates a second action
        assert r.maybe_autoscale() is None
        # a quiet window with a fleet above min -> retire the idlest
        clk.advance(10.0)
        r.register_engine("b", "127.0.0.1", 9001)
        assert r.maybe_autoscale() == "retire"
        assert calls == ["spawn", "retire:a"]
    finally:
        r.close()


# ---------------------------------------------------------------------------
# the two packages on one wire
# ---------------------------------------------------------------------------


def test_affinity_and_rendezvous_equal_jax():
    import numpy as np

    from paddle_tpu.serving import router as jrouter

    rng = np.random.RandomState(0)
    engines = [f"engine-{i}" for i in range(5)]
    for n in (1, 5, 16, 17, 40, 64):
        toks = rng.randint(0, 30000, size=n).tolist()
        for bt in (8, 16):
            key = affinity_key(toks, block_tokens=bt)
            assert key == jrouter.affinity_key(toks, block_tokens=bt)
            for k in range(1, 6):
                assert rendezvous_pick(key, engines[:k]) == jrouter.rendezvous_pick(key, engines[:k])
    assert affinity_key([2, 3], session_id="s9") == jrouter.affinity_key([2, 3], session_id="s9")
    assert affinity_key([]) is None and jrouter.affinity_key([]) is None


@pytest.mark.parametrize("first,second", [("torch", "jax"), ("jax", "torch")])
def test_journal_written_by_either_package_recovers_in_the_other(tmp_path, first, second):
    from paddle_tpu.serving.router import Router as JRouter

    classes = {"torch": Router, "jax": JRouter}
    journal = str(tmp_path / "journal.jsonl")
    clk = FakeClock()
    book = {}

    def make(pkg):
        return classes[pkg](address=None, stats_poll_s=3600.0, lease_timeout_s=2.0,
                            sleep=lambda s: clk.advance(s), clock=clk, journal_path=journal,
                            client_factory=lambda addr, timeout: FakeEngineClient(book, addr))

    r1 = make(first)
    try:
        r1.register_engine("a", "127.0.0.1", 9000)
        assert r1.serve("r1", [2, 3])["status"] == "served"
    finally:
        r1.close()
    r2 = make(second)
    try:
        r2.register_engine("a", "127.0.0.1", 9000)
        dup = r2.serve("r1", [2, 3])
        assert dup["duplicate"] is True and dup["status"] == "served"
        assert "recovered" in dup["error"]
        assert [rid for _, rid in book["serves"]] == ["r1"]
        assert r2.serve("r2", [2, 3])["status"] == "served"
    finally:
        r2.close()


V, E, H, MAXLEN = 20, 8, 12, 8


@pytest.fixture(scope="module")
def engines():
    """A port engine (CPU) and a JAX engine over the same seeded weights."""
    import paddle_tpu
    from paddle_tpu.core.topology import reset_auto_names as j_reset
    from paddle_tpu.models.seq2seq import Seq2SeqGenerator as JGen
    from paddle_tpu.models.seq2seq import seq2seq_cost as j_cost
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu_torch.core.topology import reset_auto_names
    from paddle_tpu_torch.models.seq2seq import Seq2SeqGenerator, seq2seq_cost
    from paddle_tpu_torch.serving import ServingEngine
    from test_torch_parity import carry

    kw = dict(word_dim=E, hidden_dim=H, bos_id=0, eos_id=1, max_length=MAXLEN)
    j_reset()
    cost, _ = j_cost(V, V, word_dim=E, hidden_dim=H)
    jparams = paddle_tpu.parameters.create(cost, seed=5)
    reset_auto_names()
    tcost, _ = seq2seq_cost(V, V, word_dim=E, hidden_dim=H)
    ekw = dict(max_slots=4, hbm_budget_mb=1, max_new_tokens=MAXLEN)
    teng = ServingEngine(Seq2SeqGenerator(carry(jparams, tcost), V, V, device="cpu", **kw),
                         device="cpu", **ekw)
    return teng, JEngine(JGen(jparams, V, V, **kw), **ekw)


@pytest.mark.parametrize("router_pkg", ["torch", "jax"])
def test_socket_fleet_of_both_packages_serves_like_one_engine(engines, router_pkg):
    import numpy as np

    from paddle_tpu.serving import EngineAgent as JAgent
    from paddle_tpu.serving import FleetClient as JFleetClient
    from paddle_tpu.serving import Request as JRequest
    from paddle_tpu.serving import Router as JRouter
    from paddle_tpu.serving import ServingScheduler as JScheduler
    from paddle_tpu_torch.serving import EngineAgent, FleetClient, Request, ServingScheduler

    teng, jeng = engines
    router_cls, client_cls, make = ((Router, FleetClient, Request) if router_pkg == "torch"
                                    else (JRouter, JFleetClient, JRequest))
    router = router_cls(address=("127.0.0.1", 0), stats_poll_s=0.1, lease_timeout_s=5.0,
                        affinity=False)
    scheds = [ServingScheduler(teng), JScheduler(jeng)]
    agents = []
    try:
        agents = [EngineAgent(scheds[0], "torch0", router.address),
                  JAgent(scheds[1], "jax0", router.address)]
        for a in agents:
            assert a.registered.wait(20.0), "engine never registered"
        rng = np.random.RandomState(8)
        srcs = [rng.randint(2, V, size=rng.randint(3, 20)).tolist() for _ in range(12)]
        reqs = [make(s, MAXLEN, req_id=f"f{i}") for i, s in enumerate(srcs)]
        fc = client_cls(router.address)
        try:
            for r in reqs:
                fc.submit(r)
            for r in reqs:
                assert r.wait(60.0), f"request {r.req_id} never finalized"
        finally:
            fc.close()
        for r in reqs:
            assert r.status == "served" and r.error is None, r
            assert r.tokens == teng.reference_decode(r.src_ids, MAXLEN), r.req_id
        ledger = router.fleet_stats()["ledger"]
        assert ledger["served"] == 12 and sum(ledger.values()) == 12
        assert router.duplicates_discarded == 0
        served = [s._stats.count("serving/completed") for s in scheds]
        assert sum(served) >= 12
    finally:
        for a in agents:
            a.close()
        for s in scheds:
            s.close()
        router.close()
