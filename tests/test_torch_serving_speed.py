"""The port's decode speed arms (``paddle_tpu_torch/serving/``) on the CPU,
at tests/test_serving_speed.py's tiny NMT over the JAX package's seeded
parameters: the twins of that file's cases (refcounted block sharing,
prefill-once with zero prefill dispatches, concurrent hits, the signature
guard, eviction, copy-on-write, forward-carry reuse, speculative decoding
alone and with the prefix cache, cancellation mid-speculation, beam
serving alone and mixed with greedy, beam validation, the prefix mixer),
each request held to the port's own one-shot path bit for bit (beam scores
included); and every arm's tokens held to the JAX engine's under the same
arm on the same requests (beam scores at rel 1e-5)."""

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core.topology import reset_auto_names
from paddle_tpu_torch.models.seq2seq import Seq2SeqGenerator, seq2seq_cost
from paddle_tpu_torch.reader.loadgen import PrefixMixer
from paddle_tpu_torch.serving import Request, ServingEngine, ServingScheduler
from paddle_tpu_torch.serving.pages import BlockPagedCache
from paddle_tpu_torch.utils.timers import StatSet
from test_torch_parity import carry

V, E, H = 20, 8, 12
BOS, EOS = 0, 1
MAXLEN = 8


@pytest.fixture(autouse=True)
def _flags():
    yield
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


@pytest.fixture(scope="module")
def jgen(jparams):
    from paddle_tpu.models.seq2seq import Seq2SeqGenerator as JGen

    return JGen(jparams, V, V, **_gen_kw())


def make_engine(small_gen, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("hbm_budget_mb", 1)
    kw.setdefault("max_new_tokens", MAXLEN)
    kw.setdefault("stats", StatSet())
    return ServingEngine(small_gen, device="cpu", **kw)


def srcs_of(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, V, size=n).tolist() for n in lengths]


def run_all(eng, reqs, max_steps=400):
    done = []
    pending = list(reqs)
    for _ in range(max_steps):
        if pending:
            admitted = eng.admit(pending)
            pending = pending[len(admitted):]
        done += eng.step()
        if len(done) == len(reqs):
            return done
        if not (pending or eng.n_live or eng.n_prefilling):
            break
    raise AssertionError(f"only {len(done)}/{len(reqs)} finished")


# ---------------------------------------------------------------------------
# the twins of tests/test_serving_speed.py
# ---------------------------------------------------------------------------


def test_pages_share_release_refcounts():
    c = BlockPagedCache(16, {"x": 1}, n_blocks=4, stats=StatSet())
    a = c.alloc(2)
    assert [c.refcount(p) for p in a] == [1, 1] and c.n_shared == 0
    c.share(a)
    assert [c.refcount(p) for p in a] == [2, 2]
    assert c.n_shared == 2 and c.n_used == 2  # shared blocks count ONCE
    c.release(a)
    assert [c.refcount(p) for p in a] == [1, 1] and c.n_shared == 0
    assert c.n_free == 2  # still held by the other table
    c.release(a)
    assert c.n_free == 4 and c.n_used == 0


def test_pages_double_release_and_bad_share_rejected():
    c = BlockPagedCache(16, {"x": 1}, n_blocks=4, stats=StatSet())
    a = c.alloc(1)
    c.free(a)
    with pytest.raises(ValueError, match="double free"):
        c.release(a)
    with pytest.raises(ValueError, match="sharing free block"):
        c.share(a)  # freed bytes are undefined — sharing them is a bug
    with pytest.raises(ValueError, match="foreign"):
        c.release([99])
    with pytest.raises(ValueError, match="foreign"):
        c.share([-1])


def test_pages_retain_lru_eviction_order():
    c = BlockPagedCache(16, {"x": 1}, n_blocks=4, stats=StatSet())
    evicted = []
    c.on_evict = evicted.append
    a = c.alloc(1)
    b = c.alloc(1)
    c.release(a, retain=True)  # oldest retained
    c.release(b, retain=True)
    assert c.n_retained == 2 and c.n_used == 0  # warm, not in use
    # revival: share takes a retained block back out of the LRU pool
    c.share(a)
    assert c.n_retained == 1 and c.refcount(a[0]) == 1
    c.release(a, retain=True)
    # alloc(4): 2 from the free list, then retained evict oldest-first
    got = c.alloc(4)
    assert got is not None and len(got) == 4
    assert evicted == [b[0], a[0]]  # b parked before a's re-park: b first
    assert c.n_retained == 0


def test_pages_cow_swaps_only_shared_blocks():
    c = BlockPagedCache(16, {"x": 1}, n_blocks=4, stats=StatSet())
    a = c.alloc(2)
    c.share([a[0]])  # a[0] shared with another table, a[1] exclusive
    new, copies = c.cow(a)
    assert copies and copies[0][0] == a[0]
    assert new[1] == a[1]  # exclusive block untouched
    assert new[0] != a[0] and c.refcount(new[0]) == 1
    assert c.refcount(a[0]) == 1  # the other reader keeps the original
    # refusal path: everything shared, no free blocks for the copies
    c2 = BlockPagedCache(16, {"x": 1}, n_blocks=2, stats=StatSet())
    d = c2.alloc(2)
    c2.share(d)
    assert c2.cow(d) == (None, [])


def test_prefill_once_zero_dispatches_bit_identical(small_gen):
    eng = make_engine(small_gen, prefix_cache=True)
    src = srcs_of(40, (7,))[0]
    golden = eng.reference_decode(src, MAXLEN)

    (r1,) = run_all(eng, [Request(src)])
    assert r1.tokens == golden
    assert eng.prefix_misses == 1 and eng.prefix_hits == 0
    assert eng.prefix_cache_len == 1
    assert eng.pages.n_used == 0 and eng.pages.n_retained >= 1

    before = dict(eng.trace_counts)
    dispatches = []
    orig_prefill = eng._prefill
    eng._prefill = lambda *a: (dispatches.append(1), orig_prefill(*a))[1]
    (r2,) = run_all(eng, [Request(src)])
    assert r2.tokens == golden  # bit-identical through the shared blocks
    assert eng.prefix_hits == 1
    # no prefill work for the warmed prompt: no prefill or chunk
    # dispatch counted, and the prefill program never called
    assert eng.trace_counts["prefill"] == before["prefill"]
    assert eng.trace_counts["prefill_chunk"] == before["prefill_chunk"]
    assert dispatches == []
    assert eng.pages.n_used == 0  # gauge drains even with a warm cache


def test_prefix_sharing_concurrent_hits_share_blocks(small_gen):
    eng = make_engine(small_gen, prefix_cache=True)
    src = srcs_of(41, (9,))[0]
    run_all(eng, [Request(src)])  # warm the entry
    r_a, r_b = Request(src), Request(src)
    eng.admit([r_a, r_b])
    assert eng.prefix_hits == 2
    assert eng.pages.n_shared >= 1  # both tables map the SAME blocks
    done = []
    for _ in range(100):
        done += eng.step()
        if len(done) == 2:
            break
    golden = eng.reference_decode(src, MAXLEN)
    assert r_a.tokens == golden and r_b.tokens == golden
    assert eng.pages.n_used == 0 and eng.pages.n_shared == 0


def test_prefix_cache_signature_mismatch_misses(small_gen):
    """The aliasing guard: an engine whose signature (topology
    fingerprint / feed dtype / tokenizer ids) differs must MISS on the
    same token ids — mutated here by tampering the signature hash, which
    stands in for any component of the tuple changing."""
    eng = make_engine(small_gen, prefix_cache=True)
    src = srcs_of(42, (6,))[0]
    run_all(eng, [Request(src)])
    assert eng.prefix_cache_len == 1
    eng._cache_sig_hash ^= 0x5BD1E995  # any signature component changing
    (r2,) = run_all(eng, [Request(src)])
    assert eng.prefix_hits == 0 and eng.prefix_misses == 2
    assert r2.tokens == eng.reference_decode(src, MAXLEN)


def test_prefix_entry_dies_with_evicted_block(small_gen):
    """LRU pressure reclaims a retained block -> the owning entry drops
    WHOLE (a later hit can never map half-dead bytes), and the prompt
    simply re-prefills correctly."""
    eng = make_engine(small_gen, prefix_cache=True)
    src = srcs_of(43, (5,))[0]
    run_all(eng, [Request(src)])
    assert eng.prefix_cache_len == 1
    n = eng.pages.n_free + eng.pages.n_retained
    held = eng.pages.alloc(n)  # drain the pool: retained blocks evict
    assert held is not None
    assert eng.prefix_cache_len == 0
    eng.pages.free(held)
    (r2,) = run_all(eng, [Request(src)])
    assert eng.prefix_hits == 0  # entry was gone — honest miss
    assert r2.tokens == eng.reference_decode(src, MAXLEN)


def test_cow_copies_pool_rows_before_remap(small_gen):
    eng = make_engine(small_gen, prefix_cache=True)
    src = srcs_of(44, (8,))[0]
    run_all(eng, [Request(src)])
    r_a, r_b = Request(src), Request(src)
    eng.admit([r_a, r_b])
    sid_a = next(iter(eng._slots))
    s = eng._slots[sid_a]
    old_pages = list(s.pages)
    enc_before = np.asarray(eng._enc_pool)[old_pages]
    assert eng.ensure_private_pages(s) is True
    assert s.pages != old_pages
    assert all(eng.pages.refcount(p) == 1 for p in s.pages)
    # the copy half of copy-on-write: private rows hold the same bytes
    assert np.array_equal(np.asarray(eng._enc_pool)[s.pages], enc_before)
    # the OTHER reader still maps the originals, now exclusively
    other = eng._slots[[k for k in eng._slots if k != sid_a][0]]
    assert list(other.pages) == old_pages
    # already-private slots are a no-op
    again = list(s.pages)
    assert eng.ensure_private_pages(s) is True and s.pages == again


def test_chunked_fw_carry_reuse(small_gen):
    """Partial-prefix reuse on the chunked path: a long prompt sharing
    chunk-aligned forward chunks with an earlier prompt resumes its fw
    scan at the cached boundary (the bw pass always re-runs — it reads
    the suffix) and stays bit-identical."""
    eng = make_engine(
        small_gen, prefix_cache=True, prefill_chunk_tokens=16,
        hbm_budget_mb=4,
    )
    base = srcs_of(45, (40,))[0]
    (r1,) = run_all(eng, [Request(base)])
    assert r1.tokens == eng.reference_decode(base, MAXLEN)
    # same first 32 tokens (two full 16-token chunks), different tail
    src2 = base[:32] + srcs_of(46, (8,))[0]
    r2 = Request(src2)
    eng.admit([r2])
    p = next(iter(eng._prefilling.values()))
    assert p.cursor == 2  # fw scan resumes AFTER the two cached chunks
    assert eng._stats.count("serving/prefix_fw_reuse") == 2
    while eng.n_live or eng.n_prefilling:
        eng.step()
    assert r2.tokens == eng.reference_decode(src2, MAXLEN)


def test_spec_decode_bit_identical_to_greedy(small_gen):
    srcs = srcs_of(50, (3, 7, 11, 2, 9))
    eng = make_engine(small_gen, spec_decode=True, hbm_budget_mb=2)
    done = run_all(eng, [Request(s) for s in srcs])
    assert len(done) == len(srcs)
    for r in done:
        assert r.tokens == eng.reference_decode(r.src_ids, MAXLEN), r.req_id
    assert eng.spec_proposed > 0
    assert 0.0 <= eng.spec_accept_rate() <= 1.0
    assert eng.trace_counts["verify"] >= 1
    assert eng.trace_counts["decode"] == 0  # spec path owns every step
    s = eng.summary()
    assert s["spec_decode"] is True
    assert s["spec_accept_rate"] == eng.spec_accept_rate()


def test_spec_decode_with_prefix_cache(small_gen):
    """The two tentpole halves composed: a warmed-prefix hit decoding
    speculatively over SHARED blocks is still bit-identical (verify only
    reads the encoder pools; rejection falls back to true greedy)."""
    src = srcs_of(51, (10,))[0]
    eng = make_engine(small_gen, spec_decode=True, prefix_cache=True)
    golden = eng.reference_decode(src, MAXLEN)
    (r1,) = run_all(eng, [Request(src)])
    (r2,) = run_all(eng, [Request(src)])
    assert eng.prefix_hits == 1
    assert r1.tokens == golden and r2.tokens == golden


def test_cancel_mid_speculation_releases_pages(small_gen):
    eng = make_engine(small_gen, spec_decode=True, prefix_cache=True)
    srcs = srcs_of(52, (6, 8))
    reqs = [Request(s) for s in srcs]
    eng.admit(reqs)
    eng.step()  # at least one verify dispatch in flight state
    for r in reqs:
        eng.cancel(r)
    assert eng.n_live == 0 and eng.pages.n_used == 0
    assert eng.n_free_slots == eng.max_slots


def test_beam_request_matches_one_shot(small_gen):
    eng = make_engine(small_gen, hbm_budget_mb=2)
    srcs = srcs_of(60, (4, 9, 6))
    reqs = [Request(s, beam_size=3) for s in srcs]
    done = run_all(eng, reqs)
    assert len(done) == len(reqs)
    for r in done:
        toks, score = eng.reference_beam(r.src_ids, 3, MAXLEN)
        assert r.tokens == toks, r.req_id
        assert r.beam_score == score  # the one-shot path's, bit for bit
    assert eng.pages.n_used == 0
    assert eng._stats.count("serving/beam_requests") == len(reqs)


def test_beam_mixed_with_greedy_slots(small_gen):
    """Beam and greedy requests interleave in one engine: beam slots
    retire via their own whole-sequence dispatch, greedy slots keep the
    batched decode loop, and neither disturbs the other's output."""
    eng = make_engine(small_gen, hbm_budget_mb=2)
    g_src, b_src = srcs_of(61, (5, 7))
    rg, rb = Request(g_src), Request(b_src, beam_size=2)
    done = run_all(eng, [rg, rb])
    assert len(done) == 2
    assert rg.tokens == eng.reference_decode(g_src, MAXLEN)
    toks, _ = eng.reference_beam(b_src, 2, MAXLEN)
    assert rb.tokens == toks


def test_beam_size_one_is_greedy(small_gen):
    eng = make_engine(small_gen)
    src = srcs_of(62, (6,))[0]
    (r,) = run_all(eng, [Request(src, beam_size=1)])
    assert r.tokens == eng.reference_decode(src, MAXLEN)
    assert eng.trace_counts["beam"] == 0  # beam of one IS the greedy loop


def test_beam_size_validation_through_scheduler(small_gen):
    eng = make_engine(small_gen)
    with ServingScheduler(eng) as sched:
        bad = [
            sched.submit(Request([2, 3], beam_size=0)),
            sched.submit(Request([2, 3], beam_size="wide")),
            sched.submit(Request([2, 3], beam_size=V + 1)),
        ]
        good = sched.submit(Request(srcs_of(63, (5,))[0], beam_size=2))
        assert good.wait(60)
        for r in bad:
            assert r.wait(60) and r.status == "rejected", r.req_id
        assert "positive integer" in bad[0].error
        assert "positive integer" in bad[1].error
        assert "exceeds the target vocab" in bad[2].error
        assert good.status == "served" and good.beam_score is not None


def test_prefix_mixer_deterministic_and_shaped():
    m1 = PrefixMixer(V, pool_size=3, prefix_frac=0.6, seed=7)
    m2 = PrefixMixer(V, pool_size=3, prefix_frac=0.6, seed=7)
    srcs = [m1.source(i) for i in range(64)]
    assert srcs == [m2.source(i) for i in range(64)]  # replayable drill
    assert all(2 <= t < V for s in srcs for t in s)
    prefixed = [
        s for i, s in enumerate(srcs)
        if s[: len(m1.pool[i % 3])] == m1.pool[i % 3]
    ]
    assert prefixed  # the hit path gets offered load
    assert len(prefixed) < len(srcs)  # and the miss path too
    dups = [s for s in srcs if s in (list(p) for p in m1.pool)]
    assert dups  # exact full-prompt repeats exercise prefill-once
    with pytest.raises(ValueError, match="prefix_frac"):
        PrefixMixer(V, prefix_frac=1.5)
    with pytest.raises(ValueError, match="pool_size"):
        PrefixMixer(V, pool_size=0)


def test_serving_speed_gauges_render(small_gen):
    from paddle_tpu_torch.obs.metrics import render_prometheus

    eng = make_engine(small_gen, prefix_cache=True, spec_decode=True)
    src = srcs_of(70, (6,))[0]
    with ServingScheduler(eng) as sched:
        for _ in range(2):
            r = sched.submit(Request(src))
            assert r.wait(60) and r.status == "served"
        text = render_prometheus()
        assert "paddle_tpu_serving_prefix_cache_hits 1.0" in text
        assert "paddle_tpu_serving_prefix_cache_misses 1.0" in text
        assert "paddle_tpu_serving_pages_shared 0.0" in text
        assert "paddle_tpu_serving_spec_accept_rate" in text
    text = render_prometheus()
    assert "paddle_tpu_serving_prefix_cache_hits" not in text


# ---------------------------------------------------------------------------
# every arm against the JAX engine
# ---------------------------------------------------------------------------

# (engine arms, request sources, beam width of each request or None); the
# second round repeats the first's prompts (prefix hits), with a long prompt
# sharing two chunk-aligned chunks with an earlier one (forward-carry reuse)
_ARMS = {
    "chunked": (dict(prefill_chunk_tokens=16, hbm_budget_mb=4),
                srcs_of(20, (40, 70)) + srcs_of(21, (3, 5)), None),
    "prefix": (dict(prefix_cache=True, prefill_chunk_tokens=16, hbm_budget_mb=4),
               srcs_of(45, (40, 6, 9)), None),
    "spec": (dict(spec_decode=True, hbm_budget_mb=2), srcs_of(50, (3, 7, 11, 2, 9)), None),
    "spec_prefix": (dict(spec_decode=True, prefix_cache=True, hbm_budget_mb=2),
                    srcs_of(51, (10, 4)), None),
    "beam": (dict(hbm_budget_mb=2), srcs_of(60, (4, 9, 6)), [3, 3, 3]),
    "beam_mixed": (dict(hbm_budget_mb=2), srcs_of(61, (5, 7, 3)), [None, 2, 1]),
    "int8": (dict(int8_weights=True, hbm_budget_mb=2), srcs_of(9, (3, 5, 9, 2, 17)), None),
}


@pytest.mark.parametrize("arm", sorted(_ARMS))
def test_arm_tokens_equal_the_jax_engine(small_gen, jgen, arm):
    from paddle_tpu.serving import Request as JRequest
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu.utils.timers import StatSet as JStatSet

    kw, srcs, beams = _ARMS[arm]
    kw = dict(kw, max_slots=4, max_new_tokens=MAXLEN)
    beams = beams or [None] * len(srcs)
    rounds = [srcs]
    if kw.get("prefix_cache"):
        rounds.append(srcs + [srcs[0][:32] + srcs_of(46, (8,))[0]])
    runs = []
    for eng, make in ((JEngine(jgen, stats=JStatSet(), **kw), JRequest),
                      (make_engine(small_gen, **kw), Request)):
        out = []
        for rnd in rounds:
            reqs = [make(s, beam_size=b) for s, b in zip(rnd, beams + [None] * len(rnd))]
            run_all(eng, reqs)
            out += reqs
        runs.append((eng, out))
    (jeng, jreqs), (teng, treqs) = runs
    for j, t in zip(jreqs, treqs):
        assert t.tokens == j.tokens, (arm, t.req_id)
        if t.beam_size and t.beam_size > 1:
            assert t.beam_score == pytest.approx(j.beam_score, rel=1e-5)
            assert (t.tokens, t.beam_score) == teng.reference_beam(t.src_ids, t.beam_size, MAXLEN)
        elif arm != "int8":
            assert t.tokens == teng.reference_decode(t.src_ids, MAXLEN), (arm, t.req_id)
    assert (teng.prefix_hits, teng.prefix_misses) == (jeng.prefix_hits, jeng.prefix_misses)
    if teng.spec_decode:
        assert teng.spec_accept_rate() == jeng.spec_accept_rate()
    if arm == "int8":
        assert abs(teng.weight_drift() - jeng.weight_drift()) <= 1e-6
        assert teng.weight_bytes == jeng.weight_bytes
    if arm == "prefix":
        assert teng._stats.count("serving/prefix_fw_reuse") == 2
