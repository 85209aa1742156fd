"""The serving plane of the port (``paddle_tpu_torch/serving/``) on the CPU in
f32, at the JAX package's test sizes (vocab 20, word width 8, hidden 12):

- the ``BlockPagedCache`` cases of tests/test_serving.py:66-101 on the
  port's copy;
- the engine cases of tests/test_serving.py:103-232, :342 and :510-552:
  the fused match is required; staggered admission, preemption and
  ``block_steps`` 1, 4 and 8 give each request ``reference_decode``'s tokens;
  the shape variants stay bounded by the ladders; admission is refused
  until pages free; the ``max_new_tokens`` cap; ``cancel_by_id`` frees the
  pages;
- each request's tokens equal the JAX engine's on the same weights;
- finite garbage in the scratch page and the scratch slot changes no live
  request's tokens (padding rows write there, several times per prefill);
- chunked prefill (tests/test_serving.py:425-488): interleaved with
  decoding and cancelled mid-prefill, its flag checks, and an encoder
  outside the idiom raising when the engine is built;
- ``paddle_tpu_torch.serving`` binds the JAX package's names, and the once
  deferred arm (``aot_cache_dir``) gives the engine the build store, whose
  summary the engine's reports.

The other arms live in tests/test_torch_serving_speed.py, the scheduler in
tests/test_torch_scheduler.py."""

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core.topology import reset_auto_names
from paddle_tpu_torch.models.seq2seq import Seq2SeqGenerator, seq2seq_cost
from paddle_tpu_torch.serving import Request, ServingEngine
from paddle_tpu_torch.serving.pages import BlockPagedCache
from test_torch_parity import carry

V, E, H = 20, 8, 12
BOS, EOS = 0, 1
MAXLEN = 8


@pytest.fixture(autouse=True)
def _flags():
    yield
    paddle_tpu_torch.flags.reset_flags()
    paddle_tpu.utils.flags.reset_flags()


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
    """The port's generator over the JAX package's seeded parameters."""
    reset_auto_names()
    cost, _ = seq2seq_cost(V, V, word_dim=E, hidden_dim=H)
    return Seq2SeqGenerator(carry(jparams, cost), V, V, device="cpu", **_gen_kw())


def make_engine(gen, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("hbm_budget_mb", 1)
    kw.setdefault("max_new_tokens", MAXLEN)
    return ServingEngine(gen, device="cpu", **kw)


def srcs_of(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, V, size=n).tolist() for n in lengths]


def drain(eng, reqs, first=4, limit=100):
    """Admit `first` requests, then the rest as slots free; step to the end."""
    eng.admit(reqs[:first])
    done = []
    for _ in range(limit):
        if len(done) == len(reqs):
            break
        done += eng.step()
        waiting = [r for r in reqs if r.t_admit is None]
        if eng.n_free_slots and waiting:
            eng.admit(waiting)
    return done


# ---------------------------------------------------------------------------
# block-paged cache
# ---------------------------------------------------------------------------


def test_pages_budget_derives_capacity():
    c = BlockPagedCache(16, {"enc": 24, "ep": 12}, hbm_budget_bytes=16 * 36 * 4 * 10)
    assert c.bytes_per_block == 16 * 36 * 4
    assert c.n_blocks == 10
    assert c.scratch == 10 and c.pool_rows == 11
    assert c.pages_for_tokens(1) == 1
    assert c.pages_for_tokens(16) == 1
    assert c.pages_for_tokens(17) == 2


def test_pages_alloc_free_and_refusal():
    c = BlockPagedCache(16, {"x": 1}, n_blocks=4)
    a = c.alloc(3)
    assert a is not None and len(a) == 3 and c.n_free == 1
    assert c.alloc(2) is None  # refused, not partial
    assert c.n_free == 1
    c.free(a)
    assert c.n_free == 4
    b = c.alloc(4)
    assert sorted(b) == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        c.free([7])  # foreign id
    c.free(b)
    with pytest.raises(ValueError):
        c.free([b[0]])  # double free


def test_pages_zero_capacity_budget_raises():
    with pytest.raises(ValueError):
        BlockPagedCache(16, {"x": 1024}, hbm_budget_bytes=10)


def test_pages_counters_ride_the_stat_set():
    from paddle_tpu_torch.utils.timers import StatSet

    stats = StatSet()
    c = BlockPagedCache(16, {"x": 1}, n_blocks=2, stats=stats)
    c.free(c.alloc(2))
    assert c.alloc(3) is None
    assert (stats.count("serving/pages_alloc"), stats.count("serving/pages_free"),
            stats.count("serving/alloc_refused")) == (2, 2, 1)


# ---------------------------------------------------------------------------
# engine: each request's tokens are reference_decode's
# ---------------------------------------------------------------------------


def test_engine_requires_fused_match(small_gen, monkeypatch):
    monkeypatch.setattr(small_gen, "_match", None)
    with pytest.raises(ValueError, match="fused attention-GRU"):
        make_engine(small_gen)


def test_engine_requires_the_fused_flag(small_gen):
    paddle_tpu_torch.flags.set_flag("fused_attention_gru", False)
    with pytest.raises(ValueError, match="fused_attention_gru is off"):
        make_engine(small_gen)


def oneshot_logprobs(eng, src, n):
    """The one-shot greedy path's log-probability of each token it emits
    (reference_decode's batch, stepped by hand)."""
    from paddle_tpu_torch.core.batch import pad_batch_rows

    gen = eng._gen
    with torch.no_grad():
        statics, carry, b, gp = gen._prepare(pad_batch_rows(eng._feeder([(src,)]), eng.rows))
        step = gen._step_fn(statics, gp)
        ids = torch.full((b,), BOS, dtype=torch.int32)
        out = []
        for _ in range(n):
            logp, carry = step(ids, carry)
            ids = torch.argmax(logp, dim=-1).to(torch.int32)
            out.append(float(logp[0, ids[0]]))
    return out


def test_engine_staggered_bit_identical(small_gen):
    eng = make_engine(small_gen)
    reqs = [Request(s) for s in srcs_of(0, (3, 5, 9, 2, 17, 4))]
    # continuous batching: admit mid-flight, retire mid-flight
    assert len(eng.admit(reqs[:2])) == 2
    fin = eng.step() + eng.step()
    eng.admit(reqs[2:4])
    for _ in range(40):
        if len(fin) >= 4:
            break
        fin += eng.step()
    eng.admit(reqs[4:])
    for _ in range(40):
        if not eng.n_live:
            break
        fin += eng.step()
    assert len(fin) == 6 and eng.n_live == 0
    for r in reqs:
        assert r.tokens == eng.reference_decode(r.src_ids, MAXLEN), r.req_id
        assert len(r.token_times) == len(r.tokens) and r.t_admit <= r.t_first_token
        # bit for bit: the emitted tokens' log-probabilities are the one-shot
        # path's, not only the argmax
        assert r.token_logprobs == oneshot_logprobs(eng, r.src_ids, MAXLEN)[:len(r.tokens)]
    # every page and slot returned to the free pool
    assert eng.pages.n_free == eng.pages.n_blocks
    assert eng.n_free_slots == eng.max_slots


def test_engine_shape_variants_bounded_by_ladder(small_gen):
    eng = make_engine(small_gen)
    # two rounds over the same length and slot-count mix: round 2 adds no
    # shape variant
    for seed in (0, 1):
        reqs = [Request(s) for s in srcs_of(seed, (3, 5, 9, 2, 17, 4))]
        assert len(drain(eng, reqs)) == 6
        if seed == 0:
            first = (dict(eng.decode_shapes), set(eng.prefill_shapes))
            # 4 rows always; page counts {1, 2} -> rungs {1, 2}; source rungs 16, 32
            assert set(eng.decode_shapes) == {(4, 1), (4, 2)}
            assert {key[0][1] for key in eng.prefill_shapes} == {(4, 16), (4, 32)}
    assert set(eng.decode_shapes) == set(first[0]) and set(eng.prefill_shapes) == first[1]
    assert sum(eng.decode_shapes.values()) > sum(first[0].values())
    assert eng.summary()["decode_shapes"] == len(first[0])


def test_engine_admission_refused_until_pages_free(small_gen):
    # a pool of 2 blocks: one 17-token request (2 pages) fills it
    blk = 16 * (2 * H + H) * 4
    eng = make_engine(small_gen, hbm_budget_mb=2 * blk / (1 << 20))
    assert eng.pages.n_blocks == 2
    big = Request(srcs_of(2, (17,))[0])
    small = Request(srcs_of(3, (4,))[0])
    assert eng.admit([big, small]) == [big]  # strict FCFS: small waits
    assert eng.admit([small]) == []
    while eng.n_live:
        eng.step()
    assert eng.admit([small]) == [small]
    while eng.n_live:
        eng.step()
    assert small.tokens == eng.reference_decode(small.src_ids, MAXLEN)
    assert big.tokens == eng.reference_decode(big.src_ids, MAXLEN)


def test_engine_preemption_bit_identical(small_gen):
    # block_steps=1 so two steps leave every request mid-decode
    eng = make_engine(small_gen, block_steps=1)
    reqs = [Request(s) for s in srcs_of(1, (4, 6, 3))]
    eng.admit(reqs)
    fin = eng.step() + eng.step()
    victim = eng.preempt()
    assert victim is reqs[-1] and victim._resume is not None
    assert len(victim._resume["tokens"]) == 2 and eng.n_live == 2
    # pages came back; re-admission restores the saved GRU state
    assert eng.pages.n_free == eng.pages.n_blocks - 2
    eng.admit([victim])
    assert victim._resume is None
    for _ in range(40):
        if not eng.n_live:
            break
        fin += eng.step()
    for r in reqs:
        assert r.tokens == eng.reference_decode(r.src_ids, MAXLEN), r.req_id
    assert eng.preempt() is None


@pytest.mark.parametrize("k", [1, 4, 8])
def test_engine_block_steps_bit_identical(small_gen, k):
    """K tokens per dispatch, with EOS and the cap crossing mid-block, give
    the one-shot path's tokens."""
    eng = make_engine(small_gen, block_steps=k)
    srcs = srcs_of(7, (3, 5, 9, 2, 17, 4, 6, 8))
    reqs = [Request(s, max_new_tokens=[MAXLEN, 5][i % 2]) for i, s in enumerate(srcs)]
    assert len(drain(eng, reqs)) == len(reqs)
    for r in reqs:
        assert r.tokens == eng.reference_decode(r.src_ids, r.max_new_tokens), r.req_id


def test_engine_max_new_tokens_cap(small_gen):
    eng = make_engine(small_gen)
    r = Request(srcs_of(4, (6,))[0], max_new_tokens=2)
    eng.admit([r])
    fin = []
    for _ in range(10):
        if fin:
            break
        fin += eng.step()
    assert fin == [r]
    assert r.tokens == eng.reference_decode(r.src_ids, 2)
    assert len(r.tokens) <= 2


def test_cancel_by_id_frees_pages(small_gen):
    eng = make_engine(small_gen)
    a, b = (Request(s) for s in srcs_of(11, (6, 20)))
    eng.admit([a, b])
    eng.step()
    assert eng.pages.n_used == 3
    assert eng.cancel_by_id(b.req_id) is b and eng.cancel_by_id("nope") is None
    assert eng.pages.n_used == 1 and eng.n_live == 1 and b.tokens is None
    assert not eng.cancel(b)
    while eng.n_live:
        eng.step()
    assert eng.pages.n_used == 0 and eng.n_free_slots == eng.max_slots
    assert a.tokens == eng.reference_decode(a.src_ids, MAXLEN)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_engine_tokens_equal_the_jax_engine(small_gen, jparams, k):
    """Staggered admission and one preemption (the newest request, after
    the second dispatch, re-admitted first) in both engines."""
    from paddle_tpu.models.seq2seq import Seq2SeqGenerator as JGen
    from paddle_tpu.serving import Request as JRequest
    from paddle_tpu.serving import ServingEngine as JEngine

    jeng = JEngine(JGen(jparams, V, V, **_gen_kw()), max_slots=4, hbm_budget_mb=1,
                   max_new_tokens=MAXLEN, block_steps=k)
    teng = make_engine(small_gen, block_steps=k)
    srcs = srcs_of(9, (3, 5, 9, 2, 17, 4, 12, 7))
    runs = []
    for eng, make in ((jeng, JRequest), (teng, Request)):
        reqs = [make(s) for s in srcs]
        queue = list(reqs)
        eng.admit(queue[:4])
        del queue[:4]
        for step in range(100):
            if all(r.tokens is not None for r in reqs):
                break
            eng.step()
            if step == 1 and eng.n_live:
                queue.insert(0, eng.preempt())
            if queue and eng.n_free_slots:
                for r in eng.admit(queue):
                    queue.remove(r)
        runs.append(reqs)
    for j, t in zip(*runs):
        assert t.tokens == j.tokens, t.req_id
    assert any(len(t.tokens) > 2 for t in runs[1])


def test_scratch_is_never_read_by_a_live_slot(small_gen):
    """Prefill's padding rows write the scratch page and the scratch slot
    (several at once: a group of 3 pads to 4 rows); filling both with finite
    garbage before every dispatch changes no live request's tokens."""
    eng = make_engine(small_gen, block_steps=2)
    scratch = eng.pages.scratch

    def spoil():
        eng._enc_pool[scratch] = 1e30
        eng._ep_pool[scratch] = -1e30
        eng._h[eng._scratch_slot] = 1e30

    reqs = [Request(s) for s in srcs_of(12, (5, 17, 3, 9, 30))]
    spoil()
    eng.admit(reqs[:3])
    done = []
    for _ in range(40):
        spoil()
        done += eng.step()
        waiting = [r for r in reqs if r.t_admit is None]
        if waiting and eng.n_free_slots:
            spoil()
            eng.admit(waiting)
        if len(done) == len(reqs):
            break
    assert len(done) == len(reqs)
    for r in reqs:
        assert r.tokens == eng.reference_decode(r.src_ids, MAXLEN), r.req_id


def test_every_dispatch_runs_on_the_engines_rows(small_gen):
    """Why every product runs at ``rows``: at one M a row's result does not
    depend on its position, while another M may round it otherwise (on the
    CPU a one-row product does), and the engine's rows are held to
    reference_decode bit for bit."""
    w = small_gen.fused_decode_weights(small_gen.net.materialize_shared(
        small_gen.params.params))["w1"]
    x = torch.from_numpy(np.random.RandomState(0).randn(8, w.shape[0]).astype(np.float32))
    perm = torch.randperm(8)
    assert torch.equal(x[perm] @ w, (x @ w)[perm])
    assert not torch.equal(x[:1] @ w, (x @ w)[:1])
    eng = make_engine(small_gen, max_slots=3)
    assert eng.rows == 4
    reqs = [Request(s) for s in srcs_of(13, (7, 20))]
    eng.admit(reqs)  # sources at rungs 16 and 32: two prefills of 4 rows
    assert sorted(key[0][1] for key in eng.prefill_shapes) == [(4, 16), (4, 32)]
    while eng.n_live:
        eng.step()
    assert set(eng.decode_shapes) == {(4, 2)}
    for r in reqs:
        assert r.token_logprobs == oneshot_logprobs(eng, r.src_ids, MAXLEN)[:len(r.tokens)]


# ---------------------------------------------------------------------------
# chunked prefill, the engine's surface, and what is not ported yet
# ---------------------------------------------------------------------------


def test_chunked_prefill_bit_identical_interleaved(small_gen):
    """Two long prompts prefilling one chunk per step while two short ones
    decode: every request's tokens and log-probabilities are the one-shot
    path's, and each long prompt takes one dispatch per chunk and
    direction."""
    eng = make_engine(small_gen, prefill_chunk_tokens=16, hbm_budget_mb=4)
    reqs = [Request(s) for s in srcs_of(20, (40, 70)) + srcs_of(21, (3, 5))]
    eng.admit(reqs)
    assert eng.n_prefilling == 2 and eng.n_live == 2
    done = []
    for _ in range(300):
        done += eng.step()
        if len(done) == len(reqs):
            break
    assert len(done) == len(reqs)
    for r in reqs:
        assert r.tokens == eng.reference_decode(r.src_ids, MAXLEN), r.req_id
        assert r.token_logprobs == oneshot_logprobs(eng, r.src_ids, MAXLEN)[:len(r.tokens)]
    # rungs 64 and 128 at 16 tokens a chunk, both directions
    assert eng.trace_counts["prefill_chunk"] == 2 * (4 + 8)
    assert eng.trace_counts["prefill"] == 1  # the two short prompts, one rung
    assert eng.pages.n_used == 0 and eng.n_free_slots == eng.max_slots


def test_chunked_prefill_cancel_mid_prefill(small_gen):
    eng = make_engine(small_gen, prefill_chunk_tokens=16, hbm_budget_mb=4)
    r = Request(srcs_of(24, (70,))[0])
    eng.admit([r])
    eng.step()  # one forward chunk in
    assert eng.n_prefilling == 1
    assert eng.cancel(r) is True
    assert eng.pages.n_used == 0 and eng.n_free_slots == eng.max_slots
    assert eng.cancel(r) is False


def test_chunked_prefill_flag_validation(small_gen):
    with pytest.raises(ValueError, match="multiple"):
        make_engine(small_gen, prefill_chunk_tokens=24)
    with pytest.raises(ValueError, match="divide"):
        make_engine(small_gen, prefill_chunk_tokens=48)


def test_chunked_prefill_outside_the_encoder_idiom_raises(small_gen, monkeypatch):
    """No arm gives way to another: an encoder the chunk dispatches cannot
    run raises when the engine is built."""
    import dataclasses

    layers = small_gen._enc_net.topology.layers
    monkeypatch.setitem(layers, "enc_fw", dataclasses.replace(layers["enc_fw"], type="lstmemory"))
    with pytest.raises(ValueError, match="expected a fused grumemory"):
        make_engine(small_gen, prefill_chunk_tokens=16)
    make_engine(small_gen)  # whole-prompt prefill does not need the idiom


def test_engine_accepts_spec_ngram(small_gen):
    eng = make_engine(small_gen, spec_decode=True, spec_ngram=3)
    assert eng.spec_ngram == 3 and eng.spec_decode


def test_serving_binds_every_name_of_the_jax_package():
    import paddle_tpu.serving as jserving
    import paddle_tpu_torch.serving as serving

    assert sorted(serving.__all__) == sorted(jserving.__all__)
    for name in jserving.__all__:
        assert getattr(serving, name).__name__ == getattr(jserving, name).__name__
    with pytest.raises(AttributeError):
        serving.no_such_name  # noqa: B018


@pytest.mark.parametrize("arm,value", [("aot_cache_dir", "/nonexistent")])
def test_deferred_engine_arms_raise(small_gen, tmp_path, arm, value):
    """The once-deferred arm is ported: the engine takes it and reports it
    (the build store, whose summary the engine's carries); the store is
    made under the test's own directory."""
    where = str(tmp_path / value.lstrip("/"))
    eng = make_engine(small_gen, **{arm: where})
    got = eng.summary()[arm.replace("_dir", "")]
    assert got["dir"] == where
    assert (got["entries"], got["compiles"], got["loads"]) == (0, 0, 0)
    assert make_engine(small_gen).summary()["aot_cache"] is None
