"""NMT generation in the port (``ops/beam.py``, ``models/seq2seq.py``'s
generation half, ``layers/generation.py``, ``get_output``,
``seq_text_printer_evaluator``) against the JAX package, on the CPU in f32
at vocab 50, word and hidden width 16, the JAX package's parameters carried
over by path:

- ``greedy_search`` and ``beam_search`` driven by one numpy log-prob table
  through a toy step function in both packages: tokens equal, scores within
  1e-6; ``top_k`` keeps ``lax.top_k``'s order on constructed ties;
- the three beam hooks, ``max_new_tokens`` and the early exit against the
  full unroll;
- ``Seq2SeqGenerator.generate`` and ``generate_greedy``: tokens equal to the
  JAX package's, beam scores within 1e-5 relative; fused stepping equals
  generic stepping;
- ``seq2seq_generation`` serializes as the JAX package's topology does, its
  tar loads across the packages, and the beam layer through
  ``infer(field='id')`` with ``get_output(beam, "scores")`` and
  ``num_results_per_sample`` agrees with the JAX package's; under bf16
  compute the search's scores stay f32;
- ``seq_text_printer_evaluator`` writes the JAX package's text;
- end to end: the port trains on the copy task of tests/test_seq2seq.py and
  then copies greedily."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.ops import beam as jbeam
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.models import seq2seq as tseq
from paddle_tpu_torch.ops import beam as tbeam
from test_torch_parity import batch_both, build_both, carry

V, WORD, HID = 50, 16, 16
BOS, EOS = 0, 1
MAXLEN = 10


@pytest.fixture(autouse=True)
def _flags():
    yield
    paddle_tpu_torch.flags.reset_flags()
    paddle_tpu.utils.flags.reset_flags()


# ---------------------------------------------------------------------------
# the searches on a toy log-prob table
# ---------------------------------------------------------------------------


def _table(seed, steps, vocab, eos_bias=0.0):
    """[steps, vocab, vocab] log-probabilities: row (t, previous id)."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(steps, vocab, vocab).astype(np.float32)
    logits[..., EOS] += eos_bias
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


def _toy_steps(tab):
    """The same table-driven step function in both packages; the carry is
    each row's step counter, which starts at the row's index (so the rows
    differ)."""
    jt, tt = jnp.asarray(tab), torch.from_numpy(tab)

    def jstep(ids, carry):
        return jt[carry["t"], ids], {"t": carry["t"] + 1}

    def tstep(ids, carry):
        return tt[carry["t"].long(), ids.long()], {"t": carry["t"] + 1}

    return jstep, tstep


def _both_counters(b):
    return {"t": jnp.arange(b, dtype=jnp.int32)}, {"t": torch.arange(b, dtype=torch.int32)}


@pytest.mark.parametrize("seed,eos_bias", [(0, 0.0), (1, 2.0), (2, 4.0)])
def test_greedy_search_matches_jax(seed, eos_bias):
    tab = _table(seed, 17, 9, eos_bias)
    jstep, tstep = _toy_steps(tab)
    jc, tc = _both_counters(5)
    for kw in ({}, {"early_exit": True}, {"max_new_tokens": 4}, {"max_new_tokens": 99}):
        jt, jl = jbeam.greedy_search(jstep, jc, 5, BOS, EOS, 12, **kw)
        tt, tl = tbeam.greedy_search(tstep, tc, 5, BOS, EOS, 12, **kw)
        assert tt.dtype == tl.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("seed,eos_bias,k", [(0, 0.0, 3), (1, 2.0, 4), (2, 3.0, 5)])
def test_beam_search_matches_jax(seed, eos_bias, k):
    tab = _table(seed, 11, 7, eos_bias)
    jstep, tstep = _toy_steps(tab)
    jc, tc = _both_counters(3)
    js, jsc = jbeam.beam_search(jstep, jc, 3, k, 7, BOS, EOS, 8)
    ts, tsc = tbeam.beam_search(tstep, tc, 3, k, 7, BOS, EOS, 8)
    assert ts.dtype == torch.int32 and tsc.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0, atol=1e-6)


def test_beam_search_constructed_ties_keep_lax_top_k_order():
    """A uniform table ties every candidate, and beams that finish early tie
    their non-EOS candidates at score + NEG_INF: both packages keep the lower
    index first, step after step."""
    tab = np.full((8, 6, 6), np.log(1.0 / 6), np.float32)
    tab[:, :, 2] = np.log(0.3)  # a favourite that ties across parents
    tab[1:, 2, EOS] = 0.0  # after a 2, EOS is certain: finished beams tie
    jstep, tstep = _toy_steps(tab)
    jc, tc = _both_counters(2)
    js, jsc = jbeam.beam_search(jstep, jc, 2, 4, 6, BOS, EOS, 6)
    ts, tsc = tbeam.beam_search(tstep, tc, 2, 4, 6, BOS, EOS, 6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0, atol=1e-6)
    # the first step's tie among tokens 0, 1, 3, 4, 5 goes to 0, 1 and 3:
    # the beam that took EOS (1) survives as the second best
    assert tbeam.top_k(torch.from_numpy(tab[0, :1]), 4)[1].tolist() == [[2, 0, 1, 3]]
    assert ts[0, 1].tolist() == [EOS] * 6


@pytest.mark.parametrize("seed", range(4))
def test_top_k_breaks_ties_as_lax_top_k(seed):
    import jax

    rng = np.random.RandomState(seed)
    x = rng.randint(-2, 3, size=(6, 40)).astype(np.float32)  # many ties
    x[0] = 1.0  # a row of equal values
    x[1] = -1e9 + rng.randint(0, 2, size=40) * 64.0  # f32 spacing near 1e9
    x[2, ::3] = rng.randn(14).astype(np.float32)
    for k in (1, 3, 7, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tbeam.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_beam_hooks_match_jax():
    tab = _table(3, 8, 7, 1.0)
    jstep, tstep = _toy_steps(tab)
    jc, tc = _both_counters(2)
    hooks = {
        "candidate_adjust_fn": (lambda lp, s, t: lp.at[:, 3].set(-1e9),
                                lambda lp, s, t: lp.index_fill(1, torch.tensor([3]), -1e9)),
        "drop_fn": (lambda s, ids, sc, t: (ids == 4) | (ids == 5),
                    lambda s, ids, sc, t: (ids == 4) | (ids == 5)),
        "norm_fn": (lambda sc, s, ln: sc / jnp.maximum(ln, 1).astype(sc.dtype),
                    lambda sc, s, ln: sc / torch.clamp(ln, min=1).to(sc.dtype)),
    }
    for name, (jh, th) in hooks.items():
        js, jsc = jbeam.beam_search(jstep, jc, 2, 3, 7, BOS, EOS, 6, **{name: jh})
        ts, tsc = tbeam.beam_search(tstep, tc, 2, 3, 7, BOS, EOS, 6, **{name: th})
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=name)
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-6, atol=1e-6)
    ts, _ = tbeam.beam_search(tstep, tc, 2, 3, 7, BOS, EOS, 6,
                              candidate_adjust_fn=hooks["candidate_adjust_fn"][1])
    assert not (ts == 3).any()


def test_greedy_early_exit_and_cap_equal_the_full_unroll():
    """Row r emits 2 + r + t until step 2 + 2r, then EOS (tests/test_serving.py's
    toy): the early exit stops after every row has finished, and the output
    is the full unroll's, as are the capped runs truncated."""
    vocab, steps = 12, 24

    counted = [0]

    def step_fn(ids, t):
        counted[0] += 1
        row = torch.arange(ids.shape[0])
        tok = torch.where(t < 2 + 2 * row, 2 + (row + t) % (vocab - 2), EOS)
        logp = torch.full((ids.shape[0], vocab), -20.0)
        logp[row, tok] = 0.0
        return logp, t + 1

    def run(**kw):
        counted[0] = 0
        out = tbeam.greedy_search(step_fn, torch.tensor(0), 6, BOS, EOS, steps, **kw)
        return out, counted[0]

    (full_t, full_l), calls = run()
    assert full_l.tolist() == [2, 4, 6, 8, 10, 12] and calls == steps
    (early_t, early_l), calls = run(early_exit=True)
    assert torch.equal(early_t, full_t) and torch.equal(early_l, full_l)
    assert calls == 2 * tbeam.EXIT_CHECK_STEPS  # the first check after all rows finished
    for cap in (1, 4, 16, 99):
        (cap_t, cap_l), _ = run(max_new_tokens=cap, early_exit=True)
        k = min(cap, steps)
        assert torch.equal(cap_t, full_t[:, :k])
        assert torch.equal(cap_l, torch.clamp(full_l, max=k))
    (zero_t, zero_l), _ = run(max_new_tokens=0)
    assert zero_t.shape == (6, 0) and not zero_l.any()


def test_greedy_token_chain_matches_jax():
    logits = np.random.RandomState(5).randn(4, 30).astype(np.float32) * 30
    jl, jn = jbeam.greedy_token_chain(jnp.asarray(logits))
    tl, tn = tbeam.greedy_token_chain(torch.from_numpy(logits))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tn.dtype == torch.int32 and float(tl.min()) == pytest.approx(np.log(1e-9))


# ---------------------------------------------------------------------------
# Seq2SeqGenerator
# ---------------------------------------------------------------------------


def _cost(pkg):
    from paddle_tpu.models import seq2seq as jmod

    return (jmod if pkg is paddle_tpu else tseq).seq2seq_cost(V, V, WORD, HID)


def _gen_model(pkg, beam_size=3):
    from paddle_tpu.models import seq2seq as jmod

    return (jmod if pkg is paddle_tpu else tseq).seq2seq_generation(
        V, V, WORD, HID, bos_id=BOS, eos_id=EOS, beam_size=beam_size, max_length=MAXLEN)


@pytest.fixture(scope="module")
def generators():
    (jcost, _), (tcost, _) = build_both(_cost)
    jparams = paddle_tpu.parameters.create(jcost, seed=7)
    kw = dict(word_dim=WORD, hidden_dim=HID, bos_id=BOS, eos_id=EOS, max_length=MAXLEN,
              beam_size=3)
    jgen = paddle_tpu.models.seq2seq.Seq2SeqGenerator(jparams, V, V, **kw)
    tgen = tseq.Seq2SeqGenerator(carry(jparams, tcost), V, V, device="cpu", **kw)
    return jgen, tgen


def _src_batch(seed, n=6):
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, 14, size=n)
    ids = np.zeros((n, 16), np.int32)
    for i, ln in enumerate(lens):
        ids[i, :ln] = rng.randint(2, V, size=ln)
    return batch_both({"src_word": (ids, lens.astype(np.int32))})


def test_generator_matches_jax(generators):
    jgen, tgen = generators
    assert tgen._match is not None
    jb, tb = _src_batch(0)
    tseq.counters.clear()
    js, jsc = jgen.generate(jb)
    ts, tsc = tgen.generate(tb)
    assert tseq.counters["fused"] == MAXLEN and not tseq.counters["generic"]
    assert ts.shape == (6, 3, MAXLEN)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-5)
    jt, jl = jgen.generate_greedy(jb)
    tt, tl = tgen.generate_greedy(tb)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tgen.decode_weight_bytes() == sum(
        int(np.asarray(v).nbytes) for v in jgen.fused_decode_weights(
            jgen.net.materialize_shared(jgen.params.params)).values() if v is not None)


def test_fused_stepping_equals_generic(generators):
    _, tgen = generators
    _, tb = _src_batch(1)
    fused = tgen.generate(tb), tgen.generate_greedy(tb, early_exit=False)
    paddle_tpu_torch.flags.set_flag("fused_attention_gru", False)
    tseq.counters.clear()
    generic = tgen.generate(tb), tgen.generate_greedy(tb, early_exit=False)
    assert tseq.counters["generic"] == 2 * MAXLEN and not tseq.counters["fused"]
    assert torch.equal(fused[0][0], generic[0][0])
    torch.testing.assert_close(fused[0][1], generic[0][1], rtol=1e-5, atol=1e-5)
    assert torch.equal(fused[1][0], generic[1][0]) and torch.equal(fused[1][1], generic[1][1])


def test_generator_greedy_early_exit_and_cap(generators):
    _, tgen = generators
    _, tb = _src_batch(2)
    full_t, full_l = tgen.generate_greedy(tb, early_exit=False)
    early_t, early_l = tgen.generate_greedy(tb)
    assert torch.equal(full_t, early_t) and torch.equal(full_l, early_l)
    cap_t, cap_l = tgen.generate_greedy(tb, max_new_tokens=3)
    assert torch.equal(cap_t, full_t[:, :3]) and torch.equal(cap_l, torch.clamp(full_l, max=3))


def test_generator_hooks_through_generate(generators):
    jgen, tgen = generators
    jb, tb = _src_batch(3)
    jgen.candidate_adjust_fn = lambda lp, s, t: lp.at[:, 2:10].set(-1e9)
    tgen.candidate_adjust_fn = lambda lp, s, t: lp.index_fill(1, torch.arange(2, 10), -1e9)
    try:
        js, _ = jgen.generate(jb)
        ts, _ = tgen.generate(tb)
    finally:
        jgen.candidate_adjust_fn = tgen.candidate_adjust_fn = None
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not ((ts >= 2) & (ts < 10)).any()


# ---------------------------------------------------------------------------
# the generation topology and the beam_search layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gen_topologies():
    jbeam_l, tbeam_l = build_both(_gen_model)
    return jbeam_l, tbeam_l


def test_generation_topology_serializes_as_jax(gen_topologies):
    from paddle_tpu.core.topology import Topology as JTopo

    jl, tl = gen_topologies
    assert TTopo([tl]).serialize() == JTopo([jl]).serialize()
    (jl5, js), (tl5, ts) = build_both(lambda pkg: (
        lambda b: (b, pkg.layer.get_output(b, "scores")))(
            _gen_model(pkg, beam_size=5)))
    assert TTopo([tl5, ts]).serialize() == JTopo([jl5, js]).serialize()
    assert ts.size == 5


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_generation_tar_loads_across_packages(gen_topologies, writer):
    jl, tl = gen_topologies
    jparams = paddle_tpu.parameters.create(jl, seed=4)
    tparams = paddle_tpu_torch.parameters.create(tl, seed=4, device="cpu")
    assert "decoder.@gen_emb.w" in tparams.names()
    assert sorted(tparams.names()) == sorted(jparams.names())
    src, dst = (jparams, tparams) if writer == "jax" else (tparams, jparams)
    rng = np.random.RandomState(2)
    for name in src.names():
        src.set(name, rng.randn(*np.shape(src.get(name))).astype(np.float32))
    buf = io.BytesIO()
    src.to_tar(buf)
    buf.seek(0)
    dst.from_tar(buf)
    for name in src.names():
        assert np.array_equal(np.asarray(dst.get(name)), np.asarray(src.get(name))), name


def _beam_infer(pkg, params, beam, samples, n_results=None):
    scores = pkg.layer.get_output(beam, "scores")
    kw = {} if pkg is paddle_tpu else {"device": "cpu"}
    ids = pkg.infer(output_layer=beam, parameters=params, input=samples, field="id", **kw)
    vals = pkg.infer(output_layer=scores, parameters=params, input=samples, **kw)
    return ids, vals


@pytest.mark.parametrize("n_results", [None, 2])
def test_beam_layer_infer_matches_jax(n_results):
    def model(pkg):
        from paddle_tpu.models import seq2seq as jmod

        mod = jmod if pkg is paddle_tpu else tseq
        enc, enc_proj, boot = mod._encoder_and_boot(V, WORD, HID)
        L = pkg.layer
        beam = L.beam_search(
            mod.decoder_step_builder(HID, V, boot),
            input=[L.GeneratedInput(V, WORD), L.StaticInput(enc, is_seq=True),
                   L.StaticInput(enc_proj, is_seq=True)],
            bos_id=BOS, eos_id=EOS, beam_size=3, max_length=MAXLEN,
            num_results_per_sample=n_results, name="decoder")
        return beam

    jl, tl = build_both(model)
    jparams = paddle_tpu.parameters.create(jl, seed=9)
    tparams = carry(jparams, tl)
    rng = np.random.RandomState(6)
    samples = [(rng.randint(2, V, size=n).tolist(),) for n in (3, 7, 12, 5, 9)]
    jids, jsc = _beam_infer(paddle_tpu, jparams, jl, samples)
    tids, tsc = _beam_infer(paddle_tpu_torch, tparams, tl, samples)
    n = n_results or 3
    assert tids.shape == (5, n, MAXLEN) and tids.dtype == np.int64
    assert tsc.shape == (5, n)
    np.testing.assert_array_equal(tids, np.asarray(jids))
    np.testing.assert_allclose(tsc, np.asarray(jsc), rtol=1e-5)


def test_beam_layer_keeps_f32_scores_under_bf16(gen_topologies):
    from paddle_tpu_torch.core.compiler import CompiledNetwork

    _, tl = gen_topologies
    net = CompiledNetwork(TTopo([tl]), compute_dtype="bfloat16")
    params = net.init_params(3, device="cpu")
    ids = np.random.RandomState(0).randint(2, V, size=(2, 16)).astype(np.int32)
    _, tb = batch_both({"src_word": (ids, np.asarray([16, 9], np.int32))})
    outs, _ = net.apply(params, tb, train=False)
    assert outs["decoder"].data.dtype == torch.int32
    scores = outs["decoder@scores"].data
    assert scores.dtype == torch.float32 and torch.isfinite(scores).all()
    assert (scores[:, :-1] >= scores[:, 1:]).all()


def test_seq_text_printer_writes_the_jax_text(tmp_path, gen_topologies):
    from paddle_tpu import evaluator as jev
    from paddle_tpu.core.batch import SeqTensor as JSeq
    from paddle_tpu_torch import evaluator as tev
    from paddle_tpu_torch.core.batch import SeqTensor as TSeq

    jl, tl = gen_topologies
    words = [f"w{i}" for i in range(V)]
    ids = np.random.RandomState(1).randint(0, V, size=(3, 2, MAXLEN)).astype(np.int32)
    lens = np.asarray([4, 1, 7], np.int32)
    for case, mapping in (("raw", None), ("words", words), ("call", lambda i: f"<{i}>")):
        jf, tf = tmp_path / f"j_{case}.txt", tmp_path / f"t_{case}.txt"
        jev.seq_text_printer_evaluator(jl, id_to_word=mapping, result_file=str(jf)).update(
            {jl.name: JSeq(jnp.asarray(ids))})
        tev.seq_text_printer_evaluator(tl, id_to_word=mapping, result_file=str(tf)).update(
            {tl.name: TSeq(torch.from_numpy(ids))})
        seq_ids = ids[:, 0]
        jev.seq_text_printer_evaluator(jl, id_to_word=mapping, result_file=str(jf)).update(
            {jl.name: JSeq(jnp.asarray(seq_ids), jnp.asarray(lens))})
        tev.seq_text_printer_evaluator(tl, id_to_word=mapping, result_file=str(tf)).update(
            {tl.name: TSeq(torch.from_numpy(seq_ids), torch.from_numpy(lens))})
        import jax

        jax.effects_barrier()
        assert tf.read_text() == jf.read_text() and tf.read_text().count("\n") == 6
    dict_file = tmp_path / "dict.txt"
    dict_file.write_text("".join(f"{w}\tx\n" for w in words))
    tev.seq_text_printer_evaluator(tl, dict_file=str(dict_file),
                                   result_file=str(tmp_path / "d.txt")).update(
        {tl.name: TSeq(torch.from_numpy(ids[:1, 0]), torch.tensor([2]))})
    assert (tmp_path / "d.txt").read_text() == f"w{ids[0, 0, 0]} w{ids[0, 0, 1]}\n"


# ---------------------------------------------------------------------------
# end to end: train on the copy task, then copy
# ---------------------------------------------------------------------------

COPY_V = 16
FEEDING = {"src_word": 0, "trg_word": 1, "trg_next": 2}


def _copy_reader(n=512, seed=0):
    """tests/test_seq2seq.py's copy task: src random tokens in [2, 16), the
    target a copy (slots: src, BOS + copy, copy + EOS)."""

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            toks = rng.randint(2, COPY_V, size=rng.randint(2, 6)).tolist()
            yield toks, [BOS] + toks, toks + [EOS]

    return reader


def test_port_trains_then_copies():
    from paddle_tpu_torch.core.topology import reset_auto_names
    from paddle_tpu_torch.reader.feeder import DataFeeder

    reset_auto_names()
    torch.manual_seed(0)
    cost, _ = tseq.seq2seq_cost(COPY_V, COPY_V, word_dim=24, hidden_dim=32)
    params = paddle_tpu_torch.parameters.create(cost, seed=3, device="cpu")
    trainer = paddle_tpu_torch.trainer.SGD(
        cost, params, paddle_tpu_torch.optimizer.Adam(learning_rate=0.01), device="cpu")
    costs = []
    trainer.train(paddle_tpu_torch.batch(_copy_reader(), 64), num_passes=14, feeding=FEEDING,
                  event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, paddle_tpu_torch.event.EndIteration) else None)
    assert costs[-1] < costs[0] * 0.25, (costs[0], costs[-1])
    gen = tseq.Seq2SeqGenerator(params, COPY_V, COPY_V, word_dim=24, hidden_dim=32,
                                bos_id=BOS, eos_id=EOS, max_length=10, beam_size=3,
                                device="cpu")
    samples = list(_copy_reader(n=32, seed=99)())
    feeder = DataFeeder(trainer.topology.data_types(), FEEDING, device="cpu")
    batch = feeder(samples)
    toks, lengths = gen.generate_greedy(batch)
    greedy_ok = [toks[i, :lengths[i]].tolist() == s[0] for i, s in enumerate(samples)]
    assert sum(greedy_ok) / len(samples) > 0.4, sum(greedy_ok)
    seqs, scores = gen.generate(batch)
    assert (scores[:, :-1] >= scores[:, 1:]).all()
    beam_ok = []
    for i, s in enumerate(samples):
        top = seqs[i, 0].tolist()
        beam_ok.append((top[:top.index(EOS)] if EOS in top else top) == s[0])
    assert sum(beam_ok) >= sum(greedy_ok) - 1
