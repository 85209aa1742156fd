"""The port's linear-chain CRF (``paddle_tpu_torch/layers/structured.py``:
``crf`` and ``crf_decoding``), ``chunk_evaluator``,
``maxframe_printer_evaluator`` and the sequence tagger
(``models/sequence_tagging.py``) against the JAX package on the CPU.

- ``crf``: per-row costs and one step's gradients (emissions through an fc,
  and the transitions) on carried parameters, float32, relative 1e-5, on
  ragged batches, with length-1 rows and a batch whose longest row is 1;
- ``crf_decoding``: Viterbi paths equal to JAX's position by position, the
  same batches plus a constructed tie (equal emissions, zero transitions:
  both take the first maximum), and the label-mismatch maps;
- ``chunk_evaluator``: precision, recall and F1 equal to JAX's over the
  plain, IOB, IOE and IOBES schemes, on random tag sequences and on edge
  sequences (a chunk at the last position, a type change inside I tags);
- ``maxframe_printer_evaluator``: the printed text equal to JAX's;
- ``ner_crf_cost`` at the JAX test's size (vocab 60, 5 labels): one step's
  gradients and the decoded paths against JAX's, training to the JAX test's
  cost bar and decoding above its 0.9 tag accuracy through
  ``paddle.infer(field='id')``; a ``shard_axis`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu.core.compiler import CompiledNetwork as JNet
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu_torch.core.batch import SeqTensor as TSeq
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo

from test_torch_parity import batch_both, build_both, carry, grads_both, rel_l2

N = 4  # labels of the layer tests
FEAT = 6


def crf_net(pkg, label_out=False):
    """x -> fc (the emissions) -> crf cost and crf_decoding, sharing the
    transitions by name."""
    L, dt, attr = pkg.layer, pkg.data_type, pkg.attr
    x = L.data("x", dt.dense_vector_sequence(FEAT))
    lab = L.data("lab", dt.integer_value_sequence(N))
    emis = L.fc(x, size=N, act=pkg.activation.Linear(), name="emis")
    crfw = attr.ParamAttr(name="crfw")
    cost = L.crf(emis, lab, size=N, param_attr=crfw, name="cost")
    decode = L.crf_decoding(emis, size=N, param_attr=crfw, name="decode",
                            label=lab if label_out else None)
    return cost, decode


def crf_arrays(lengths, t=None, seed=0):
    lengths = np.asarray(lengths, np.int32)
    t = t or int(lengths.max())
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lengths), t, FEAT).astype(np.float32) * 2.0
    lab = rng.randint(0, N, size=(len(lengths), t)).astype(np.int32)
    lab[np.arange(t)[None, :] >= lengths[:, None]] = 0
    return {"x": (x, lengths), "lab": (lab, lengths)}


CASES = {
    "ragged": ([7, 3, 5, 1], 9),
    "length_one_rows": ([1, 4, 1], 4),
    "longest_row_one": ([1, 1, 1], 1),
    "longest_row_one_padded": ([1, 1], 8),
    "full": ([6, 6], 6),
}


def _outputs(jout, tout, arrays, jparams, names):
    jnet = JNet(JTopo(list(jout)), compute_dtype=jnp.float32)
    tnet = TNet(TTopo(list(tout)), compute_dtype=torch.float32)
    jb, tb = batch_both(arrays)
    jo = jnet.apply(jparams.params, jb, state=jparams.state, train=False)[0]
    to = tnet.apply(carry(jparams).params, tb, train=False)[0]
    return ([np.asarray(jo[n].data) for n in names], [to[n].data.numpy() for n in names])


@pytest.mark.parametrize("case", sorted(CASES))
def test_crf_cost_and_gradients_match_jax(case):
    lengths, t = CASES[case]
    (jcost, jdec), (tcost, tdec) = build_both(crf_net)
    jparams = paddle_tpu.parameters.create([jcost, jdec], seed=3)
    arrays = crf_arrays(lengths, t)
    (jc,), (tc,) = _outputs([jcost], [tcost], arrays, jparams, ["cost"])
    assert tc.shape == jc.shape == (len(lengths), 1)
    assert np.all(np.isfinite(tc))
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-5)
    jm, tm, jg, tg = grads_both(jcost, tcost, jparams, arrays)
    assert abs(tm - jm) <= 1e-5 * abs(jm)
    assert set(tg) == {"emis", "cost"}
    assert rel_l2(tg, jg) <= 1e-5, rel_l2(tg, jg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_crf_decoding_paths_and_mismatch_match_jax(case):
    lengths, t = CASES[case]
    (jcost, jdec), (tcost, tdec) = build_both(lambda pkg: crf_net(pkg, label_out=True))
    jparams = paddle_tpu.parameters.create([jcost, jdec], seed=4)
    arrays = crf_arrays(lengths, t, seed=1)
    (jerr,), (terr,) = _outputs([jcost, jdec], [tcost, tdec], arrays, jparams, ["decode"])
    assert terr.dtype == np.float32 and terr.shape == jerr.shape
    np.testing.assert_array_equal(terr, jerr)
    # the paths themselves, from the same parameters without the label
    (jc, jd), (tc, td) = build_both(crf_net)
    (jp,), (tp,) = _outputs([jc, jd], [tc, td], arrays, jparams, ["decode"])
    assert tp.dtype == np.int32
    np.testing.assert_array_equal(tp, jp)
    pad = np.arange(tp.shape[1])[None, :] >= np.asarray(lengths)[:, None]
    assert not tp[pad].any()


def test_crf_decoding_tie_takes_the_first_maximum():
    """Equal emissions and zero transitions: every path ties, and both
    packages take label 0 at every step; with two tied maxima at a step
    (labels 1 and 3 there), label 1."""
    (_, jdec), (_, tdec) = build_both(crf_net)
    jparams = paddle_tpu.parameters.create([jdec], seed=5)
    jparams.params["decode"]["w"] = jnp.zeros((N + 2, N), jnp.float32)
    jparams.params["emis"]["w0"] = jnp.zeros((FEAT, N), jnp.float32)
    jparams.params["emis"]["b"] = jnp.asarray([0.0, 2.0, 0.0, 2.0], jnp.float32)
    arrays = crf_arrays([5, 2, 1], 6, seed=2)
    (jp,), (tp,) = _outputs([jdec], [tdec], arrays, jparams, ["decode"])
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tp[0, :5], [1, 1, 1, 1, 1])
    jparams.params["emis"]["b"] = jnp.zeros((N,), jnp.float32)
    (jp,), (tp,) = _outputs([jdec], [tdec], arrays, jparams, ["decode"])
    np.testing.assert_array_equal(tp, jp)
    assert not tp.any()


def test_crf_stays_float32_under_bfloat16():
    """full_precision: under a bfloat16 compute dtype the emissions reach
    the CRF in float32 and its cost is float32."""
    (_, _), (tcost, tdec) = build_both(crf_net)
    net = TNet(TTopo([tcost, tdec]), compute_dtype=torch.bfloat16)
    params = net.init_params(0, device="cpu")
    _, tb = batch_both(crf_arrays([5, 3], 5))
    outs, _ = net.apply(params, tb, train=False)
    assert outs["emis"].data.dtype == torch.bfloat16
    assert outs["cost"].data.dtype == torch.float32
    assert outs["decode"].data.dtype == torch.int32
    assert torch.isfinite(outs["cost"].data).all()


# ---------------------------------------------------------------------------
# chunk_evaluator
# ---------------------------------------------------------------------------

TYPES = 3
TAGS = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}


def _chunk_both(scheme, pred, gold, lengths):
    def make(pkg):
        dt = pkg.data_type
        k = TYPES * TAGS[scheme] + 1
        p = pkg.layer.data("pred", dt.integer_value_sequence(k))
        g = pkg.layer.data("gold", dt.integer_value_sequence(k))
        return pkg.evaluator.chunk_evaluator(p, g, scheme, TYPES, name="chunk")

    jev, tev = build_both(make)
    lengths = np.asarray(lengths, np.int32)
    jacc = jev.update({"pred": JSeq(jnp.asarray(pred), jnp.asarray(lengths)),
                       "gold": JSeq(jnp.asarray(gold), jnp.asarray(lengths))})
    tacc = tev.update({"pred": TSeq(torch.from_numpy(pred), torch.from_numpy(lengths)),
                       "gold": TSeq(torch.from_numpy(gold), torch.from_numpy(lengths))})
    jres = jev.finalize({k: np.asarray(v) for k, v in jacc.items()})
    tres = tev.finalize({k: v.numpy() for k, v in tacc.items()})
    return jres, tres, {k: float(v) for k, v in tacc.items()}


@pytest.mark.parametrize("scheme", ["plain", "IOB", "IOE", "IOBES"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_evaluator_matches_jax_on_random_tags(scheme, seed):
    rng = np.random.RandomState(seed)
    b, t = 6, 12
    k = TYPES * TAGS[scheme] + 1
    gold = rng.randint(0, k, size=(b, t)).astype(np.int32)
    # predictions: the gold tags with a quarter of the positions redrawn
    pred = np.where(rng.rand(b, t) < 0.25, rng.randint(0, k, size=(b, t)), gold).astype(np.int32)
    lengths = rng.randint(2, t + 1, size=b)
    jres, tres, counts = _chunk_both(scheme, pred, gold, lengths)
    assert tres == jres
    assert counts["gold"] > 0


def test_chunk_evaluator_edge_sequences_match_jax():
    """IOB (type * 2 + tag, B = 0, I = 1, O = 6): a chunk at the last
    position, a type change inside I tags, a leading I, and O runs."""
    o = TYPES * 2
    gold = np.array([
        [o, o, o, 0, o, o, o, 0],      # chunk of type 0 at the last position
        [0, 1, 3, 3, o, 2, 3, 1],      # I of type 1 after I of type 0: a new chunk
        [1, 1, o, 4, 5, 5, o, o],      # leading I starts a chunk
        [o, o, o, o, o, o, o, o],
    ], np.int32)
    pred = gold.copy()
    pred[0, 7] = o            # misses the last-position chunk
    pred[1, 2] = 1            # merges the type change into one chunk
    pred[3, 5] = 2            # a spurious chunk
    lengths = np.array([8, 8, 6, 7], np.int32)
    for scheme in ("IOB", "IOE", "IOBES"):
        jres, tres, counts = _chunk_both(scheme, pred, gold, lengths)
        assert tres == jres, scheme
    jres, tres, counts = _chunk_both("IOB", gold, gold, lengths)
    assert tres["chunk.F1"] == jres["chunk.F1"] == 1.0
    assert counts["gold"] == 8  # 2 + 4 + 2 + 0


def test_maxframe_printer_text_matches_jax(capsys):
    def make(pkg):
        x = pkg.layer.data("x", pkg.data_type.dense_vector_sequence(3))
        return pkg.evaluator.maxframe_printer_evaluator(x, name="mf")

    jev, tev = build_both(make)
    rng = np.random.RandomState(0)
    data = rng.randn(3, 5, 3).astype(np.float32)
    lengths = np.array([5, 2, 1], np.int32)
    jev.update({"x": JSeq(jnp.asarray(data), jnp.asarray(lengths))})
    jax.effects_barrier()
    jtext = capsys.readouterr().out
    assert tev.update({"x": TSeq(torch.from_numpy(data), torch.from_numpy(lengths))}) == {}
    ttext = capsys.readouterr().out
    assert ttext == jtext
    assert ttext.startswith("mf:\nsample 0: frame")


# ---------------------------------------------------------------------------
# the sequence tagger
# ---------------------------------------------------------------------------

VOCAB, LABELS = 60, 5


def _ner(pkg):
    from importlib import import_module

    mod = import_module(f"{pkg.__name__}.models.sequence_tagging")
    return mod.ner_crf_cost(VOCAB, LABELS)


def _tag_arrays(seed, n=12):
    from paddle_tpu_torch.models.sequence_tagging import synthetic_tag_reader

    rows = list(synthetic_tag_reader(VOCAB, LABELS, n=n, seed=seed)())
    t = max(len(r[0]) for r in rows)
    words = np.zeros((n, t), np.int32)
    tags = np.zeros((n, t), np.int32)
    for i, (w, g) in enumerate(rows):
        words[i, : len(w)], tags[i, : len(g)] = w, g
    lengths = np.array([len(r[0]) for r in rows], np.int32)
    return rows, {"word": (words, lengths), "label": (tags, lengths)}


def test_ner_crf_gradients_and_decoding_match_jax():
    (jcost, jdec), (tcost, tdec) = build_both(_ner)
    jparams = paddle_tpu.parameters.create([jcost, jdec], seed=2)
    _, arrays = _tag_arrays(5)
    jc, tc, jg, tg = grads_both(jcost, tcost, jparams, arrays)
    assert abs(tc - jc) <= 1e-5 * abs(jc)
    assert rel_l2(tg, jg) <= 1e-5
    assert set(tg) == {"word_emb", "proj_f", "rnn_f", "proj_b", "rnn_b", "crf_input",
                       "crf_cost"}
    (jp,), (tp,) = _outputs([jcost, jdec], [tcost, tdec], arrays, jparams, ["crf_decode"])
    np.testing.assert_array_equal(tp, jp)


def test_ner_crf_trains_and_decodes_through_infer():
    """The JAX package's tests/test_demos.py tagger at its size: the mean of
    the last 4 costs under half the first 4's, then tag accuracy above 0.9
    on a fresh batch decoded by paddle.infer(field='id'), which returns the
    valid positions of every row, concatenated."""
    P = paddle_tpu_torch
    from paddle_tpu_torch.evaluator import chunk_evaluator
    from paddle_tpu_torch.models.sequence_tagging import ner_crf_cost, synthetic_tag_reader

    P.topology.reset_auto_names()
    cost, decode = ner_crf_cost(VOCAB, LABELS)
    label = [lo for lo in P.Topology(cost).data_layers()]
    assert label == ["word", "label"]
    lab_layer = cost.parents[1]
    trainer = P.trainer.SGD(
        cost=cost, parameters=P.parameters.create(cost, seed=3, device="cpu"),
        update_equation=P.optimizer.Adam(learning_rate=2e-2), extra_layers=[decode],
        evaluators=[chunk_evaluator(decode, lab_layer, "IOB", 2, name="chunk")],
        device="cpu")
    costs, f1 = [], []

    def handler(e):
        if isinstance(e, P.event.EndIteration):
            costs.append(e.cost)
        if isinstance(e, P.event.EndPass):
            f1.append(e.evaluator["chunk.F1"])

    trainer.train(reader=P.batch(synthetic_tag_reader(VOCAB, LABELS, n=96, seed=3), 16),
                  num_passes=10, event_handler=handler)
    assert np.mean(costs[-4:]) < 0.5 * np.mean(costs[:4]), (costs[:4], costs[-4:])
    assert len(f1) == 10 and f1[-1] > f1[0]
    rows = list(synthetic_tag_reader(VOCAB, LABELS, n=32, seed=11)())
    ids = P.infer(output_layer=decode, parameters=trainer.parameters,
                  input=[(w,) for w, _ in rows], field="id", device="cpu")
    want = np.concatenate([np.asarray(w) % LABELS for w, _ in rows])
    assert ids.shape == want.shape and ids.dtype == np.int64
    assert (ids == want).mean() > 0.9


def test_shard_axis_raises_naming_itself():
    from paddle_tpu_torch.models.sequence_tagging import ner_crf_cost

    cost, _ = ner_crf_cost(VOCAB, LABELS, shard_axis="model")
    with pytest.raises(NotImplementedError, match="shard_axis='model'"):
        paddle_tpu_torch.parameters.create(cost, device="cpu")


def test_tar_carries_the_shared_crf_weight_across_packages():
    """The tagger's parameters through the v1 tar, JAX package to port and
    back: the name-shared transitions travel once, under their name."""
    import io

    (jcost, jdec), (tcost, tdec) = build_both(_ner)
    jparams = paddle_tpu.parameters.create([jcost, jdec], seed=6)
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    detached = paddle_tpu_torch.parameters.Parameters.from_tar(buf)
    assert sorted(detached.names()) == sorted(jparams.names())
    tparams = paddle_tpu_torch.parameters.create([tcost, tdec], seed=0, device="cpu")
    detached.merge_into(tparams)
    assert sorted(tparams.names()) == sorted(jparams.names())
    assert "crf_cost.w" in tparams.names() and "crf_decode.w" not in tparams.names()
    assert np.array_equal(tparams.get("crfw"), np.asarray(jparams.get("crfw")))
    for name in jparams.names():
        assert np.array_equal(tparams.get(name), np.asarray(jparams.get(name))), name
    out = io.BytesIO()
    tparams.to_tar(out)
    assert out.getvalue() == buf.getvalue()
    # the decoder served from the loaded parameters (the training topology's:
    # crfw lives at the crf layer) agrees with the JAX package's paths
    rows, arrays = _tag_arrays(7, n=6)
    ids = paddle_tpu_torch.infer(tdec, tparams, [(w,) for w, _ in rows], field="id",
                                 device="cpu")
    (jp,), _ = _outputs([jcost, jdec], [tcost, tdec], arrays, jparams, ["crf_decode"])
    want = np.concatenate([jp[i, : len(w)] for i, (w, _) in enumerate(rows)])
    np.testing.assert_array_equal(ids, want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tagger_checkpoint_restores_in_the_other_package(tmp_path, writer):
    """A CheckpointManager step of the tagger's trainer (the recurrent
    layers' w_h/b, the shared crfw, Adam's slots) restores in the other
    package, and both go on alike."""
    from paddle_tpu import checkpoint as jckpt
    from paddle_tpu_torch import checkpoint as tckpt
    from paddle_tpu.models.sequence_tagging import synthetic_tag_reader as j_reader
    from test_torch_parity import assert_trees_equal, numpy_tree

    (jcost, jdec), (tcost, tdec) = build_both(_ner)
    jparams = paddle_tpu.parameters.create(jcost, seed=4)
    pkgs = {"jax": (paddle_tpu, jcost, jparams, jckpt, {}),
            "port": (paddle_tpu_torch, tcost, carry(jparams, tcost), tckpt, {"device": "cpu"})}
    reader_name = "port" if writer == "jax" else "jax"
    rows = list(j_reader(VOCAB, LABELS, n=48, seed=2)())

    def trainer(pkg, cost, params, kw):
        return pkg.trainer.SGD(cost=cost, parameters=params,
                               update_equation=pkg.optimizer.Adam(learning_rate=2e-2), **kw)

    def train(pkg, tr, part):
        costs = []
        tr.train(pkg.batch(lambda: iter(part), 8), event_handler=lambda e: costs.append(e.cost)
                 if isinstance(e, pkg.event.EndIteration) else None)
        return costs

    wpkg, wcost, wparams, wck, wkw = pkgs[writer]
    rpkg, rcost, _, rck, rkw = pkgs[reader_name]
    wtr = trainer(wpkg, wcost, wparams, wkw)
    train(wpkg, wtr, rows[:24])
    wtr.save_checkpoint(wck.CheckpointManager(str(tmp_path)), step=3)
    fresh = rpkg.parameters.create(rcost, seed=8, **rkw)
    rtr = trainer(rpkg, rcost, fresh, rkw)
    assert rtr.restore_checkpoint(rck.CheckpointManager(str(tmp_path)))
    assert_trees_equal(rtr.parameters.params, numpy_tree(wtr.parameters.params))
    assert_trees_equal(rtr._opt_state["m"], numpy_tree(wtr._opt_state["m"]))
    np.testing.assert_allclose(train(rpkg, rtr, rows[24:]), train(wpkg, wtr, rows[24:]),
                               rtol=1e-5)
