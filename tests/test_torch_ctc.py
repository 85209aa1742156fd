"""CTC in the port (``ctc``, ``warp_ctc`` and ``ctc_error_evaluator``)
against the JAX package on the CPU (f32), and a narrow CRNN-CTC line
recognizer through both.

The cost and the gradients of the logits and of the parameters in front of
it within rtol 1e-5 and atol 1e-6 (of the leaf's largest |g| for a
gradient), over the JAX tests' cases (``tests/test_structured.py:156-230``):
ragged rows, an empty label, labels repeated back to back, ``norm_by_times``,
[B, L, 1] labels and both blank conventions (``warp_ctc``'s 0, ``ctc``'s
size - 1); ``F.ctc_loss`` as a second oracle; the bf16 compute dtype
handing the layer f32 logits.  The evaluator: the best-path decode
(``tests/test_evaluators.py:122``; the first maximum on a tie), the edit
distances equal to the JAX package's, and ``ctc_error_evaluator`` over a
ragged batch, directly, through the v1 name and through ``SGD.train``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import evaluator as jev
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu_torch import evaluator as tev
from paddle_tpu_torch.core.batch import SeqTensor as TSeq
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from test_torch_parity import (
    assert_grads_close, assert_outputs_close, build_both, carry, grads_both,
    jax_params_from_port_init, outputs_both)

RTOL, ATOL = 1e-5, 1e-6


def _ctc_batch(b, t, c, lmax, seed=0, blank=0, lab_len=None, in_len=None, labels=None):
    """Logits [B, T, C] from N(0, 1), ragged input lengths (the first row
    full), label ids that avoid `blank`, ragged label lengths."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, c).astype(np.float32)
    if in_len is None:
        in_len = rng.randint(max(2 * lmax + 1, 2), t + 1, size=b)
        in_len[0] = t
    if lab_len is None:
        lab_len = rng.randint(1, lmax + 1, size=b)
    if labels is None:
        labels = rng.randint(0, c - 1, size=(b, lmax))
        labels = np.where(labels >= blank, labels + 1, labels) if blank < c - 1 else labels
    return (logits, np.asarray(in_len, np.int32), np.asarray(labels, np.int32),
            np.asarray(lab_len, np.int32))


# name -> (_ctc_batch kwargs, blank (None: ctc's size - 1), norm_by_times)
CASES = {
    "warp_blank0": (dict(b=4, t=9, c=5, lmax=3), 0, False),
    "ctc_blank_last": (dict(b=4, t=9, c=5, lmax=3, blank=4), None, False),
    "empty_label_row": (dict(b=3, t=6, c=4, lmax=2, lab_len=[2, 0, 1]), 0, False),
    "repeated_labels": (dict(b=3, t=10, c=4, lmax=4, lab_len=[4, 3, 2],
                             labels=[[1, 1, 2, 2], [3, 3, 3, 0], [2, 2, 0, 0]]), 0, False),
    "norm_by_times": (dict(b=4, t=8, c=6, lmax=3, seed=3), 0, True),
    "single_frame_rows": (dict(b=3, t=5, c=4, lmax=1, in_len=[5, 1, 3], lab_len=[1, 1, 0]),
                          0, False),
}


def _ctc_net(pkg, c, blank, norm_by_times, fc_in=None):
    L, dt = pkg.layer, pkg.data_type
    x = L.data("probs", dt.dense_vector_sequence(fc_in or c))
    if fc_in:  # an fc in front, so a parameter gradient passes through the cost
        x = L.fc(x, size=c, act=pkg.activation.Identity())
    lab = L.data("lab", dt.integer_value_sequence(c))
    if blank is None:
        return L.ctc(x, lab, size=c, norm_by_times=norm_by_times, name="cost")
    return L.warp_ctc(x, lab, size=c, blank=blank, norm_by_times=norm_by_times, name="cost")


def _jbatch(logits, in_len, labels, lab_len, label_dim3=False):
    lab = labels[..., None] if label_dim3 else labels
    return {"probs": JSeq(logits, in_len), "lab": JSeq(lab, lab_len)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ctc_matches_jax(case):
    kw, blank, nbt = CASES[case]
    logits, in_len, labels, lab_len = _ctc_batch(**kw)
    jout, tout = build_both(lambda p: _ctc_net(p, kw["c"], blank, nbt))
    assert TTopo([tout]).serialize() == paddle_tpu.Topology([jout]).serialize()
    jo, to, jg, tg = outputs_both(jout, tout, _jbatch(logits, in_len, labels, lab_len),
                                  input_grads=("probs",), jit=True)
    assert to["cost"].data.shape == (kw["b"], 1)
    assert_outputs_close(jo, to, atol=ATOL, rtol=RTOL)
    assert_grads_close(jg, tg)


def test_ctc_labels_b_l_1_and_a_parameter_gradient():
    """[B, L, 1] labels, and the mean cost's gradient of an fc in front."""
    logits, in_len, labels, lab_len = _ctc_batch(b=4, t=7, c=5, lmax=2, seed=11)
    x = np.random.RandomState(12).randn(4, 7, 6).astype(np.float32)
    jout, tout = build_both(lambda p: _ctc_net(p, 5, 0, False, fc_in=6))
    jparams = jax_params_from_port_init(jout, tout, seed=3)
    arrays = {"probs": (x, in_len), "lab": (labels[..., None], lab_len)}
    jc, tc, jg, tg = grads_both(jout, tout, jparams, arrays, jit=True)
    np.testing.assert_allclose(tc, jc, rtol=RTOL)
    assert_grads_close(jg, tg)


def _port_cost(logits, in_len, labels, lab_len, c, blank, nbt=False, dtype=torch.float32):
    _, tout = build_both(lambda p: _ctc_net(p, c, blank, nbt))
    net = TNet(TTopo([tout]), compute_dtype=dtype)
    batch = {"probs": TSeq(torch.from_numpy(logits), torch.from_numpy(in_len)),
             "lab": TSeq(torch.from_numpy(labels), torch.from_numpy(lab_len))}
    return net.apply({}, batch, train=False)[0]["cost"].data


@pytest.mark.parametrize("blank", [0, 4])
def test_ctc_matches_torch_ctc_loss(blank):
    """F.ctc_loss computes the same cost: a second oracle, as in the JAX
    package's test."""
    logits, in_len, labels, lab_len = _ctc_batch(b=5, t=12, c=5, lmax=4, seed=5, blank=blank)
    got = _port_cost(logits, in_len, labels, lab_len, 5, blank if blank == 0 else None)
    lp = F.log_softmax(torch.from_numpy(logits), dim=-1).transpose(0, 1)
    want = F.ctc_loss(lp, torch.from_numpy(labels).long(), torch.from_numpy(in_len).long(),
                      torch.from_numpy(lab_len).long(), blank=blank, reduction="none")
    np.testing.assert_allclose(got[:, 0].numpy(), want.numpy(), rtol=RTOL)


def test_ctc_empty_label_is_all_blank():
    """An empty label: -log P(all blank) exactly (the s_eff == 1 case)."""
    got = _port_cost(np.zeros((1, 2, 3), np.float32), np.array([2], np.int32),
                     np.zeros((1, 2), np.int32), np.array([0], np.int32), 3, 0)
    np.testing.assert_allclose(float(got[0, 0]), 2 * np.log(3.0), rtol=1e-6)


def test_ctc_runs_in_f32_under_bf16():
    """full_precision: under bf16 compute the cost sees f32 logits and
    returns f32, equal to the f32 network's on bf16-representable logits."""
    logits, in_len, labels, lab_len = _ctc_batch(b=3, t=8, c=5, lmax=3, seed=9)
    logits = torch.from_numpy(logits).bfloat16().float().numpy()
    lo = _port_cost(logits, in_len, labels, lab_len, 5, 0, dtype=torch.bfloat16)
    hi = _port_cost(logits, in_len, labels, lab_len, 5, 0)
    assert lo.dtype == torch.float32
    np.testing.assert_allclose(lo.numpy(), hi.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# ctc_error_evaluator
# ---------------------------------------------------------------------------


def test_best_path_collapses_and_takes_the_first_maximum():
    """tests/test_evaluators.py:122: the argmax path [1, 1, 0, 2, 2] (blank
    0) collapses to [1, 2]; on a tie the lower class wins, as jnp.argmax."""
    logits = np.full((2, 5, 3), -5.0, np.float32)
    for t, c in enumerate([1, 1, 0, 2, 2]):
        logits[0, t, c] = 5.0
    logits[1, :, 1] = logits[1, :, 2] = 1.0  # a tie between 1 and 2 at every step
    dec, n = tev._ctc_best_path(torch.from_numpy(logits), torch.tensor([5, 3]), 0)
    jdec, jn = jev._ctc_best_path(jnp.asarray(logits), jnp.asarray([5, 3]), 0)
    assert n.tolist() == [2, 1] == np.asarray(jn).tolist()
    assert dec[0, :2].tolist() == [1, 2] and dec[1, 0].item() == 1
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))


def test_edit_distance_equals_jax():
    rng = np.random.RandomState(4)
    a = rng.randint(0, 4, size=(16, 9))
    b = rng.randint(0, 4, size=(16, 6))
    alen, blen = rng.randint(0, 10, size=16), rng.randint(0, 7, size=16)
    got = tev._edit_distance(a, alen, b, blen)
    want = np.asarray(jev._edit_distance(jnp.asarray(a, jnp.int32), jnp.asarray(alen),
                                         jnp.asarray(b, jnp.int32), jnp.asarray(blen)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(tev._edit_distance(
        np.array([[1, 2, 3, 0], [1, 1, 0, 0]]), np.array([3, 2]),
        np.array([[1, 3, 0], [2, 2, 2]]), np.array([2, 3])), [1, 3])


def _ragged_outputs(seed=8):
    rng = np.random.RandomState(seed)
    b, t, c = 6, 10, 5
    logits = rng.randn(b, t, c).astype(np.float32) * 3
    in_len = np.array([10, 7, 3, 1, 9, 5], np.int32)
    labels = rng.randint(1, c, size=(b, 4)).astype(np.int32)
    lab_len = np.array([4, 2, 0, 1, 3, 4], np.int32)
    return logits, in_len, labels, lab_len


def test_ctc_error_evaluator_equals_jax_over_a_ragged_batch():
    logits, in_len, labels, lab_len = _ragged_outputs()
    (jp, jl), (tp, tl) = build_both(lambda p: (
        p.layer.data("p", p.data_type.dense_vector_sequence(5)),
        p.layer.data("l", p.data_type.integer_value_sequence(5))))
    jacc = jev.ctc_error_evaluator(jp, jl, name="e").update(
        {"p": JSeq(jnp.asarray(logits), jnp.asarray(in_len)),
         "l": JSeq(jnp.asarray(labels), jnp.asarray(lab_len))})
    tevl = tev.ctc_error_evaluator(tp, tl, name="e")
    tacc = tevl.update({"p": TSeq(torch.from_numpy(logits), torch.from_numpy(in_len)),
                        "l": TSeq(torch.from_numpy(labels), torch.from_numpy(lab_len))})
    assert set(tacc) == set(jacc)
    for k in jacc:
        assert float(tacc[k]) == float(jacc[k]), k
    assert float(tacc["dist"]) > 0
    assert tevl.finalize(tacc) == {"e": float(jacc["dist"]) / float(jacc["ref"])}


def test_ctc_error_evaluator_v1_name(tmp_path):
    """The v1 config name registers the port's evaluator with the parse
    result, as the JAX package's does."""
    cfg = tmp_path / "ctc.py"
    cfg.write_text(
        "from paddle.trainer_config_helpers import *\n"
        "x = data_layer('x', size=5)\n"
        "lab = data_layer('lab', size=5)\n"
        "ctc_error_evaluator(input=x, label=lab, name='err')\n"
        "outputs(warp_ctc_layer(input=x, label=lab, size=5, blank=0))\n")
    import paddle_tpu.v1_compat
    import paddle_tpu_torch.v1_compat

    j = paddle_tpu.v1_compat.parse_config(str(cfg))
    t = paddle_tpu_torch.v1_compat.parse_config(str(cfg))
    assert t.topology.serialize() == j.topology.serialize()
    assert [e.name for e in t.evaluators] == [e.name for e in j.evaluators] == ["err"]
    assert t.evaluators[0].update.__module__ == "paddle_tpu_torch.evaluator"
    TNet(t.topology)


# ---------------------------------------------------------------------------
# the CRNN-CTC line recognizer at a narrow width
# ---------------------------------------------------------------------------


def crnn_ctc(pkg, h=32, w=100, filters=(64, 128), gru=128, classes=38):
    """Grayscale lines h x w -> conv 3x3 + max pool 2/2, twice -> block_expand
    (block_y = h / 4, block_x 1): w / 4 frames -> bidirectional_gru ->
    fc(classes) -> warp_ctc(blank 0).  Returns (cost, logits)."""
    L, A, dt, P = pkg.layer, pkg.activation, pkg.data_type, pkg.pooling
    img = L.data("image", dt.dense_vector(h * w), height=h, width=w)
    net = img
    for k, f in enumerate(filters):
        net = L.img_conv(net, filter_size=3, num_filters=f, padding=1, act=A.Relu(),
                         num_channels=1 if k == 0 else None)
        net = L.img_pool(net, pool_size=2, stride=2, pool_type=P.Max())
    net = L.block_expand(net, block_x=1, block_y=h // 4)
    net = pkg.networks.bidirectional_gru(net, size=gru, return_seq=True)
    logits = L.fc(net, size=classes, act=A.Identity(), name="logits")
    label = L.data("label", dt.integer_value_sequence(classes))
    return L.warp_ctc(logits, label, size=classes, blank=0, name="ctc"), logits


NARROW = dict(h=8, w=24, filters=(4, 6), gru=5, classes=6)


def _lines(n, seed, h=8, w=24, classes=6, lmin=1, lmax=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h * w).astype(np.float32)
    return [(x[i], [int(v) for v in rng.randint(1, classes, size=rng.randint(lmin, lmax + 1))])
            for i in range(n)]


def test_crnn_ctc_narrow_cost_and_gradients():
    (jcost, _), (tcost, _) = build_both(lambda p: crnn_ctc(p, **NARROW))
    assert TTopo([tcost]).serialize() == paddle_tpu.Topology([jcost]).serialize()
    jparams = jax_params_from_port_init(jcost, tcost, seed=5)
    s = _lines(5, 6)
    lab = np.zeros((5, 4), np.int32)
    for i, (_, ids) in enumerate(s):
        lab[i, :len(ids)] = ids
    arrays = {"image": (np.stack([x for x, _ in s]), None),
              "label": (lab, np.asarray([len(ids) for _, ids in s], np.int32))}
    jc, tc, jg, tg = grads_both(jcost, tcost, jparams, arrays, jit=True)
    np.testing.assert_allclose(tc, jc, rtol=RTOL)
    assert_grads_close(jg, tg)


def test_crnn_ctc_narrow_adam_trajectory_with_the_evaluator():
    """Four Adam(1e-2) steps through SGD.train in both packages with
    ctc_error_evaluator: the costs within 1e-5, and each step's error and
    the pass's equal."""
    def net(pkg):
        cost, logits = crnn_ctc(pkg, **NARROW)
        label = pkg.layer.data("label", pkg.data_type.integer_value_sequence(6))
        return cost, pkg.evaluator.ctc_error_evaluator(logits, label, name="err")

    (jcost, jerr), (tcost, terr) = build_both(net)
    jparams = jax_params_from_port_init(jcost, tcost, seed=7)
    samples = _lines(16, 8)
    got = []
    for pkg, cost, params, err, kw in (
            (paddle_tpu, jcost, jparams, jerr, {}),
            (paddle_tpu_torch, tcost, carry(jparams), terr, {"device": "cpu"})):
        events = []
        trainer = pkg.trainer.SGD(cost=cost, parameters=params, evaluators=[err],
                                  update_equation=pkg.optimizer.Adam(learning_rate=1e-2), **kw)
        trainer.train(pkg.batch(lambda: iter(samples), 4), feeding={"image": 0, "label": 1},
                      event_handler=lambda e, ev=events, p=pkg: ev.append(e) if isinstance(
                          e, (p.event.EndIteration, p.event.EndPass)) else None)
        got.append(events)
    (jevents, tevents) = got
    assert len(tevents) == len(jevents) == 5
    np.testing.assert_allclose([e.cost for e in tevents[:4]], [e.cost for e in jevents[:4]],
                               rtol=RTOL)
    for je, te in zip(jevents, tevents):
        assert te.evaluator["err"] == je.evaluator["err"]
    assert 0 < tevents[-1].evaluator["err"]
