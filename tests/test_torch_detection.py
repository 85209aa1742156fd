"""The SSD detection suite in the port (``ops/detection.py``,
``layers/detection.py``: priorbox, multibox_loss, detection_output;
``evaluator.detection_map_evaluator``) against the JAX package on the CPU,
in f32.

The ops: IoU, the box codec, matching (the two-gts-share-a-prior case of
``tests/test_detection.py``, clipped duplicate priors, random batches), NMS
and the hard-negative ranks with tied scores — indices equal, values within
rtol 1e-5.  The layers on the tiny SSD of ``tests/test_detection.py``:
outputs within rtol 1e-5 / atol 1e-5, gradients within rtol 1e-5 and atol
1e-6 of each leaf's largest |g|, the detection block's labels equal.  The
evaluator: the mAP cases of ``tests/test_detection.py`` and random
detections, accumulators and mAP equal to the JAX package's.  A 5-step SSD
trajectory: costs within rtol 1e-4 per step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import evaluator as jev
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu.ops import detection as JD
from paddle_tpu_torch import evaluator as tev
from paddle_tpu_torch.core.batch import SeqTensor as TSeq
from paddle_tpu_torch.ops import detection as TD
from test_torch_parity import (
    assert_grads_close, build_both, carry, jax_params_from_port_init, numpy_tree,
    outputs_both, to_port, train_both)

RTOL, ATOL = 1e-5, 1e-6
N_CLS = 3  # background + 2 object classes
VAR = (0.1, 0.1, 0.2, 0.2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _random_boxes(rng, *shape):
    """Corner-form boxes in [0, 1] with positive extent."""
    lo = rng.uniform(0.0, 0.7, size=shape + (2,))
    wh = rng.uniform(0.05, 0.3, size=shape + (2,))
    return np.concatenate([lo, np.minimum(lo + wh, 1.0)], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def test_iou_and_codec_match_jax():
    rng = np.random.RandomState(0)
    a, b = _random_boxes(rng, 7), _random_boxes(rng, 5)
    b[0] = a[0]  # IoU 1
    b[1] = [0.0, 0.0, 0.0, 0.0]  # an empty box: union 0 on its own
    np.testing.assert_allclose(TD.iou_matrix(_t(a), _t(b)).numpy(),
                               np.asarray(JD.iou_matrix(jnp.asarray(a), jnp.asarray(b))),
                               rtol=RTOL, atol=1e-7)
    priors, gt = _random_boxes(rng, 9), _random_boxes(rng, 9)
    enc_t = TD.encode_boxes(_t(gt), _t(priors), VAR)
    enc_j = np.asarray(JD.encode_boxes(jnp.asarray(gt), jnp.asarray(priors), VAR))
    np.testing.assert_allclose(enc_t.numpy(), enc_j, rtol=RTOL, atol=1e-6)
    dec = TD.decode_boxes(enc_t, _t(priors), VAR).numpy()
    np.testing.assert_allclose(dec, np.asarray(JD.decode_boxes(jnp.asarray(enc_j),
                                                               jnp.asarray(priors), VAR)),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(dec, gt, atol=1e-5)  # the round trip
    x = np.linspace(-3, 3, 13).astype(np.float32)
    np.testing.assert_array_equal(TD.smooth_l1(_t(x)).numpy(), np.asarray(JD.smooth_l1(x)))


def _match_both(priors, gt, valid, thr):
    jm, jp, ji = JD.match_priors(jnp.asarray(priors), jnp.asarray(gt), jnp.asarray(valid), thr)
    tm, tp, ti = TD.match_priors(_t(priors), _t(gt), _t(valid), thr)
    return (np.asarray(jm), np.asarray(jp), np.asarray(ji)), (tm.numpy(), tp.numpy(), ti.numpy())


def _assert_match_equal(j, t):
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_allclose(t[2], j[2], rtol=RTOL, atol=1e-7)


def test_match_priors_two_gts_share_a_prior():
    """tests/test_detection.py:319: both gts best overlap prior 1; the
    bipartite pass still gives each its own prior."""
    priors = np.array([[0.0, 0.0, 0.4, 0.4], [0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9]],
                      np.float32)
    gt = np.array([[0.1, 0.1, 0.5, 0.5], [0.12, 0.12, 0.48, 0.48]], np.float32)
    j, t = _match_both(priors, gt, np.array([True, True]), 0.99)
    _assert_match_equal(j, t)
    assert {int(t[0][i]) for i in range(3) if t[1][i]} == {0, 1}


def test_match_priors_clipped_duplicates_take_the_lower_index():
    """Priors clipped at the image border can coincide; the flat row-major
    argmax gives a tie to the lower prior, in both packages."""
    priors = np.clip(np.array([[-0.2, -0.2, 0.3, 0.3], [-0.1, -0.1, 0.3, 0.3],
                               [0.5, 0.5, 0.9, 0.9], [0.0, 0.0, 0.3, 0.3]], np.float32), 0, 1)
    gt = np.array([[0.0, 0.0, 0.3, 0.3], [0.55, 0.5, 0.9, 0.9], [0, 0, 0, 0]], np.float32)
    valid = np.array([True, True, False])
    for thr in (0.5, 1.01):
        j, t = _match_both(priors, gt, valid, thr)
        _assert_match_equal(j, t)
    # above any IoU only the bipartite pass matches: prior 0 of the three
    assert t[1].tolist() == [True, False, True, False] and t[0][0] == 0


def test_match_priors_batched_equals_each_image():
    """One batched call against the JAX package image by image (ragged valid
    counts, one image with none)."""
    rng = np.random.RandomState(1)
    priors = _random_boxes(rng, 40)
    gt = _random_boxes(rng, 3, 4)
    valid = np.array([[1, 1, 0, 0], [1, 1, 1, 1], [0, 0, 0, 0]], bool)
    tm, tp, ti = TD.match_priors(_t(priors), _t(gt), _t(valid), 0.3)
    for b in range(3):
        j = JD.match_priors(jnp.asarray(priors), jnp.asarray(gt[b]), jnp.asarray(valid[b]), 0.3)
        _assert_match_equal([np.asarray(x) for x in j], (tm[b].numpy(), tp[b].numpy(),
                                                         ti[b].numpy()))


def test_nms_matches_jax():
    rng = np.random.RandomState(2)
    boxes = _random_boxes(rng, 30)
    boxes[5] = boxes[4]  # a duplicate box
    scores = rng.rand(3, 30).astype(np.float32)
    scores[:, ::4] = -np.inf  # under the confidence threshold
    scores[1, 7] = scores[1, 9]  # a tie: the lower index first
    ti, tk = TD.nms(_t(boxes)[None], _t(scores), 0.3, 8)
    for b in range(3):
        ji, jk = JD.nms(jnp.asarray(boxes), jnp.asarray(scores[b]), 0.3, 8)
        np.testing.assert_array_equal(ti[b].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tk[b].numpy(), np.asarray(jk))
    # every candidate suppressed before max_out rounds: idx 0 and score 0
    few = np.full((1, 30), -np.inf, np.float32)
    few[0, 3] = 0.5
    ti, tk = TD.nms(_t(boxes), _t(few), 0.3, 4)
    assert ti.tolist() == [[3, 0, 0, 0]] and tk.tolist() == [[0.5, 0.0, 0.0, 0.0]]


def test_hard_negative_ranks_ties_rank_by_index():
    rng = np.random.RandomState(3)
    score = np.round(rng.rand(2, 40), 1).astype(np.float32)  # many ties
    mask = rng.rand(2, 40) > 0.3
    tr = TD.hard_negative_ranks(_t(score), _t(mask)).numpy()
    for b in range(2):
        np.testing.assert_array_equal(
            tr[b], np.asarray(JD.hard_negative_ranks(jnp.asarray(score[b]), jnp.asarray(mask[b]))))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _ssd(pkg, img_hw=8, cell=4, keep_top_k=8, nms_top_k=8, conf_thr=0.3):
    """tests/test_detection.py's tiny SSD: image -> conv feature map ->
    loc/conf heads + priorbox; two prior variants per cell."""
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    k = 2
    img = L.data("image", dt.dense_vector(3 * img_hw * img_hw), height=img_hw, width=img_hw)
    gt = L.data("gt", dt.dense_vector_sequence(6))
    feat = L.img_conv(img, filter_size=3, num_filters=8, stride=img_hw // cell, padding=1,
                      act=A.Relu(), name="feat")
    loc = L.img_conv(feat, filter_size=3, num_filters=k * 4, padding=1, act=A.Identity(),
                     name="loc")
    cnf = L.img_conv(feat, filter_size=3, num_filters=k * N_CLS, padding=1, act=A.Identity(),
                     name="cnf")
    pb = L.priorbox(feat, img, aspect_ratio=[1.0], variance=list(VAR), min_size=[3.0],
                    max_size=[5.0], name="pb")
    cost = L.multibox_loss(input_loc=loc, input_conf=cnf, priorbox=pb, label=gt,
                           num_classes=N_CLS, name="mbl")
    det = L.detection_output(input_loc=loc, input_conf=cnf, priorbox=pb, num_classes=N_CLS,
                             keep_top_k=keep_top_k, nms_top_k=nms_top_k,
                             confidence_threshold=conf_thr, name="det")
    return cost, det, pb


GTS = [
    [(1, 0.1, 0.1, 0.4, 0.4, 0)],
    [(2, 0.5, 0.5, 0.9, 0.9, 0), (1, 0.0, 0.0, 0.3, 0.3, 1), (2, 0.45, 0.1, 0.75, 0.35, 0)],
    [(1, 0.2, 0.6, 0.5, 0.95, 0), (1, 0.6, 0.2, 0.95, 0.5, 0)],
]


def _gt_arrays(gts):
    g = max(len(x) for x in gts)
    arr = np.zeros((len(gts), g, 6), np.float32)
    lens = np.array([len(x) for x in gts], np.int32)
    for i, rows in enumerate(gts):
        arr[i, : len(rows)] = rows
    return arr, lens


def _ssd_batch(seed=0, gts=GTS):
    arr, lens = _gt_arrays(gts)
    image = np.random.RandomState(seed).rand(len(gts), 3 * 8 * 8).astype(np.float32)
    return {"image": JSeq(jnp.asarray(image)), "gt": JSeq(jnp.asarray(arr), jnp.asarray(lens))}


def test_priorbox_is_the_prior_block_over_the_batch():
    (_, _, jpb), (_, _, tpb) = build_both(_ssd)
    jo, to, _, _ = outputs_both(jpb, tpb, _ssd_batch(), grads=False,
                                jparams=jax_params_from_port_init(jpb, tpb, 0))
    np.testing.assert_array_equal(to["pb"].data, jo["pb"].data)
    assert to["pb"].data.shape == (3, 4 * 4 * 2, 8)


def test_multibox_loss_and_gradients_match_jax():
    (jcost, _, _), (tcost, _, _) = build_both(_ssd)
    jo, to, jg, tg = outputs_both(jcost, tcost, _ssd_batch(), input_grads=("image",), jit=True,
                                  jparams=jax_params_from_port_init(jcost, tcost, 4))
    np.testing.assert_allclose(to["mbl"].data, jo["mbl"].data, rtol=RTOL, atol=1e-5)
    assert to["mbl"].data.shape == (3, 1) and (to["mbl"].data > 0).all()
    assert_grads_close(jg, tg, rtol=RTOL, atol=ATOL)


def test_detection_output_matches_jax():
    (_, jdet, _), (_, tdet, _) = build_both(
        lambda pkg: _ssd(pkg, keep_top_k=16, nms_top_k=6, conf_thr=0.2))
    jo, to, jg, tg = outputs_both(jdet, tdet, _ssd_batch(seed=1), jit=True,
                                  jparams=jax_params_from_port_init(jdet, tdet, 5))
    j, t = jo["det"].data, to["det"].data
    assert t.shape == (3, 16, 6)  # 2 classes x 6 kept, then 4 rows of padding
    np.testing.assert_array_equal(t[..., 0], j[..., 0])  # labels and the padding
    assert (t[..., 0] >= 0).any() and (t[..., 0] == -1).any()
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-6)
    assert_grads_close(jg, tg, rtol=RTOL, atol=ATOL)


def test_ssd_trajectory_matches_jax():
    """5 steps of Adam through SGD.train in both packages on one batch."""
    (jcost, _, _), (tcost, _, _) = build_both(_ssd)
    jparams = jax_params_from_port_init(jcost, tcost, 6)
    arr, lens = _gt_arrays(GTS)
    image = np.random.RandomState(7).rand(3, 3 * 8 * 8).astype(np.float32)
    samples = [(image[i], [tuple(r) for r in arr[i, : lens[i]]]) for i in range(3)] * 5
    jc, tc, _, _ = train_both(jcost, tcost, jparams,
                              lambda pkg: pkg.optimizer.Adam(learning_rate=1e-2), samples, 3,
                              {"image": 0, "gt": 1})
    assert len(tc) == 5 and tc[-1] < tc[0]
    np.testing.assert_allclose(tc, jc, rtol=1e-4)


# ---------------------------------------------------------------------------
# the mAP evaluator
# ---------------------------------------------------------------------------


def _map_both(dets, gts, ap_type="11point", **kw):
    """(JAX mAP, port mAP, JAX accumulators, port accumulators)."""
    arr, lens = _gt_arrays(gts)
    out = []
    for pkg, ev_mod, seq in ((paddle_tpu, jev, JSeq), (paddle_tpu_torch, tev, TSeq)):
        L, dt = pkg.layer, pkg.data_type
        det_l = L.data("det", dt.dense_vector(6))
        gt_l = L.data("gtv", dt.dense_vector_sequence(6))
        ev = ev_mod.detection_map_evaluator(det_l, gt_l, num_classes=N_CLS, ap_type=ap_type,
                                            name="map", **kw)
        conv = jnp.asarray if pkg is paddle_tpu else torch.from_numpy
        update = jax.jit(ev.update) if pkg is paddle_tpu else ev.update
        acc = update({"det": seq(conv(np.asarray(dets, np.float32))),
                      "gtv": seq(conv(arr), conv(lens))})
        acc = {k: np.asarray(v) for k, v in acc.items()}
        out.append((ev.finalize(acc)["map"], acc))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _dets(*rows):
    return np.asarray([list(rows)], np.float32)


MAP_CASES = {
    # tests/test_detection.py:281-330
    "perfect": (_dets([1, 0.9, 0.1, 0.1, 0.4, 0.4], [2, 0.8, 0.5, 0.5, 0.9, 0.9]),
                [[(1, 0.1, 0.1, 0.4, 0.4, 0), (2, 0.5, 0.5, 0.9, 0.9, 0)]], "11point", 1.0),
    "half": (_dets([1, 0.9, 0.1, 0.1, 0.4, 0.4], [2, 0.8, 0.0, 0.0, 0.05, 0.05]),
             [[(1, 0.1, 0.1, 0.4, 0.4, 0), (2, 0.5, 0.5, 0.9, 0.9, 0)]], "11point", 0.5),
    "duplicate_is_fp": (_dets([1, 0.9, 0.1, 0.1, 0.4, 0.4], [1, 0.8, 0.11, 0.11, 0.41, 0.41]),
                        [[(1, 0.1, 0.1, 0.4, 0.4, 0)]], "Integral", 1.0),
    "difficult_ignored": (_dets([1, 0.9, 0.1, 0.1, 0.4, 0.4]),
                          [[(1, 0.1, 0.1, 0.4, 0.4, 1), (1, 0.6, 0.6, 0.9, 0.9, 0)]], "11point",
                          0.0),
}


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_detection_map_cases(case):
    dets, gts, ap_type, want = MAP_CASES[case]
    jm, tm, ja, ta = _map_both(dets, gts, ap_type)
    assert tm == pytest.approx(want, abs=1e-2)
    assert tm == jm
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


@pytest.mark.parametrize("ap_type,difficult", [("11point", False), ("Integral", True)])
def test_detection_map_random_matches_jax(ap_type, difficult):
    """Random detections over a ragged batch: padded label -1 rows, tied
    scores, boxes near their gts, difficult gts."""
    rng = np.random.RandomState(8)
    gts = []
    for n in (3, 1, 4, 2):
        boxes = _random_boxes(rng, n)
        gts.append([(int(rng.randint(1, N_CLS)), *boxes[i], float(rng.rand() < 0.25))
                    for i in range(n)])
    dets = np.zeros((4, 10, 6), np.float32)
    for b, rows in enumerate(gts):
        for k in range(10):
            src = rows[k % len(rows)]
            jitter = rng.normal(0, 0.03, 4)
            dets[b, k] = [rng.randint(0, N_CLS), np.round(rng.rand(), 2), *(np.asarray(src[1:5]) + jitter)]
        dets[b, 8:, 0] = -1  # padding rows
        dets[b, 8:, 1] = 0
    dets[0, 1, 1] = dets[0, 2, 1]  # a tie
    jm, tm, ja, ta = _map_both(dets, gts, ap_type, evaluate_difficult=difficult)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert tm == jm and 0.0 < tm < 1.0


def test_detection_map_through_sgd_test():
    """The evaluator beside SGD.test on the tiny SSD (the JAX package's
    value from the same parameters)."""
    (jcost, jdet, _), (tcost, tdet, _) = build_both(lambda pkg: _ssd(pkg, conf_thr=0.05))
    jparams = jax_params_from_port_init(jcost, tcost, 9)
    arr, lens = _gt_arrays(GTS)
    image = np.random.RandomState(10).rand(3, 3 * 8 * 8).astype(np.float32)
    samples = [(image[i], [tuple(r) for r in arr[i, : lens[i]]]) for i in range(3)]
    got = []
    for pkg, cost, det, params, kw in (
            (paddle_tpu, jcost, jdet, jparams, {}),
            (paddle_tpu_torch, tcost, tdet, carry(jparams), {"device": "cpu"})):
        gt_layer = [p for p in cost.parents if p.name == "gt"][0]
        ev = pkg.evaluator.detection_map_evaluator(det, gt_layer, num_classes=N_CLS, name="map")
        trainer = pkg.trainer.SGD(cost=cost, parameters=params,
                                  update_equation=pkg.optimizer.Adam(learning_rate=1e-3),
                                  extra_layers=[det], evaluators=[ev], **kw)
        res = trainer.test(pkg.batch(lambda: iter(samples), 3), feeding={"image": 0, "gt": 1})
        got.append(res.metrics["map"])
    assert got[1] == pytest.approx(got[0], abs=1e-6)


def _two_map_ssd(pkg, priors_slot):
    """Heads on two maps (4x4 and 2x2) of one image.  The port takes the
    reference's multi-map form, a concat of one priorbox per map; the JAX
    package's layers read priors as [B, P, 8] only, so its twin reads them
    from a data slot."""
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    img = L.data("image", dt.dense_vector(3 * 8 * 8), height=8, width=8)
    gt = L.data("gt", dt.dense_vector_sequence(6))
    f1 = L.img_conv(img, 3, 8, stride=2, padding=1, act=A.Relu(), name="f1")
    f2 = L.img_conv(f1, 3, 8, stride=2, padding=1, act=A.Relu(), name="f2")
    locs, confs, pbs = [], [], []
    for k, (f, lo, hi) in enumerate(((f1, 2.0, 4.0), (f2, 4.0, 7.0))):
        locs.append(L.img_conv(f, 3, 4 * 4, padding=1, act=A.Identity(), name=f"loc{k}"))
        confs.append(L.img_conv(f, 3, 4 * N_CLS, padding=1, act=A.Identity(), name=f"cnf{k}"))
        pbs.append(L.priorbox(f, img, aspect_ratio=[2.0], variance=list(VAR), min_size=[lo],
                              max_size=[hi], name=f"pb{k}"))
    priors = (L.data("pri", dt.dense_vector_sequence(8)) if priors_slot
              else L.concat(pbs, name="pri"))
    return L.multibox_loss(input_loc=locs, input_conf=confs, priorbox=priors, label=gt,
                           num_classes=N_CLS, name="mbl")


def test_two_maps_through_a_concat_of_priorboxes():
    """The concat's flat [B, P * 8] priors are read as [B, P, 8] in the
    heads' map order: the loss and its gradients equal the JAX package's fed
    the same priors as [B, P, 8]."""
    from paddle_tpu.core.compiler import CompiledNetwork as JNet
    from paddle_tpu.core.topology import Topology as JTopo, reset_auto_names
    from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
    from paddle_tpu_torch.core.topology import Topology as TTopo

    reset_auto_names()
    jcost = _two_map_ssd(paddle_tpu, True)
    tcost = _two_map_ssd(paddle_tpu_torch, False)
    tnet = TNet(TTopo([tcost]))
    jparams = jax_params_from_port_init(jcost, tcost, 11)
    batch = _ssd_batch(seed=12)
    tbatch = to_port(batch)
    leaves = {k: {kk: vv.clone().requires_grad_(True) for kk, vv in p.items()}
              for k, p in carry(jparams).params.items()}
    touts = tnet.apply(leaves, tbatch, train=False)[0]
    pri = touts["pri"].data.reshape(3, -1, 8)
    assert pri.shape[1] == 4 * 4 * 4 + 2 * 2 * 4
    torch.testing.assert_close(pri, torch.cat([touts["pb0"].data, touts["pb1"].data], 1))
    touts["mbl"].data.sum().backward()
    jnet = JNet(JTopo([jcost]))
    batch["pri"] = JSeq(jnp.asarray(pri.detach().numpy()), jnp.full((3,), pri.shape[1]))

    def jloss(p):
        return jnp.sum(jnet.apply(p, batch, train=False)[0]["mbl"].data)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams.params)
    assert float(touts["mbl"].data.sum().detach()) == pytest.approx(float(jl), rel=RTOL)
    assert_grads_close(numpy_tree(jg), {k: {kk: vv.grad for kk, vv in p.items()}
                                        for k, p in leaves.items()}, rtol=RTOL, atol=ATOL)
