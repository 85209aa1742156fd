"""The 2D multi-dimensional LSTM in the port (``layers/mdlstm.py``: a
wavefront over anti-diagonals with a hand-written backward) against the
JAX package's row-of-columns scan on the CPU, in f32.

Outputs within rtol 1e-5 / atol 1e-6, gradients (parameters and input)
within rtol 1e-5 and atol 1e-6 of each leaf's largest |g|: the four
(reverse_h, reverse_w) directions at 4x5 with size 3, other activations,
a tall and a wide image, no bias; the causality case of
``tests/test_layer_extras.py``; and a tiny MDLSTM-CTC line recognizer's
cost and gradients."""

import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from test_torch_parity import (
    assert_grads_close, build_both, grads_both, jax_params_from_port_init, outputs_both,
    to_port)

RTOL, ATOL = 1e-5, 1e-6


def _md(pkg, n=3, h=4, w=5, **kw):
    L, dt = pkg.layer, pkg.data_type
    x = L.data("x", dt.dense_vector(5 * n * h * w), height=h, width=w)
    return L.mdlstmemory(x, size=n, name="md", **kw)


def _check(build, shape, seed):
    jout, tout = build_both(build)
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jparams = jax_params_from_port_init(jout, tout, seed)
    # a non-zero bias, so its gradient and the masked cells are exercised
    jparams.params["md"] = {**jparams.params["md"]}
    if "b" in jparams.params["md"]:
        jparams.params["md"]["b"] = jnp.asarray(
            np.random.RandomState(seed + 1).randn(*jparams.params["md"]["b"].shape) * 0.3,
            jnp.float32)
    jo, to, jg, tg = outputs_both(jout, tout, {"x": JSeq(jnp.asarray(x))}, jparams=jparams,
                                  input_grads=("x",), jit=True)
    np.testing.assert_allclose(to["md"].data, jo["md"].data, rtol=RTOL, atol=ATOL)
    assert_grads_close(jg, tg, rtol=RTOL, atol=ATOL)
    return to["md"].data


@pytest.mark.parametrize("rev_h,rev_w", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_four_directions_match_jax(rev_h, rev_w):
    out = _check(lambda pkg: _md(pkg, reverse_h=rev_h, reverse_w=rev_w), (2, 5 * 3 * 4 * 5), 1)
    assert out.shape == (2, 4, 5, 3)


@pytest.mark.parametrize("case", ["relu_acts", "tall", "wide_no_bias"])
def test_shapes_and_activations_match_jax(case):
    def build(pkg):
        A = pkg.activation
        if case == "relu_acts":
            return _md(pkg, n=2, h=3, w=3, act=A.Relu(), state_act=A.Sigmoid())
        if case == "tall":
            return _md(pkg, n=2, h=6, w=2, reverse_w=True)
        return _md(pkg, n=2, h=2, w=7, bias_attr=False)

    shapes = {"relu_acts": (3, 5 * 2 * 9), "tall": (2, 5 * 2 * 12), "wide_no_bias": (2, 5 * 2 * 14)}
    _check(build, shapes[case], 2)


def test_causality():
    """tests/test_layer_extras.py:94: the output at (0, 0) does not depend on
    the input at (2, 2); with both reverses the dependency flips."""
    for rev, upstream, downstream in ((False, (0, 0), (2, 2)), (True, (2, 2), (0, 0))):
        _, tout = build_both(lambda pkg: _md(pkg, n=2, h=3, w=3, reverse_h=rev, reverse_w=rev))
        net = TNet(TTopo([tout]))
        params = net.init_params(seed=0, device="cpu")
        base = np.random.RandomState(1).rand(1, 10, 3, 3).astype(np.float32)  # CHW
        pert = base.copy()
        pert[0, :, downstream[0], downstream[1]] += 3.0
        outs = [net.apply(params, to_port({"x": JSeq(v.reshape(1, -1))}), train=False)[0]["md"]
                .data for v in (base, pert)]
        np.testing.assert_allclose(outs[0][0, upstream[0], upstream[1]],
                                   outs[1][0, upstream[0], upstream[1]], atol=1e-6)
        assert (outs[0][0, downstream[0], downstream[1]]
                - outs[1][0, downstream[0], downstream[1]]).abs().max() > 1e-4


def _mdlstm_ctc(pkg, h=4, w=6, n=3, classes=6):
    """A tiny MDLSTM-CTC line recognizer: conv, then per direction a 1x1 conv
    to 5n gates and an mdlstmemory, the four summed, block_expand into W
    frames, fc and warp_ctc."""
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    img = L.data("image", dt.dense_vector(h * w), height=h, width=w)
    feat = L.img_conv(img, filter_size=3, num_filters=4, padding=1, num_channels=1,
                      act=A.Relu(), name="conv")
    dirs = []
    for k, (rh, rw) in enumerate(((False, False), (True, False), (False, True), (True, True))):
        g = L.img_conv(feat, filter_size=1, num_filters=5 * n, act=A.Identity(), name=f"gates{k}")
        dirs.append(L.mdlstmemory(g, size=n, reverse_h=rh, reverse_w=rw, name=f"md{k}"))
    net = L.addto(dirs, act=A.Identity(), bias_attr=False, name="sum")
    net = L.block_expand(net, block_x=1, block_y=h, num_channels=n, name="frames")
    logits = L.fc(net, size=classes, act=A.Identity(), name="logits")
    label = L.data("label", dt.integer_value_sequence(classes))
    return L.warp_ctc(logits, label, size=classes, blank=0, name="ctc")


def test_mdlstm_ctc_net_matches_jax():
    jcost, tcost = build_both(_mdlstm_ctc)
    jparams = jax_params_from_port_init(jcost, tcost, 3)
    rng = np.random.RandomState(3)
    image = rng.randn(3, 4 * 6).astype(np.float32)
    labels = np.asarray([[1, 2, 3], [4, 4, 0], [5, 0, 0]], np.int32)
    batch = {"image": (image, None), "label": (labels, np.asarray([3, 2, 1], np.int32))}
    jc, tc, jg, tg = grads_both(jcost, tcost, jparams, batch, train=False, jit=True)
    assert tc == pytest.approx(jc, rel=RTOL)
    assert_grads_close(jg, tg, rtol=RTOL, atol=ATOL)
