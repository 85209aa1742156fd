"""The image types of the port (``convt``, the cross-map ``norm``,
``maxout``, ``pad``, ``crop``, ``bilinear_interp``, ``spp``,
``featmap_expand``, ``block_expand`` and ``conv_op``) against the JAX
package on the CPU (f32), and AlexNet through both.

Each case builds one small network in both packages, moves the JAX
parameters across by path and feeds the same seeded numpy batch: outputs,
and the gradients of the parameters and of the image slot, within rtol 1e-5
and atol 1e-6 (of the leaf's largest |g| for a gradient): the same
arithmetic in another summation order.  Brought
over from the JAX package's tests: the even-size cmrnorm window
(``tests/test_layer_extras.py:251``), grouped convt shapes and group
independence (:31, :50), crop's axis offsets (:280), the image networks of
``tests/test_layer_grad.py:148-205``, ``block_expand``'s first block
(``tests/test_sampled_misc.py:172``) and ``conv_operator``
(``tests/test_mixed.py:119``), plain and transposed.  Also: bilinear
downsampling (antialiased), spp on extents that are not a multiple of its
bins (and the all-pad window of h = 5 with 4 bins, -inf in both), a narrow
AlexNet (forward, gradients and a 3-step Momentum trajectory) and
AlexNet's v1 config at full width, parsed by both packages into the same
Topology."""

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.v1_compat
import paddle_tpu_torch
import paddle_tpu_torch.v1_compat
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from test_torch_parity import (
    assert_grads_close, assert_outputs_close, assert_params_carry, build_both, carry, grads_both,
    jax_params_from_port_init, outputs_both, train_both)

RTOL, ATOL = 1e-5, 1e-6
B = 3


def _img(pkg, c, h, w, name="img"):
    return pkg.layer.data(name, pkg.data_type.dense_vector(c * h * w), height=h, width=w)


def _conv(pkg, x, filters, **kw):
    """A conv in front of a type, so the parameter gradients pass through it."""
    return pkg.layer.img_conv(x, filter_size=3, num_filters=filters, padding=1,
                              act=pkg.activation.Identity(), **kw)


# name -> (the network over a package and its image input, (c, h, w) of the image slot)
CASES = {
    "cmrnorm_5": (lambda p, x: p.layer.img_cmrnorm(_conv(p, x, 7), size=5, scale=0.05,
                                                   power=0.75), (3, 6, 5)),
    "cmrnorm_even_4": (lambda p, x: p.layer.img_cmrnorm(x, size=4, scale=0.01, power=0.75),
                       (6, 3, 3)),
    "cmrnorm_3_default": (lambda p, x: p.layer.img_cmrnorm(x, size=3), (2, 5, 5)),
    "convt_dcgan_s2_k4_p1": (lambda p, x: p.layer.img_conv(
        x, filter_size=4, num_filters=5, stride=2, padding=1, trans=True,
        act=p.activation.Relu()), (4, 4, 4)),
    "convt_groups2": (lambda p, x: p.layer.img_conv(
        x, filter_size=2, num_filters=4, stride=2, groups=2, trans=True,
        act=p.activation.Identity()), (4, 5, 5)),
    "convt_s2_p1_k3_nobias": (lambda p, x: p.layer.img_conv(
        x, filter_size=3, num_filters=3, stride=2, padding=1, trans=True, bias_attr=False,
        act=p.activation.Identity()), (2, 6, 6)),
    "convt_rect_5x3_pad_past_k": (lambda p, x: p.layer.img_conv(
        x, filter_size=3, filter_size_y=5, num_filters=3, stride=2, padding=3, padding_y=1,
        trans=True, act=p.activation.Identity()), (2, 6, 7)),
    "maxout_2": (lambda p, x: p.layer.maxout(_conv(p, x, 8), groups=2), (2, 5, 5)),
    "maxout_3": (lambda p, x: p.layer.maxout(x, groups=3), (6, 4, 3)),
    "pad": (lambda p, x: p.layer.img_pad(_conv(p, x, 2), pad_c=(1, 1), pad_h=(1, 0),
                                         pad_w=(0, 2)), (2, 4, 5)),
    "crop_fcn_227_to_224": (lambda p, x: p.layer.crop(x, offset=[1, 2], axis=2,
                                                      shape=[224, 224]), (1, 227, 227)),
    "crop_channels": (lambda p, x: p.layer.crop(_conv(p, x, 5), offset=[1, 1, 2], axis=1,
                                                shape=[3, 3, 2]), (2, 5, 6)),
    "bilinear_up_2x": (lambda p, x: p.layer.bilinear_interp(_conv(p, x, 3), out_size_x=10,
                                                            out_size_y=8), (2, 4, 5)),
    "bilinear_down_2x": (lambda p, x: p.layer.bilinear_interp(x, out_size_x=4, out_size_y=6),
                         (3, 12, 8)),
    "bilinear_grad_9x9": (lambda p, x: p.layer.bilinear_interp(x, out_size_x=9, out_size_y=9),
                          (2, 5, 5)),
    "bilinear_mixed_axes": (lambda p, x: p.layer.bilinear_interp(x, out_size_x=7,
                                                                 out_size_y=3), (2, 5, 7)),
    "spp_max_13": (lambda p, x: p.layer.spp(_conv(p, x, 4), pyramid_height=3), (2, 13, 13)),
    "spp_avg_13": (lambda p, x: p.layer.spp(_conv(p, x, 4), pyramid_height=3,
                                            pool_type=p.pooling.Avg()), (2, 13, 13)),
    "spp_max_7x5": (lambda p, x: p.layer.spp(x, pyramid_height=2), (3, 7, 5)),
    "featmap_expand_row": (lambda p, x: p.layer.featmap_expand(
        p.layer.fc(x, size=5, act=p.activation.Tanh()), 3), (1, 2, 3)),
    "featmap_expand_col": (lambda p, x: p.layer.featmap_expand(
        p.layer.fc(x, size=5, act=p.activation.Tanh()), 3, as_row_vector=False), (1, 2, 3)),
    "block_expand_8x1": (lambda p, x: p.layer.block_expand(_conv(p, x, 3), block_x=1,
                                                           block_y=4), (2, 4, 6)),
    "block_expand_stride_pad": (lambda p, x: p.layer.block_expand(
        x, block_x=2, block_y=3, stride_x=2, stride_y=1, padding_x=1, padding_y=0), (2, 5, 6)),
    "conv_operator": (lambda p, x: p.layer.conv_operator(
        x, p.layer.fc(p.layer.data("z", p.data_type.dense_vector(4)), size=2 * 3 * 3 * 3,
                      act=p.activation.Identity()),
        filter_size=3, num_filters=2, num_channels=3), (3, 8, 8)),
    "conv_operator_s2_p1": (lambda p, x: p.layer.conv_operator(
        x, p.layer.fc(p.layer.data("z", p.data_type.dense_vector(4)), size=3 * 2 * 3 * 3,
                      act=p.activation.Identity()),
        filter_size=3, num_filters=3, num_channels=2, stride=2, padding=1), (2, 7, 7)),
    "conv_operator_trans": (lambda p, x: p.layer.conv_operator(
        x, p.layer.fc(p.layer.data("z", p.data_type.dense_vector(4)), size=2 * 3 * 4 * 4,
                      act=p.activation.Identity()),
        filter_size=4, num_filters=2, num_channels=3, stride=2, padding=1, trans=True),
        (3, 4, 4)),
    "mixed_conv_operator": (lambda p, x: p.layer.mixed(
        size=2 * 6 * 6, bias_attr=True, input=[p.layer.conv_operator(
            x, p.layer.fc(p.layer.data("z", p.data_type.dense_vector(4)), size=2 * 2 * 3 * 3,
                          act=p.activation.Identity()),
            filter_size=3, num_filters=2, num_channels=2, padding=1)]), (2, 6, 6)),
    "mixed_conv_projection_trans": (lambda p, x: p.layer.mixed(
        size=3 * 8 * 8, bias_attr=True, input=[p.layer.conv_projection(
            x, filter_size=4, num_filters=3, stride=2, padding=1, trans=True)]), (2, 4, 4)),
}


def _batch(case, seed=0):
    c, h, w = CASES[case][1]
    rng = np.random.RandomState(seed)
    jb = {"img": JSeq(rng.randn(B, c * h * w).astype(np.float32))}
    if "conv_operator" in case:
        jb["z"] = JSeq(rng.randn(B, 4).astype(np.float32))
    return jb


def _build(case):
    build, (c, h, w) = CASES[case]
    return build_both(lambda pkg: build(pkg, _img(pkg, c, h, w)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_type_matches_jax(case):
    """Outputs, parameter gradients and the image slot's gradient."""
    jout, tout = _build(case)
    assert TTopo([tout]).serialize() == paddle_tpu.Topology([jout]).serialize()
    jo, to, jg, tg = outputs_both(jout, tout, _batch(case), input_grads=("img",), jit=True,
                                  jparams=jax_params_from_port_init(jout, tout, seed=2))
    assert_outputs_close(jo, to, atol=ATOL, rtol=RTOL)
    a = tout.conf.attrs
    if to[tout.name].data.ndim == 4 and "out_h" in a:  # image outputs stay NHWC
        assert to[tout.name].data.shape[1:] == (a["out_h"], a["out_w"], a["channels"])
    assert_grads_close(jg, tg)


@pytest.mark.parametrize("case", ["convt_groups2", "convt_dcgan_s2_k4_p1", "conv_operator",
                                  "mixed_conv_projection_trans"])
def test_parameters_carry_by_name_and_shape(case):
    jout, tout = _build(case)
    assert_params_carry(jout, tout)


def test_convt_group_independence():
    """Group 0's output channels do not depend on group 1's input channels
    (tests/test_layer_extras.py:50)."""
    def net(pkg):
        return pkg.layer.img_conv(_img(pkg, 2, 4, 4, "x"), filter_size=2, num_filters=2,
                                  stride=2, groups=2, trans=True, bias_attr=False,
                                  act=pkg.activation.Identity(), name="up")

    jout, tout = build_both(net)
    params = carry(paddle_tpu.parameters.create(jout, seed=1)).params
    tnet = TNet(TTopo([tout]))
    base = np.random.RandomState(0).rand(1, 2, 4, 4).astype(np.float32)
    pert = base.copy()
    pert[0, 1] += 5.0
    outs = []
    for x in (base, pert):
        b = {"x": paddle_tpu_torch.core.batch.SeqTensor(torch.from_numpy(x.reshape(1, -1)))}
        outs.append(tnet.apply(params, b, train=False)[0]["up"].data.numpy())
    assert outs[0].shape == (1, 8, 8, 2)
    np.testing.assert_allclose(outs[0][..., 0], outs[1][..., 0], atol=1e-6)
    assert np.abs(outs[0][..., 1] - outs[1][..., 1]).max() > 1e-3


def test_cmrnorm_even_window_formula():
    """The port's norm against the formula (tests/test_layer_extras.py:251):
    the window starts (size - 1) // 2 channels left, reaching one further
    right for an even size."""
    c, hw, size, scale, power = 6, 3, 4, 0.01, 0.75
    jout, tout = build_both(lambda p: p.layer.img_cmrnorm(_img(p, c, hw, hw, "x"), size=size,
                                                          scale=scale, power=power, name="n"))
    chw = np.random.RandomState(0).randn(2, c, hw, hw).astype(np.float32)
    _, to, _, _ = outputs_both(jout, tout, {"x": JSeq(chw.reshape(2, -1))}, grads=False)
    x = chw.transpose(0, 2, 3, 1)
    want = np.zeros_like(x)
    half = (size - 1) // 2
    for ch in range(c):
        lo, hi = max(0, ch - half), min(c, ch + size - half)
        want[..., ch] = x[..., ch] * (1.0 + scale * (x[..., lo:hi] ** 2).sum(-1)) ** (-power)
    np.testing.assert_allclose(to["n"].data, want, rtol=RTOL, atol=ATOL)


def test_crop_offsets_align_to_axis():
    """crop(axis=2, offset=[h, w]) takes the window at rows h.., columns w..
    (tests/test_layer_extras.py:280)."""
    jout, tout = build_both(lambda p: p.layer.crop_layer(
        input=_img(p, 1, 4, 5), axis=2, offset=[1, 2], shape=[2, 2], name="c"))
    assert tout.size == 4
    x = np.arange(20, dtype=np.float32).reshape(1, 20)
    jo, to, _, _ = outputs_both(jout, tout, {"img": JSeq(x)}, grads=False)
    np.testing.assert_array_equal(to["c"].data.reshape(-1), x.reshape(4, 5)[1:3, 2:4].reshape(-1))
    assert_outputs_close(jo, to, atol=0, rtol=0)


def test_block_expand_first_block_and_lengths():
    """tests/test_sampled_misc.py:172: a 4x4 image in 2x2 blocks of stride 2
    is a sequence of 4 blocks, the first the top-left patch; every row is
    full length, and the lengths carry their host copy."""
    jout, tout = build_both(lambda p: p.layer.block_expand(
        _img(p, 1, 4, 4), block_x=2, block_y=2, stride_x=2, stride_y=2, name="be"))
    x = np.arange(16, dtype=np.float32).reshape(1, 16)
    jo, to, _, _ = outputs_both(jout, tout, {"img": JSeq(x)}, grads=False)
    assert to["be"].data.shape == (1, 4, 4)
    np.testing.assert_array_equal(to["be"].data[0, 0], [0, 1, 4, 5])
    np.testing.assert_array_equal(to["be"].lengths, [4])
    assert_outputs_close(jo, to, atol=0, rtol=0)
    out = TNet(TTopo([tout])).apply({}, {"img": paddle_tpu_torch.core.batch.SeqTensor(
        torch.from_numpy(x))}, train=False)[0]["be"]
    np.testing.assert_array_equal(out.lengths._host_lengths, [4])


def test_spp_all_pad_window_is_minus_inf_in_both():
    """h = 5 with 4 bins: the window is 2 rows, the pad 3, so the last
    window of the level holds pad only and max pools it to -inf, in both
    packages (a reference-side observation, mirrored)."""
    jout, tout = build_both(lambda p: p.layer.spp(_img(p, 2, 5, 8), pyramid_height=3, name="s"))
    x = np.random.RandomState(3).randn(2, 2 * 5 * 8).astype(np.float32)
    jo, to, _, _ = outputs_both(jout, tout, {"img": JSeq(x)}, grads=False)
    assert np.isneginf(jo["s"].data).any()
    np.testing.assert_array_equal(np.isneginf(to["s"].data), np.isneginf(jo["s"].data))
    assert_outputs_close(jo, to, atol=ATOL, rtol=RTOL)


def test_bilinear_weights_are_jax_image_resize():
    """Each axis's weight matrix is jax.image.resize's: the port's
    resize_weights, applied to the identity, reproduces resize of a basis,
    both up and down (where the triangle widens: antialiasing)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu_torch.layers.conv import resize_weights

    for n_in, n_out in ((5, 9), (12, 4), (7, 3), (6, 6), (28, 56), (56, 28)):
        want = np.asarray(jax.image.resize(jnp.eye(n_in, dtype=jnp.float32), (n_in, n_out),
                                           "bilinear"))
        got = resize_weights(n_in, n_out, torch.device("cpu")).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=f"{n_in}->{n_out}")
        if n_out != n_in:
            np.testing.assert_allclose(got.sum(0), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# AlexNet
# ---------------------------------------------------------------------------


def alexnet(pkg, img=227, filters=(96, 256, 384, 384, 256), fc=4096, classes=1000,
            drop_rate=0.5):
    """benchmark/paddle/image/alexnet.py's network through a package's v2
    DSL (layer_num=1, so groups 1); returns (cost, prediction)."""
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    drop = pkg.attr.ExtraAttr(drop_rate=drop_rate)
    net = L.data("data", dt.dense_vector(img * img * 3), height=img, width=img)
    net = L.img_conv(net, filter_size=11, num_channels=3, num_filters=filters[0], stride=4,
                     padding=1)
    net = L.img_cmrnorm(net, size=5, scale=0.0001, power=0.75)
    net = L.img_pool(net, pool_size=3, stride=2)
    net = L.img_conv(net, filter_size=5, num_filters=filters[1], stride=1, padding=2)
    net = L.img_cmrnorm(net, size=5, scale=0.0001, power=0.75)
    net = L.img_pool(net, pool_size=3, stride=2)
    net = L.img_conv(net, filter_size=3, num_filters=filters[2], stride=1, padding=1)
    net = L.img_conv(net, filter_size=3, num_filters=filters[3], stride=1, padding=1)
    net = L.img_conv(net, filter_size=3, num_filters=filters[4], stride=1, padding=1)
    net = L.img_pool(net, pool_size=3, stride=2)
    net = L.fc(net, size=fc, act=A.Relu(), layer_attr=drop)
    net = L.fc(net, size=fc, act=A.Relu(), layer_attr=drop)
    net = L.fc(net, size=classes, act=A.Softmax())
    lab = L.data("label", dt.integer_value(classes))
    return L.classification_cost(input=net, label=lab), net


NARROW = dict(img=67, filters=(8, 16, 24, 24, 16), fc=64, classes=10)


def _alex_samples(n, seed, classes=10, img=67):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3 * img * img).astype(np.float32)
    y = rng.randint(0, classes, size=n)
    return [(x[i], int(y[i])) for i in range(n)]


def test_alexnet_narrow_forward_and_gradients():
    (jcost, jprob), (tcost, tprob) = build_both(lambda p: alexnet(p, **NARROW))
    assert TTopo([tcost]).serialize() == paddle_tpu.Topology([jcost]).serialize()
    jparams = jax_params_from_port_init(jcost, tcost, seed=4)
    s = _alex_samples(4, 5)
    arrays = {"data": (np.stack([x for x, _ in s]), None),
              "label": (np.asarray([y for _, y in s], np.int32), None)}
    # dropout is off (train=False) so both packages run the same function
    jc, tc, jg, tg = grads_both(jcost, tcost, jparams, arrays, train=False, jit=True)
    np.testing.assert_allclose(tc, jc, rtol=RTOL)
    assert_grads_close(jg, tg)
    jo, to, _, _ = outputs_both(jprob, tprob, {"data": JSeq(arrays["data"][0])}, grads=False,
                                jparams=jparams, jit=True)
    assert_outputs_close(jo, to, atol=ATOL, rtol=RTOL)


def test_alexnet_narrow_momentum_trajectory():
    """Three Momentum(0.01, 0.9) steps with L2 5e-4 (the config's per-sample
    settings under the mean cost) in both packages; dropout draws differ
    between them, so these networks drop nothing."""
    (jcost, _), (tcost, _) = build_both(lambda p: alexnet(p, drop_rate=0.0, **NARROW))
    jparams = jax_params_from_port_init(jcost, tcost, seed=6)

    def opt(pkg):
        return pkg.optimizer.Momentum(
            learning_rate=0.01, momentum=0.9,
            regularization=pkg.optimizer.L2Regularization(rate=5e-4))

    jc, tc, _, _ = train_both(jcost, tcost, jparams, opt, _alex_samples(12, 7), 4,
                              {"data": 0, "label": 1})
    assert len(tc) == 3
    np.testing.assert_allclose(tc, jc, rtol=RTOL)


ALEXNET_V1 = '''
from paddle.trainer_config_helpers import *

height = 227
width = 227
num_class = 1000
batch_size = get_config_arg('batch_size', int, 128)
gp = get_config_arg('layer_num', int, 1)

settings(
    batch_size=batch_size,
    learning_rate=0.01 / batch_size,
    learning_method=MomentumOptimizer(0.9),
    regularization=L2Regularization(0.0005 * batch_size))

net = data_layer('data', size=height * width * 3)
net = img_conv_layer(input=net, filter_size=11, num_channels=3, num_filters=96, stride=4,
                     padding=1)
net = img_cmrnorm_layer(input=net, size=5, scale=0.0001, power=0.75)
net = img_pool_layer(input=net, pool_size=3, stride=2)
net = img_conv_layer(input=net, filter_size=5, num_filters=256, stride=1, padding=2, groups=gp)
net = img_cmrnorm_layer(input=net, size=5, scale=0.0001, power=0.75)
net = img_pool_layer(input=net, pool_size=3, stride=2)
net = img_conv_layer(input=net, filter_size=3, num_filters=384, stride=1, padding=1)
net = img_conv_layer(input=net, filter_size=3, num_filters=384, stride=1, padding=1, groups=gp)
net = img_conv_layer(input=net, filter_size=3, num_filters=256, stride=1, padding=1, groups=gp)
net = img_pool_layer(input=net, pool_size=3, stride=2)
net = fc_layer(input=net, size=4096, act=ReluActivation(), layer_attr=ExtraAttr(drop_rate=0.5))
net = fc_layer(input=net, size=4096, act=ReluActivation(), layer_attr=ExtraAttr(drop_rate=0.5))
net = fc_layer(input=net, size=num_class, act=SoftmaxActivation())
lab = data_layer('label', num_class)
loss = cross_entropy(input=net, label=lab)
outputs(loss)
'''


def test_alexnet_v1_config_full_width_builds_the_jax_topology(tmp_path):
    """The reference's alexnet.py (bench_alexnet's batch_size=128) parsed
    by both packages: the same Topology, 9216 inputs to the first fc."""
    cfg = tmp_path / "alexnet.py"
    cfg.write_text(ALEXNET_V1)
    j = paddle_tpu.v1_compat.parse_config(str(cfg), "batch_size=128")
    t = paddle_tpu_torch.v1_compat.parse_config(str(cfg), "batch_size=128")
    assert t.topology.serialize() == j.topology.serialize()
    convs = [c for c in t.topology.layers.values() if c.type == "conv"]
    assert [(c.attrs["out_h"], c.attrs["channels"]) for c in convs] == [
        (55, 96), (27, 256), (13, 384), (13, 384), (13, 256)]
    assert sum(c.type == "norm" for c in t.topology.layers.values()) == 2
    fc1 = next(c for c in t.topology.layers.values() if c.type == "fc")
    assert t.topology.layers[fc1.inputs[0]].size == 9216
    TNet(t.topology)
