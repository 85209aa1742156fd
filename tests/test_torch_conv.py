"""Image layers of the port (conv, pool, batch_norm) against the JAX package's,
layer by layer: one small topology is built in both packages, the JAX
parameters and layer state are carried over with ``parameters.from_numpy``,
the same numpy batch goes through both networks, and outputs (and the new
batch-norm state) must agree at f32 within atol 1e-5 (the same arithmetic
in another summation order; the inputs are O(1))."""

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
from paddle_tpu_torch.layers.conv import to_nhwc

ATOL = 1e-5
B = 3

# conv cases: (input c, h, w, filter (x, y), stride, padding, groups, bias)
CONV = {
    "s1_p0": (4, 9, 9, (3, None), 1, 0, 1, True),
    "s2_p1": (4, 9, 10, (3, None), 2, 1, 1, True),
    "s2_p3_7x7": (3, 15, 15, (7, None), 2, 3, 1, False),
    "groups2": (4, 8, 8, (3, None), 1, 1, 2, True),
    "groups2_s2_nobias": (6, 9, 9, (1, None), 2, 0, 2, False),
    "rect_5x3": (2, 11, 9, (3, 5), 1, 1, 1, True),
}
# pool cases: (c, h, w, size, stride, padding, type); each odd size with
# stride 2 leaves a non-zero ceil-mode extra
POOL = {
    "max_3s2_p1": (5, 11, 11, 3, 2, 1, "max"),
    "max_2s2_odd": (5, 7, 9, 2, 2, 0, "max"),
    "avg_3s2_p1": (5, 11, 11, 3, 2, 1, "avg"),
    "avg_2s2_odd": (5, 7, 9, 2, 2, 0, "avg"),
    "avg_3s2_p0_odd": (5, 8, 10, 3, 2, 0, "avg"),
    "avg_global": (5, 4, 4, 4, 1, 0, "avg"),
}


def _img_input(L, dt, c, h, w):
    """An image data slot [B, c*h*w] (CHW order) with its geometry."""
    return L.data("img", dt.dense_vector(c * h * w), height=h, width=w)


def _build(case, pkg):
    """The case's output layer and the flat image size, in package `pkg`."""
    L, A, dt = pkg.layer, pkg.activation, pkg.data_type
    if case in CONV:
        c, h, w, (fx, fy), s, p, g, bias = CONV[case]
        x = _img_input(L, dt, c, h, w)
        return L.img_conv(x, filter_size=fx, filter_size_y=fy, num_filters=6, stride=s,
                          padding=p, groups=g, bias_attr=bias, act=A.Relu(), name="out"), c * h * w
    if case in POOL:
        c, h, w, k, s, p, kind = POOL[case]
        x = _img_input(L, dt, c, h, w)
        pt = pkg.pooling.Max() if kind == "max" else pkg.pooling.Avg()
        return L.img_pool(x, pool_size=k, stride=s, padding=p, pool_type=pt, name="out"), c * h * w
    if case == "flat_data_conv":
        # a flat CHW slot without declared geometry: the conv factors it
        x = L.data("img", dt.dense_vector(3 * 6 * 6))
        return L.img_conv(x, filter_size=3, num_filters=4, num_channels=3, padding=1,
                          name="out"), 3 * 6 * 6
    if case == "fc_after_conv":
        x = _img_input(L, dt, 2, 7, 5)
        conv = L.img_conv(x, filter_size=3, num_filters=3, padding=1, act=A.Relu())
        return L.fc(conv, size=7, act=A.Identity(), name="out"), 2 * 7 * 5
    if case.startswith("bn_img"):
        x = _img_input(L, dt, 4, 5, 6)
        conv = L.img_conv(x, filter_size=3, num_filters=5, padding=1, act=A.Identity())
        return L.batch_norm(conv, act=A.Relu(), name="out"), 4 * 5 * 6
    if case.startswith("bn_flat"):
        x = L.data("img", dt.dense_vector(12))
        return L.batch_norm(x, act=A.Identity(), name="out"), 12
    raise KeyError(case)


def _both(case):
    jout, n = _build(case, paddle_tpu)
    tout, _ = _build(case, paddle_tpu_torch)
    jnet = JNet(JTopo(jout), compute_dtype=jnp.float32)
    tnet = TNet(TTopo(tout), compute_dtype=torch.float32)
    assert jnet.topology.serialize() == tnet.topology.serialize()
    jparams, jstate = jnet.init(jax.random.PRNGKey(3))
    carried = paddle_tpu_torch.parameters.from_numpy(
        _numpy_tree(jparams), _numpy_tree(jstate), device="cpu"
    )
    return jnet, tnet, jparams, jstate, carried, n


def _numpy_tree(tree):
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in tree.items()}


def _image(n, seed=0):
    return np.random.RandomState(seed).randn(B, n).astype(np.float32)


def _moved_state(tree, seed):
    """A state unlike the initial one (as after training), so global
    statistics differ from batch statistics."""
    rng = np.random.RandomState(seed)
    return {k: {"mean": rng.randn(*v["mean"].shape).astype(np.float32) * 0.5,
                "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
            for k, v in tree.items()}


@pytest.mark.parametrize(
    "case", [*CONV, *POOL, "flat_data_conv", "fc_after_conv", "bn_img_train", "bn_img_eval",
             "bn_flat_train", "bn_flat_eval"],
)
def test_image_layer_matches_jax(case):
    jnet, tnet, jparams, jstate, carried, n = _both(case)
    train = not case.endswith("_eval")
    if case.startswith("bn"):
        jstate = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
                  for k, v in _moved_state(_numpy_tree(jstate), seed=1).items()}
        carried.state = paddle_tpu_torch.parameters.from_numpy(
            {}, _numpy_tree(jstate), device="cpu").state
    x = _image(n)
    jouts, jnew = jnet.apply(jparams, {"img": JSeq(jnp.asarray(x))}, state=jstate, train=train)
    touts, tnew = tnet.apply(carried.params, {"img": TSeq(torch.from_numpy(x))},
                             state=carried.state, train=train)
    got, want = touts["out"].data.numpy(), np.asarray(jouts["out"].data)
    assert got.shape == want.shape
    if want.ndim == 4:  # image outputs stay contiguous NHWC
        assert touts["out"].data.is_contiguous()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert set(tnew) == set(jnew)
    for layer, st in jnew.items():
        for key, v in st.items():
            np.testing.assert_allclose(tnew[layer][key].numpy(), np.asarray(v), atol=ATOL,
                                       err_msg=f"{layer}.{key}")
    if case.startswith("bn"):
        # train moves the state and uses batch statistics; eval keeps it
        moved = not np.allclose(np.asarray(jnew["out"]["mean"]), np.asarray(jstate["out"]["mean"]))
        assert moved == train


def test_conv_gradients_match_jax():
    """Input and weight gradients of a grouped, strided, rectangular conv
    with bias, followed by batch norm in train mode: within 1e-5 of the
    largest JAX gradient of any leaf (the bias's own gradient is zero up to
    rounding: batch statistics cancel a per-channel shift)."""
    def build(pkg):
        L, A, dt = pkg.layer, pkg.activation, pkg.data_type
        x = L.data("img", dt.dense_vector(4 * 9 * 8), height=9, width=8)
        conv = L.img_conv(x, filter_size=3, filter_size_y=5, num_filters=6, stride=2, padding=1,
                          groups=2, act=A.Identity(), name="conv")
        return L.batch_norm(conv, act=A.Relu(), name="out")

    jnet = JNet(JTopo(build(paddle_tpu)), compute_dtype=jnp.float32)
    tnet = TNet(TTopo(build(paddle_tpu_torch)), compute_dtype=torch.float32)
    jparams, jstate = jnet.init(jax.random.PRNGKey(4))
    x = _image(4 * 9 * 8, seed=2)
    gy = np.random.RandomState(3).randn(B, 4, 4, 6).astype(np.float32)

    def jloss(p, xi):
        outs, _ = jnet.apply(p, {"img": JSeq(xi)}, state=jstate, train=True)
        return jnp.sum(outs["out"].data * gy)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    leaves = {k: {kk: torch.tensor(np.asarray(vv), requires_grad=True) for kk, vv in v.items()}
              for k, v in jparams.items()}
    xt = torch.tensor(x, requires_grad=True)
    state = paddle_tpu_torch.parameters.from_numpy({}, _numpy_tree(jstate), device="cpu").state
    touts, _ = tnet.apply(leaves, {"img": TSeq(xt)}, state=state, train=True)
    (touts["out"].data * torch.from_numpy(gy)).sum().backward()
    pairs = [(xt.grad, jgx, "input")] + [
        (leaves[k][kk].grad, jg[k][kk], f"{k}.{kk}") for k in jg for kk in jg[k]]
    bar = 1e-5 * max(float(np.abs(np.asarray(want)).max()) for _, want, _ in pairs)
    for got, want, name in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=bar, err_msg=name)


def test_to_nhwc_reads_flat_input_in_chw_order():
    flat = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, -1)
    got = to_nhwc(flat, 4, 5, 3)
    assert got.shape == (2, 4, 5, 3) and got.is_contiguous()
    assert torch.equal(got, flat.reshape(2, 3, 4, 5).permute(0, 2, 3, 1))
    assert to_nhwc(got, 4, 5, 3) is got  # a contiguous NHWC tensor passes as is


def test_apply_defaults_match_jax_on_a_batch_norm_network():
    """CompiledNetwork.apply given a state and no `train` runs in training
    mode in both packages (batch statistics, the state moved; the port's
    default was train=False); forward and cost return the state as the JAX
    package's do."""
    jnet, tnet, jparams, jstate, carried, n = _both("bn_img_train")
    moved = _moved_state(_numpy_tree(jstate), seed=2)
    carried.state = paddle_tpu_torch.parameters.from_numpy({}, moved, device="cpu").state
    x = _image(n, seed=4)
    jouts, jst = jnet.apply(jparams, {"img": JSeq(jnp.asarray(x))}, state=moved)
    touts, tst = tnet.apply(carried.params, {"img": TSeq(torch.from_numpy(x))},
                            state=carried.state)
    np.testing.assert_allclose(touts["out"].data.numpy(), np.asarray(jouts["out"].data), atol=ATOL)
    for key in ("mean", "var"):
        np.testing.assert_allclose(tst["out"][key].numpy(), np.asarray(jst["out"][key]), atol=ATOL)
        assert not np.allclose(np.asarray(jst["out"][key]), moved["out"][key])
    # without a state both use batch statistics and return an empty state
    jouts, jst = jnet.apply(jparams, {"img": JSeq(jnp.asarray(x))})
    touts, tst = tnet.apply(carried.params, {"img": TSeq(torch.from_numpy(x))})
    np.testing.assert_allclose(touts["out"].data.numpy(), np.asarray(jouts["out"].data), atol=ATOL)
    assert tst == {} and jst == {}
    # with the state given, forward and cost hand back the moved state
    out, outs, new_state = tnet.forward(carried.params, {"img": TSeq(torch.from_numpy(x))},
                                        state=carried.state)
    assert out is outs["out"] and set(new_state) == {"out"}
    cost, (outs2, state2) = tnet.cost(carried.params, {"img": TSeq(torch.from_numpy(x))},
                                      state=carried.state)
    assert cost.dim() == 0 and set(state2) == {"out"}
    # the inputs are not mutated
    assert np.array_equal(carried.state["out"]["mean"].numpy(), moved["out"]["mean"])


@pytest.mark.parametrize("layer_type", ["priorbox", "detection_output", "multibox_loss",
                                        "mdlstmemory"])
def test_unported_image_layers_fail_at_compile(layer_type):
    """These were the last image types without a torch impl; they are
    registered now.  A type without one still fails when its network is
    compiled, naming itself."""
    from paddle_tpu_torch.layers.base import registered_layer_types

    L = paddle_tpu_torch.layer
    x = L.data("img", paddle_tpu_torch.data_type.dense_vector(48), height=4, width=4)
    assert layer_type in registered_layer_types()
    with pytest.raises(NotImplementedError, match=layer_type + "_without_impl"):
        TNet(TTopo(L._unary(layer_type + "_without_impl", x)))


def test_transposed_img_conv_raises():
    """A transposed conv whose groups divide neither its input nor its
    output channels raises when it is built, as in the JAX package."""
    L = paddle_tpu_torch.layer
    x = L.data("img", paddle_tpu_torch.data_type.dense_vector(48), height=4, width=4)
    with pytest.raises(ValueError, match="transpose conv groups=2"):
        L.img_conv(x, filter_size=3, num_filters=2, groups=2, trans=True)


def test_train_step_threads_detached_state():
    """make_train_step takes and returns the state as (params, state,
    opt_state, batch) -> (params, state, opt_state, metrics): the new state
    holds no graph and the given one is not mutated; make_eval_step runs on
    global statistics and leaves the state alone."""
    from paddle_tpu_torch.trainer.step import make_eval_step, make_train_step

    L, A, dt = paddle_tpu_torch.layer, paddle_tpu_torch.activation, paddle_tpu_torch.data_type
    x = L.data("img", dt.dense_vector(2 * 5 * 5), height=5, width=5)
    label = L.data("label", dt.integer_value(3))
    conv = L.img_conv(x, filter_size=3, num_filters=4, padding=1, act=A.Identity())
    pred = L.fc(L.batch_norm(conv, act=A.Relu()), size=3, act=A.Softmax())
    net = TNet(TTopo(L.classification_cost(pred, label)), compute_dtype=torch.float32)
    params, state = net.init(seed=1, device="cpu")
    opt = paddle_tpu_torch.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    rng = np.random.RandomState(5)
    batch = {"img": TSeq(torch.from_numpy(rng.randn(B, 50).astype(np.float32))),
             "label": TSeq(torch.from_numpy(rng.randint(0, 3, size=B).astype(np.int32)))}
    before = {k: {kk: v.clone() for kk, v in s.items()} for k, s in state.items()}
    params, new_state, opt_state, metrics = make_train_step(net, opt)(
        params, state, opt.init(params), batch)
    assert set(new_state) == set(state) and np.isfinite(float(metrics["cost"]))
    for k, s in new_state.items():
        for kk, v in s.items():
            assert v.grad_fn is None and not v.requires_grad
            assert not torch.equal(v, before[k][kk])
            assert torch.equal(state[k][kk], before[k][kk])
    want, _ = net.cost(params, batch, state=new_state, train=False)
    got = make_eval_step(net)(params, new_state, batch)["cost"]
    assert torch.allclose(got, want) and not torch.allclose(got, net.cost(params, batch)[0])
