"""The port's op framework (paddle_tpu_torch/framework/) against the JAX
package's on the CPU, on the same numpy inputs from seeded RandomStates:

- every case of tests/test_framework_ops.py through both packages: each
  op's inferred shapes and every scope variable after the run, f32 within
  1e-6 relative L2 (the same arithmetic in another summation order);
- Backward of single ops, of fc_net (its missing out@GRADs seeded with
  ones), of a 2-op net with a no_grad_set, of a softmax cross-entropy net
  whose float label gets zero gradients, and of a RecurrentOp at T = 5
  against JAX's vjp through its scan: names equal, values within 1e-6
  relative L2;
- numeric_gradient against the JAX package's on the same ops: both
  evaluate the objective in f32, so they agree within f32 rounding of the
  objective over 2 * delta, and the port's check_gradients passes the JAX
  package's cases;
- both registries list the same ten op types, and a float64 input computes
  in f32 in both.
"""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import framework as jfw
from paddle_tpu.framework.net import fc_net as j_fc_net
from paddle_tpu_torch import framework as tfw
from paddle_tpu_torch.framework.net import fc_net as t_fc_net

REL = 1e-6
FW = {"jax": (jfw, j_fc_net), "torch": (tfw, t_fc_net)}
TEN_OPS = ["add", "fill_zeros_like", "mean", "mul", "onehot_cross_entropy", "rowwise_add",
           "scale", "sgd", "sigmoid", "softmax"]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def as_np(v):
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def scope_of(pkg, arrays):
    fw = FW[pkg][0]
    scope = fw.Scope(device="cpu") if pkg == "torch" else fw.Scope()
    for k, v in arrays.items():
        scope.new_var(k).set(v)
    return scope


def rnd(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _rnn(fw, fc_net):
    step = fw.NetOp()
    step.add_op(fw.create_op("mul", X="x_t", Y="W", Out="xw"))
    step.add_op(fw.create_op("mul", X="h_pre", Y="U", Out="hu"))
    step.add_op(fw.create_op("add", X="xw", Y="hu", Out="pre_act"))
    step.add_op(fw.create_op("sigmoid", X="pre_act", Y="h"))
    step.complete_add_op()
    return fw.RecurrentOp(step_net=step, inlinks={"x": "x_t"}, outlinks=["h"],
                          memories=[("h_pre", "h", "h0")])


def _ce_net(fw, fc_net):
    net = fw.NetOp()
    net.add_op(fw.create_op("mul", X="x", Y="w", Out="h"))
    net.add_op(fw.create_op("rowwise_add", X="h", b="b", Out="hb"))
    net.add_op(fw.create_op("softmax", X="hb", Y="p"))
    net.add_op(fw.create_op("onehot_cross_entropy", X="p", label="label", Y="ce"))
    net.add_op(fw.create_op("mean", X="ce", Out="cost"))
    net.complete_add_op()
    return net


def _two_op(fw, fc_net):
    net = fw.NetOp()
    net.add_op(fw.create_op("mul", X="x", Y="w", Out="h"))
    net.add_op(fw.create_op("add", X="h", Y="h", Out="h2"))
    net.complete_add_op()
    return net


T, B, D = 5, 2, 3
# case -> (ops built from (framework, fc_net), input arrays); the cases of
# tests/test_framework_ops.py, each run op by op in one scope
CASES = {
    "add": (lambda fw, fc: [fw.create_op("add", X="x", Y="y", Out="out")],
            {"x": rnd(0, 3, 4), "y": rnd(1, 3, 4)}),
    "mul": (lambda fw, fc: [fw.create_op("mul", X="x", Y="y", Out="out")],
            {"x": rnd(2, 3, 5), "y": rnd(3, 5, 2)}),
    "rowwise_add_sigmoid_softmax_mean_scale": (
        lambda fw, fc: [fw.create_op("rowwise_add", X="x", b="b", Out="r"),
                        fw.create_op("sigmoid", X="r", Y="s"),
                        fw.create_op("softmax", X="x", Y="sm"),
                        fw.create_op("mean", X="x", Out="m"),
                        fw.create_op("scale", X="x", Out="sc", scale=2.5)],
        {"x": rnd(4, 4, 6), "b": rnd(5, 6)}),
    "cross_entropy": (
        lambda fw, fc: [fw.create_op("onehot_cross_entropy", X="x", label="lab", Y="ce")],
        {"x": np.array([[0.2, 0.8], [0.9, 0.1]], np.float32), "lab": np.array([1, 0], np.int32)}),
    "cross_entropy_float_label": (
        lambda fw, fc: [fw.create_op("onehot_cross_entropy", X="x", label="lab", Y="ce")],
        {"x": np.array([[0.2, 0.8, 0.0], [0.5, 0.0, 0.5]], np.float32),
         "lab": np.array([1.0, 2.9], np.float32)}),
    "sgd": (lambda fw, fc: [fw.create_op("sgd", param="p", grad="g", param_out="p2",
                                         learning_rate=0.1)],
            {"p": np.ones((2, 2), np.float32), "g": np.full((2, 2), 0.5, np.float32)}),
    "fill_zeros_like": (lambda fw, fc: [fw.create_op("fill_zeros_like", Src="x", Dst="z")],
                        {"x": rnd(6, 2, 3)}),
    "fc_net": (lambda fw, fc: [fc("x", "w", "b", "out")],
               {"x": rnd(7, 4, 3), "w": rnd(8, 3, 5), "b": rnd(9, 5)}),
    "recurrent": (lambda fw, fc: [_rnn(fw, fc)],
                  {"x": rnd(13, T, B, D), "W": rnd(14, D, D), "U": rnd(15, D, D),
                   "h0": np.zeros((B, D), np.float32)}),
}


def run_case(pkg, case):
    fw, fc = FW[pkg]
    build, arrays = CASES[case]
    scope = scope_of(pkg, arrays)
    shapes = []
    for op in build(fw, fc):
        if hasattr(op, "infer_shape"):
            op.infer_shape(scope)
            shapes.append({n: scope.get_var(n).shape for n in op.output_names()})
        op.run(scope)
    return {n: as_np(scope.get_var(n).get()) for n in scope.local_names()}, shapes


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_the_jax_package(case):
    (jv, jshapes), (tv, tshapes) = run_case("jax", case), run_case("torch", case)
    assert tshapes == jshapes
    assert sorted(tv) == sorted(jv)
    for n in jv:
        assert tv[n].shape == jv[n].shape and tv[n].dtype == jv[n].dtype, n
        assert rel(tv[n], jv[n]) <= REL, (n, rel(tv[n], jv[n]))


def test_values_stay_tensors_on_the_scope_device():
    arrays = CASES["fc_net"][1]
    scope = scope_of("torch", arrays)
    t_fc_net("x", "w", "b", "out").run(scope)
    for n in scope.local_names():
        assert torch.is_tensor(scope.get_var(n).get())
        assert scope.get_var(n).get().device == torch.device("cpu")
    want = 1 / (1 + np.exp(-(arrays["x"] @ arrays["w"] + arrays["b"])))
    np.testing.assert_allclose(scope.get_var("out").get().numpy(), want, rtol=1e-5)


def test_float64_inputs_compute_in_float32_as_in_the_jax_package():
    x64 = np.random.RandomState(20).randn(3, 4) * (1 + 1e-9)
    out = {}
    for pkg in ("jax", "torch"):
        scope = scope_of(pkg, {"x": x64, "y": x64 / 3})
        FW[pkg][0].create_op("add", X="x", Y="y", Out="out").run(scope)
        out[pkg] = as_np(scope.get_var("out").get())
    assert out["torch"].dtype == out["jax"].dtype == np.float32
    np.testing.assert_array_equal(out["torch"], out["jax"])


def test_scope_hierarchy_and_device():
    parent = tfw.Scope(device="cpu")
    parent.new_var("a").set(np.zeros(2))
    child = parent.new_scope()
    assert child.device == torch.device("cpu")
    assert child.find_var("a") is parent.vars["a"]
    child.new_var("a").set(np.ones(2))  # shadowing
    np.testing.assert_allclose(child.find_var("a").get(), 1.0)
    np.testing.assert_allclose(parent.find_var("a").get(), 0.0)
    assert child.find_var("missing") is None
    with pytest.raises(KeyError):
        child.get_var("missing")
    assert parent.local_names() == ["a"] and child.var("b") is child.new_var("b")
    assert child.new_var("z").set_dims((2, 3)).get().dtype == torch.float32


def test_net_external_io_and_lowering():
    nets = {pkg: _two_op(*FW[pkg]) for pkg in FW}
    assert nets["torch"].external_inputs == nets["jax"].external_inputs == ["x", "w"]
    assert nets["torch"].external_outputs == nets["jax"].external_outputs == ["h", "h2"]
    with pytest.raises(RuntimeError):
        nets["torch"].add_op(tfw.create_op("sigmoid", X="h2", Y="s"))
    x, w = rnd(8, 2, 3), rnd(9, 3, 4)
    jouts = j_fc_net("x", "w", None, "out").lower()(x, w)
    touts = t_fc_net("x", "w", None, "out").lower()(torch.from_numpy(x), torch.from_numpy(w))
    assert len(touts) == len(jouts) == 2
    for t, j in zip(touts, jouts):
        assert rel(as_np(t), j) <= REL


# Backward cases: (forward built from (framework, fc_net), inputs, no_grad_set,
# the out@GRADs set before the run; the others are seeded with ones)
BWD_CASES = {
    "mul": (lambda fw, fc: fw.create_op("mul", X="x", Y="w", Out="out"),
            {"x": rnd(9, 3, 4), "w": rnd(10, 4, 2)}, None, {"out@GRAD": rnd(11, 3, 2)}),
    "mul_no_grad_w": (lambda fw, fc: fw.create_op("mul", X="x", Y="w", Out="out"),
                      {"x": rnd(9, 3, 4), "w": rnd(10, 4, 2)}, {"w"}, {}),
    "fc_net": (lambda fw, fc: fc("x", "w", "b", "out"),
               {"x": rnd(10, 3, 4), "w": rnd(11, 4, 2), "b": rnd(12, 2)}, None, {}),
    "two_op_no_grad_x": (_two_op, {"x": rnd(12, 3, 4), "w": rnd(13, 4, 2)}, {"x"},
                         {"h2@GRAD": rnd(14, 3, 2)}),
    "softmax_cross_entropy": (
        _ce_net, {"x": rnd(15, 4, 5), "w": rnd(16, 5, 3), "b": rnd(17, 3),
                  "label": np.array([0, 2, 1, 2], np.float32)}, None,
        {"cost@GRAD": np.ones((), np.float32)}),
    "recurrent": (_rnn, {"x": rnd(13, T, B, D), "W": rnd(14, D, D), "U": rnd(15, D, D),
                         "h0": rnd(16, B, D)}, None, {"h@GRAD": rnd(17, T, B, D)}),
}


def run_backward(pkg, case):
    fw, fc = FW[pkg]
    build, arrays, no_grad, seeds = BWD_CASES[case]
    fwd = build(fw, fc)
    scope = scope_of(pkg, arrays)
    fwd.run(scope)
    for k, v in seeds.items():
        scope.new_var(k).set(v)
    bwd = fw.Backward(fwd, no_grad_set=no_grad)
    bwd.run(scope)
    return bwd.output_names(), {n: as_np(scope.get_var(n).get()) for n in bwd.output_names()}


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_matches_the_jax_package(case):
    (jn, jg), (tn, tg) = run_backward("jax", case), run_backward("torch", case)
    assert tn == jn
    for n in jn:
        assert tg[n].shape == jg[n].shape, n
        if not np.any(jg[n]):  # an input no output depends on: zeros in both
            assert not np.any(tg[n]), n
            continue
        assert rel(tg[n], jg[n]) <= REL, (n, rel(tg[n], jg[n]))
    if case == "mul":
        _, arrays, _, seeds = BWD_CASES[case]
        np.testing.assert_allclose(tg["x@GRAD"], seeds["out@GRAD"] @ arrays["w"].T, rtol=1e-5)
    if case == "softmax_cross_entropy":
        assert tn[-1] == "label@GRAD" and not np.any(tg["label@GRAD"])


def _numeric_ops(fw, fc):
    return {"sigmoid": fw.create_op("sigmoid", X="x", Y="y"),
            "softmax": fw.create_op("softmax", X="x", Y="y"),
            "mul": fw.create_op("mul", X="x", Y="y", Out="o"),
            "fc_net": fc("x", "w", "b", "out")}


NUMERIC_INPUTS = {
    "sigmoid": {"x": rnd(11, 3, 5)},
    "softmax": {"x": rnd(11, 3, 5)},
    "mul": {"x": rnd(12, 3, 4), "y": rnd(13, 4, 2)},
    "fc_net": {"x": rnd(10, 3, 4), "w": rnd(11, 4, 2), "b": rnd(12, 2)},
}


@pytest.mark.parametrize("name", sorted(NUMERIC_INPUTS))
def test_numeric_gradient_matches_the_jax_package(name):
    inputs = NUMERIC_INPUTS[name]
    jop, top = _numeric_ops(*FW["jax"])[name], _numeric_ops(*FW["torch"])[name]
    delta = 1e-3
    for wrt in inputs:
        jn = jfw.numeric_gradient(jop, inputs, wrt, delta=delta)
        tn = tfw.numeric_gradient(top, inputs, wrt, delta=delta, device="cpu")
        # both evaluate the objective in f32: they differ by its rounding,
        # a few f32 ulps of sum(|outputs|), over 2 * delta
        traced = top.trace({k: torch.from_numpy(v) for k, v in inputs.items()})
        scale = sum(float(traced[n].abs().sum()) for n in top.output_names())
        bar = 8 * np.finfo(np.float32).eps * scale / (2 * delta)
        assert np.abs(tn - jn).max() <= bar, (wrt, np.abs(tn - jn).max(), bar)
    tfw.check_gradients(top, inputs, device="cpu")


def test_gradient_checker_rejects_a_wrong_gradient():
    op = tfw.create_op("mul", X="x", Y="y", Out="o")
    inputs = NUMERIC_INPUTS["mul"]
    with pytest.raises(AssertionError, match="gradient mismatch"):
        tfw.check_gradients(op, inputs, out_grads={"o": np.ones((3, 2))}, rtol=1e-6,
                            atol=1e-9, device="cpu")
    tfw.check_gradients(op, inputs, out_grads={"o": rnd(3, 3, 2)}, device="cpu")


def test_registries_list_the_same_ten_op_types():
    assert tfw.OpRegistry.op_types() == jfw.OpRegistry.op_types() == TEN_OPS
    for t in TEN_OPS:
        j, p = jfw.OpRegistry.get(t), tfw.OpRegistry.get(t)
        assert (p.inputs, p.outputs, p.attrs) == (j.inputs, j.outputs, j.attrs), t
    with pytest.raises(KeyError):
        tfw.OpRegistry.get("nope")
    with pytest.raises(ValueError, match="duplicate"):
        tfw.register_op("add", ["X"], ["Out"])(lambda x: x)
    with pytest.raises(ValueError, match="missing input slot"):
        tfw.Operator("add", {"X": "x"}, {"Out": "o"})


def test_recurrent_op_inputs_and_backward_through_the_loop():
    rnns = {pkg: _rnn(*FW[pkg]) for pkg in FW}
    assert rnns["torch"].input_names() == rnns["jax"].input_names()
    assert set(rnns["torch"].input_names()) == {"x", "h0", "W", "U"}
    # the JAX vjp runs through lax.scan under jit as well; the port's
    # autograd through its loop matches both
    _, arrays, _, seeds = BWD_CASES["recurrent"]
    jin = {k: jax.numpy.asarray(v) for k, v in arrays.items()}

    def f(vals):
        return rnns["jax"].trace(vals)["h"]

    _, vjp = jax.vjp(f, jin)
    (jg,) = vjp(jax.numpy.asarray(seeds["h@GRAD"]))
    _, tg = run_backward("torch", "recurrent")
    for n in arrays:
        assert rel(tg[n + "@GRAD"], np.asarray(jg[n])) <= REL, n
