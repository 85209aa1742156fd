"""The costs of ``layers/cost.py`` (but ``rank_cost``, in
``test_torch_sampled.py``) and the 22 elementwise and misc types of
``layers/basic.py`` and ``layers/misc.py`` in the port against the JAX
package on the CPU (f32).

Each type runs on its network of ``tests/test_layer_grad_sweep.py``
(:230-394) on the same random batch, with the JAX parameters (and layer
state) moved across: outputs within atol 1e-5 and rtol 1e-5 with equal
lengths (ids equal for ``maxid``), and the gradients of parameters and float
inputs within 1e-4 relative L2, one forward case and one gradient case per
type.  Extra cases: ``cos`` with ``cos_n > 1``, ``data_norm``'s three
strategies on random statistics, the ``dotmul`` projection's scale vector,
``trans`` with no height, ``repeat`` in place, ``prelu`` with
``partial_sum`` and ``sum_cost`` over a sequence.  ``power``'s inputs are
made positive (a negative base to a real power is NaN in both packages).  Also:
``maxid`` takes the first maximum on a tie, ``print`` prints
``"{name}: {val}"``, every new parameter and state vector has the JAX
package's name and shape, and a ``model_type('multi_nn')`` v1 config
compiles in the port with the JAX package's cost and gradients."""

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from layer_grad_util import rand_batch_for
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu.core.compiler import CompiledNetwork as JNet
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from test_torch_parity import (
    assert_outputs_close, assert_params_carry, batch_both, build_both, carry, numpy_tree,
    outputs_both, rel_l2)
from paddle_tpu_torch.utils.tree import map_leaves

GRAD_REL = 1e-4


def _dense(pkg, dim=8, name="in0"):
    return pkg.layer.data(name, pkg.data_type.dense_vector(dim))


def _dense_seq(pkg, dim=8, name="seq0"):
    return pkg.layer.data(name, pkg.data_type.dense_vector_sequence(dim))


def _ids(pkg, vocab=10, name="ids0"):
    return pkg.layer.data(name, pkg.data_type.integer_value(vocab))


def _fc(pkg, x, size, act):
    return pkg.layer.fc(x, size=size, act=act)


class Case(NamedTuple):
    build: Callable
    slots: Tuple[str, ...] = ()  # float slots whose gradients are compared
    prep: Optional[Callable] = None  # (jbatch, jparams, jout) -> jbatch, on the JAX side
    grad: bool = True


def _positive(*slots):
    def prep(jbatch, jparams, jout):
        for slot in slots:
            jbatch[slot] = JSeq(jnp.abs(jbatch[slot].data) + 0.5)
        return jbatch
    return prep


def _soft_targets(jbatch, jparams, jout):
    jbatch["t"] = JSeq(1.0 / (1.0 + jnp.exp(-jbatch["t"].data)))
    return jbatch


def _stats(jbatch, jparams, jout):
    """Random fixed statistics for data_norm (min < max; for decimal
    scaling, magnitudes of max from 0.03 to 700, off the powers of ten)."""
    rng = np.random.RandomState(5)
    d = jbatch["in0"].data.shape[-1]
    lo = rng.randn(d)
    if jout.conf.attrs["strategy"] == "decimal-scaling":
        hi = rng.uniform(0.03, 700.0, d) * rng.choice([-1.0, 1.0], d)
    else:
        hi = lo + rng.uniform(0.5, 3.0, d)
    stats = {"mean": rng.randn(d), "std": rng.uniform(0.5, 2.0, d), "min": lo, "max": hi}
    jparams.state = {jout.name: {k: jnp.asarray(v, jnp.float32) for k, v in stats.items()}}
    return jbatch


def _data_norm(strategy):
    return Case(lambda pkg: pkg.layer.data_norm(_dense(pkg), strategy=strategy), ("in0",),
                _stats)


def _dotmul_projection(pkg):
    """The dotmul projection form (a [size] scale vector): its conf is
    built directly, as no DSL callable builds it."""
    x = _dense(pkg)
    conf = pkg.core.topology.LayerConf(name="dm", type="dotmul", size=8, inputs=(x.name,),
                                       bias=False, attrs={"projection": True})
    return pkg.core.topology.LayerOutput(conf, [x])


def _multi_nn(pkg):
    """The multi_nn ensemble's joint cost as the sweep builds it: two
    sub-network costs summed, output [1]."""
    L, A = pkg.layer, pkg.activation
    a = L.classification_cost(_fc(pkg, _dense(pkg, 6, "xa"), 3, A.Softmax()), _ids(pkg, 3, "la"))
    b = L.square_error_cost(_fc(pkg, _dense(pkg, 4, "xb"), 2, A.Identity()),
                            _dense(pkg, 2, "lb"))
    conf = pkg.core.topology.LayerConf(name="__multi_nn_cost__", type="multi_nn_cost", size=1,
                                       inputs=(a.name, b.name), bias=False)
    return pkg.core.topology.LayerOutput(conf, [a, b])


CASES = {
    # -- costs -----------------------------------------------------------
    "soft_binary_class_cross_entropy": Case(
        lambda pkg: pkg.layer.soft_binary_class_cross_entropy_cost(
            _fc(pkg, _dense(pkg, 6), 6, pkg.activation.Sigmoid()), _dense(pkg, 6, "t")),
        ("in0",), _soft_targets),
    "smooth_l1": Case(lambda pkg: pkg.layer.smooth_l1_cost(
        _fc(pkg, _dense(pkg), 3, pkg.activation.Identity()), _dense(pkg, 3, "lbl")),
        ("in0", "lbl")),
    "huber_regression": Case(lambda pkg: pkg.layer.huber_regression_cost(
        _fc(pkg, _dense(pkg), 3, pkg.activation.Identity()), _dense(pkg, 3, "lbl")),
        ("in0", "lbl")),
    "huber_classification": Case(lambda pkg: pkg.layer.huber_classification_cost(
        _fc(pkg, _dense(pkg), 1, pkg.activation.Identity()), _ids(pkg, 2, "lbl")), ("in0",)),
    "sum_cost": Case(lambda pkg: pkg.layer.sum_cost(
        _fc(pkg, _dense(pkg), 4, pkg.activation.Tanh())), ("in0",)),
    "sum_cost_sequence": Case(lambda pkg: pkg.layer.sum_cost(
        _fc(pkg, _dense_seq(pkg, 4), 3, pkg.activation.Tanh())), ("seq0",)),
    "cross_entropy_with_selfnorm": Case(lambda pkg: pkg.layer.cross_entropy_with_selfnorm_cost(
        _fc(pkg, _dense(pkg), 5, pkg.activation.Softmax()), _ids(pkg, 5, "lbl")), ("in0",)),
    "multi_nn_cost": Case(_multi_nn, ("xa", "xb", "lb")),
    # -- layers/basic.py -------------------------------------------------
    "slope_intercept": Case(lambda pkg: pkg.layer.slope_intercept(
        _dense(pkg), slope=2.0, intercept=0.5), ("in0",)),
    "interpolation": Case(lambda pkg: pkg.layer.interpolation(
        _dense(pkg, 1, "w"), _dense(pkg, 8, "a"), _dense(pkg, 8, "b")), ("w", "a", "b")),
    "sum_to_one_norm": Case(lambda pkg: pkg.layer.sum_to_one_norm(_dense(pkg)), ("in0",),
                            _positive("in0")),
    "row_l2_norm": Case(lambda pkg: pkg.layer.row_l2_norm(_dense(pkg)), ("in0",)),
    "maxid": Case(lambda pkg: pkg.layer.maxid(_dense(pkg)), grad=False),
    "multiplex": Case(lambda pkg: pkg.layer.multiplex(
        [pkg.layer.data("sel", pkg.data_type.integer_value(2)), _dense(pkg, 6, "a"),
         _dense(pkg, 6, "b")]), ("a", "b")),
    "trans": Case(lambda pkg: pkg.layer.trans(_dense(pkg, 12), height=3), ("in0",)),
    "trans_whole_batch": Case(lambda pkg: pkg.layer.trans(_dense(pkg, 12)), ("in0",)),
    "repeat": Case(lambda pkg: pkg.layer.repeat(_dense(pkg, 6), num_repeats=2), ("in0",)),
    "repeat_in_place": Case(lambda pkg: pkg.layer.repeat(
        _dense(pkg, 6), num_repeats=3, as_row_vector=False), ("in0",)),
    "resize": Case(lambda pkg: pkg.layer.resize(_dense(pkg, 12), size=6), ("in0",)),
    "clip": Case(lambda pkg: pkg.layer.clip(_dense(pkg), min=-0.4, max=0.4), ("in0",)),
    "dotmul": Case(lambda pkg: pkg.layer.dotmul_operator(
        _dense(pkg, 8, "a"), _dense(pkg, 8, "b")), ("a", "b")),
    "dotmul_projection": Case(_dotmul_projection, ("in0",)),
    "out_prod": Case(lambda pkg: pkg.layer.out_prod(_dense(pkg, 4, "a"), _dense(pkg, 3, "b")),
                     ("a", "b")),
    "cos": Case(lambda pkg: pkg.layer.cos_sim(_dense(pkg, 8, "a"), _dense(pkg, 8, "b"),
                                              scale=5.0), ("a", "b")),
    "cos_n3": Case(lambda pkg: pkg.layer.cos_sim(_dense(pkg, 4, "a"), _dense(pkg, 12, "b"),
                                                 scale=2.0, size=3), ("a", "b")),
    "tensor": Case(lambda pkg: pkg.layer.tensor(_dense(pkg, 4, "a"), _dense(pkg, 3, "b"),
                                                size=5, act=pkg.activation.Tanh()), ("a", "b")),
    # -- layers/misc.py --------------------------------------------------
    "prelu": Case(lambda pkg: pkg.layer.prelu(_dense(pkg)), ("in0",)),
    "prelu_partial_sum": Case(lambda pkg: pkg.layer.prelu(_dense(pkg), partial_sum=4),
                              ("in0",)),
    "power": Case(lambda pkg: pkg.layer.power(_dense(pkg, 1, "w"), _dense(pkg, 8, "x")),
                  ("w", "x"), _positive("w", "x")),
    "data_norm": _data_norm("z-score"),
    "data_norm_min_max": _data_norm("min-max"),
    "data_norm_decimal_scaling": _data_norm("decimal-scaling"),
    "rotate": Case(lambda pkg: pkg.layer.rotate(_dense(pkg, 12, "r"), height=3, width=4),
                   ("r",)),
    "linear_comb": Case(lambda pkg: pkg.layer.linear_comb(
        _dense(pkg, 3, "w"), _dense(pkg, 12, "x"), size=4), ("w", "x")),
    "cos_vm": Case(lambda pkg: pkg.layer.cos_sim_vec_mat(
        _dense(pkg, 3, "v"), _dense(pkg, 12, "m"), size=4), ("v", "m")),
    "print": Case(lambda pkg: pkg.layer.print_layer(
        _fc(pkg, _dense(pkg), 3, pkg.activation.Tanh())), ("in0",)),
    "scale_shift": Case(lambda pkg: pkg.layer.scale_shift(_dense(pkg)), ("in0",)),
}

NEW_TYPES = {"soft_binary_class_cross_entropy", "smooth_l1", "huber_regression",
             "huber_classification", "sum_cost", "cross_entropy_with_selfnorm", "multi_nn_cost",
             "slope_intercept", "interpolation", "sum_to_one_norm", "row_l2_norm", "maxid",
             "multiplex", "trans", "repeat", "resize", "clip", "dotmul", "out_prod", "cos",
             "tensor", "prelu", "power", "data_norm", "rotate", "linear_comb", "cos_vm", "print",
             "scale_shift"}


def _both(case, seed=1):
    """(JAX output, port output, JAX batch, JAX Parameters) of a case."""
    c = CASES[case]
    jout, tout = build_both(c.build)
    assert TTopo([tout]).serialize() == JTopo([jout]).serialize()
    jbatch = rand_batch_for(JTopo([jout]), batch_size=4, max_len=6, seed=3)
    jparams = paddle_tpu.parameters.create(jout, seed=seed)
    if c.prep is not None:
        jbatch = c.prep(jbatch, jparams, jout)
    return jout, tout, jbatch, jparams


def test_every_new_type_has_a_case():
    types = set()
    for c in CASES.values():
        jout, _ = build_both(c.build)
        types |= {conf.type for conf in JTopo([jout]).layers.values()}
    assert NEW_TYPES <= types
    assert len(NEW_TYPES) == 29


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    jout, tout, jbatch, jparams = _both(case)
    jo, to, _, _ = outputs_both(jout, tout, jbatch, grads=False, jparams=jparams)
    if case == "maxid":
        assert to[jout.name].data.dtype == np.int32
        assert_outputs_close(jo, to, atol=0, rtol=0)
    else:
        assert_outputs_close(jo, to)


@pytest.mark.parametrize("case", sorted(k for k in CASES if CASES[k].grad))
def test_gradients_match_jax(case):
    jout, tout, jbatch, jparams = _both(case)
    jo, to, jg, tg = outputs_both(jout, tout, jbatch, input_grads=CASES[case].slots,
                                  jparams=jparams)
    assert_outputs_close(jo, to)
    err = rel_l2(tg, jg)
    assert err <= GRAD_REL, err


def test_multi_nn_cost_is_one_value():
    jout, tout, jbatch, jparams = _both("multi_nn_cost")
    jo, to, _, _ = outputs_both(jout, tout, jbatch, grads=False, jparams=jparams)
    assert to[jout.name].data.shape == jo[jout.name].data.shape == (1,)


def test_maxid_takes_the_first_maximum():
    jout, tout = build_both(lambda pkg: pkg.layer.maxid(_dense(pkg, 4)))
    x = np.asarray([[1, 3, 3, 0], [2, 2, 2, 2], [0, 0, 0, 5]], np.float32)
    jo, to, _, _ = outputs_both(jout, tout, {"in0": JSeq(jnp.asarray(x))}, grads=False)
    np.testing.assert_array_equal(to[jout.name].data, [1, 0, 3])
    assert_outputs_close(jo, to, atol=0, rtol=0)


def test_print_prints_name_and_value(capsys):
    L, dt = paddle_tpu_torch.layer, paddle_tpu_torch.data_type
    out = L.print_layer(L.data("x", dt.dense_vector(3)), name="shown")
    x = torch.tensor([[1.0, 2.0, 3.0]])
    got = TNet(TTopo([out])).apply({}, {"x": paddle_tpu_torch.core.batch.SeqTensor(x)},
                                   train=False)[0]["shown"]
    assert torch.equal(got.data, x)
    assert capsys.readouterr().out == f"shown: {x.numpy()}\n"


@pytest.mark.parametrize("case", ["dotmul_projection", "tensor", "prelu", "prelu_partial_sum",
                                  "scale_shift", "data_norm"])
def test_new_parameters_carry_by_name_and_shape(case):
    """dotmul.w, tensor w [K, d1, d2], prelu.a, scale_shift's scale and
    shift, and data_norm's four state vectors."""
    assert_params_carry(*build_both(CASES[case].build))


MULTI_NN = """
from paddle.trainer_config_helpers import *
settings(batch_size=8, learning_rate=1e-2, learning_method=AdamOptimizer())
model_type('multi_nn')
SubModelBegin('branch_a')
xa = data_layer(name='xa', size=6)
la = data_layer(name='la', size=2)
fa = fc_layer(input=xa, size=2, act=SoftmaxActivation())
ca = classification_cost(input=fa, label=la, name='cost_a')
Inputs('xa', 'la')
Outputs('cost_a')
SubModelEnd('branch_a')
SubModelBegin('branch_b')
xb = data_layer(name='xb', size=4)
lb = data_layer(name='lb', size=1)
fb = fc_layer(input=xb, size=1, act=LinearActivation())
cb = regression_cost(input=fb, label=lb, name='cost_b')
Inputs('xb', 'lb')
Outputs('cost_b')
SubModelEnd('branch_b')
"""


def test_multi_nn_model_type_compiles_and_matches_jax(tmp_path):
    """The v1 model_type('multi_nn') assembly (tests/test_v1_compat.py:839)
    compiles in the port, and its joint cost and gradients equal the JAX
    package's on the same batch and parameters."""
    from paddle_tpu.v1_compat import parse_config as jparse
    from paddle_tpu_torch.v1_compat import parse_config as tparse

    cfg = tmp_path / "multi.py"
    cfg.write_text(MULTI_NN)
    jp, tp = build_both(lambda pkg: (jparse if pkg is paddle_tpu else tparse)(str(cfg)))
    assert tp.output_layers[0] == "__multi_nn_cost__"
    assert tp.topology.serialize() == jp.topology.serialize()
    jparams = paddle_tpu.parameters.create(jp.topology, seed=4)
    rng = np.random.RandomState(0)
    arrays = {"xa": (rng.randn(8, 6).astype(np.float32), None),
              "la": (rng.randint(0, 2, 8).astype(np.int32), None),
              "xb": (rng.randn(8, 4).astype(np.float32), None),
              "lb": (rng.randn(8, 1).astype(np.float32), None)}
    assert tp.topology.layers["__multi_nn_cost__"].type == "multi_nn_cost"
    jnet = JNet(jp.topology, compute_dtype=jnp.float32)
    tnet = TNet(tp.topology, compute_dtype=torch.float32)
    jb, tb = batch_both(arrays)
    jc, jg = jax.value_and_grad(
        lambda p: jnet.cost(p, jb, state=jparams.state, train=False)[0])(jparams.params)
    leaves = map_leaves(lambda v: v.clone().requires_grad_(True), carry(jparams).params)
    tc = tnet.cost(leaves, tb, train=False)[0]
    tc.backward()
    assert abs(tc.item() - float(jc)) <= 1e-5 * abs(float(jc))
    err = rel_l2(map_leaves(lambda v: v.grad, leaves), numpy_tree(jg))
    assert err <= GRAD_REL, err
