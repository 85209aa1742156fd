"""The port's whole DSL against the JAX package's:

- every public callable of ``paddle_tpu.layers`` exists in
  ``paddle_tpu_torch.layers`` (198 of 198);
- DSL programs over the unported layer types and the ``layer_math``
  operator programs build Topologies that serialize byte-identically;
- a layer type with no torch impl fails when its network is compiled,
  with an error that names the type (each of the JAX package's registered
  types the port lacks)."""

import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.layers import base as jbase
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.layers import base as tbase
from test_torch_parity import build_both


def _public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_") and callable(getattr(mod, n)))


def test_every_public_callable_exists():
    want = _public(paddle_tpu.layer)
    got = _public(paddle_tpu_torch.layer)
    assert len(want) == 198
    assert [n for n in want if n not in got] == []


_UNPORTED = sorted(set(jbase.registered_layer_types()) - set(tbase.registered_layer_types()))


def test_the_unported_types_are_the_roadmaps():
    assert len(_UNPORTED) == 63  # 95 - 32 (ROADMAP Queue 1 item 3)


@pytest.mark.parametrize("type_name", _UNPORTED)
def test_an_unported_type_fails_naming_itself(type_name):
    with pytest.raises(NotImplementedError, match=repr(type_name)):
        tbase.get_layer_impl(type_name)


def _inputs(pkg):
    L, dt = pkg.layer, pkg.data_type
    return {
        "x": L.data(name="x", type=dt.dense_vector(8)),
        "y": L.data(name="y", type=dt.dense_vector(8)),
        "w": L.data(name="w", type=dt.dense_vector(1)),
        "lab": L.data(name="lab", type=dt.integer_value(8)),
        "s": L.data(name="s", type=dt.dense_vector_sequence(8)),
        "ids": L.data(name="ids", type=dt.integer_value_sequence(20)),
        "img": L.data(name="img", type=dt.dense_vector(3 * 8 * 8), height=8, width=8),
    }


# name -> (builder, the unported type its network fails on, or None)
PROGRAMS = {
    "maxid": (lambda L, i, pkg: L.maxid(i["x"]), "maxid"),
    "power": (lambda L, i, pkg: L.power(i["x"], i["w"]), "power"),
    "scale_shift": (lambda L, i, pkg: L.scale_shift(i["x"]), "scale_shift"),
    "prelu": (lambda L, i, pkg: L.prelu(i["x"]), "prelu"),
    "trans": (lambda L, i, pkg: L.trans(i["x"]), "trans"),
    "repeat": (lambda L, i, pkg: L.repeat(i["x"], 3), "repeat"),
    "clip": (lambda L, i, pkg: L.clip(i["x"], -0.5, 0.5), "clip"),
    "cos_sim": (lambda L, i, pkg: L.cos_sim(i["x"], i["y"]), "cos"),
    "interpolation": (lambda L, i, pkg: L.interpolation(input=[i["x"], i["y"]], weight=i["w"]),
                      "interpolation"),
    "slope_intercept": (lambda L, i, pkg: L.slope_intercept(i["x"], 2.0, 1.0), "slope_intercept"),
    "row_l2_norm": (lambda L, i, pkg: L.row_l2_norm(i["x"]), "row_l2_norm"),
    "sum_to_one_norm": (lambda L, i, pkg: L.sum_to_one_norm(i["x"]), "sum_to_one_norm"),
    "out_prod": (lambda L, i, pkg: L.out_prod(i["x"], i["y"]), "out_prod"),
    "multiplex": (lambda L, i, pkg: L.multiplex([i["lab"], i["x"], i["y"]]), "multiplex"),
    "linear_comb": (lambda L, i, pkg: L.linear_comb(i["w"], i["x"], size=8), "linear_comb"),
    "seq_reshape": (lambda L, i, pkg: L.seq_reshape(i["s"], 4), "seqreshape"),
    "seq_concat": (lambda L, i, pkg: L.seq_concat(i["s"], i["s"]), "seqconcat"),
    "img_cmrnorm": (lambda L, i, pkg: L.img_cmrnorm(i["img"], 3, num_channels=3), "norm"),
    "maxout": (lambda L, i, pkg: L.maxout(i["img"], 3, num_channels=3), "maxout"),
    "spp": (lambda L, i, pkg: L.spp(i["img"], 2, num_channels=3), "spp"),
    "bilinear_interp": (lambda L, i, pkg: L.bilinear_interp(i["img"], 4, 4, num_channels=3),
                        "bilinear_interp"),
    "img_pad": (lambda L, i, pkg: L.img_pad(i["img"], pad_h=(1, 1), num_channels=3), "pad"),
    "block_expand": (lambda L, i, pkg: L.block_expand(i["img"], 2, 2, num_channels=3),
                     "block_expand"),
    "nce": (lambda L, i, pkg: L.nce(i["x"], i["lab"], num_classes=8), "nce"),
    "hsigmoid": (lambda L, i, pkg: L.hsigmoid(i["x"], i["lab"], num_classes=8), "hsigmoid"),
    "ctc": (lambda L, i, pkg: L.ctc(L.fc(i["s"], size=21), i["ids"], size=21), "ctc"),
    "rank_cost": (lambda L, i, pkg: L.rank_cost(i["w"], i["w"], i["w"]), "rank_cost"),
    "huber": (lambda L, i, pkg: L.huber_regression_cost(i["x"], i["y"]), "huber_regression"),
    "smooth_l1": (lambda L, i, pkg: L.smooth_l1_cost(i["x"], i["y"]), "smooth_l1"),
    "sum_cost": (lambda L, i, pkg: L.sum_cost(i["x"]), "sum_cost"),
    "selfnorm": (lambda L, i, pkg: L.cross_entropy_with_selfnorm_cost(
        L.fc(i["x"], size=8, act=pkg.activation.Softmax()), i["lab"]),
        "cross_entropy_with_selfnorm"),
    "eos": (lambda L, i, pkg: L.eos(i["ids"], 1), "eos_id"),
    "kmax_seq_score": (lambda L, i, pkg: L.kmax_seq_score(L.fc(i["s"], size=1), 2),
                       "kmax_seq_score"),
    "row_conv": (lambda L, i, pkg: L.row_conv(i["s"], 3), "row_conv"),
    "conv_shift": (lambda L, i, pkg: L.conv_shift(i["x"], L.fc(i["x"], size=3)), "conv_shift"),
    "gated_unit": (lambda L, i, pkg: L.gated_unit(i["x"], 4), "dotmul"),
    "selective_fc": (lambda L, i, pkg: L.selective_fc(i["x"], None, 4), "selective_fc"),
    "data_norm": (lambda L, i, pkg: L.data_norm(i["x"]), "data_norm"),
    "context_projection": (lambda L, i, pkg: L.mixed(
        size=24, input=[L.context_projection(i["s"], 3)]), "context_projection"),
    "conv_projection": (lambda L, i, pkg: L.mixed(
        size=4 * 8 * 8, input=[L.conv_projection(i["img"], 3, 4, num_channels=3, padding=1)]),
        None),
    "square_error": (lambda L, i, pkg: L.square_error_cost(i["x"], i["y"]), None),
    "weighted_square_error": (lambda L, i, pkg: L.square_error_cost(i["x"], i["y"],
                                                                     weight=i["w"]), None),
    "dotmul_operator": (lambda L, i, pkg: L.mixed(
        size=8, input=[L.dotmul_operator(i["x"], i["y"])]), "dotmul"),
    "sequence_conv_pool": (lambda L, i, pkg: pkg.networks.sequence_conv_pool(
        L.embedding(i["ids"], size=8), context_len=3, hidden_size=6), "context_projection"),
    "img_conv_group": (lambda L, i, pkg: pkg.networks.img_conv_group(
        i["img"], conv_num_filter=[4, 4], pool_size=2, num_channels=3, conv_padding=1,
        conv_filter_size=3, pool_stride=2), None),
    "math": (lambda L, i, pkg: L.layer_math.exp(i["x"]) * 0.5 + L.layer_math.log(
        L.layer_math.sqrt(L.layer_math.square(i["y"]))) - 2 * i["x"] + L.layer_math.relu(
        L.layer_math.abs(i["x"])) * i["y"] + L.layer_math.sigmoid(L.layer_math.tanh(
            L.layer_math.reciprocal(1.0 - i["y"]))), "slope_intercept"),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_programs_serialize_identically(name):
    build, missing = PROGRAMS[name]
    jout, tout = build_both(lambda pkg: build(pkg.layer, _inputs(pkg), pkg))
    jt, tt = paddle_tpu.Topology([jout]), paddle_tpu_torch.Topology([tout])
    assert tt.serialize() == jt.serialize()
    if missing is None:
        TNet(tt)
    else:
        with pytest.raises(NotImplementedError, match=repr(missing)):
            TNet(tt)
