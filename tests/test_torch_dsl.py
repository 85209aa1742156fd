"""The port's whole DSL against the JAX package's:

- every public callable of ``paddle_tpu.layers`` exists in
  ``paddle_tpu_torch.layers`` (198 of 198);
- DSL programs over layer types ported late and the ``layer_math``
  operator programs build Topologies that serialize byte-identically, and
  compile;
- the port registers every one of the JAX package's 95 layer types;
- the programs over the image types, the conv operator, CTC, the detection
  types, moe and mdlstmemory run their forward in the port;
- the v1 names of the costs, the sampled outputs, the elementwise types,
  the image types and CTC build the JAX package's Topology and compile in
  the port."""

import numpy as np
import pytest
import torch

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
    assert len(jbase.registered_layer_types()) == 95
    assert _UNPORTED == []  # 95 of 95: ROADMAP Queue 1 item 3 is done


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
        "gt": L.data(name="gt", type=dt.dense_vector_sequence(6)),
    }


def _ssd_head(L, i, pkg):
    """A feature map of the image (4x4), its loc and conf heads (4 priors
    per cell, 3 classes) and its priorbox."""
    feat = L.img_conv(i["img"], 3, 4, stride=2, padding=1)
    loc = L.img_conv(feat, 3, 4 * 4, padding=1, act=pkg.activation.Identity())
    conf = L.img_conv(feat, 3, 4 * 3, padding=1, act=pkg.activation.Identity())
    pb = L.priorbox(feat, i["img"], aspect_ratio=[2.0], variance=[0.1, 0.1, 0.2, 0.2],
                    min_size=[2.0], max_size=[4.0])
    return loc, conf, pb


# name -> (builder, the unported type its network fails on, or None)
PROGRAMS = {
    "maxid": (lambda L, i, pkg: L.maxid(i["x"]), None),
    "power": (lambda L, i, pkg: L.power(i["x"], i["w"]), None),
    "scale_shift": (lambda L, i, pkg: L.scale_shift(i["x"]), None),
    "prelu": (lambda L, i, pkg: L.prelu(i["x"]), None),
    "trans": (lambda L, i, pkg: L.trans(i["x"]), None),
    "repeat": (lambda L, i, pkg: L.repeat(i["x"], 3), None),
    "clip": (lambda L, i, pkg: L.clip(i["x"], -0.5, 0.5), None),
    "cos_sim": (lambda L, i, pkg: L.cos_sim(i["x"], i["y"]), None),
    "interpolation": (lambda L, i, pkg: L.interpolation(input=[i["x"], i["y"]], weight=i["w"]),
                      None),
    "slope_intercept": (lambda L, i, pkg: L.slope_intercept(i["x"], 2.0, 1.0), None),
    "row_l2_norm": (lambda L, i, pkg: L.row_l2_norm(i["x"]), None),
    "sum_to_one_norm": (lambda L, i, pkg: L.sum_to_one_norm(i["x"]), None),
    "out_prod": (lambda L, i, pkg: L.out_prod(i["x"], i["y"]), None),
    "multiplex": (lambda L, i, pkg: L.multiplex([i["lab"], i["x"], i["y"]]), None),
    "linear_comb": (lambda L, i, pkg: L.linear_comb(i["w"], i["x"], size=8), None),
    "seq_reshape": (lambda L, i, pkg: L.seq_reshape(i["s"], 4), None),
    "seq_concat": (lambda L, i, pkg: L.seq_concat(i["s"], i["s"]), None),
    "img_cmrnorm": (lambda L, i, pkg: L.img_cmrnorm(i["img"], 3, num_channels=3), None),
    "maxout": (lambda L, i, pkg: L.maxout(i["img"], 3, num_channels=3), None),
    "spp": (lambda L, i, pkg: L.spp(i["img"], 2, num_channels=3), None),
    "bilinear_interp": (lambda L, i, pkg: L.bilinear_interp(i["img"], 4, 4, num_channels=3),
                        None),
    "img_pad": (lambda L, i, pkg: L.img_pad(i["img"], pad_h=(1, 1), num_channels=3), None),
    "block_expand": (lambda L, i, pkg: L.block_expand(i["img"], 2, 2, num_channels=3),
                     None),
    "img_conv_trans": (lambda L, i, pkg: L.img_conv(i["img"], 4, 5, stride=2, padding=1,
                                                    trans=True), None),
    "crop": (lambda L, i, pkg: L.crop(i["img"], offset=[1, 1], axis=2, shape=[5, 6]), None),
    "featmap_expand": (lambda L, i, pkg: L.featmap_expand(i["x"], 3), None),
    "conv_operator": (lambda L, i, pkg: L.mixed(size=2 * 8 * 8, input=[L.conv_operator(
        i["img"], L.fc(i["x"], size=2 * 3 * 3 * 3), 3, 2, num_channels=3, padding=1)]), None),
    "warp_ctc": (lambda L, i, pkg: L.warp_ctc(L.fc(i["s"], size=21), i["ids"], size=21), None),
    "conv_projection_trans": (lambda L, i, pkg: L.mixed(
        size=4 * 16 * 16, bias_attr=True, input=[L.conv_projection(
            i["img"], 4, 4, num_channels=3, stride=2, padding=1, trans=True)]), None),
    "nce": (lambda L, i, pkg: L.nce(i["x"], i["lab"], num_classes=8), None),
    "hsigmoid": (lambda L, i, pkg: L.hsigmoid(i["x"], i["lab"], num_classes=8), None),
    "ctc": (lambda L, i, pkg: L.ctc(L.fc(i["s"], size=21), i["ids"], size=21), None),
    "rank_cost": (lambda L, i, pkg: L.rank_cost(i["w"], i["w"], i["w"]), None),
    "huber": (lambda L, i, pkg: L.huber_regression_cost(i["x"], i["y"]), None),
    "smooth_l1": (lambda L, i, pkg: L.smooth_l1_cost(i["x"], i["y"]), None),
    "sum_cost": (lambda L, i, pkg: L.sum_cost(i["x"]), None),
    "selfnorm": (lambda L, i, pkg: L.cross_entropy_with_selfnorm_cost(
        L.fc(i["x"], size=8, act=pkg.activation.Softmax()), i["lab"]), None),
    "eos": (lambda L, i, pkg: L.eos(i["ids"], 1), None),
    "kmax_seq_score": (lambda L, i, pkg: L.kmax_seq_score(L.fc(i["s"], size=1), 2), None),
    "row_conv": (lambda L, i, pkg: L.row_conv(i["s"], 3), None),
    "conv_shift": (lambda L, i, pkg: L.conv_shift(i["x"], L.fc(i["x"], size=3)), None),
    "gated_unit": (lambda L, i, pkg: L.gated_unit(i["x"], 4), None),
    "selective_fc": (lambda L, i, pkg: L.selective_fc(i["x"], None, 4), None),
    "data_norm": (lambda L, i, pkg: L.data_norm(i["x"]), None),
    "context_projection": (lambda L, i, pkg: L.mixed(
        size=24, input=[L.context_projection(i["s"], 3)]), None),
    "conv_projection": (lambda L, i, pkg: L.mixed(
        size=4 * 8 * 8, input=[L.conv_projection(i["img"], 3, 4, num_channels=3, padding=1)]),
        None),
    "square_error": (lambda L, i, pkg: L.square_error_cost(i["x"], i["y"]), None),
    "weighted_square_error": (lambda L, i, pkg: L.square_error_cost(i["x"], i["y"],
                                                                     weight=i["w"]), None),
    "dotmul_operator": (lambda L, i, pkg: L.mixed(
        size=8, input=[L.dotmul_operator(i["x"], i["y"])]), None),
    "sequence_conv_pool": (lambda L, i, pkg: pkg.networks.sequence_conv_pool(
        L.embedding(i["ids"], size=8), context_len=3, hidden_size=6), None),
    "img_conv_group": (lambda L, i, pkg: pkg.networks.img_conv_group(
        i["img"], conv_num_filter=[4, 4], pool_size=2, num_channels=3, conv_padding=1,
        conv_filter_size=3, pool_stride=2), None),
    "priorbox": (lambda L, i, pkg: _ssd_head(L, i, pkg)[2], None),
    "multibox_loss": (lambda L, i, pkg: L.multibox_loss(
        *_ssd_head(L, i, pkg), label=i["gt"], num_classes=3), None),
    "detection_output": (lambda L, i, pkg: L.detection_output(
        *_ssd_head(L, i, pkg), num_classes=3, nms_top_k=4, keep_top_k=5), None),
    "moe": (lambda L, i, pkg: L.moe_layer(i["x"], expert_hidden=6, num_experts=2), None),
    "mdlstmemory": (lambda L, i, pkg: L.mdlstmemory(L.img_conv(i["img"], 1, 10), size=2,
                                                     reverse_w=True), None),
    "math": (lambda L, i, pkg: L.layer_math.exp(i["x"]) * 0.5 + L.layer_math.log(
        L.layer_math.sqrt(L.layer_math.square(i["y"]))) - 2 * i["x"] + L.layer_math.relu(
        L.layer_math.abs(i["x"])) * i["y"] + L.layer_math.sigmoid(L.layer_math.tanh(
            L.layer_math.reciprocal(1.0 - i["y"]))), None),
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


# the programs over the types ported with the image layers, the conv
# operator and CTC, and with the detection types, moe and mdlstmemory
RUN = ["img_cmrnorm", "maxout", "spp", "bilinear_interp", "img_pad", "block_expand", "ctc",
       "img_conv_trans", "crop", "featmap_expand", "conv_operator", "warp_ctc",
       "conv_projection_trans", "priorbox", "multibox_loss", "detection_output", "moe",
       "mdlstmemory"]


def _random_batch(topology, rng):
    """A port batch of 3 rows for every data slot of `_inputs` the topology
    reads: sequences of 4 steps (ids in [1, 20)), ground truth of 1-3 boxes
    per image (classes 1-2)."""
    shapes = {"x": (8,), "y": (8,), "w": (1,), "img": (3 * 8 * 8,)}
    out = {}
    for name in topology.data_layers():
        if name == "gt":
            lo = rng.uniform(0.0, 0.6, size=(3, 3, 2))
            gt = np.concatenate([rng.randint(1, 3, size=(3, 3, 1)), lo, lo + 0.3,
                                 np.zeros((3, 3, 1))], -1).astype(np.float32)
            out[name] = paddle_tpu_torch.core.batch.SeqTensor(
                torch.from_numpy(gt), torch.tensor([3, 1, 2], dtype=torch.int32))
        elif name in shapes:
            out[name] = paddle_tpu_torch.core.batch.SeqTensor(
                torch.from_numpy(rng.randn(3, *shapes[name]).astype(np.float32)))
        elif name == "s":
            out[name] = paddle_tpu_torch.core.batch.SeqTensor(
                torch.from_numpy(rng.randn(3, 4, 8).astype(np.float32)),
                torch.tensor([4, 3, 2], dtype=torch.int32))
        else:
            out[name] = paddle_tpu_torch.core.batch.SeqTensor(
                torch.from_numpy(rng.randint(1, 8 if name == "lab" else 20,
                                             size=(3, 4) if name == "ids" else (3,))
                                 .astype(np.int32)),
                torch.tensor([2, 1, 3], dtype=torch.int32) if name == "ids" else None)
    return out


@pytest.mark.parametrize("name", RUN)
def test_new_type_programs_run(name):
    """The port runs each program's forward on a random batch: finite values
    of the size the DSL gave the output."""
    build, _ = PROGRAMS[name]
    _, tout = build_both(lambda pkg: build(pkg.layer, _inputs(pkg), pkg))
    net = TNet(paddle_tpu_torch.Topology([tout]))
    params, state = net.init(seed=1, device="cpu")
    batch = _random_batch(net.topology, np.random.RandomState(2))
    y = net.apply(params, batch, state=state, train=False)[0][tout.name].data
    assert torch.isfinite(y).all()
    per_row = y[0].numel() if tout.conf.type != "block_expand" else y.shape[-1]
    assert per_row == tout.size


# the v1 names (``paddle.trainer_config_helpers``) of the types ported with
# the costs, the sampled outputs and the elementwise layers: name -> network
# over (v1 module, inputs, package)
V1_PROGRAMS = {
    "nce_layer": lambda v, i, pkg: v.nce_layer(input=i["x"], label=i["lab"], num_classes=8,
                                               neg_distribution=[1.0 / 8] * 8),
    "hsigmoid": lambda v, i, pkg: v.hsigmoid(input=i["x"], label=i["lab"], num_classes=8),
    "selective_fc_layer": lambda v, i, pkg: v.selective_fc_layer(input=i["x"], select=i["y"],
                                                                 size=8),
    "lambda_cost": lambda v, i, pkg: v.lambda_cost(input=v.fc_layer(i["s"], size=1),
                                                   score=v.fc_layer(i["s"], size=1),
                                                   NDCG_num=3),
    "rank_cost": lambda v, i, pkg: v.rank_cost(left=i["w"], right=i["w"], label=i["w"]),
    "cos_sim": lambda v, i, pkg: v.cos_sim(a=i["x"], b=i["y"], scale=2.0),
    "cos_sim_vec_mat": lambda v, i, pkg: v.cos_sim_vec_mat(i["w"], i["x"], size=8),
    "huber_cost": lambda v, i, pkg: v.huber_cost(input=v.fc_layer(i["x"], size=1),
                                                 label=i["lab"]),
    "huber_regression_cost": lambda v, i, pkg: v.huber_regression_cost(i["x"], i["y"]),
    "smooth_l1_cost": lambda v, i, pkg: v.smooth_l1_cost(i["x"], i["y"]),
    "sum_cost": lambda v, i, pkg: v.sum_cost(input=i["x"]),
    "cross_entropy_with_selfnorm_cost": lambda v, i, pkg: v.cross_entropy_with_selfnorm_cost(
        input=v.fc_layer(i["x"], size=8, act=v.SoftmaxActivation()), label=i["lab"]),
    "soft_binary_class_cross_entropy_cost": lambda v, i, pkg: (
        v.soft_binary_class_cross_entropy_cost(
            input=v.fc_layer(i["x"], size=8, act=v.SigmoidActivation()), label=i["y"])),
    "maxid_layer": lambda v, i, pkg: v.maxid_layer(input=i["x"]),
    "multiplex_layer": lambda v, i, pkg: v.multiplex_layer(input=[i["lab"], i["x"], i["y"]]),
    "trans_layer": lambda v, i, pkg: v.trans_layer(input=i["x"]),
    "repeat_layer": lambda v, i, pkg: v.repeat_layer(input=i["x"], num_repeats=2),
    "resize_layer": lambda v, i, pkg: v.resize_layer(input=i["x"], size=4),
    "clip_layer": lambda v, i, pkg: v.clip_layer(input=i["x"], min=-0.5, max=0.5),
    "out_prod_layer": lambda v, i, pkg: v.out_prod_layer(input1=i["x"], input2=i["y"]),
    "tensor_layer": lambda v, i, pkg: v.tensor_layer(a=i["x"], b=i["y"], size=3),
    "dotmul_operator": lambda v, i, pkg: v.mixed_layer(
        size=8, input=[v.dotmul_operator(a=i["x"], b=i["y"])]),
    "prelu_layer": lambda v, i, pkg: v.prelu_layer(input=i["x"], partial_sum=2),
    "power_layer": lambda v, i, pkg: v.power_layer(input=i["x"], weight=i["w"]),
    "data_norm": lambda v, i, pkg: v.data_norm(input=i["x"], strategy="min-max"),
    "rotate_layer": lambda v, i, pkg: v.rotate_layer(input=i["x"], height=2, width=4),
    "linear_comb_layer": lambda v, i, pkg: v.linear_comb_layer(weights=i["w"], vectors=i["x"],
                                                               size=8),
    "convex_comb_layer": lambda v, i, pkg: v.convex_comb_layer(weights=i["w"], vectors=i["x"],
                                                               size=8),
    "print_layer": lambda v, i, pkg: v.print_layer(input=i["x"]),
    "scale_shift_layer": lambda v, i, pkg: v.scale_shift_layer(input=i["x"]),
    "slope_intercept_layer": lambda v, i, pkg: v.slope_intercept_layer(input=i["x"], slope=2.0,
                                                                       intercept=1.0),
    "interpolation_layer": lambda v, i, pkg: v.interpolation_layer(input=[i["x"], i["y"]],
                                                                   weight=i["w"]),
    "sum_to_one_norm_layer": lambda v, i, pkg: v.sum_to_one_norm_layer(input=i["x"]),
    "row_l2_norm_layer": lambda v, i, pkg: v.row_l2_norm_layer(input=i["x"]),
    "img_cmrnorm_layer": lambda v, i, pkg: v.img_cmrnorm_layer(input=i["img"], size=5,
                                                               scale=0.0001, power=0.75),
    "img_conv_layer_trans": lambda v, i, pkg: v.img_conv_layer(
        input=i["img"], filter_size=4, num_filters=5, stride=2, padding=1, trans=True),
    "spp_layer": lambda v, i, pkg: v.spp_layer(input=i["img"], pyramid_height=2,
                                               pool_type=v.AvgPooling()),
    "maxout_layer": lambda v, i, pkg: v.maxout_layer(input=i["img"], groups=3),
    "pad_layer": lambda v, i, pkg: v.pad_layer(input=i["img"], pad_c=[1, 1], pad_h=[0, 2],
                                               pad_w=[1, 0]),
    "crop_layer": lambda v, i, pkg: v.crop_layer(input=i["img"], axis=2, offset=[1, 2],
                                                 shape=[4, 5]),
    "bilinear_interp_layer": lambda v, i, pkg: v.bilinear_interp_layer(
        input=i["img"], out_size_x=16, out_size_y=12),
    "featmap_expand_layer": lambda v, i, pkg: v.featmap_expand_layer(input=i["x"],
                                                                     num_filters=2),
    "block_expand_layer": lambda v, i, pkg: v.block_expand_layer(
        input=i["img"], block_x=2, block_y=8, stride_x=1, stride_y=1),
    "conv_projection_trans": lambda v, i, pkg: v.mixed_layer(
        size=2 * 16 * 16, input=[v.conv_projection(input=i["img"], filter_size=4,
                                                   num_filters=2, stride=2, padding=1,
                                                   trans=True)]),
    "conv_operator": lambda v, i, pkg: v.mixed_layer(size=2 * 6 * 6, input=[v.conv_operator(
        img=i["img"], filter=v.fc_layer(i["x"], size=2 * 3 * 3 * 3), filter_size=3,
        num_filters=2, num_channels=3)]),
    "ctc_layer": lambda v, i, pkg: v.ctc_layer(input=v.fc_layer(i["s"], size=21),
                                               label=i["ids"], size=21),
    "warp_ctc_layer": lambda v, i, pkg: v.warp_ctc_layer(input=v.fc_layer(i["s"], size=21),
                                                         label=i["ids"], size=21, blank=0,
                                                         norm_by_times=True),
}


@pytest.mark.parametrize("name", sorted(V1_PROGRAMS))
def test_v1_names_build_the_jax_topology(name):
    """Through the v1 config surface each name builds the JAX package's
    Topology byte for byte, and the port compiles it."""
    import importlib

    def build(pkg):
        v1 = importlib.import_module(pkg.__name__ + ".v1_compat.config_helpers")
        return V1_PROGRAMS[name](v1, _inputs(pkg), pkg)

    jout, tout = build_both(build)
    tt = paddle_tpu_torch.Topology([tout])
    assert tt.serialize() == paddle_tpu.Topology([jout]).serialize()
    TNet(tt)
