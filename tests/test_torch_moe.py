"""The mixture-of-experts layer in the port (``layers/moe.py``, dispatch by
index) against the JAX package's (one-hot dispatch einsums) on the CPU, in
f32, and ``transformer_cost(moe_experts=)`` through both.

Outputs and the aux output ``<name>@aux_loss`` within rtol 1e-5 / atol
1e-6; gradients (parameters and input) within rtol 1e-5 and atol 1e-6 of
each leaf's largest |g|: with ample capacity (and against a dense numpy
reference), with tokens dropped by capacity (``capacity_factor=0.26``),
with padded sequences, and under bf16 compute (rtol 2e-2: both packages
round the gate to bf16 before the combine).  The init stds read the fan-in.
A ``moe`` with ``shard_axis="model"`` builds and runs on one device; any
other sharded layer still raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu.core.compiler import CompiledNetwork as JNet
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from test_torch_parity import (
    assert_grads_close, build_both, carry, grads_both, outputs_both, to_port)

RTOL, ATOL = 1e-5, 1e-6


def _moe(pkg, d=4, e=3, hid=5, cf=1.25, seq=False, shard=None):
    L, dt = pkg.layer, pkg.data_type
    x = L.data("x", dt.dense_vector_sequence(d) if seq else dt.dense_vector(d))
    attr = pkg.attr.ExtraAttr(shard_axis=shard) if shard else None
    return L.moe_layer(x, expert_hidden=hid, num_experts=e, capacity_factor=cf,
                       layer_attr=attr, name="m")


def _dense_reference(x, p):
    """Top-1 MoE with no capacity drops: y_n = gate_n * FFN_e(n)(x_n)."""
    logits = x @ p["router"]
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    idx = np.argmax(gates, -1)
    out = np.zeros((x.shape[0], p["w2"].shape[-1]), np.float32)
    for n in range(x.shape[0]):
        e = int(idx[n])
        h = np.maximum(x[n] @ p["w1"][e] + p["b1"][e], 0)
        out[n] = gates[n, e] * (h @ p["w2"][e] + p["b2"][e])
    return out


def _both(jout, tout, jbatch, seed, names=("m", "m@aux_loss")):
    return outputs_both(jout, tout, jbatch, seed=seed, names=list(names), input_grads=("x",),
                        jit=True)


def _assert_close(jo, to, jg, tg):
    for n in jo:
        np.testing.assert_allclose(to[n].data, jo[n].data, rtol=RTOL, atol=ATOL, err_msg=n)
    assert_grads_close(jg, tg, rtol=RTOL, atol=ATOL)


def test_ample_capacity_matches_jax_and_the_dense_reference():
    jout, tout = build_both(lambda pkg: _moe(pkg, cf=6.0))  # nothing can drop
    x = np.random.RandomState(0).randn(12, 4).astype(np.float32)
    jo, to, jg, tg = _both(jout, tout, {"x": JSeq(jnp.asarray(x))}, seed=0)
    _assert_close(jo, to, jg, tg)
    p = {k: np.asarray(v) for k, v in paddle_tpu.parameters.create(jout, seed=0).params["m"].items()}
    np.testing.assert_allclose(to["m"].data, _dense_reference(x, p), rtol=1e-4, atol=1e-5)
    aux = to["m@aux_loss"].data
    assert aux.shape == (12, 1) and aux.min() >= 1.0 - 1e-5
    np.testing.assert_allclose(aux, aux[0, 0], rtol=1e-6)


def test_capacity_drops_tokens_and_masks_padding():
    """capacity 0.26 * 8 / 2 -> one slot per expert: at most two tokens
    keep an output; padded positions are exactly zero."""
    jout, tout = build_both(lambda pkg: _moe(pkg, e=2, hid=3, cf=0.26, seq=True))
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 4).astype(np.float32)
    lens = np.asarray([4, 2], np.int32)
    jo, to, jg, tg = _both(jout, tout, {"x": JSeq(jnp.asarray(x), jnp.asarray(lens))}, seed=1)
    _assert_close(jo, to, jg, tg)
    got = to["m"].data
    assert 0 < np.sum(np.any(got != 0, axis=-1)) <= 2
    np.testing.assert_array_equal(got[1, 2:], 0.0)


def test_padded_sequences_take_no_capacity():
    """Padding of a ragged batch routes nowhere: the aux and every valid
    token's output equal the JAX package's at a capacity the valid tokens
    alone fill."""
    jout, tout = build_both(lambda pkg: _moe(pkg, d=6, e=4, hid=8, cf=1.0, seq=True))
    rng = np.random.RandomState(2)
    x = rng.randn(3, 7, 6).astype(np.float32)
    lens = np.asarray([7, 3, 1], np.int32)
    jo, to, jg, tg = _both(jout, tout, {"x": JSeq(jnp.asarray(x), jnp.asarray(lens))}, seed=2)
    _assert_close(jo, to, jg, tg)
    np.testing.assert_array_equal(to["m"].data[2, 1:], 0.0)


def test_bf16_compute_matches_jax():
    """Under bf16 compute both packages round the gate to bf16 before the
    combine; outputs within rtol 2e-2 of the JAX package's."""
    jout, tout = build_both(lambda pkg: _moe(pkg, d=8, e=4, hid=16, cf=1.5))
    x = np.random.RandomState(3).randn(16, 8).astype(np.float32)
    jparams = paddle_tpu.parameters.create(jout, seed=3)
    jnet = JNet(JTopo([jout]), compute_dtype=jnp.bfloat16)
    jo = jnet.apply(jparams.params, {"x": JSeq(jnp.asarray(x))}, train=False)[0]
    tnet = TNet(TTopo([tout]), compute_dtype=torch.bfloat16)
    to = tnet.apply(carry(jparams).params, to_port({"x": JSeq(x)}), train=False)[0]
    want = np.asarray(jo["m"].data.astype(jnp.float32))
    got = to["m"].data.float().numpy()
    assert to["m"].data.dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


def test_init_stds_read_the_fan_in():
    d, e, hid = 256, 4, 512
    _, tout = build_both(lambda pkg: _moe(pkg, d=d, e=e, hid=hid))
    p = TNet(TTopo([tout])).init_params(seed=0, device="cpu")["m"]
    assert p["w1"].shape == (e, d, hid) and p["w2"].shape == (e, hid, d)
    assert abs(float(p["w1"].std()) - d ** -0.5) < 0.2 * d ** -0.5
    assert abs(float(p["w2"].std()) - hid ** -0.5) < 0.2 * hid ** -0.5
    assert abs(float(p["router"].std()) - d ** -0.5) < 0.2 * d ** -0.5
    assert float(p["b1"].abs().max()) == 0.0 and float(p["b2"].abs().max()) == 0.0


def test_transformer_with_moe_encoder_matches_jax():
    """transformer_cost(moe_experts=2), 2 layers: the encoder FFNs are moe
    layers (the decoder's stay fc), and the cost and every gradient agree
    with the JAX package's."""
    def build(pkg):
        from importlib import import_module
        return import_module(pkg.__name__ + ".models.transformer").transformer_cost(
            30, 30, d_model=16, n_heads=2, n_layers=2, d_ff=24, moe_experts=2)[0]

    jcost, tcost = build_both(build)
    types = {c.type for c in TTopo([tcost]).layers.values()}
    names = set(TTopo([tcost]).layers)
    assert "moe" in types and {"enc0_moe", "enc1_moe", "dec0_ff1"} <= names
    assert "enc0_ff1" not in names
    jparams = paddle_tpu.parameters.create(jcost, seed=4)
    rng = np.random.RandomState(4)
    lens = np.asarray([6, 4, 2], np.int32)
    ids = lambda: rng.randint(2, 30, size=(3, 6)).astype(np.int32)  # noqa: E731
    batch = {"src_word": (ids(), lens), "trg_word": (ids(), lens), "trg_next": (ids(), lens)}
    jc, tc, jg, tg = grads_both(jcost, tcost, jparams, batch, train=False, jit=True)
    assert tc == pytest.approx(jc, rel=RTOL)
    assert_grads_close(jg, tg, rtol=RTOL, atol=ATOL)


def test_sharded_moe_runs_on_one_device_and_other_sharding_raises():
    """shard_axis="model" on a moe only places experts on a mesh: the port
    runs the layer unsharded with the unsharded layer's values.  Any other
    layer with a shard_axis still fails at build."""
    jout, tout = build_both(lambda pkg: _moe(pkg, shard="model"))
    _, plain = build_both(lambda pkg: _moe(pkg))
    x = np.random.RandomState(5).randn(10, 4).astype(np.float32)
    jparams = paddle_tpu.parameters.create(jout, seed=5)
    got = TNet(TTopo([tout])).apply(carry(jparams).params, to_port({"x": JSeq(x)}),
                                    train=False)[0]["m"].data
    want = TNet(TTopo([plain])).apply(carry(jparams).params, to_port({"x": JSeq(x)}),
                                      train=False)[0]["m"].data
    assert torch.equal(got, want)
    L = paddle_tpu_torch.layer
    fc = L.fc(L.data("y", paddle_tpu_torch.data_type.dense_vector(4)), size=4,
              layer_attr=paddle_tpu_torch.attr.ExtraAttr(shard_axis="model"))
    with pytest.raises(NotImplementedError, match="shard_axis='model'"):
        TNet(TTopo([fc]))
