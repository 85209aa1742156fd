"""Layer impls of the port against the JAX package's: one small topology is
built in both packages, the JAX parameters are carried over with
``parameters.from_numpy``, the same numpy batch goes through both networks,
and the outputs must agree at f32 (atol 1e-5: the same arithmetic in another
summation order)."""

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
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.utils import flags as tflags

ATOL = 1e-5
B, D, V = 2, 16, 30


def _build(case, L, A, dt):
    """The case's topology in whichever package `L`/`A`/`dt` come from;
    returns (output layer, {slot: (kind, T, lengths)})."""
    if case == "embedding":
        ids = L.data("ids", dt.integer_value_sequence(V))
        return L.embedding(ids, size=D, name="out"), {"ids": ("ids", 24, [24, 9])}
    if case == "cross_dense" or case.startswith("cross"):
        tq, tk = (32, 64) if case == "cross_dense" else (128, 128)
        q = L.data("q", dt.dense_vector_sequence(D))
        kv = L.data("kv", dt.dense_vector_sequence(D))
        out = L.multi_head_attention(q, key_value=kv, n_heads=2, name="out")
        return out, {"q": ("x", tq, [tq, 5]), "kv": ("x", tk, [tk - 3, 17])}
    x = L.data("x", dt.dense_vector_sequence(D))
    t = 128 if case.startswith(("self", "causal")) else 24
    slots = {"x": ("x", t, [t, 11])}
    if case == "layer_norm":
        return L.layer_norm(x, name="out"), slots
    if case == "pos_encoding":
        return L.pos_encoding(x, emb_scale=3.0, name="out"), slots
    if case == "fc":
        return L.fc(x, size=12, act=A.Relu(), name="out"), slots
    if case == "fc_softmax":
        return L.fc(x, size=12, act=A.Softmax(), name="out"), slots
    if case == "addto":
        y = L.fc(x, size=D, act=A.Identity(), name="proj")
        return L.addto([x, y], act=A.Identity(), bias_attr=True, name="out"), slots
    causal = case.startswith("causal")
    return L.multi_head_attention(x, n_heads=2, causal=causal, name="out"), slots


def _batch(slots, seq_cls, as_array, seed=0):
    rng = np.random.RandomState(seed)
    batch = {}
    for name, (kind, t, lens) in slots.items():
        if kind == "ids":
            data = rng.randint(0, V, size=(B, t)).astype(np.int32)
        else:
            data = rng.randn(B, t, D).astype(np.float32)
        batch[name] = seq_cls(as_array(data), as_array(np.asarray(lens, np.int32)))
    return batch


@pytest.fixture
def flash_flag():
    yield lambda on: tflags.set_flag("use_flash_attention", on)
    tflags.reset_flags()


@pytest.mark.parametrize(
    "case,flash",
    [
        ("layer_norm", False),
        ("pos_encoding", False),
        ("fc", False),
        ("fc_softmax", False),
        ("embedding", False),
        ("addto", False),
        ("self", False),
        ("causal", False),
        ("cross", False),
        ("cross_dense", False),
        ("self", True),
        ("causal", True),
        ("cross", True),
    ],
)
def test_layer_matches_jax(case, flash, flash_flag, monkeypatch):
    jout, slots = _build(case, paddle_tpu.layer, paddle_tpu.activation, paddle_tpu.data_type)
    tout, _ = _build(
        case, paddle_tpu_torch.layer, paddle_tpu_torch.activation, paddle_tpu_torch.data_type
    )
    jnet = JNet(JTopo(jout), compute_dtype=jnp.float32)
    tnet = TNet(TTopo(tout), compute_dtype=torch.float32)
    jparams = jnet.init_params(jax.random.PRNGKey(3))
    tparams = paddle_tpu_torch.parameters.from_numpy(
        {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jparams.items()},
        device="cpu",
    ).params

    calls = []
    plain = tfa.flash_attention_reference
    monkeypatch.setattr(
        tfa, "flash_attention_reference", lambda *a, **k: calls.append(1) or plain(*a, **k)
    )
    flash_flag(flash)
    jouts, _ = jnet.apply(jparams, _batch(slots, JSeq, jnp.asarray), train=False)
    touts, _ = tnet.apply(tparams, _batch(slots, TSeq, torch.from_numpy), train=False)
    got, want = touts["out"].data.numpy(), np.asarray(jouts["out"].data)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the flash-routed cases really took the flash wrapper (its plain version
    # on the CPU); the JAX package runs dense here (its gate is TPU-only)
    assert len(calls) == (1 if flash else 0)
    assert tfa.flash_attention.launches == 0


def test_unported_layer_fails_at_compile_not_import():
    L = paddle_tpu_torch.layer
    x = L.data("x", paddle_tpu_torch.data_type.integer_value_sequence(V))
    lbl = L.data("y", paddle_tpu_torch.data_type.integer_value_sequence(V))
    # a cost type the DSL can describe but the port has no impl for (every
    # type of the JAX package has one now)
    cost = L._cost2("no_such_cost", L.fc(x, size=V), lbl)
    with pytest.raises(NotImplementedError, match="no_such_cost"):
        TNet(TTopo(cost))
