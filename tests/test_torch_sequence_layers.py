"""The 13 sequence layer types of the nested-sequence slice in the port
against the JAX package on the CPU (f32): ``seqreshape``, ``seqconcat``,
``sampling_id``, ``eos_id``, ``context_projection``, ``row_conv``,
``conv_shift``, ``slice_time`` (``layers/sequence.py``), ``sub_seq``,
``kmax_seq_score``, ``agent``, ``scatter_agent`` and ``gather_agent``
(``layers/misc.py``).

The differentiable ones take the networks of ``tests/test_layer_grad_sweep.py``
(:263-313) on its random batches: outputs within atol 1e-5 and rtol 1e-5
(lengths equal), gradients of parameters and float inputs within 1e-4
relative L2.  ``context_projection`` also runs with ``context_start`` below
and above 0 and with a window wholly in the past, and inside
``networks.sequence_conv_pool``.  ``sub_seq`` and ``kmax_seq_score`` repeat
``tests/test_sampled_misc.py``'s cases (:198, :244), and ``kmax_seq_score``
breaks a tie toward the lower step, as ``lax.top_k`` does, with -1 past a
sequence's length.  ``sampling_id``: without a step seed it is the argmax;
with one, its frequencies over 20,000 draws lie within 0.02 of the row's
probabilities (the port's generator is not ``jax.random``'s, so the parity
is statistical)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from layer_grad_util import rand_batch_for
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu.core.topology import Topology as JTopo
from paddle_tpu_torch.core.batch import SeqTensor as TSeq
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.layers.base import registered_layer_types
from test_torch_parity import assert_outputs_close, build_both, outputs_both, rel_l2

GRAD_REL = 1e-4
SLICE_TYPES = {"seqreshape", "seqconcat", "sampling_id", "eos_id", "context_projection",
               "row_conv", "conv_shift", "slice_time", "sub_seq", "kmax_seq_score", "agent",
               "scatter_agent", "gather_agent"}


def _dense(pkg, dim=8, name="in0"):
    return pkg.layer.data(name, pkg.data_type.dense_vector(dim))


def _dense_seq(pkg, dim=8, name="seq0"):
    return pkg.layer.data(name, pkg.data_type.dense_vector_sequence(dim))


def _slice_time(pkg):
    """slice_time has no DSL face: its conf is built directly, as the sweep
    builds it."""
    x = _dense_seq(pkg, 4)
    conf = pkg.core.topology.LayerConf(name="st", type="slice_time", size=4, inputs=(x.name,),
                                       act="identity", bias=False, attrs={"offset": 1})
    return pkg.core.topology.LayerOutput(conf, [x])


def _context(start, clen=3):
    def build(pkg):
        L = pkg.layer
        return L.mixed(size=4 * clen, input=L.context_projection(
            _dense_seq(pkg, 4), context_len=clen, context_start=start))
    return build


# name -> (network function, float slots whose gradients are compared)
GRAD_CASES = {
    "seqreshape": (lambda pkg: pkg.layer.seq_reshape(_dense_seq(pkg, 4), reshape_size=8),
                   ("seq0",)),
    "seqconcat": (lambda pkg: pkg.layer.seq_concat(_dense_seq(pkg, 4, "a"),
                                                   _dense_seq(pkg, 4, "b")), ("a", "b")),
    "context_projection": (_context(-1), ("seq0",)),
    "context_projection_past": (_context(-2), ("seq0",)),
    "context_projection_ahead": (_context(1), ("seq0",)),
    "context_projection_all_past": (_context(-4, clen=2), ("seq0",)),
    "row_conv": (lambda pkg: pkg.layer.row_conv(_dense_seq(pkg, 4), context_len=3), ("seq0",)),
    "conv_shift": (lambda pkg: pkg.layer.conv_shift(_dense(pkg, 8, "a"), _dense(pkg, 3, "b")),
                   ("a", "b")),
    "slice_time": (_slice_time, ("seq0",)),
    "sub_seq": (lambda pkg: pkg.layer.sub_seq(
        _dense_seq(pkg, 3, "s"), pkg.layer.data("off", pkg.data_type.integer_value(2)),
        pkg.layer.data("sz", pkg.data_type.integer_value(2))), ("s",)),
    "agent": (lambda pkg: pkg.layer.agent(pkg.layer.fc(_dense_seq(pkg, 4), size=5)), ()),
    "scatter_agent": (lambda pkg: pkg.layer.scatter_agent(
        pkg.layer.fc(_dense_seq(pkg, 4), size=5),
        pkg.layer.data("ids", pkg.data_type.integer_value(4))), ("seq0",)),
    "gather_agent": (lambda pkg: pkg.layer.gather_agent(
        [_dense_seq(pkg, 4, "a"), _dense_seq(pkg, 4, "b"), _dense_seq(pkg, 4, "c")]),
        ("a", "b", "c")),
    "sequence_conv_pool": (lambda pkg: pkg.networks.sequence_conv_pool(
        pkg.layer.embedding(pkg.layer.data("ids", pkg.data_type.integer_value_sequence(20)),
                            size=8), context_len=3, hidden_size=6), ()),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_layer_matches_jax(case):
    build, slots = GRAD_CASES[case]
    jout, tout = build_both(build)
    assert TTopo([tout]).serialize() == JTopo([jout]).serialize()
    jbatch = rand_batch_for(JTopo([jout]), batch_size=4, max_len=6, seed=3)
    jo, to, jg, tg = outputs_both(jout, tout, jbatch, seed=1, input_grads=slots)
    assert_outputs_close(jo, to)
    err = rel_l2(tg, jg)
    assert err <= GRAD_REL, err


def test_context_projection_windows_read_zeros_outside():
    """context_start -1, length 3 over [1, 2, 3 | pad]: the windows
    (0, 1, 2), (1, 2, 3), (2, 3, 0) and zero past the length."""
    out = _context(-1)(paddle_tpu_torch).parents[0]
    x = torch.tensor([[[1.0], [2.0], [3.0], [9.0]]])
    batch = {"seq0": TSeq(x.expand(1, 4, 4).contiguous(), torch.tensor([3], dtype=torch.int32))}
    got = TNet(TTopo([out])).apply({}, batch, train=False)[0][out.name].data[0, :, ::4]
    np.testing.assert_array_equal(got.numpy(), [[0, 1, 2], [1, 2, 3], [2, 3, 0], [3, 0, 0]])


@pytest.mark.parametrize("t", [1, 5])
def test_eos_id_matches_jax(t):
    """eos_id over an id sequence (T = 1 drops the time axis, as the JAX
    package's squeeze does)."""
    def build(pkg):
        return pkg.layer.eos(pkg.layer.data("ids", pkg.data_type.integer_value_sequence(6)), 2)

    jout, tout = build_both(build)
    ids = np.random.RandomState(0).randint(0, 6, size=(3, t)).astype(np.int32)
    ids[0, 0] = ids[2, -1] = 2
    jbatch = {"ids": JSeq(jnp.asarray(ids), jnp.asarray(np.minimum([5, 3, 1], t), jnp.int32))}
    jo, to, _, _ = outputs_both(jout, tout, jbatch, grads=False)
    assert_outputs_close(jo, to, atol=0, rtol=0)
    assert to[jout.name].data.dtype == np.float32 and to[jout.name].data.sum() > 0


def _run(out, batch):
    return TNet(TTopo([out])).apply({}, batch, train=False)[0][out.name]


def test_sub_seq_takes_the_slice():
    """tests/test_sampled_misc.py:198: offset 2, size 3 of a 6-step sequence."""
    L, dt = paddle_tpu_torch.layer, paddle_tpu_torch.data_type
    out = L.sub_seq(L.data("s", dt.dense_vector_sequence(2)), L.data("off", dt.integer_value(10)),
                    L.data("sz", dt.integer_value(10)))
    data = np.arange(12, dtype=np.float32).reshape(1, 6, 2)
    got = _run(out, {"s": TSeq(torch.from_numpy(data), torch.tensor([6], dtype=torch.int32)),
                     "off": TSeq(torch.tensor([2], dtype=torch.int32)),
                     "sz": TSeq(torch.tensor([3], dtype=torch.int32))})
    assert int(got.lengths[0]) == 3
    np.testing.assert_allclose(got.data.numpy()[0, :3], data[0, 2:5])


def _kmax(pkg, k):
    return pkg.layer.kmax_seq_score(pkg.layer.data("s", pkg.data_type.dense_vector_sequence(1)),
                                    beam_size=k)


@pytest.mark.parametrize("scores,length,k,want", [
    ([0.1, 0.9, 0.5, 0.3], 3, 2, [1, 2]),  # tests/test_sampled_misc.py:244
    ([0.5, 0.9, 0.5, 0.5], 4, 3, [1, 0, 2]),  # a three-way tie: the lower step first
    ([0.7, 0.2, 0.9, 0.9], 2, 3, [0, 1, -1]),  # past the length: -1
    ([-np.inf, 0.3, 0.3, 0.8], 4, 4, [3, 1, 2, -1]),  # a -inf score reads as no step
])
def test_kmax_seq_score_matches_jax(scores, length, k, want):
    jout, tout = build_both(lambda pkg: _kmax(pkg, k))
    data = np.asarray(scores, np.float32).reshape(1, 4, 1)
    jbatch = {"s": JSeq(jnp.asarray(data), jnp.asarray([length], jnp.int32))}
    jo, to, _, _ = outputs_both(jout, tout, jbatch, grads=False)
    assert_outputs_close(jo, to, atol=0, rtol=0)
    np.testing.assert_array_equal(to[jout.name].data[0], want)


def _sampler():
    L, dt = paddle_tpu_torch.layer, paddle_tpu_torch.data_type
    return L.sampling_id(L.data("p", dt.dense_vector(4)))


def test_sampling_id_without_a_seed_is_the_argmax():
    out = _sampler()
    probs = torch.softmax(torch.randn(64, 4, generator=torch.Generator().manual_seed(0)), -1)
    for train in (False, True):
        got = TNet(TTopo([out])).apply({}, {"p": TSeq(probs)}, train=train, rng=None)[0]
        assert torch.equal(got[out.name].data, probs.argmax(-1).to(torch.int32))


def test_sampling_id_draws_the_rows_distribution():
    """20,000 rows of one distribution, one step seed: each id's frequency
    within 0.02 of its probability; another seed draws other ids."""
    out = _sampler()
    p = torch.tensor([[0.1, 0.2, 0.3, 0.4]]).expand(20000, 4).contiguous()
    net = TNet(TTopo([out]))
    draws = [net.apply({}, {"p": TSeq(p)}, train=True, rng=seed)[0][out.name].data
             for seed in (5, 6)]
    freq = torch.bincount(draws[0].long(), minlength=4).double() / 20000
    assert torch.allclose(freq, p[0].double(), atol=0.02), freq
    assert not torch.equal(draws[0], draws[1])
    again = net.apply({}, {"p": TSeq(p)}, train=True, rng=5)[0][out.name].data
    assert torch.equal(again, draws[0])


def test_the_slice_registers_the_thirteen_types():
    assert SLICE_TYPES <= set(registered_layer_types())
    assert SLICE_TYPES <= set(paddle_tpu.layers.base.registered_layer_types())
