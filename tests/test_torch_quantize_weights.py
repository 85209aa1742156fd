"""The tensor halves of the port's block-scaled quantizer and the serving
engine's int8 weight bundles (``paddle_tpu_torch/ops/quantize.py``) on the
CPU against the JAX package's (``paddle_tpu/ops/quantize.py:165-381``):

- ``quantize_block_scaled`` gives JAX's int8 payloads and scales bit for
  bit, ties that round half to even included, its bf16 payloads too, and
  round-trips within half a scale; stochastic rounding draws from an
  explicit ``torch.Generator`` (the same seed, the same payload; each
  value rounds to one of its two neighbours; unbiased over many draws);
- ``quantize_weight_bundle`` on the serving engine's decode bundle (the
  tiny NMT over the JAX package's seeded parameters) gives JAX's ``q`` and
  ``s`` bit for bit, the same quantized keys and byte count, and the
  engine's ``weight_drift`` is within 1e-6 of the JAX engine's;
- tests/test_quantized_e2e.py's int8 serving case: the drift under the
  ``serving_int8_drift_budget`` flag, about 4x fewer weight bytes, more
  slots per GB, every request served by the int8 decode with the tokens of
  the one-shot path stepping on the dequantized bundle, and at least half
  with the f32 one-shot path's tokens;
- ``quantized_psum`` still raises (tests/test_torch_elastic.py holds it)."""

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core.topology import reset_auto_names
from paddle_tpu_torch.models.seq2seq import Seq2SeqGenerator, seq2seq_cost
from paddle_tpu_torch.ops import quantize as tq
from paddle_tpu_torch.serving import Request, ServingEngine
from test_torch_parity import carry


def _jq():
    from paddle_tpu.ops import quantize

    return quantize


def _ties():
    """Blocks whose max is 127, so the scale is 1 and the payload is the
    value rounded: .5 ties round to the even neighbour."""
    x = np.random.RandomState(1).randn(3, 64).astype(np.float32) * 40
    x[:, 0] = 127.0
    x[0, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    return x


@pytest.mark.parametrize("block", [64, 256])
def test_block_scaled_equals_jax_bit_for_bit(block):
    import jax.numpy as jnp

    for x in (_ties(), np.random.RandomState(2).randn(17, 13).astype(np.float32)):
        jp, js = _jq().quantize_block_scaled(jnp.asarray(x), block=block)
        tp, ts = tq.quantize_block_scaled(torch.from_numpy(x), block=block)
        assert tp.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        back = tq.dequantize_block_scaled(tp, ts, x.shape)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(_jq().dequantize_block_scaled(jp, js, x.shape)))
        assert float((back - torch.from_numpy(x)).abs().max()) <= float(ts.max()) / 2 + 1e-6
    tp, _ = tq.quantize_block_scaled(torch.from_numpy(_ties()), block=64)
    assert tp[0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]


def test_block_scaled_zero_guard_and_bf16_payload():
    import jax.numpy as jnp

    pz, sz = tq.quantize_block_scaled(torch.zeros(70))
    assert float(pz.abs().max()) == 0.0 and float(sz.max()) == 0.0
    x = np.random.RandomState(3).randn(5, 40).astype(np.float32)
    tp, ts = tq.quantize_block_scaled(torch.from_numpy(x), block=32,
                                      payload_dtype=torch.bfloat16)
    jp, js = _jq().quantize_block_scaled(jnp.asarray(x), block=32, payload_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(tp.float().numpy(), np.asarray(jp, np.float32))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_block_scaled_stochastic_rounding_takes_a_generator():
    x = torch.from_numpy(np.random.RandomState(4).randn(4096).astype(np.float32))
    with pytest.raises(ValueError, match="Generator"):
        tq.quantize_block_scaled(x, stochastic=True)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return tq.quantize_block_scaled(x, block=256, stochastic=True, generator=g)

    (p1, s1), (p2, _), (p3, _) = draw(0), draw(0), draw(1)
    assert torch.equal(p1, p2) and not torch.equal(p1, p3)
    v = x.reshape(-1, 256) / s1[:, None]
    assert bool(((p1.float() == v.floor()) | (p1.float() == v.ceil())).all())
    mean = torch.stack([draw(k)[0].float() for k in range(64)]).mean(0)
    assert float((mean - v).abs().mean()) < 0.05


V, E, H, MAXLEN = 96, 24, 32, 12


@pytest.fixture(scope="module")
def jparams():
    from paddle_tpu.core.topology import reset_auto_names as j_reset
    from paddle_tpu.models.seq2seq import seq2seq_cost as j_cost

    j_reset()
    cost, _ = j_cost(V, V, word_dim=E, hidden_dim=H)
    return paddle_tpu.parameters.create(cost, seed=7)


def _engines(jparams, int8):
    from paddle_tpu.models.seq2seq import Seq2SeqGenerator as JGen
    from paddle_tpu.serving import ServingEngine as JEngine

    kw = dict(word_dim=E, hidden_dim=H, bos_id=0, eos_id=1, max_length=MAXLEN)
    reset_auto_names()
    cost, _ = seq2seq_cost(V, V, word_dim=E, hidden_dim=H)
    gen = Seq2SeqGenerator(carry(jparams, cost), V, V, device="cpu", **kw)
    ekw = dict(max_slots=8, hbm_budget_mb=2, max_new_tokens=MAXLEN, int8_weights=int8)
    return (ServingEngine(gen, device="cpu", **ekw),
            JEngine(JGen(jparams, V, V, **kw), **ekw))


def test_weight_bundle_equals_jax_bit_for_bit(jparams):
    teng, jeng = _engines(jparams, True)
    assert set(teng._w_meta) == set(jeng._w_meta) == {"emb_w", "w_emb", "w1", "w_ctx", "w_c",
                                                       "head_w"}
    for k in teng._w_meta:
        np.testing.assert_array_equal(teng._w_arg[k]["q"].numpy(), np.asarray(jeng._w_arg[k]["q"]))
        np.testing.assert_array_equal(teng._w_arg[k]["s"].numpy(), np.asarray(jeng._w_arg[k]["s"]))
        assert teng._w_meta[k][0] == jeng._w_meta[k][0]
    assert teng.weight_bytes == jeng.weight_bytes
    assert abs(teng.weight_drift() - jeng.weight_drift()) <= 1e-6
    deq = tq.dequantize_weight_bundle(teng._w_arg, teng._w_meta)
    assert deq["v"] is teng._w_arg["v"] and deq["head_b"] is teng._w_arg["head_b"]


def test_weight_bundle_keys_and_bytes():
    rng = np.random.RandomState(7)
    w = {"head_w": torch.from_numpy(rng.randn(48, 40).astype(np.float32)),
         "w_ctx": torch.from_numpy(rng.randn(96, 144).astype(np.float32)),
         "v": torch.from_numpy(rng.randn(48).astype(np.float32)),
         "small": torch.from_numpy(rng.randn(8, 8).astype(np.float32)),
         "head_b": None}
    wq, meta = tq.quantize_weight_bundle(w, block=128)
    assert set(meta) == {"head_w", "w_ctx"}
    assert wq["v"] is w["v"] and wq["small"] is w["small"] and wq["head_b"] is None
    assert tq.weight_bundle_bytes(wq) < tq.weight_bundle_bytes(w) / 2.5


def test_serving_int8_drift_and_capacity(jparams):
    f32, _ = _engines(jparams, False)
    q8, _ = _engines(jparams, True)
    budget = float(paddle_tpu_torch.flags.get_flag("serving_int8_drift_budget"))
    assert 0.0 < q8.weight_drift() < budget and f32.weight_drift() == 0.0
    assert f32.weight_bytes > 2.5 * q8.weight_bytes
    assert q8.slots_per_gb(16) > f32.slots_per_gb(16)
    rng = np.random.RandomState(3)
    reqs = [Request(rng.randint(2, V, size=6).tolist()) for _ in range(6)]
    q8.admit(reqs)
    while q8.n_live:
        q8.step()
    assert all(r.tokens for r in reqs)
    # the int8 decode is the one-shot path stepping on the dequantized bundle
    deq = q8._weights()
    q8._gen.fused_decode_weights = lambda gp: deq
    try:
        assert all(r.tokens == q8.reference_decode(r.src_ids, MAXLEN) for r in reqs)
    finally:
        del q8._gen.fused_decode_weights
    same = sum(r.tokens == f32.reference_decode(r.src_ids, MAXLEN) for r in reqs)
    assert same >= len(reqs) // 2, same
    summ = q8.summary()
    assert summ["int8_weights"] is True and summ["weight_bytes"] == q8.weight_bytes


def test_quantized_psum_still_raises():
    with pytest.raises(NotImplementedError, match="item 6"):
        tq.quantized_psum({}, "data")
