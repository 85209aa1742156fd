"""The port's recurrent cores (``paddle_tpu_torch/ops/rnn.py``: ``GruCore``
and ``AttGruCore``, autograd Functions with hand-written backwards) against
the JAX package's (``paddle_tpu/ops/rnn.py`` ``_gru_core`` and
``_attgru_core``, custom VJPs), in float64 on the CPU: the same numpy inputs
through ``gru_scan`` / ``attention_gru_scan`` of both packages, values and
every gradient.

- the GRU core: the cases of tests/test_rnn_cores.py::
  test_gru_core_matches_autodiff (ragged x reverse), and other gate and
  candidate activations (the written-out derivatives, and softmax, which
  takes its VJP by autograd);
- the fused attention-GRU core: the cases of
  tests/test_attention_gru_fused.py (ragged x reverse x early exit), the
  boot-state gradient with a masked tail (early exit bit-identical to the
  full loop), a finite-difference check (torch.autograd.gradcheck), and
  the score activations the matcher admits;
- early exit runs only the live steps (the counters say how many).

Tolerances are the JAX tests' (values 1e-10 relative, gradients 1e-8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import rnn as jrnn
from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.utils.flags import reset_flags, set_flag


@pytest.fixture(autouse=True)
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)
    reset_flags()


def _weights(n):
    """A fixed cosine weighting of an output of n elements (the JAX tests'
    loss shapes every element differently)."""
    return np.cos(np.arange(n)).astype(np.float64)


def _jax_grads(fn, args):
    return jax.value_and_grad(fn, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])


def _torch_grads(fn, args):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    v = fn(*ts)
    grads = torch.autograd.grad(v, ts)
    return v.item(), [g.numpy() for g in grads]


def _assert_close(tv, tg, jv, jg, names):
    np.testing.assert_allclose(tv, float(jv), rtol=1e-10)
    for a, b, name in zip(tg, jg, names):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-10, err_msg=name)


# ---------------------------------------------------------------------------
# GRU
# ---------------------------------------------------------------------------


def _gru_case(seed=1, b=3, t=6, h=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, 3 * h), rng.randn(h, 2 * h) * 0.3, rng.randn(h, h) * 0.3,
            rng.randn(3 * h) * 0.1, rng.randn(b, h) * 0.5)


def _gru_both(args, lengths, reverse, gate_act="sigmoid", act="tanh"):
    w = _weights(int(np.prod(args[0].shape[:2])) * args[2].shape[0])

    def jloss(gates, w_h, w_c, bias, h0):
        hs, hl = jrnn.gru_scan(gates, w_h, w_c, bias,
                               None if lengths is None else jnp.asarray(lengths),
                               gate_act=gate_act, act=act, reverse=reverse, h0=h0)
        return jnp.sum(hs.reshape(-1) * w) + jnp.sum(hl * 1.3)

    def tloss(gates, w_h, w_c, bias, h0):
        hs, hl = trnn.gru_scan(gates, w_h, w_c, bias,
                               None if lengths is None else torch.tensor(lengths),
                               gate_act=gate_act, act=act, reverse=reverse, h0=h0)
        return (hs.reshape(-1) * torch.from_numpy(w)).sum() + (hl * 1.3).sum()

    jv, jg = _jax_grads(jloss, args)
    tv, tg = _torch_grads(tloss, args)
    return tv, tg, jv, jg


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_gru_core_matches_jax(reverse, ragged):
    lengths = np.array([6, 3, 1], np.int32) if ragged else None
    _assert_close(*_gru_both(_gru_case(), lengths, reverse),
                  ("gates", "w_h", "w_c", "bias", "h0"))


@pytest.mark.parametrize("gate_act,act", [
    ("relu", "stanh"), ("sigmoid", "softrelu"), ("tanh", "identity"), ("sigmoid", "softmax")])
def test_gru_core_other_activations_match_jax(gate_act, act):
    lengths = np.array([5, 2, 6], np.int32)
    _assert_close(*_gru_both(_gru_case(seed=4), lengths, False, gate_act, act),
                  ("gates", "w_h", "w_c", "bias", "h0"))


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_early_exit_runs_only_live_steps(reverse):
    """Every row shorter than the padded T: the loop runs max(len) steps,
    and values and gradients equal the full loop's bit for bit."""
    args = _gru_case(seed=2, t=8)
    lengths = np.array([3, 5, 1], np.int32)
    out = {}
    for early in (True, False):
        set_flag("scan_early_exit", early)
        trnn.counters.clear()
        tv, tg, _, _ = _gru_both(args, lengths, reverse)
        out[early] = (tv, tg, dict(trnn.counters))
    assert out[True][2]["gru_steps"] == 5 and out[True][2]["gru_skipped"] == 3
    assert out[False][2]["gru_steps"] == 8
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-14)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# fused attention-GRU
# ---------------------------------------------------------------------------

B, T, S, H, P, E = 3, 5, 4, 6, 7, 8
ATT_KEYS = ("gates", "enc", "enc_proj", "w1", "v", "w_ctx", "w_c")


def _att_case(seed=0, ragged=True):
    rng = np.random.RandomState(seed)
    args = (rng.randn(B, T, 3 * H), rng.randn(B, S, E), rng.randn(B, S, P),
            rng.randn(H, P + 2 * H) * 0.3, rng.randn(P) * 0.5, rng.randn(E, 3 * H) * 0.3,
            rng.randn(H, H) * 0.3)
    enc_lengths = rng.randint(1, S + 1, B).astype(np.int32) if ragged else None
    lengths = rng.randint(2, T + 1, B).astype(np.int32) if ragged else None
    h0 = rng.randn(B, H) * 0.5
    return args, enc_lengths, lengths, h0


def _att_both(args, enc_lengths, lengths, h0, reverse, early_exit, att_act="tanh"):
    w = _weights(B * T * H)

    def jloss(*a):
        hs, hl = jrnn.attention_gru_scan(
            *a, enc_lengths=None if enc_lengths is None else jnp.asarray(enc_lengths),
            lengths=None if lengths is None else jnp.asarray(lengths), h0=jnp.asarray(h0),
            reverse=reverse, early_exit=early_exit, att_act=att_act)
        return jnp.sum(hs.reshape(-1) * w) + jnp.sum(hl)

    def tloss(*a):
        hs, hl = trnn.attention_gru_scan(
            *a, enc_lengths=None if enc_lengths is None else torch.tensor(enc_lengths),
            lengths=None if lengths is None else torch.tensor(lengths), h0=torch.tensor(h0),
            reverse=reverse, early_exit=early_exit, att_act=att_act)
        return (hs.reshape(-1) * torch.from_numpy(w)).sum() + hl.sum()

    jv, jg = _jax_grads(jloss, args)
    tv, tg = _torch_grads(tloss, args)
    return tv, tg, jv, jg


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("early_exit", [False, True])
def test_fused_core_matches_jax(ragged, reverse, early_exit):
    args, el, ll, h0 = _att_case(0, ragged)
    _assert_close(*_att_both(args, el, ll, h0, reverse, early_exit), ATT_KEYS)


@pytest.mark.parametrize("att_act", ["identity", "sigmoid", "relu", "stanh", "softrelu"])
def test_fused_core_score_activations_match_jax(att_act):
    args, el, ll, h0 = _att_case(6)
    _assert_close(*_att_both(args, el, ll, h0, False, True, att_act), ATT_KEYS)


def test_fused_core_h0_grad_and_masked_tail():
    """The boot state's gradient flows; with every row dead past step 2 the
    early exit runs 2 steps and equals the full loop (and the JAX core)."""
    args, el, ll, h0 = _att_case(3)
    short = np.minimum(ll, 2)
    w = _weights(B * T * H)
    res = {}
    for early in (False, True):
        trnn.counters.clear()

        def tloss(h0_, a=args, early=early):
            hs, hl = trnn.attention_gru_scan(
                *[torch.from_numpy(x) for x in a], enc_lengths=torch.tensor(el),
                lengths=torch.tensor(short), h0=h0_, early_exit=early)
            return (hs ** 2).sum() + (hl ** 2).sum()

        h = torch.tensor(h0, requires_grad=True)
        v = tloss(h)
        (g,) = torch.autograd.grad(v, h)
        res[early] = (v.item(), g.numpy(), dict(trnn.counters))
    assert res[True][2]["attgru_steps"] == 2 and res[True][2]["attgru_skipped"] == T - 2
    assert np.abs(res[False][1]).max() > 0
    np.testing.assert_allclose(res[True][0], res[False][0], rtol=1e-12)
    np.testing.assert_allclose(res[True][1], res[False][1], rtol=1e-10, atol=1e-12)

    def jloss(h0_):
        hs, hl = jrnn.attention_gru_scan(
            *[jnp.asarray(x) for x in args], enc_lengths=jnp.asarray(el),
            lengths=jnp.asarray(short), h0=h0_, early_exit=True)
        return jnp.sum(hs ** 2) + jnp.sum(hl ** 2)

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(h0))
    np.testing.assert_allclose(res[True][0], float(jv), rtol=1e-10)
    np.testing.assert_allclose(res[True][1], np.asarray(jg), rtol=1e-8, atol=1e-10)
    del w


def test_fused_core_finite_diff():
    args, el, ll, h0 = _att_case(1)
    ts = [torch.tensor(a, requires_grad=True) for a in args]

    def f(*a):
        hs, _ = trnn.attention_gru_scan(*a, enc_lengths=torch.tensor(el),
                                        lengths=torch.tensor(ll), h0=torch.tensor(h0))
        return (hs ** 2).mean()

    assert torch.autograd.gradcheck(f, ts, eps=1e-6, atol=1e-5, rtol=1e-5)
