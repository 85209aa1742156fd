"""The port's flash attention (paddle_tpu_torch/ops/flash_attention.py), forward
and backward, against the JAX package's Pallas kernels run in interpret mode:
the plain versions on the CPU here, the CUDA kernels against the plain
versions on a card (marked `cuda`, skipped without one).

The JAX package is imported inside the tests that compare with it, so that
on a machine with a card and no JAX the card tests still run:
``python -m pytest tests/test_torch_flash_attention.py -m cuda --noconftest``.
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as tfa

# the JAX test's own bar for the interpret kernel against dense attention
# (tests/test_pallas_attention.py:47): f32, different summation orders
ATOL = 5e-5
# gradients: both sides are the same f32 algorithm in another summation
# order (the JAX test's own bar for its backward against dense is 2e-3)
GRAD_ATOL = 1e-4


def _qkv(t=256, b=2, h=2, dh=64, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, dh).astype(np.float32) for _ in range(3)]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax():
    """(jax.numpy, the JAX package's pallas_attention module)."""
    import jax.numpy as jnp

    from paddle_tpu.ops import pallas_attention

    return jnp, pallas_attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_interpret(causal):
    jnp, jfa = _jax()
    q, k, v = _qkv()
    lens = np.asarray([256, 173], np.int32)
    want_o, res = jfa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        causal, 128, 128, True,
    )
    want_lse = np.asarray(res[-1])[..., 0]  # [B, H, T]
    got_o, got_lse = tfa.flash_attention(
        *_torch(q, k, v), torch.from_numpy(lens), causal, return_lse=True
    )
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=ATOL)
    # the public JAX entry point too
    want_pub = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths=jnp.asarray(lens),
        causal=causal, interpret=True,
    )
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_pub), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_padding_invariance(causal):
    q, k, v = _qkv()
    lens = torch.tensor([256, 173], dtype=torch.int32)
    base = tfa.flash_attention(*_torch(q, k, v), lens, causal)
    k2, v2 = k.copy(), v.copy()
    rng = np.random.RandomState(1)
    k2[1, 173:] = 100 * rng.randn(*k2[1, 173:].shape)
    v2[1, 173:] = 100 * rng.randn(*v2[1, 173:].shape)
    moved = tfa.flash_attention(*_torch(q, k2, v2), lens, causal)
    np.testing.assert_array_equal(base.numpy(), moved.numpy())


def test_length_zero_row_is_zero_like_pallas():
    jnp, jfa = _jax()
    q, k, v = _qkv(t=128)
    lens = np.asarray([128, 0], np.int32)
    o, lse = tfa.flash_attention(*_torch(q, k, v), torch.from_numpy(lens), return_lse=True)
    assert torch.count_nonzero(o[1]) == 0
    assert torch.isfinite(lse).all()
    want_o, res = jfa._flash_fwd(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(lens), False, 128, 128, True
    )
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[-1])[..., 0], rtol=1e-6)


def test_no_lengths_means_all_keys():
    q, k, v = _qkv(t=128, b=1)
    full = tfa.flash_attention(*_torch(q, k, v))
    same = tfa.flash_attention(*_torch(q, k, v), torch.tensor([128], dtype=torch.int32))
    np.testing.assert_array_equal(full.numpy(), same.numpy())
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    dense = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(full.numpy(), dense, atol=ATOL)


@pytest.mark.parametrize(
    "t,dh", [(128, 64), (256, 8), (1024, 64), (64, 64), (200, 64), (384, 64), (128, 12)]
)
def test_supported_matches_jax(t, dh):
    _, jfa = _jax()
    assert tfa.supported(t, dh) == jfa.supported(t, dh)


def test_cpu_call_does_not_count_launches():
    q, k, v = _qkv(t=64, b=1)
    before = tfa.flash_attention.launches
    tfa.flash_attention(*_torch(q, k, v), causal=True)
    assert tfa.flash_attention.launches == before == 0


def test_wrapper_rejects_mismatched_operands():
    q, k, v = _qkv(t=64, b=1)
    with pytest.raises(ValueError):
        tfa.flash_attention(*_torch(q, k[:, :32], v))
    with pytest.raises(TypeError):
        tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k).double(), torch.from_numpy(v))
    with pytest.raises(ValueError):
        tfa.flash_attention(*_torch(q, k, v), torch.tensor([64, 64], dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_kernel_matches_plain(cuda, dtype, atol, causal):
    """Ragged T, a dh that is not a power of two, a length-0 row, and q/k/v as
    strided column slices of one fused projection (as the layer passes them)."""
    b, t, h, dh = 3, 200, 4, 40
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((b, t, 3 * h * dh), generator=g, device=cuda).to(dtype)
    q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
    lens = torch.tensor([200, 77, 0], dtype=torch.int32, device=cuda)
    before = tfa.flash_attention.launches
    o, lse = tfa.flash_attention(q, k, v, lens, causal, return_lse=True)
    assert tfa.flash_attention.launches == before + 1
    ro, rlse = tfa.flash_attention_reference(q, k, v, lens, causal, return_lse=True)
    torch.cuda.synchronize()
    assert (o.float() - ro.float()).abs().max().item() <= atol
    assert (lse - rlse).abs().max().item() <= atol
    assert torch.count_nonzero(o[2]) == 0


# ---------------------------------------------------------------------------
# bf16: the plain versions against the interpret kernels in the working type
# ---------------------------------------------------------------------------

# Both sides round p (and, backward, ds) to bf16 before each product and the
# result once on store; they differ in f32 summation order and exp's last
# bit.  That moves a rounded result by one bf16 step (2^-7 |x| bounds a step
# at x: it is 2^(e-7) for |x| in [2^e, 2^(e+1))), and, where it flips the
# rounding of one p or ds, moves a whole row by one bf16 step of that
# operand times its partner: a step at the tensor's scale, 2^-8 max|x|.
BF16_STEP = 2.0 ** -7


def _bf16(*arrays):
    """numpy f32 arrays -> (the same values as JAX bf16, as torch bf16)."""
    import jax.numpy as jnp

    return (
        [jnp.asarray(a, jnp.bfloat16) for a in arrays],
        [torch.from_numpy(a).to(torch.bfloat16) for a in arrays],
    )


def _assert_one_bf16_step(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bar = BF16_STEP * np.abs(want) + BF16_STEP / 2 * np.abs(want).max()
    excess = np.abs(got - want) - bar
    assert excess.max() <= 0, f"{name}: {excess.max()} past one bf16 step"


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_plain_forward_matches_pallas_interpret(causal):
    """Ragged length, a length-0 row.  The JAX kernel walks 64-key tiles
    (block_k=64) like the port, so the online softmax rescales at the same
    keys and p rounds from the same values."""
    import jax.numpy as jnp

    _, jfa = _jax()
    (jq, jk, jv), (tq, tk, tv) = _bf16(*_qkv(b=3, seed=2))
    lens = np.asarray([256, 173, 0], np.int32)
    want_o, res = jfa._flash_fwd(jq, jk, jv, jnp.asarray(lens), causal, 128, 64, True)
    got_o, got_lse = tfa.flash_attention(tq, tk, tv, torch.from_numpy(lens), causal, return_lse=True)
    assert got_o.dtype == torch.bfloat16
    _assert_one_bf16_step(got_o.float().numpy(), want_o.astype(jnp.float32), "O")
    # lse is f32 on both sides: the f32 bar of the f32 tests
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(res[-1])[..., 0], atol=ATOL)
    assert torch.count_nonzero(got_o[2]) == 0


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_plain_backward_matches_pallas_interpret(causal):
    """dq, dk, dv of sum(o * w) (a fixed f32 cotangent, so both sides get
    the same bf16 dO) through both differentiable entry points."""
    import jax
    import jax.numpy as jnp

    _, jfa = _jax()
    q, k, v = _qkv(b=3, seed=3)
    w = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    lens = np.asarray([256, 173, 0], np.int32)
    jqkv, tqkv = _bf16(q, k, v)

    def loss(q, k, v):
        o = jfa.flash_attention_diff(q, k, v, jnp.asarray(lens), causal, 128, 64, True)
        return jnp.sum(o.astype(jnp.float32) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*jqkv)
    tqkv = [x.requires_grad_(True) for x in tqkv]
    o = tfa.flash_attention_diff(*tqkv, torch.from_numpy(lens), causal)
    (o.float() * torch.from_numpy(w)).sum().backward()
    for name, x, wg in zip("qkv", tqkv, want):
        assert x.grad.dtype == torch.bfloat16
        _assert_one_bf16_step(x.grad.float().numpy(), wg.astype(jnp.float32), f"d{name}")
        assert torch.count_nonzero(x.grad[2]) == 0


def test_bf16_rounding_is_a_noop_for_f32():
    """The operand rounding of the plain versions changes nothing in f32."""
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tfa._operand(x, torch.float32), x)
    assert torch.equal(tfa._operand(x.double(), torch.float64), x.double())
    r = tfa._operand(x, torch.bfloat16)
    assert r.dtype == torch.float32 and torch.equal(r, x.to(torch.bfloat16).float())


# Scores of query rows 0 and 1 against key 1 (key 0 scores 0): bf16 values
# whose exp, 0.96982 and 0.96357, lies about a third of a bf16 step from the
# nearest bf16 (0.96875 and 0.96484), so exp's last bit cannot flip the
# rounding, while rounding moves 1 - p by 4-11% and p0 - p1 by 38%.
ROUNDING_SCORES = (-0.0306396484375, -0.037109375)


def _rounding_probe():
    """bf16-exact [1, 128, 1, 64] inputs, length 2, on which rounding p and
    ds before their products moves O, dq, dk and dv by several bf16 steps:
    q_i = s_i e0 +- e2 (rows 0, 1; other rows 0), k_0 = 8 e3 and
    k_1 = 8 e0 - 8 e3 (scale 1/8: s_i0 = 0, s_i1 = s_i), v_0 = -e1, v_1 = e1,
    so O_i[1] = (p_i1 - 1) / (1 + p_i1); and, with v = 0, dO_i = +-e1,
    lse = 0 and delta = -8 on rows 0 and 1, ds_ij = p_ij, so
    dv_1[1] = dk_1[2] = p_01 - p_11 and dq_i[3] = 8 (1 - p_i1)."""
    shape = (1, 128, 1, 64)
    q, k, v, do, out = (np.zeros(shape, np.float32) for _ in range(5))
    for i, (s, sign) in enumerate(zip(ROUNDING_SCORES, (1.0, -1.0))):
        q[0, i, 0, 0], q[0, i, 0, 2] = s, sign
        do[0, i, 0, 1], out[0, i, 0, 1] = sign, -8.0 * sign  # delta_i = -8
    k[0, 0, 0, 3] = 8.0
    k[0, 1, 0, 0], k[0, 1, 0, 3] = 8.0, -8.0
    v[0, 0, 0, 1], v[0, 1, 0, 1] = -1.0, 1.0
    return q, k, v, do, out, np.asarray([2], np.int32)


def _far_from(got, want, name):
    """The unrounded plain version must miss the one-bf16-step bar."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert (np.abs(got - want) > BF16_STEP * np.abs(want)).any(), (
        f"{name}: dropping the bf16 rounding stays within one bf16 step"
    )


def test_bf16_plain_forward_rounds_p_as_pallas_does(monkeypatch):
    """O of the plain forward holds to the interpret kernel within one bf16
    step of each value (no tensor-wide term), and misses it without the
    rounding of p before P@V (pallas_attention.py:114)."""
    import jax.numpy as jnp

    _, jfa = _jax()
    q, k, v, _, _, lens = _rounding_probe()
    (jq, jk, jv), (tq, tk, tv) = _bf16(q, k, v)
    want = np.asarray(
        jfa._flash_fwd(jq, jk, jv, jnp.asarray(lens), False, 128, 64, True)[0].astype(jnp.float32)
    )
    got = tfa.flash_attention(tq, tk, tv, torch.from_numpy(lens)).float().numpy()
    assert (np.abs(got - want) <= BF16_STEP * np.abs(want)).all(), np.abs(got - want).max()
    monkeypatch.setattr(tfa, "_operand", lambda x, dtype: x)
    _far_from(tfa.flash_attention(tq, tk, tv, torch.from_numpy(lens)).float().numpy(), want, "O")


def test_bf16_plain_backward_rounds_p_and_ds_as_pallas_does(monkeypatch):
    """dq, dk, dv of the plain backward equal the interpret kernels' exactly
    on the probe (every sum is exact there and each p sits away from a bf16
    rounding boundary), and miss them without the rounding of p before dv
    (pallas_attention.py:199) and of ds before dq and dk (:162, :208)."""
    import jax.numpy as jnp

    _, jfa = _jax()
    q, k, _, do, out, lens = _rounding_probe()
    (jq, jk, jv, jdo, jout), tensors = _bf16(q, k, np.zeros_like(q), do, out)
    res = (jq, jk, jv, jnp.asarray(lens), jnp.swapaxes(jout, 1, 2),
           jnp.zeros((1, 1, 128, 1), jnp.float32))
    want = [np.asarray(g.astype(jnp.float32)) for g in jfa._flash_bwd(False, 128, 64, True, res, jdo)[:3]]
    tq, tk, tv, tdo, tout = tensors
    lse = torch.zeros((1, 1, 128))
    delta = (tdo.float() * tout.float()).sum(-1).permute(0, 2, 1).contiguous()
    assert delta[0, 0, :2].tolist() == [-8.0, -8.0]

    def plain():
        return [g.float().numpy() for g in tfa.flash_attention_bwd_reference(
            tq, tk, tv, lse, delta, tdo, torch.from_numpy(lens))]

    for name, g, w in zip(("dq", "dk", "dv"), plain(), want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    monkeypatch.setattr(tfa, "_operand", lambda x, dtype: x)
    for name, g, w in zip(("dq", "dk", "dv"), plain(), want):
        _far_from(g, w, name)


# ---------------------------------------------------------------------------
# backward: flash_attention_diff / flash_attention_bwd
# ---------------------------------------------------------------------------


def _grads(q, k, v, lens, causal):
    """dq, dk, dv of sum(o**2) through the port's differentiable entry point."""
    qkv = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = tfa.flash_attention_diff(*qkv, lens, causal)
    (o ** 2).sum().backward()
    return [x.grad for x in qkv]


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_pallas_interpret(causal):
    import jax

    jnp, jfa = _jax()
    q, k, v = _qkv(t=128)
    lens = np.asarray([128, 90], np.int32)

    def loss(q, k, v):
        o = jfa.flash_attention_diff(q, k, v, jnp.asarray(lens), causal, 128, 128, True)
        return jnp.sum(o ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    got = _grads(q, k, v, torch.from_numpy(lens), causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_gradcheck_float64(causal):
    """The Function against finite differences, with a ragged length."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (
        torch.randn((1, 16, 1, 8), generator=g, dtype=torch.float64, requires_grad=True)
        for _ in range(3)
    )
    lens = torch.tensor([11], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention_diff(q, k, v, lens, causal), (q, k, v)
    )


@pytest.mark.parametrize("causal", [False, True])
def test_gradient_padding_invariance(causal):
    q, k, v = _qkv(t=128)
    lens = torch.tensor([128, 90], dtype=torch.int32)
    base = _grads(q, k, v, lens, causal)
    k2, v2 = k.copy(), v.copy()
    rng = np.random.RandomState(1)
    k2[1, 90:] += 100 * np.sign(rng.randn(*k2[1, 90:].shape))
    v2[1, 90:] -= 100 * np.sign(rng.randn(*v2[1, 90:].shape))
    dq, dk, dv = _grads(q, k2, v2, lens, causal)
    np.testing.assert_array_equal(dq.numpy(), base[0].numpy())
    assert torch.count_nonzero(dk[1, 90:]) == torch.count_nonzero(dv[1, 90:]) == 0
    np.testing.assert_array_equal(dk[1, :90].numpy(), base[1][1, :90].numpy())


def test_gradient_of_length_zero_row_is_zero():
    q, k, v = _qkv(t=128)
    dq, dk, dv = _grads(q, k, v, torch.tensor([128, 0], dtype=torch.int32), False)
    for g in (dq, dk, dv):
        assert torch.count_nonzero(g[1]) == 0
        assert torch.count_nonzero(g[0]) > 0


def test_cpu_gradient_comes_from_the_plain_backward(monkeypatch):
    """The Function's backward calls flash_attention_bwd_reference: with it
    replaced, the gradients are the replacement's.  Autograd through the
    plain forward would give the true gradients instead."""
    q, k, v = _qkv(t=128, b=1)
    calls = []

    def marked(q, k, v, *rest):
        calls.append(1)
        return tuple(torch.full_like(x, float(i + 1)) for i, x in enumerate((q, k, v)))

    monkeypatch.setattr(tfa, "flash_attention_bwd_reference", marked)
    dq, dk, dv = _grads(q, k, v, None, True)
    assert len(calls) == 1
    assert (dq == 1).all() and (dk == 2).all() and (dv == 3).all()


def test_flash_attention_refuses_grad_inputs():
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _qkv(t=64, b=1))
    with pytest.raises(RuntimeError, match="flash_attention_diff"):
        tfa.flash_attention(q, k, v)
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).shape == q.shape


def test_bwd_wrapper_checks_operands():
    q, k, v = _torch(*_qkv(t=64, b=1))
    o, lse = tfa.flash_attention(q, k, v, return_lse=True)
    delta = torch.zeros_like(lse)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd(q, k, v, o, lse[:, :, :32], delta, o)
    with pytest.raises(TypeError):
        tfa.flash_attention_bwd(q, k, v, o, lse, delta, o.double())
    # a strided output gradient is made dense, not refused
    do = torch.randn(1, 64, 2, 128)[..., ::2]
    want = tfa.flash_attention_bwd(q, k, v, o, lse, delta, do.contiguous())
    for g, w in zip(tfa.flash_attention_bwd(q, k, v, o, lse, delta, do), want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert tfa.flash_attention_bwd.dq_launches == tfa.flash_attention_bwd.dkv_launches == 0


def _bar_case(causal, seed=5):
    """bf16 operands, the forward's lse and delta, the derived bars and the
    plain backward, at a ragged length."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in (*_qkv(seed=seed), _qkv(seed=seed + 1)[0]))
    lens = torch.tensor([256, 173], dtype=torch.int32)
    o, lse = tfa.flash_attention(q, k, v, lens, causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, lse, delta, do)
    return args, lens, tfa.flash_attention_bwd_bar(*args, lens, causal), \
        tfa.flash_attention_bwd_reference(*args, lens, causal)


def _excess(got, want, bars):
    """max over elements of |got - want| - bar, per gradient."""
    return [((g.double() - w.double()).abs() - bar).max().item()
            for g, w, bar in zip(got, want, bars)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("variant", ["f64_sums", "ds_unrounded", "mask_dropped"])
def test_bf16_bar_passes_other_sum_orders_and_rejects_faults(monkeypatch, variant, causal):
    """The derived bf16 bar against three backwards: the plain one with its
    sums taken in f64 (another summation order, whose ds round from other
    f32 values: it differs, within the bar), one with ds left unrounded and
    one with the length mask dropped (each past the bar somewhere)."""
    args, lens, bars, want = _bar_case(causal)
    if variant == "f64_sums":
        monkeypatch.setattr(tfa, "_acc_dtype", lambda dtype: torch.float64)
        got = tfa.flash_attention_bwd_reference(*args, lens, causal)
        assert any(not torch.equal(g, w) for g, w in zip(got, want))
        assert max(_excess(got, want, bars)) <= 0
    elif variant == "ds_unrounded":
        got = tfa.flash_attention_bwd_reference(*args, lens, causal, round_ds=False)
        ex = _excess(got, want, bars)
        assert ex[0] > 0 and ex[1] > 0, ex  # dq and dk; dv does not use ds
    else:
        got = tfa.flash_attention_bwd_reference(*args, None, causal)
        assert min(_excess(got, want, bars)) > 0


def test_bf16_bar_has_no_flat_floor():
    """Where both sides are exactly 0 (keys past the length, a length-0
    row) the bar is 0; it takes bf16 inputs only."""
    args, lens, bars, want = _bar_case(False)
    assert torch.count_nonzero(bars[1][1, 173:]) == torch.count_nonzero(bars[2][1, 173:]) == 0
    assert (bars[0] > 0).all()
    q, k, v, lse, delta, do = args
    with pytest.raises(TypeError):
        tfa.flash_attention_bwd_bar(q.float(), k.float(), v.float(), lse, delta, do.float(), lens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [40, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["fused", "separate"])
def test_cuda_backward_kernels_match_plain(cuda, dtype, dh, causal, layout):
    """Both backward kernels against the plain backward: ragged T, head dims
    that are and are not multiples of 16, a length-0 row and a length that is
    not a multiple of 64; q/k/v as strided slices of one fused projection or
    dense.  f32: |d| <= 1e-4; bf16: |d| <= flash_attention_bwd_bar, which
    bounds the rounding flips of ds and p and the store's rounding."""
    b, t, h = 3, 200, 4
    g = torch.Generator(device="cuda").manual_seed(0)
    if layout == "fused":
        qkv = torch.randn((b, t, 3 * h * dh), generator=g, device=cuda).to(dtype)
        q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
    else:
        q, k, v = (torch.randn((b, t, h, dh), generator=g, device=cuda).to(dtype) for _ in range(3))
    do = torch.randn((b, t, h, dh), generator=g, device=cuda).to(dtype)
    lens = torch.tensor([200, 77, 0], dtype=torch.int32, device=cuda)
    o, lse = tfa.flash_attention(q, k, v, lens, causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    before = (tfa.flash_attention_bwd.dq_launches, tfa.flash_attention_bwd.dkv_launches)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, delta, do, lens, causal)
    after = (tfa.flash_attention_bwd.dq_launches, tfa.flash_attention_bwd.dkv_launches)
    assert after == (before[0] + 1, before[1] + 1)
    want = tfa.flash_attention_bwd_reference(q, k, v, lse, delta, do, lens, causal)
    if dtype == torch.bfloat16:
        bars = tfa.flash_attention_bwd_bar(q, k, v, lse, delta, do, lens, causal)
    else:
        bars = (1e-4,) * 3
    torch.cuda.synchronize()
    for name, x, r, bar in zip(("dq", "dk", "dv"), got, want, bars):
        assert x.dtype == dtype and x.is_contiguous()
        assert bool(((x.double() - r.double()).abs() <= bar).all()), name
        assert torch.count_nonzero(x[2]) == 0, name
    # keys past the length get no gradient
    assert torch.count_nonzero(got[1][1, 77:]) == torch.count_nonzero(got[2][1, 77:]) == 0


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernels' alignment rule (16-byte cp.async chunks)
# ---------------------------------------------------------------------------


def _misaligned_views(dev, b=2, t=128, h=2, dh=64):
    """(name, q) bf16 views the tensor-core kernels cannot copy in 16-byte
    chunks: an address 2 bytes past 16, and a token stride of h*dh + 4."""
    wide = torch.zeros((b, t, h * dh + 8), dtype=torch.bfloat16, device=dev)
    odd = torch.zeros((b, t, h * dh + 4), dtype=torch.bfloat16, device=dev)
    return (
        ("address", wide[..., 1 : 1 + h * dh].view(b, t, h, dh)),
        ("token stride", odd[..., : h * dh].view(b, t, h, dh)),
    )


@pytest.mark.parametrize("case", [0, 1])
def test_check_aligned_rejects_what_cp_async_cannot_copy(case):
    name, x = _misaligned_views("cpu")[case]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.check_aligned(name, x)


def test_check_aligned_takes_the_main_path_operands():
    """The fused QKV's column slices (token stride 3*H*dh) and dense tensors."""
    b, t, h, dh = 2, 128, 2, 40
    qkv = torch.zeros((b, t, 3 * h * dh), dtype=torch.bfloat16)
    for x in (*(y.view(b, t, h, dh) for y in qkv.split(h * dh, dim=-1)),
              torch.zeros((b, t, h, dh), dtype=torch.bfloat16)):
        tfa.check_aligned("q", x)


@pytest.mark.cuda
def test_cuda_misaligned_bf16_raises(cuda):
    """A misaligned bf16 view raises ValueError, never a fallback: forward
    and backward, and no launch is counted."""
    before = (tfa.flash_attention.launches, tfa.flash_attention_bwd.dq_launches,
              tfa.flash_attention_bwd.dkv_launches)
    for name, x in _misaligned_views(cuda):
        ok = torch.zeros(x.shape, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfa.flash_attention(x, ok, ok)
        o, lse = tfa.flash_attention(ok, ok, ok, return_lse=True)
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfa.flash_attention_bwd(ok, x, ok, o, lse, torch.zeros_like(lse), ok)
    assert tfa.flash_attention_bwd.dq_launches == before[1]
    assert tfa.flash_attention_bwd.dkv_launches == before[2]
    assert tfa.flash_attention.launches == before[0] + 2
