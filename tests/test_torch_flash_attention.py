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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-3)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["fused", "separate"])
def test_cuda_backward_kernels_match_plain(cuda, dtype, atol, causal, layout):
    """Both backward kernels against the plain backward: ragged T, a dh that
    is not a power of two, a length-0 row and a length that is not a multiple
    of 64; q/k/v as strided slices of one fused projection or dense.  Each
    gradient rounds once on store, so a bf16 value may land one step away:
    |d| <= atol + 1e-2 |ref| in bf16."""
    b, t, h, dh = 3, 200, 4, 40
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
    torch.cuda.synchronize()
    rel = 1e-2 if dtype == torch.bfloat16 else 0.0
    for name, x, r in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == dtype and x.is_contiguous()
        excess = ((x.float() - r.float()).abs() - rel * r.float().abs()).max().item()
        assert excess <= atol, name
        assert torch.count_nonzero(x[2]) == 0, name
    # keys past the length get no gradient
    assert torch.count_nonzero(got[1][1, 77:]) == torch.count_nonzero(got[2][1, 77:]) == 0
