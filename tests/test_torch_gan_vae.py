"""The port's GAN and VAE trainers (paddle_tpu_torch/models/gan.py, vae.py)
against the JAX package's on the CPU, f32:

- a 20-batch GAN trajectory from the JAX trainer's trees carried into the
  port (Adam states re-initialised), both drawing z and z2 from copies of
  one RandomState: every step's two losses within 1e-4 relative, and the
  trees after it within 1e-4 relative L2;
- one D step's and one G step's gradients from the same trees within 1e-5
  relative L2, with no gradient reaching the other network;
- 10 VAE steps fed the eps sequence the JAX trainer draws (its key split,
  then a normal draw): losses within 1e-5 relative, trees within 1e-4
  relative L2; then ``reconstruct`` and ``_decode`` at a fixed z within
  1e-5 relative L2;
- the three learning cases of tests/test_gan_vae.py on the port.
"""

import jax
import numpy as np
import torch

from paddle_tpu.models.gan import GANTrainer as JGAN
from paddle_tpu.models.vae import VAETrainer as JVAE
from paddle_tpu_torch.models.gan import GANTrainer as TGAN
from paddle_tpu_torch.models.vae import VAETrainer as TVAE
from paddle_tpu_torch.parameters import from_numpy
from test_torch_parity import numpy_tree, rel_l2

NOISE, DATA, HIDDEN, B = 4, 8, 16, 16


def tree_in(jtree):
    """A JAX parameter tree as the port's (CPU tensors)."""
    return from_numpy(numpy_tree(jtree), device="cpu").params


def gan_pair(seed=1):
    jg = JGAN(NOISE, DATA, hidden=HIDDEN, seed=seed)
    tg = TGAN(NOISE, DATA, hidden=HIDDEN, seed=seed, device="cpu")
    tg.g_params, tg.d_params = tree_in(jg.g_params), tree_in(jg.d_params)
    tg.g_opt_state, tg.d_opt_state = tg.g_opt.init(tg.g_params), tg.d_opt.init(tg.d_params)
    return jg, tg


def real_rows(rng, n=B):
    centers = np.where(rng.rand(n, 1) < 0.5, 1.5, -1.5)
    return (centers + 0.3 * rng.randn(n, DATA)).astype(np.float32)


def test_gan_trajectory_matches_the_jax_package():
    jg, tg = gan_pair()
    data = np.random.RandomState(5)
    jrng, trng = np.random.RandomState(7), np.random.RandomState(7)
    worst = 0.0
    for _ in range(20):
        real = real_rows(data)
        jl, tl = jg.train_batch(real, jrng), tg.train_batch(real, trng)
        for j, t in zip(jl, tl):
            worst = max(worst, abs(t - j) / abs(j))
    g_err = rel_l2(tg.g_params, numpy_tree(jg.g_params))
    d_err = rel_l2(tg.d_params, numpy_tree(jg.d_params))
    print(f"gan 20 batches: worst loss {worst:.3g}, G {g_err:.3g}, D {d_err:.3g}")
    assert worst <= 1e-4 and g_err <= 1e-4 and d_err <= 1e-4


def test_gan_step_gradients_match_the_jax_package():
    jg, tg = gan_pair(seed=2)
    rng = np.random.RandomState(3)
    real, z = real_rows(rng), rng.randn(B, NOISE).astype(np.float32)
    jnp = jax.numpy

    def jd_loss(dp):
        fake = jg.g_net.apply(jg.g_params, {"z": _jseq(z)}, train=True)[0][jg.g_out].data
        pr = jnp.clip(jg.d_net.apply(dp, {"x": _jseq(real)}, train=True)[0][jg.d_out].data[:, 0],
                      1e-6, 1 - 1e-6)
        pf = jnp.clip(jg.d_net.apply(dp, {"x": _jseq(fake)}, train=True)[0][jg.d_out].data[:, 0],
                      1e-6, 1 - 1e-6)
        return -jnp.mean(jnp.log(pr) + jnp.log(1.0 - pf))

    def jg_loss(gp):
        fake = jg.g_net.apply(gp, {"z": _jseq(z)}, train=True)[0][jg.g_out].data
        pf = jnp.clip(jg.d_net.apply(jg.d_params, {"x": _jseq(fake)}, train=True)[0][jg.d_out]
                      .data[:, 0], 1e-6, 1 - 1e-6)
        return -jnp.mean(jnp.log(pf))

    jdl, jdg = jax.value_and_grad(jd_loss)(jg.d_params)
    jgl, jgg = jax.value_and_grad(jg_loss)(jg.g_params)
    tdl, tdg = tg.d_grads(torch.from_numpy(real), torch.from_numpy(z))
    tgl, tgg = tg.g_grads(torch.from_numpy(z))
    assert abs(tdl.item() - float(jdl)) <= 1e-5 * abs(float(jdl))
    assert abs(tgl.item() - float(jgl)) <= 1e-5 * abs(float(jgl))
    assert rel_l2(tdg, numpy_tree(jdg)) <= 1e-5 and rel_l2(tgg, numpy_tree(jgg)) <= 1e-5
    # each step differentiates its own network only, and the G step leaves D
    d_before = {k: {kk: v.clone() for kk, v in p.items()} for k, p in tg.d_params.items()}
    tg.g_step(torch.from_numpy(z))
    assert all(v.grad is None and not v.requires_grad
               for p in tg.d_params.values() for v in p.values())
    assert rel_l2(tg.d_params, numpy_tree(d_before)) == 0.0


def _jseq(x):
    from paddle_tpu.core.batch import SeqTensor

    return SeqTensor(jax.numpy.asarray(x))


def jax_eps_sequence(seed, n, b, latent):
    """The eps the JAX trainer's train_batch draws in its first n calls."""
    key = jax.random.PRNGKey(seed + 1)
    out = []
    for _ in range(n):
        key, r = jax.random.split(key)
        out.append(np.array(jax.random.normal(r, (b, latent))))
    return out


def test_vae_steps_reconstruct_and_decode_match_the_jax_package():
    seed, latent = 4, 2
    jv = JVAE(data_dim=DATA, latent_dim=latent, hidden=HIDDEN, lr=3e-3, seed=seed)
    tv = TVAE(data_dim=DATA, latent_dim=latent, hidden=HIDDEN, lr=3e-3, seed=seed, device="cpu")
    tv.params = tree_in(jv.params)
    tv.opt_state = tv.opt.init(tv.params)
    data = np.random.RandomState(6)
    for eps in jax_eps_sequence(seed, 10, B, latent):
        x = real_rows(data)
        jl = jv.train_batch(x)
        tv.params, tv.opt_state, tl = tv._step(tv.params, tv.opt_state, torch.from_numpy(x),
                                               torch.from_numpy(eps))
        assert abs(tl.item() - jl) <= 1e-5 * abs(jl), (tl.item(), jl)
    err = rel_l2(tv.params, numpy_tree(jv.params))
    print(f"vae 10 steps: trees {err:.3g}")
    assert err <= 1e-4
    x = real_rows(data, 32)
    tv.params = tree_in(jv.params)  # the same trees for the forward checks
    assert rel_l2(tv.reconstruct(x), jv.reconstruct(x)) <= 1e-5
    z = np.random.RandomState(8).randn(32, latent).astype(np.float32)
    with torch.no_grad():
        tz = tv._decode(tv.params["dec"], torch.from_numpy(z)).numpy()
    assert rel_l2(tz, np.asarray(jv._decode(jv.params["dec"], jax.numpy.asarray(z)))) <= 1e-5
    assert tv.sample(5).shape == (5, DATA) and np.isfinite(tv.sample(5)).all()


# the learning cases of tests/test_gan_vae.py, on the port


def test_gan_learns_gaussian():
    """G must move its output distribution onto N(3, 0.5)^2."""
    rng = np.random.RandomState(0)
    gan = TGAN(noise_dim=4, data_dim=2, hidden=32, seed=1, device="cpu")
    before = gan.sample(512, np.random.RandomState(99))
    for _ in range(400):
        real = (3.0 + 0.5 * rng.randn(64, 2)).astype(np.float32)
        gan.train_batch(real, rng)
    after = gan.sample(512, np.random.RandomState(99))
    assert np.abs(before.mean(0)).max() < 1.5
    np.testing.assert_allclose(after.mean(0), [3.0, 3.0], atol=0.6)
    assert 0.1 < after.std(0).mean() < 1.5  # not collapsed to a point mass


def test_gan_losses_are_finite_and_adversarial():
    rng = np.random.RandomState(2)
    gan = TGAN(noise_dim=3, data_dim=2, hidden=16, seed=3, device="cpu")
    d_losses, g_losses = [], []
    for _ in range(50):
        real = (1.0 + 0.2 * rng.randn(32, 2)).astype(np.float32)
        d, g = gan.train_batch(real, rng)
        d_losses.append(d)
        g_losses.append(g)
    assert np.isfinite(d_losses).all() and np.isfinite(g_losses).all()
    assert min(d_losses) < 1.3
    assert max(g_losses) > 0.05


def test_vae_reconstructs_and_samples():
    rng = np.random.RandomState(0)
    centers = np.asarray([[2.0, 2.0, 2.0, 2.0], [-2.0, -2.0, -2.0, -2.0]])
    vae = TVAE(data_dim=4, latent_dim=2, hidden=32, lr=3e-3, seed=0, device="cpu")

    def batch(n=64):
        c = centers[rng.randint(2, size=n)]
        return (c + 0.2 * rng.randn(n, 4)).astype(np.float32)

    losses = [vae.train_batch(batch()) for _ in range(300)]
    assert np.mean(losses[-20:]) < 0.3 * np.mean(losses[:20])
    x = batch(128)
    rec = vae.reconstruct(x)
    assert np.mean(np.sum((rec - x) ** 2, axis=-1)) < 1.0
    s = vae.sample(256)
    d = np.minimum(
        np.linalg.norm(s - centers[0], axis=-1),
        np.linalg.norm(s - centers[1], axis=-1),
    )
    assert np.median(d) < 2.0
