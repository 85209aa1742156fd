"""GAN demo — v1_api_demo/gan parity; the counterpart of
``paddle_tpu/models/gan.py``.

The generator and the discriminator are two CompiledNetworks, each with its
own Adam(beta1=0.5).  The discriminator step differentiates only the
discriminator's leaves, with the generator's sample drawn under
``torch.no_grad()``; the generator step differentiates only the generator's
leaves, through the discriminator, whose tensors take no gradient and do
not change.  The noise comes from the caller's ``np.random.RandomState`` in
the JAX package's order (``z`` for the discriminator step, then ``z2``), so
the two packages can be held step for step."""

from __future__ import annotations

import numpy as np
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.core.compiler import CompiledNetwork
from paddle_tpu_torch.core.device import resolve_device, upload
from paddle_tpu_torch.core.initializers import split_seeds
from paddle_tpu_torch.core.topology import Topology, reset_auto_names
from paddle_tpu_torch.trainer.step import value_and_grad

L = paddle.layer
A = paddle.activation


def generator_net(noise_dim: int, data_dim: int, hidden: int = 64):
    z = L.data("z", paddle.data_type.dense_vector(noise_dim))
    h = L.fc(z, size=hidden, act=A.Relu(), name="g_h1")
    h = L.fc(h, size=hidden, act=A.Relu(), name="g_h2")
    return L.fc(h, size=data_dim, act=A.Identity(), name="g_out")


def discriminator_net(data_dim: int, hidden: int = 64):
    x = L.data("x", paddle.data_type.dense_vector(data_dim))
    h = L.fc(x, size=hidden, act=A.Relu(), name="d_h1")
    h = L.fc(h, size=hidden, act=A.Relu(), name="d_h2")
    return L.fc(h, size=1, act=A.Sigmoid(), name="d_out")


class GANTrainer:
    """Alternating GAN training: d_step maximizes log D(x) + log(1-D(G(z))),
    g_step maximizes log D(G(z)) (the non-saturating generator loss).  On
    `device`: the card unless the caller asks for the CPU."""

    def __init__(
        self,
        noise_dim: int,
        data_dim: int,
        hidden: int = 64,
        g_lr: float = 1e-3,
        d_lr: float = 1e-3,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.noise_dim = noise_dim
        reset_auto_names()
        g_out = generator_net(noise_dim, data_dim, hidden)
        self.g_net = CompiledNetwork(Topology([g_out]))
        self.g_out = g_out.name
        d_out = discriminator_net(data_dim, hidden)
        self.d_net = CompiledNetwork(Topology([d_out]))
        self.d_out = d_out.name

        kg, kd = split_seeds(seed)
        self.g_params = self.g_net.init_params(kg, self.device)
        self.d_params = self.d_net.init_params(kd, self.device)
        self.g_opt = paddle.optimizer.Adam(learning_rate=g_lr, beta1=0.5)
        self.d_opt = paddle.optimizer.Adam(learning_rate=d_lr, beta1=0.5)
        self.g_opt_state = self.g_opt.init(self.g_params)
        self.d_opt_state = self.d_opt.init(self.d_params)

    def d_prob(self, d_params, x: torch.Tensor) -> torch.Tensor:
        outs, _ = self.d_net.apply(d_params, {"x": SeqTensor(x)}, train=True)
        return torch.clamp(outs[self.d_out].data[:, 0], 1e-6, 1 - 1e-6)

    def generate(self, g_params, z: torch.Tensor) -> torch.Tensor:
        outs, _ = self.g_net.apply(g_params, {"z": SeqTensor(z)}, train=True)
        return outs[self.g_out].data

    # ------------------------------------------------------------------
    def d_grads(self, real: torch.Tensor, z: torch.Tensor):
        """(loss, gradients of the discriminator's leaves), G frozen."""
        with torch.no_grad():
            fake = self.generate(self.g_params, z)

        def loss(dp):
            p_real = self.d_prob(dp, real)
            p_fake = self.d_prob(dp, fake)
            return -torch.mean(torch.log(p_real) + torch.log(1.0 - p_fake)), None

        l, _, grads = value_and_grad(loss, self.d_params)
        return l, grads

    def g_grads(self, z: torch.Tensor):
        """(loss, gradients of the generator's leaves), through D frozen."""

        def loss(gp):
            return -torch.mean(torch.log(self.d_prob(self.d_params, self.generate(gp, z)))), None

        l, _, grads = value_and_grad(loss, self.g_params)
        return l, grads

    def d_step(self, real: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        l, grads = self.d_grads(real, z)
        self.d_opt.update(grads, self.d_opt_state, self.d_params)
        return l

    def g_step(self, z: torch.Tensor) -> torch.Tensor:
        l, grads = self.g_grads(z)
        self.g_opt.update(grads, self.g_opt_state, self.g_params)
        return l

    def train_batch(self, real, rng: np.random.RandomState):
        """One D step and one G step; the two losses as floats (two host
        syncs)."""
        b = real.shape[0]
        z = upload(rng.randn(b, self.noise_dim), self.device)
        d_loss = self.d_step(upload(real, self.device), z)
        z2 = upload(rng.randn(b, self.noise_dim), self.device)
        g_loss = self.g_step(z2)
        return float(d_loss), float(g_loss)

    def sample(self, n: int, rng: np.random.RandomState) -> np.ndarray:
        z = upload(rng.randn(n, self.noise_dim), self.device)
        with torch.no_grad():
            return self.generate(self.g_params, z).cpu().numpy()
