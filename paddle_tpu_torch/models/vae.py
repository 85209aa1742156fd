"""VAE demo — v1_api_demo/vae parity; the counterpart of
``paddle_tpu/models/vae.py``.

The encoder and the decoder are CompiledNetworks; one step encodes,
reparameterizes with a given eps, decodes, takes the squared-error
reconstruction plus the analytic gaussian KL, and updates BOTH networks
with one Adam.  eps is an argument of the step, drawn by ``train_batch``
from the trainer's ``torch.Generator`` on its device (seeded from
``seed + 1``, as the JAX package seeds its key), so a test can feed both
packages the same eps."""

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


def encoder_net(data_dim: int, latent_dim: int, hidden: int = 64):
    x = L.data("x", paddle.data_type.dense_vector(data_dim))
    h = L.fc(x, size=hidden, act=A.Relu(), name="e_h1")
    mu = L.fc(h, size=latent_dim, act=A.Identity(), name="e_mu")
    logvar = L.fc(h, size=latent_dim, act=A.Identity(), name="e_logvar")
    return mu, logvar


def decoder_net(latent_dim: int, data_dim: int, hidden: int = 64):
    z = L.data("z", paddle.data_type.dense_vector(latent_dim))
    h = L.fc(z, size=hidden, act=A.Relu(), name="d_h1")
    return L.fc(h, size=data_dim, act=A.Identity(), name="d_out")


class VAETrainer:
    """On `device`: the card unless the caller asks for the CPU."""

    def __init__(
        self,
        data_dim: int,
        latent_dim: int = 4,
        hidden: int = 64,
        lr: float = 1e-3,
        kl_weight: float = 1.0,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.latent_dim = latent_dim
        self.kl_weight = kl_weight
        reset_auto_names()
        mu, logvar = encoder_net(data_dim, latent_dim, hidden)
        self.enc = CompiledNetwork(Topology([mu, logvar]))
        self.mu_name, self.lv_name = mu.name, logvar.name
        dec_out = decoder_net(latent_dim, data_dim, hidden)
        self.dec = CompiledNetwork(Topology([dec_out]))
        self.dec_out = dec_out.name

        ke, kd = split_seeds(seed)
        self.params = {"enc": self.enc.init_params(ke, self.device),
                       "dec": self.dec.init_params(kd, self.device)}
        self.opt = paddle.optimizer.Adam(learning_rate=lr)
        self.opt_state = self.opt.init(self.params)
        self._rng = torch.Generator(device=self.device).manual_seed(seed + 1)

    def _decode(self, dec_params, z: torch.Tensor) -> torch.Tensor:
        outs, _ = self.dec.apply(dec_params, {"z": SeqTensor(z)}, train=True)
        return outs[self.dec_out].data

    def loss(self, p, x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        outs, _ = self.enc.apply(p["enc"], {"x": SeqTensor(x)}, train=True)
        mu_v = outs[self.mu_name].data
        lv_v = outs[self.lv_name].data
        z = mu_v + eps * torch.exp(0.5 * lv_v)  # reparameterization
        recon = self._decode(p["dec"], z)
        rec = torch.mean(torch.sum((recon - x) ** 2, dim=-1))
        kl = -0.5 * torch.mean(torch.sum(1 + lv_v - mu_v**2 - torch.exp(lv_v), dim=-1))
        return rec + self.kl_weight * kl

    def loss_grads(self, params, x: torch.Tensor, eps: torch.Tensor):
        """(loss, gradients of the {"enc", "dec"} tree) at one eps."""
        l, _, grads = value_and_grad(lambda p: (self.loss(p, x, eps), None), params)
        return l, grads

    def _step(self, params, opt_state, x: torch.Tensor, eps: torch.Tensor):
        """(params, opt_state, loss): one update, in place."""
        l, grads = self.loss_grads(params, x, eps)
        params, opt_state = self.opt.update(grads, opt_state, params)
        return params, opt_state, l

    def train_batch(self, x) -> float:
        x = upload(x, self.device)
        eps = torch.randn((x.shape[0], self.latent_dim), generator=self._rng,
                          device=self.device)
        self.params, self.opt_state, l = self._step(self.params, self.opt_state, x, eps)
        return float(l)

    def sample(self, n: int) -> np.ndarray:
        z = torch.randn((n, self.latent_dim), generator=self._rng, device=self.device)
        with torch.no_grad():
            return self._decode(self.params["dec"], z).cpu().numpy()

    def reconstruct(self, x) -> np.ndarray:
        with torch.no_grad():
            outs, _ = self.enc.apply(
                self.params["enc"], {"x": SeqTensor(upload(x, self.device))}, train=False)
            return self._decode(self.params["dec"], outs[self.mu_name].data).cpu().numpy()
