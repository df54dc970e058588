"""VAE / CVAE baselines.

Counterpart of `gemm_gan_tpu/models/vae.py`: an MLP encoder (ReLU blocks)
-> (mu, logvar) -> reparameterized latent -> MLP decoder; the CVAE
conditions encoder and decoder on two categorical label embeddings
(`label_embed_dim` each). Reconstruction is MSE or Gaussian NLL, KL is
analytic.

The MLPs' Linears compute in the compute dtype (`ops/linear.py`: under
`compute_dtype="bfloat16"` they round as Flax's `Dense(dtype=bf16)` does);
the heads (`mu_head`, `logvar_head`, `out_head`, `out_logvar`) and the
label tables stay f32, as in JAX. Weights start from Flax's distributions
(`models.gan.init_flax_like_`: lecun-normal kernels, zero biases,
`default_embed_init` tables).

The randomness is an input: `forward` takes the reparameterization noise
`eps` [B, latent] and `sample` the prior draw `z`, drawn by the caller
(`train/vae.py` from its `torch.Generator`), so a test can feed JAX's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gemm_gan_tpu_torch.config import ModelConfig
from gemm_gan_tpu_torch.models.gan import init_flax_like_
from gemm_gan_tpu_torch.ops.linear import DTYPES, Linear
from gemm_gan_tpu_torch.utils.device import DeviceLike, resolve_device


class _MLP(nn.Module):
    """Linear -> ReLU blocks in `dtype` (Flax's `_MLP`: `Dense_i`)."""

    def __init__(self, in_features: int, dims: Sequence[int], dtype: torch.dtype):
        super().__init__()
        ins = [in_features, *dims[:-1]]
        self.dense = nn.ModuleList(Linear(i, o, dtype) for i, o in zip(ins, dims))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.dense:
            x = torch.relu(layer(x))
        return x


class _Base(nn.Module):
    def __init__(self, cfg: ModelConfig, cond_features: int):
        super().__init__()
        if cfg.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype={cfg.compute_dtype!r} not in {sorted(DTYPES)}")
        self.cfg = cfg
        dtype = DTYPES[cfg.compute_dtype]
        enc, dec, latent = cfg.vae_encoder_dims, cfg.vae_decoder_dims, cfg.vae_latent_dim
        self.encoder = _MLP(cfg.n_genes + cond_features, enc, dtype)
        self.mu_head = Linear(enc[-1], latent)
        self.logvar_head = Linear(enc[-1], latent)
        self.decoder = _MLP(latent + cond_features, dec, dtype)
        self.out_head = Linear(dec[-1], cfg.n_genes)

    def _finish(self, device: DeviceLike, generator: Optional[torch.Generator]):
        """Flax-like random weights from `generator`, then onto `device`."""
        init_flax_like_(self, generator)
        self.to(resolve_device(device))

    def _encode(self, x):
        h = self.encoder(x)
        return self.mu_head(h), self.logvar_head(h)

    @staticmethod
    def reparameterize(mu, logvar, eps):
        return mu + torch.exp(0.5 * logvar) * eps


class VAE(_Base):
    """x [B, n_genes] -> (reconstruction, mu, logvar); with
    `vae_recon="gaussian_nll"` the reconstruction is (mean, logvar)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, 0)
        if cfg.vae_recon == "gaussian_nll":
            self.out_logvar = Linear(cfg.vae_decoder_dims[-1], cfg.n_genes)
        self._finish(device, generator)

    def encode(self, x):
        return self._encode(x)

    def decode(self, z):
        h = self.decoder(z)
        if self.cfg.vae_recon == "gaussian_nll":
            return self.out_head(h), self.out_logvar(h)
        return self.out_head(h)

    def forward(self, x, eps):
        mu, logvar = self.encode(x)
        return self.decode(self.reparameterize(mu, logvar, eps)), mu, logvar

    def sample(self, z):
        """Decode prior draws z [num, latent] (the mean under gaussian_nll)."""
        out = self.decode(z)
        return out[0] if isinstance(out, tuple) else out


class CVAE(_Base):
    """(x, disease, site) -> (reconstruction, mu, logvar), the labels'
    embeddings concatenated to the encoder's and the decoder's inputs."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        f = cfg.fusion
        super().__init__(cfg, 2 * f.label_embed_dim)
        self.disease_embed = nn.Embedding(f.n_disease_types, f.label_embed_dim)
        self.site_embed = nn.Embedding(f.n_primary_sites, f.label_embed_dim)
        self._finish(device, generator)

    def _labels(self, disease, site):
        return torch.cat([self.disease_embed(disease.long()), self.site_embed(site.long())],
                         dim=-1)

    def encode(self, x, disease, site):
        return self._encode(torch.cat([x, self._labels(disease, site)], dim=-1))

    def decode(self, z, disease, site):
        return self.out_head(self.decoder(torch.cat([z, self._labels(disease, site)], dim=-1)))

    def forward(self, x, disease, site, eps):
        mu, logvar = self.encode(x, disease, site)
        return self.decode(self.reparameterize(mu, logvar, eps), disease, site), mu, logvar

    def sample(self, z, disease, site):
        return self.decode(z, disease, site)


def kl_divergence(mu, logvar):
    """Analytic KL(N(mu, sigma) || N(0, 1)), summed over the latent dims,
    the mean over the batch."""
    return torch.mean(-0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1))


def recon_loss(x, out, kind: str = "mse"):
    """MSE, or the Gaussian NLL of `out` = (mean, logvar)."""
    if kind == "gaussian_nll":
        mean, logvar = out
        return torch.mean(0.5 * (torch.exp(-logvar) * (x - mean) ** 2 + logvar))
    return torch.mean((x - out) ** 2)


def elbo_loss(x, out, mu, logvar, beta: float = 1.0, recon: str = "mse"):
    r = recon_loss(x, out, recon)
    kl = kl_divergence(mu, logvar)
    return r + beta * kl, (r, kl)
