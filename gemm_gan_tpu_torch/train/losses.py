"""WGAN-GP losses.

Counterpart of `gemm_gan_tpu/train/losses.py`. The gradient penalty is the
squared deviation of the per-sample gradient L2 norm from 1, the gradient
taken w.r.t. the interpolated expression only (conditioning held fixed),
with `torch.autograd.grad(..., create_graph=True)` so that the outer
gradient differentiates through it. The norm is sqrt(sum g^2 + 1e-12), as
in the JAX package, not `g.norm()`. The interpolation coefficients α
[B, 1] are drawn by the caller.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def wasserstein_loss(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return (y_pred * y_true).mean()


def g_loss(fake_scores: torch.Tensor) -> torch.Tensor:
    """Generator loss: -E[D(G(z))]."""
    return wasserstein_loss(fake_scores, -torch.ones_like(fake_scores))


def d_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Critic loss E[D(fake)] - E[D(real)], with its two components."""
    loss_real = wasserstein_loss(-torch.ones_like(real_scores), real_scores)
    loss_fake = wasserstein_loss(torch.ones_like(fake_scores), fake_scores)
    return loss_real + loss_fake, loss_real, loss_fake


def drift_penalty(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """ε-drift regularizer E[D(real)^2] + E[D(fake)^2] (off unless
    `train.drift_epsilon` > 0)."""
    return (real_scores ** 2).mean() + (fake_scores ** 2).mean()


def _penalty(grads: torch.Tensor) -> torch.Tensor:
    norms = torch.sqrt((grads * grads).sum(dim=1) + 1e-12)
    return ((norms - 1.0) ** 2).mean()


def _interpolate(real, fake, alpha):
    return (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)


def gradient_penalty(disc_fn: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     alpha: torch.Tensor) -> torch.Tensor:
    """((||∇_x D(x̂)||₂ − 1)²).mean() with x̂ = αx + (1−α)·fake.

    `disc_fn` maps [B, n_genes] to [B, 1] scores, critic params and
    conditioning closed over; the critic is per-sample, so the gradient of
    the summed score is the stack of per-sample gradients."""
    interp = _interpolate(real, fake, alpha)
    grads, = torch.autograd.grad(disc_fn(interp).sum(), interp, create_graph=True)
    return _penalty(grads)


def batched_scores_and_gp(score_fn: Callable[[torch.Tensor], torch.Tensor],
                          real: torch.Tensor, fake: torch.Tensor,
                          alpha: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(D(real), D(fake), gradient penalty) from ONE [3B] trunk call.

    `score_fn` maps [N, n_genes] -> [N, 1] for any N (a row-tiled condition
    vector closed over). The penalty's gradient is taken w.r.t. the interp
    slice only; the same numbers as three separate calls, with one read of
    the critic's [n_genes, hidden] weights instead of three."""
    B = real.shape[0]
    interp = _interpolate(real, fake, alpha)
    scores = score_fn(torch.cat([real, fake, interp], dim=0))
    grads, = torch.autograd.grad(scores[2 * B:].sum(), interp, create_graph=True)
    return scores[:B], scores[B:2 * B], _penalty(grads)
