"""The WGAN-GP training step of the flagship, in plain PyTorch.

What one step of the port's production setting computes
(`cond_embed_reuse="per_update"`, batched scores), written from the
algorithm: the generator embeds the conditioning once (no gradient); each
of `n_critic` critic updates makes fakes from fresh z, embeds the
conditioning with gradient, scores real, fake and the interpolates
alpha*real + (1-alpha)*fake as one [3B] trunk call, and descends
E[D(fake)] - E[D(real)] + gp_weight * E[(||grad_x D(interp)|| - 1)^2] +
drift_epsilon * (E[D(real)^2] + E[D(fake)^2]), the penalty's gradient taken
w.r.t. the interpolates with `create_graph` (a double backward through the
trunk); then the critic's embedding (no gradient) scores the generator's
fakes, and the generator descends -E[D(G(z))]. Each update clips its
gradients by global norm and steps RMSprop (decay 0.99, eps 1e-8 outside
the root, the rate halving every `lr_halve_every_epochs` epochs of that
optimizer's own updates); after the step the generator's EMA moves.

The batch comes from a bank held on the device, as the port's
`DeviceCache` serves it; this module works the same tables out again from
their published rule: each epoch's order is numpy's
`RandomState(seed + epoch).permutation`, its subsampling scores
U(0, 1)[batches, B, slots] from a device generator seeded with
`SeedSequence([seed, epoch])`, and each case keeps its `num_patches` valid
slots of smallest score (ascending), invalid ones zeroed.

z, alpha and the generator's z come from a device generator seeded like
the program's; dropout masks from the default generator of the device
(`numerics.Dropout`). The nets are the configuration's architecture
(`reference/<architecture>.py`).

`FAULTS` plants a fault in the reference put in the program's place, for
the check's calibration and its tests: a step over half of the batch, the
critic's updates over half of it, a critic loss without the penalty or
without the drift term.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import model
from perfbench.reference.numerics import Dropout, Precision

Params = Dict[str, torch.Tensor]

RMSPROP_DECAY = 0.99
RMSPROP_EPS = 1e-8
GP_NORM_EPS = 1e-12
WIDENED = ("patches", "tokens")  # stored narrow in the bank, used in f32


# ------------------------------------------------------------------ batches
def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    return np.random.RandomState(seed + epoch).permutation(np.arange(n))


def epoch_scores(seed: int, epoch: int, batches: int, B: int, slots: int,
                 device) -> torch.Tensor:
    s = int(np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0])
    g = torch.Generator(device=device).manual_seed(s)
    return torch.rand(batches, B, slots, generator=g, device=device)


def assemble(bank: Dict[str, torch.Tensor], idx: torch.Tensor,
             scores: Optional[torch.Tensor], num_patches: int) -> Dict[str, torch.Tensor]:
    """Rows `idx` of `bank`, the patches subsampled with `scores` [B,
    slots] when given, embeddings widened to f32."""
    batch = {k: v.index_select(0, idx) for k, v in bank.items()}
    if scores is not None:
        mask = batch["patch_mask"]
        sel = torch.topk(torch.where(mask, scores, 2.0), num_patches, dim=1,
                         largest=False).indices
        patches = torch.gather(batch["patches"], 1,
                               sel[..., None].expand(-1, -1, batch["patches"].shape[-1]))
        keep = torch.gather(mask, 1, sel)
        batch["patches"], batch["patch_mask"] = patches * keep[..., None], keep
    for k in WIDENED:
        batch[k] = batch[k].float()
    batch["genes"] = batch["genes"].float()
    return batch


# ------------------------------------------------------------------- draws
def step_draws(rng: torch.Generator, n_critic: int, B: int, latent: int,
               device) -> Dict[str, torch.Tensor]:
    """One step's z [n_critic, B, latent], alpha [n_critic, B, 1] and
    generator z [B, latent], drawn in that order."""
    return {"z": torch.randn(n_critic, B, latent, generator=rng, device=device),
            "alpha": torch.rand(n_critic, B, 1, generator=rng, device=device),
            "z_gen": torch.randn(B, latent, generator=rng, device=device)}


# --------------------------------------------------------------- optimizer
class RMSprop:
    """RMSprop with global-norm clipping over the leaves of one net; `nu`
    may start from a run's second moments. `grads` keeps the last update's
    gradients as the optimizer took them (clipped)."""

    def __init__(self, params: Params, lr: float, clip: Optional[float],
                 steps_per_epoch: int, halve_every_epochs: int, nu: Optional[Params] = None):
        self.params = params
        self.lr, self.clip = lr, clip
        self.steps_per_epoch, self.halve_every = steps_per_epoch, halve_every_epochs
        self.nu = {k: (torch.zeros_like(v) if nu is None else nu[k].to(v.device).clone())
                   for k, v in params.items()}
        self.grads: Params = {}
        self.count = 0

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        if self.clip is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            grads = [g * scale for g in grads]
        epoch = self.count // max(self.steps_per_epoch, 1)
        lr = self.lr * 0.5 ** (epoch // self.halve_every)
        for (k, p), g in zip(self.params.items(), grads):
            nu = self.nu[k]
            nu.mul_(RMSPROP_DECAY).addcmul_(g, g, value=1 - RMSPROP_DECAY)
            p.sub_(lr * g / (nu.sqrt() + RMSPROP_EPS))
        self.grads = dict(zip(self.params, grads))
        self.count += 1


# --------------------------------------------------------------------- step
FAULTS = ("half_batch", "critic_half_batch", "no_gp", "no_drift")


def _penalty(grads: torch.Tensor) -> torch.Tensor:
    norms = torch.sqrt((grads * grads).sum(dim=1) + GP_NORM_EPS)
    return ((norms - 1.0) ** 2).mean()


def _half(x):
    if isinstance(x, dict):
        return {k: _half(v) for k, v in x.items()}
    return x[:x.shape[0] // 2]


class WGANGPReference:
    """The reference's training state and step: generator, critic, EMA
    generator (weights of the caller's, copied), the two optimizers (second
    moments from `g_nu` and `d_nu` when given, else nought).

    `dtype` is the configuration's compute dtype, in which the nets
    compute and with which the dropout masks are drawn; `precision` the
    products' operand rounding (the control); `fault` one of `FAULTS`
    other than "half_batch", which the caller plants in the batch."""

    def __init__(self, cfg: dict, gen: Params, critic: Params, steps_per_epoch: int,
                 dtype: torch.dtype, precision: Optional[str] = None,
                 fault: Optional[str] = None, ema: Optional[Params] = None,
                 g_nu: Optional[Params] = None, d_nu: Optional[Params] = None):
        t = cfg["train"]
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
        self.cfg, self.t, self.fault = cfg, t, fault
        self.prec = Precision(precision)
        self.gen = {k: v.detach().clone().requires_grad_(True) for k, v in gen.items()}
        self.critic = {k: v.detach().clone().requires_grad_(True) for k, v in critic.items()}
        self.ema = ({k: v.detach().clone() for k, v in (ema or gen).items()}
                    if t["ema_decay"] > 0 else None)
        self.g_opt = RMSprop(self.gen, t["lr_gen"], t["clip_grad_gen"], steps_per_epoch,
                             t["lr_halve_every_epochs"], g_nu)
        self.d_opt = RMSprop(self.critic, t["lr_disc"], t["clip_grad_disc"], steps_per_epoch,
                             t["lr_halve_every_epochs"], d_nu)
        p = cfg["fusion"]["dropout"]
        self.dropout = Dropout(p, dtype)
        net = model(cfg["architecture"]).Net
        self.G = net(cfg, self.gen, self.dropout, self.prec, dtype)
        self.D = net(cfg, self.critic, self.dropout, self.prec, dtype)

    def snapshot(self) -> Dict[str, Params]:
        """The state as the check keeps a run's: each net's parameters and
        each optimizer's second moments, copied to the host."""
        def host(params):
            return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}

        return {"gen": host(self.gen), "critic": host(self.critic),
                "ema": host(self.ema) if self.ema is not None else {},
                "g_nu": host(self.g_opt.nu), "d_nu": host(self.d_opt.nu)}

    def critic_update(self, real, cond, g_cvec, z, alpha):
        t = self.t
        if self.fault == "critic_half_batch":
            real, cond, g_cvec, z, alpha = (_half(x) for x in (real, cond, g_cvec, z, alpha))
        B = real.shape[0]
        with torch.no_grad():
            fake = self.G.score(z, g_cvec)
        cvec = self.D.embed(cond)
        interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
        scores = self.D.score(torch.cat([real, fake, interp], 0),
                              torch.cat([cvec, cvec, cvec], 0))
        gx, = torch.autograd.grad(scores[2 * B:].sum(), interp, create_graph=True)
        gp = _penalty(gx)
        d_real, d_fake = scores[:B], scores[B:2 * B]
        loss = (-d_real).mean() + d_fake.mean()
        total = loss if self.fault == "no_gp" else loss + t["gp_weight"] * gp
        if t["drift_epsilon"] > 0 and self.fault != "no_drift":
            total = total + t["drift_epsilon"] * ((d_real ** 2).mean() + (d_fake ** 2).mean())
        self.d_opt.update(torch.autograd.grad(total, list(self.critic.values())))
        return {"d_loss": loss.detach(), "gp": gp.detach(),
                "d_real": d_real.mean().detach(), "d_fake": d_fake.mean().detach()}

    def generator_update(self, cond, z):
        with torch.no_grad():
            d_cvec = self.D.embed(cond)
        fake = self.G.score(z, self.G.embed(cond))
        loss = (-self.D.score(fake, d_cvec)).mean()
        self.g_opt.update(torch.autograd.grad(loss, list(self.gen.values())))
        return loss.detach()

    def move_ema(self) -> None:
        if self.ema is not None:
            d = self.t["ema_decay"]
            with torch.no_grad():
                for k, e in self.ema.items():
                    e.mul_(d).add_(self.gen[k], alpha=1.0 - d)

    def critic_updates(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The step up to its generator update: the generator's embedding,
        then the `n_critic` critic updates; the last one's metrics."""
        real = batch["genes"]
        cond = {k: batch[k] for k in ("tokens", "token_mask", "patches", "patch_mask")}
        with torch.no_grad():
            g_cvec = self.G.embed(cond)
        for i in range(self.t["n_critic"]):
            metrics = self.critic_update(real, cond, g_cvec, draws["z"][i], draws["alpha"][i])
        return metrics

    def step(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """One step on `batch` (genes and conditioning, f32) with `draws`
        (`step_draws`); returns the last critic update's d_loss, gp,
        d_real, d_fake and the generator's g_loss."""
        metrics = self.critic_updates(batch, draws)
        cond = {k: batch[k] for k in ("tokens", "token_mask", "patches", "patch_mask")}
        metrics["g_loss"] = self.generator_update(cond, draws["z_gen"])
        self.move_ema()
        return metrics
