"""The fused WGAN-GP training step on the card.

Counterpart of `gemm_gan_tpu/train/wgan.py::WGANGPEngine`. One `step` is
`n_critic` critic updates (the same real batch, fresh z and α each, the
gradient penalty taken w.r.t. the interpolated expression only) and one
generator update, each followed by its optimizer's update. PyTorch runs
it eagerly; every attention backward goes through the CUDA kernels of
`kernels/flash_attention.py`.

Two paths, as in the JAX package:

* `train.cond_embed_reuse="per_update"` (the production setting): the
  generator embeds the conditioning once per step (no grad: its params are
  constant across the critic updates); each critic update embeds it once
  with grad and scores real, fake and the penalty's interpolates through
  that one vector, with `batched_scores` as one [3B] trunk call; the
  generator update embeds the critic's side once without grad.
* `"per_call"` (the library default): every forward embeds afresh.

The penalty's inner gradient reaches only the critic's trunk, so attention
is differentiated once (the kernels' autograd Functions are first order).

Randomness: z and α come from `state.rng`, or from `draws` when the caller
passes them (the tests rebuild them from the JAX key schedule). Dropout
masks come from PyTorch's default generator of the device; seed it with
`torch.manual_seed` for a repeatable run.

Not ported (raise `NotImplementedError`): `ema_decay > 0`, `p_aug > 0`,
`grad_accum > 1`, `hoist_fakes=True` on the per_update batched path, and
what `models.gan.check_supported` refuses (bf16, other fusions).
`critic_scan` changes nothing here: the critic updates are a Python loop
either way.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from gemm_gan_tpu_torch.config import ExperimentConfig
from gemm_gan_tpu_torch.convert import flax_to_state_dict
from gemm_gan_tpu_torch.models.gan import Critic, Generator
from gemm_gan_tpu_torch.serving import GeneratorServer, cond_keys_for
from gemm_gan_tpu_torch.train import losses
from gemm_gan_tpu_torch.train.schedules import ScheduledRMSprop
from gemm_gan_tpu_torch.train.state import GANTrainState
from gemm_gan_tpu_torch.utils.device import DeviceLike, resolve_device

Batch = Mapping[str, Any]


class WGANGPEngine:
    def __init__(self, cfg: ExperimentConfig, steps_per_epoch: int = 1,
                 device: DeviceLike = None):
        t = cfg.train
        if t.n_critic < 1:
            raise ValueError(f"train.n_critic must be >= 1, got {t.n_critic}")
        if cfg.model.use_batchnorm:
            raise ValueError("model.use_batchnorm=True is not supported by the "
                             "WGAN-GP engine: the per-sample gradient penalty "
                             "needs a critic without batch statistics")
        if t.cond_embed_reuse not in ("per_call", "per_update"):
            raise ValueError(f"cond_embed_reuse must be 'per_call' or 'per_update', "
                             f"got {t.cond_embed_reuse!r}")
        self.reuse = t.cond_embed_reuse == "per_update"
        for name, unported in (
                ("train.ema_decay > 0", t.ema_decay > 0),
                ("train.p_aug > 0", t.p_aug > 0),
                ("train.grad_accum > 1", t.grad_accum > 1),
                ("train.hoist_fakes=True", t.hoist_fakes and self.reuse
                 and t.batched_scores)):
            if unported:
                raise NotImplementedError(f"{name} is not ported")
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)
        self.keys = cond_keys_for(cfg.model.fusion)
        self.history: Dict[str, list] = {"d_loss": [], "g_loss": []}

    # ------------------------------------------------------------------ state
    def _state(self, gen: Generator, critic: Critic, seed: int) -> GANTrainState:
        t = self.cfg.train
        g_opt = ScheduledRMSprop(gen.parameters(), t, t.lr_gen, self.steps_per_epoch,
                                 t.clip_grad_gen)
        d_opt = ScheduledRMSprop(critic.parameters(), t, t.lr_disc, self.steps_per_epoch,
                                 t.clip_grad_disc)
        rng = torch.Generator(device=self.device).manual_seed(seed)
        return GANTrainState(0, gen, critic, g_opt, d_opt, rng)

    def init_state(self, seed: int, sample_batch: Batch) -> GANTrainState:
        """Fresh nets (Flax-like random init from `seed`) and optimizers.
        `sample_batch` is checked for the keys a step reads."""
        self._tensors(sample_batch)
        m = self.cfg.model
        init = torch.Generator().manual_seed(seed)
        gen = Generator(m, device=self.device, generator=init)
        critic = Critic(m, device=self.device, generator=init)
        return self._state(gen, critic, seed)

    def state_from_flax(self, g_params: Mapping, d_params: Mapping,
                        seed: Optional[int] = None) -> GANTrainState:
        """A state whose nets carry a JAX run's Flax params (numpy trees, e.g.
        `jax.device_get(state.g_params)`), with fresh optimizers."""
        m = self.cfg.model
        gen = Generator(m, device=self.device)
        gen.load_state_dict(flax_to_state_dict(g_params))
        critic = Critic(m, device=self.device)
        critic.load_state_dict(flax_to_state_dict(d_params))
        return self._state(gen, critic, self.cfg.train.seed if seed is None else seed)

    # ------------------------------------------------------------- the step
    def _tensors(self, batch: Batch):
        """(real [B, n_genes] f32, cond dict or None) on the device."""
        missing = [k for k in ("genes", *self.keys) if k not in batch]
        if missing:
            raise ValueError(f"batch lacks keys {missing}")
        real = torch.as_tensor(batch["genes"], dtype=torch.float32, device=self.device)
        cond = ({k: torch.as_tensor(batch[k], device=self.device) for k in self.keys}
                if self.keys else None)
        return real, cond

    def _normal(self, state: GANTrainState, B: int) -> torch.Tensor:
        return torch.randn(B, self.cfg.model.latent_dim, generator=state.rng,
                           device=self.device)

    def embed_generator(self, state: GANTrainState, cond) -> Optional[torch.Tensor]:
        """per_update: the generator's condition embedding for the step's
        fakes (no grad). None on the per_call path."""
        if not self.reuse or cond is None:
            return None
        with torch.no_grad():
            return state.gen.embed_cond(cond)

    def _critic_scores(self, critic: Critic, real, fake, cond, alpha):
        """(d_real, d_fake, gp) of one critic update, on the graph."""
        t = self.cfg.train
        if self.reuse:
            cvec = critic.embed_cond(cond)
            if t.batched_scores:
                cv = None if cvec is None else torch.cat([cvec, cvec, cvec], dim=0)
                return losses.batched_scores_and_gp(
                    lambda x: critic.score(x, cv), real, fake, alpha)
            d_real = critic.score(real, cvec)
            d_fake = critic.score(fake, cvec)
        else:
            d_real = critic(real, cond)
            d_fake = critic(fake, cond)
            cvec = critic.embed_cond(cond)
        gp = losses.gradient_penalty(lambda x: critic.score(x, cvec), real, fake, alpha)
        return d_real, d_fake, gp

    def critic_update(self, state: GANTrainState, real, cond, g_cvec, z, alpha):
        """One critic update on fakes made from `z`; returns the detached
        (Wasserstein loss E[D(fake)] - E[D(real)], gp, mean D(real), mean
        D(fake)). The update descends that loss + gp_weight * gp (+ drift)."""
        t = self.cfg.train
        with torch.no_grad():
            fake = (state.gen.score(z, g_cvec) if g_cvec is not None
                    else state.gen(z, cond))
        d_real, d_fake, gp = self._critic_scores(state.critic, real, fake, cond, alpha)
        loss = losses.d_loss(d_real, d_fake)[0]
        total = loss + t.gp_weight * gp
        if t.drift_epsilon > 0:
            total = total + t.drift_epsilon * losses.drift_penalty(d_real, d_fake)
        state.d_opt.apply(torch.autograd.grad(total, state.d_opt.params))
        return tuple(x.detach() for x in (loss, gp, d_real.mean(), d_fake.mean()))

    def generator_update(self, state: GANTrainState, cond, z) -> torch.Tensor:
        """One generator update; returns the detached generator loss."""
        critic = state.critic
        d_cvec = None
        if self.reuse and cond is not None:
            # no generator gradient flows through the critic's fusion
            with torch.no_grad():
                d_cvec = critic.embed_cond(cond)
        fake = state.gen(z, cond)
        scores = critic.score(fake, d_cvec) if d_cvec is not None else critic(fake, cond)
        gl = losses.g_loss(scores)
        state.g_opt.apply(torch.autograd.grad(gl, state.g_opt.params))
        return gl.detach()

    def step(self, state: GANTrainState, batch: Batch,
             draws: Optional[Mapping[str, Any]] = None):
        """One fused step. Returns (state, metrics), metrics as 0-d tensors
        on the device, as the JAX engine reports them: d_loss (the
        Wasserstein part, without the penalty), gp, d_real, d_fake of the
        last critic update, and g_loss.

        `draws` replaces the step's random draws: "z" [n_critic, B, latent]
        and "alpha" [n_critic, B, 1] for the critic updates, "z_gen"
        [B, latent] for the generator update."""
        n_critic = self.cfg.train.n_critic
        real, cond = self._tensors(batch)
        B = real.shape[0]
        if draws is not None:
            draws = {k: torch.tensor(np.asarray(draws[k]), dtype=torch.float32,
                                     device=self.device) for k in ("z", "alpha", "z_gen")}
        state.gen.train()
        state.critic.train()
        g_cvec = self.embed_generator(state, cond)
        aux = None
        for i in range(n_critic):
            if draws is None:
                z = self._normal(state, B)
                alpha = torch.rand(B, 1, generator=state.rng, device=self.device)
            else:
                z, alpha = draws["z"][i], draws["alpha"][i]
            aux = self.critic_update(state, real, cond, g_cvec, z, alpha)
        z = self._normal(state, B) if draws is None else draws["z_gen"]
        gl = self.generator_update(state, cond, z)
        d_loss, gp, d_real, d_fake = aux
        state.step += 1
        return state, {"d_loss": d_loss, "g_loss": gl, "gp": gp,
                       "d_real": d_real, "d_fake": d_fake}

    # -------------------------------------------------------------- the loop
    def fit(self, state: GANTrainState, epochs: int,
            batches_fn: Callable[[], Iterable[Batch]],
            on_epoch_end: Optional[Callable] = None) -> GANTrainState:
        """`epochs` passes over `batches_fn()`; `history` keeps each epoch's
        last d_loss and g_loss. `on_epoch_end(engine, state, epoch)` may
        return a replacement state."""
        self.history = {"d_loss": [], "g_loss": []}
        for epoch in range(epochs):
            metrics = None
            for batch in batches_fn():
                state, metrics = self.step(state, batch)
            if metrics is not None:
                self.history["d_loss"].append(float(metrics["d_loss"]))
                self.history["g_loss"].append(float(metrics["g_loss"]))
            if on_epoch_end is not None:
                state = on_epoch_end(self, state, epoch) or state
        return state

    # -------------------------------------------------------------- sampling
    def generate_samples(self, state: GANTrainState, generator: torch.Generator,
                         batch: Batch) -> torch.Tensor:
        """Fakes [B, n_genes] (on the device) for one batch's conditioning,
        one embedding per batch, z drawn from `generator`."""
        server = GeneratorServer.for_module(state.gen)
        return server.sample(batch if self.keys else None, generator,
                             n=None if self.keys else batch["genes"].shape[0])

    def generate_samples_all(self, state: GANTrainState, batches: Iterable[Batch],
                             num_repeats: int, generator: torch.Generator
                             ) -> Dict[str, Any]:
        """`GeneratorServer.sample_all` with the state's generator."""
        return GeneratorServer.for_module(state.gen).sample_all(batches, num_repeats,
                                                               generator)
