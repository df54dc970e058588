"""The VAE / CVAE training engine.

Counterpart of `gemm_gan_tpu/train/vae.py::VAEEngine`: the β-ELBO objective
(MSE or Gaussian-NLL reconstruction + analytic KL) of `models/vae.py`, its
gradient clipped to a global norm of `train.vae_clip_grad` (optax's clip:
no epsilon on the norm), then Adam (b1 0.9, b2 0.999, eps 1e-8: optax's
defaults) under `warmup_exp_decay`, whose rate is computed on the device
from the update count, so a captured step replays with each replay's rate.

Three ways to run steps, one body (`_fused_step`, which reads device
tensors only and changes no host state):

* `step(state, batch)`: one step, eagerly;
* `step_many(state, stacked)`: the JAX `step_many` (`lax.scan` over [K, B,
  ...] batches); the stack is copied once into static device buffers and,
  on the card, one captured CUDA graph of the step is replayed K times
  (`train.wgan._StepGraph`, after one eager warm-up step); on the CPU the
  body runs in a loop. Graphed and eager steps are bitwise equal;
* `fit`, with JAX's `stacked_fn`, `start_epoch` and `on_epoch_end`.

Randomness: the reparameterization noise comes from `state.rng` (registered
with a captured graph), or from `eps` when the caller passes it (the tests
feed JAX's draws); `sample` and `eval_loss` draw from the caller's
generator. The VAE launches no attention kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import torch

from gemm_gan_tpu_torch.config import ExperimentConfig
from gemm_gan_tpu_torch.convert import flax_to_state_dict
from gemm_gan_tpu_torch.models.vae import CVAE, VAE, elbo_loss
from gemm_gan_tpu_torch.serving import to_device
from gemm_gan_tpu_torch.train.schedules import ScheduledOptimizer, warmup_exp_decay
from gemm_gan_tpu_torch.train.state import VAETrainState
from gemm_gan_tpu_torch.train.wgan import _buffer_dtype, _host_tensor, _row, _StepGraph
from gemm_gan_tpu_torch.utils.device import DeviceLike, host, resolve_device

Batch = Mapping[str, Any]
# optax.adam's defaults, which the JAX engine takes
ADAM_B1, ADAM_B2 = 0.9, 0.999


class VAEEngine:
    def __init__(self, cfg: ExperimentConfig, steps_per_epoch: int = 1,
                 conditional: Optional[bool] = None, device: DeviceLike = None):
        self.cfg = cfg
        self.conditional = (cfg.variant == "cvae") if conditional is None else conditional
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)
        self.keys = ("genes", "disease", "site") if self.conditional else ("genes",)
        t = cfg.train
        self.schedule = warmup_exp_decay(t.vae_lr, steps_per_epoch, t.vae_warmup_epochs,
                                         t.vae_lr_decay)
        self.history: Dict[str, list] = {"loss": [], "recon": [], "kl": []}
        self._graphs: Dict[tuple, _StepGraph] = {}

    # ------------------------------------------------------------------ state
    def _model(self, generator: Optional[torch.Generator] = None):
        cls = CVAE if self.conditional else VAE
        return cls(self.cfg.model, device=self.device, generator=generator)

    def _state(self, model, seed: int) -> VAETrainState:
        t = self.cfg.train
        adam = dataclasses.replace(t, optimizer="adam", adam_b1=ADAM_B1, adam_b2=ADAM_B2)
        opt = ScheduledOptimizer(model.parameters(), adam, t.vae_lr, self.steps_per_epoch,
                                 t.vae_clip_grad, schedule=self.schedule)
        return VAETrainState(0, model, opt, torch.Generator(device=self.device).manual_seed(seed))

    def init_state(self, seed: int, sample_batch: Batch) -> VAETrainState:
        """A fresh model (Flax-like random init from `seed`) and optimizer;
        `sample_batch` is checked for the keys a step reads."""
        self._tensors(sample_batch)
        return self._state(self._model(torch.Generator().manual_seed(seed)), seed)

    def state_from_flax(self, params: Mapping, seed: Optional[int] = None) -> VAETrainState:
        """A state whose model carries a JAX run's Flax params (a numpy
        tree), with a fresh optimizer."""
        model = self._model()
        model.load_state_dict(flax_to_state_dict(params))
        return self._state(model, self.cfg.train.seed if seed is None else seed)

    # ------------------------------------------------------------- the step
    def _tensors(self, batch: Batch) -> tuple:
        """(genes f32, and for the CVAE disease and site) on the device."""
        missing = [k for k in self.keys if k not in batch]
        if missing:
            raise ValueError(f"batch lacks keys {missing}")
        return tuple(to_device(batch[k], self.device) for k in self.keys)

    def _eps(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return torch.randn(n, self.cfg.model.vae_latent_dim, generator=generator,
                           device=self.device)

    def _losses(self, model, inputs: tuple, eps: torch.Tensor) -> tuple:
        out, mu, logvar = model(*inputs, eps)
        loss, (r, kl) = elbo_loss(inputs[0], out, mu, logvar, self.cfg.train.vae_beta,
                                  self.cfg.model.vae_recon)
        return loss, r, kl

    def _fused_step(self, state: VAETrainState, inputs: tuple,
                    eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The step's device work; no host state changes and no host
        synchronisation, so a CUDA graph can capture it."""
        if eps is None:
            eps = self._eps(state.rng, inputs[0].shape[0])
        loss, r, kl = self._losses(state.model, inputs, eps)
        state.opt.update(torch.autograd.grad(loss, state.opt.params))
        return {"loss": loss.detach(), "recon": r.detach(), "kl": kl.detach()}

    def _advance(self, state: VAETrainState, n: int) -> None:
        state.step += n
        state.opt.count += n

    def step(self, state: VAETrainState, batch: Batch, eps=None):
        """One step. Returns (state, metrics), metrics 0-d tensors on the
        device: loss (β-ELBO), recon, kl. `eps` [B, latent] replaces the
        reparameterization draw."""
        if eps is not None:
            eps = to_device(eps, self.device)
        metrics = self._fused_step(state, self._tensors(batch), eps)
        self._advance(state, 1)
        return state, metrics

    def step_many(self, state: VAETrainState, stacked: Mapping[str, Any], eps=None):
        """K steps over batches stacked on a leading axis [K, B, ...] (`eps`
        likewise [K, B, latent]); returns (state, metrics of the last step).
        One graph is kept per batch layout and state, and reused for any K up
        to its buffers' rows."""
        arrays = {k: _host_tensor(stacked[k]) for k in self.keys}
        if eps is not None:
            arrays["eps"] = _host_tensor(eps).float()
        K = len(arrays["genes"])
        if K < 1 or any(len(x) != K for x in arrays.values()):
            raise ValueError(f"step_many needs K >= 1 batches on every key's leading "
                             f"axis, got {[tuple(x.shape) for x in arrays.values()]}")
        layout = tuple((k, tuple(x.shape[1:]), _buffer_dtype(x)) for k, x in arrays.items())
        graph = self._graphs.get(layout)
        if graph is None or graph.state is not state or len(graph.buffers["genes"]) < K:
            buffers = {k: torch.empty((K, *shape), dtype=dtype, device=self.device)
                       for k, shape, dtype in layout}
            graph = _StepGraph(self, state, buffers, self._stacked_inputs(buffers))
            self._graphs[layout] = graph
        for k, x in arrays.items():
            if x.device.type == "cpu" and self.device.type == "cuda":
                x = x.pin_memory()
            graph.buffers[k][:K].copy_(x, non_blocking=True)
        metrics = graph.run(K)
        self._advance(state, K)
        return state, metrics

    def _stacked_inputs(self, buffers: Dict[str, torch.Tensor]) -> Callable:
        keys = self.keys

        def inputs(i):
            eps = _row(buffers["eps"], i) if "eps" in buffers else None
            return tuple(_row(buffers[k], i) for k in keys), eps

        return inputs

    # -------------------------------------------------------------- the loop
    def fit(self, state: VAETrainState, epochs: int,
            batches_fn: Optional[Callable[[], Iterable[Batch]]] = None, logger=None,
            stacked_fn: Optional[Callable] = None, on_epoch_end: Optional[Callable] = None,
            start_epoch: int = 0) -> VAETrainState:
        """Epochs [start_epoch, epochs): `stacked_fn(epoch)` (a [K, B, ...]
        stack) through `step_many`, else `batches_fn()` through `step`.
        `history` keeps each epoch's last loss, recon and kl;
        `on_epoch_end(engine, state, epoch)` may return a replacement state."""
        if batches_fn is None and stacked_fn is None:
            raise ValueError("fit() needs batches_fn or stacked_fn")
        history = {"loss": [], "recon": [], "kl": []}
        for epoch in range(start_epoch, epochs):
            last = None
            if stacked_fn is not None:
                state, last = self.step_many(state, stacked_fn(epoch))
            else:
                for batch in batches_fn():
                    state, last = self.step(state, batch)
            if last is not None:
                for k in history:
                    history[k].append(float(last[k]))
                if logger is not None:
                    logger.log(state.step, **last)
            if on_epoch_end is not None:
                state = on_epoch_end(self, state, epoch) or state
        self.history = history
        return state

    # ------------------------------------------------------ evaluation, sampling
    @torch.no_grad()
    def eval_loss(self, state: VAETrainState, generator: torch.Generator, batch: Batch,
                  eps=None) -> Dict[str, float]:
        """The β-ELBO of one batch without a gradient or an update (the
        validation criterion of gate-best selection), its noise drawn from
        `generator` (or `eps`)."""
        inputs = self._tensors(batch)
        eps = (self._eps(generator, inputs[0].shape[0]) if eps is None else
               to_device(eps, self.device))
        loss, r, kl = self._losses(state.model, inputs, eps)
        return {"loss": float(loss), "recon": float(r), "kl": float(kl)}

    @torch.no_grad()
    def sample(self, state: VAETrainState, generator: torch.Generator,
               num: Optional[int] = None, disease=None, site=None, z=None,
               device_out: bool = False):
        """Profiles decoded from prior draws z [n, latent] (drawn from
        `generator` unless given): `num` of them, or for the CVAE one per
        (disease, site) label. A numpy array, or a device tensor with
        `device_out`."""
        if self.conditional:
            labels = tuple(to_device(v, self.device) for v in (disease, site))
            num = len(labels[0])
        else:
            labels = ()
        z = self._eps(generator, num) if z is None else to_device(z, self.device)
        out = state.model.sample(z, *labels)
        return out if device_out else host(out)
