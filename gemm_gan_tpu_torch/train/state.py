"""The training states of the WGAN-GP engine and of the VAE engine.

Counterpart of `gemm_gan_tpu/train/state.py` (`GANTrainState`,
`VAETrainState`). Where the JAX state is an immutable pytree, this one
holds the modules and optimizers themselves; `WGANGPEngine.step` (and
`VAEEngine.step`) updates them in place (no second copy of
the weights) and returns the same object with `step` advanced. In-place
updates also keep every tensor at its address, which a CUDA graph of the
step needs (`WGANGPEngine.step_many`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn

from gemm_gan_tpu_torch.models.gan import Critic, Generator
from gemm_gan_tpu_torch.train.schedules import ScheduledOptimizer


@dataclass(eq=False)
class GANTrainState:
    step: int                  # fused steps taken
    gen: Generator
    critic: Critic
    g_opt: ScheduledOptimizer  # each counts its own updates (`.count`)
    d_opt: ScheduledOptimizer
    rng: torch.Generator       # the run's z, α and instance-noise draws, on the engine's device
    # EMA of the generator (`train.ema_decay` > 0), None when off
    g_ema: Optional[Generator] = None


@dataclass(eq=False)
class VAETrainState:
    step: int                  # steps taken
    model: nn.Module           # a `models.vae.VAE` or `CVAE`
    opt: ScheduledOptimizer    # Adam under warmup_exp_decay, its moments and counts
    rng: torch.Generator       # the reparameterization draws, on the engine's device


TrainState = Union[GANTrainState, VAETrainState]
