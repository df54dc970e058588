"""The training state of the WGAN-GP engine.

Counterpart of `gemm_gan_tpu/train/state.py::GANTrainState`. Where the JAX
state is an immutable pytree, this one holds the modules and optimizers
themselves; `WGANGPEngine.step` updates them in place (no second copy of
the weights) and returns the same object with `step` advanced.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gemm_gan_tpu_torch.models.gan import Critic, Generator
from gemm_gan_tpu_torch.train.schedules import ScheduledRMSprop


@dataclass
class GANTrainState:
    step: int                # fused steps taken
    gen: Generator
    critic: Critic
    g_opt: ScheduledRMSprop  # each counts its own updates (`.count`)
    d_opt: ScheduledRMSprop
    rng: torch.Generator     # the run's z and α draws, on the engine's device
