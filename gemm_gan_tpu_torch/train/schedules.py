"""The optimizer of the WGAN-GP step: RMSprop, the halving schedule and
global-norm clipping.

Counterpart of `gemm_gan_tpu/train/schedules.py::make_optimizer`:

* RMSprop is torch's own with alpha 0.99 and eps 1e-8 outside the sqrt,
  the update optax's `rmsprop(decay=0.99, eps=1e-8, eps_in_sqrt=False)`
  makes.
* The learning rate halves every `lr_halve_every_epochs` epochs of THIS
  optimizer's own updates, as optax's `scale_by_schedule` counts them: the
  critic's optimizer updates `n_critic` times per step, so its rate halves
  `n_critic` times sooner, in steps, than the generator's.
* Clipping is optax's `clip_by_global_norm`: the gradients are scaled by
  max/‖g‖ only when ‖g‖ >= max. `torch.nn.utils.clip_grad_norm_` adds
  1e-6 to the norm and is not used.

Adam and AdamW raise `NotImplementedError`: not ported yet.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from gemm_gan_tpu_torch.config import TrainConfig

RMSPROP_ALPHA = 0.99
RMSPROP_EPS = 1e-8


def halving_lr(base_lr: float, count: int, steps_per_epoch: int,
               halve_every_epochs: int) -> float:
    """The rate of update number `count` (0-based)."""
    epoch = count // max(steps_per_epoch, 1)
    return base_lr * 0.5 ** (epoch // halve_every_epochs)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale `grads` in place by max_norm / ‖grads‖ when the global norm is
    at least `max_norm` (no host synchronisation)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


class ScheduledRMSprop:
    """RMSprop over `params` with the halving schedule and optional clipping.

    `apply(grads)` takes one gradient per parameter, in order, and updates
    the parameters in place. `count` is the number of updates made."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: TrainConfig,
                 lr: float, steps_per_epoch: int, clip_grad: Optional[float] = None):
        if cfg.optimizer in ("adam", "adamw"):
            raise NotImplementedError(f"optimizer {cfg.optimizer!r} is not ported; "
                                      f"the port trains with 'rmsprop'")
        if cfg.optimizer != "rmsprop":
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.params = list(params)
        self.base_lr = lr
        self.steps_per_epoch = steps_per_epoch
        self.halve_every_epochs = cfg.lr_halve_every_epochs
        self.clip_grad = clip_grad
        self.count = 0
        self.rmsprop = torch.optim.RMSprop(self.params, lr=lr, alpha=RMSPROP_ALPHA,
                                           eps=RMSPROP_EPS)

    @property
    def lr(self) -> float:
        """The rate the next update uses."""
        return halving_lr(self.base_lr, self.count, self.steps_per_epoch,
                          self.halve_every_epochs)

    def apply(self, grads: Iterable[torch.Tensor]) -> None:
        grads = list(grads)
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if self.clip_grad is not None:
            clip_by_global_norm_(grads, self.clip_grad)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.rmsprop.param_groups:
            group["lr"] = self.lr
        self.rmsprop.step()
        for p in self.params:
            p.grad = None
        self.count += 1
