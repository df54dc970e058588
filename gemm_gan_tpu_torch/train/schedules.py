"""The optimizers of the WGAN-GP step (RMSprop, Adam and AdamW under the
halving schedule) and of the VAE (Adam under `warmup_exp_decay`), with
global-norm clipping.

Counterpart of `gemm_gan_tpu/train/schedules.py`, written
with `torch._foreach_*` so that an update reads nothing from the host: the
update count lives on the device (`count_t`) and the rate is computed
there from it, so a CUDA graph that captured an update replays it with the
rate of each replay's count. The host's `count` mirrors it for `lr` and for
callers; whoever runs updates without `apply` (the engine's step, a graph's
replays) advances it.

* RMSprop is optax's `rmsprop(decay=0.99, eps=1e-8, eps_in_sqrt=False)`,
  torch's RMSprop with alpha 0.99: nu = 0.99 nu + 0.01 g², update
  -lr g / (sqrt(nu) + 1e-8).
* Adam is optax's `adam(b1=adam_b1, b2=adam_b2, eps=1e-8)`: bias-corrected
  moments of the optimizer's own update count; AdamW adds optax's decoupled
  `weight_decay` times the params (before the update) to the Adam update
  ahead of the rate.
* The rate halves every `lr_halve_every_epochs` epochs of THIS optimizer's
  own updates, as optax's `scale_by_schedule` counts them: the critic's
  optimizer updates `n_critic` times per step, so its rate halves
  `n_critic` times sooner, in steps, than the generator's.
* Clipping is optax's `clip_by_global_norm`: the gradients are scaled by
  max/‖g‖ only when ‖g‖ >= max. `torch.nn.utils.clip_grad_norm_` adds
  1e-6 to the norm and is not used. ‖g‖ is the norm of the tensors'
  norms (one `_foreach_norm`), which differs from optax's sum of squares
  only in its summation order.
* Under a mesh (`mesh`), `update` first averages the gradients over the
  `data` axis (one all-reduce), and the global norm counts the squares of
  the `model`-sharded parameters (`sharded`) summed over `model` and each
  replicated parameter once: JAX's global norm over its global arrays.
  The moments are made like the parameters, so a sharded parameter's are
  its shard's.
* `schedule` replaces the halving schedule by any function of the update
  count that takes a device tensor, such as `warmup_exp_decay` (the VAE's
  linear warmup, then exponential decay, per epoch of updates).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Union

import torch

from gemm_gan_tpu_torch.config import TrainConfig
from gemm_gan_tpu_torch.utils.metrics import TRACER

RMSPROP_ALPHA = 0.99
EPS = 1e-8
OPTIMIZERS = ("rmsprop", "adam", "adamw")


def halving_lr(base_lr: float, count: int, steps_per_epoch: int,
               halve_every_epochs: int) -> float:
    """The rate of update number `count` (0-based)."""
    epoch = count // max(steps_per_epoch, 1)
    return base_lr * 0.5 ** (epoch // halve_every_epochs)


def warmup_exp_decay(base_lr: float, steps_per_epoch: int, warmup_epochs: int,
                     decay_per_epoch: float) -> Callable:
    """The VAE's rate as a function of the update count (an int, or a
    device tensor for an in-graph rate, computed there in f32): epoch =
    count / steps_per_epoch, base_lr * epoch / warmup_epochs while epoch <
    warmup_epochs, then base_lr * decay_per_epoch ** (epoch - warmup_epochs).
    The first update's rate is 0, as optax's."""
    def schedule(count: Union[int, torch.Tensor]):
        if not isinstance(count, torch.Tensor):
            return float(schedule(torch.tensor(count)))
        epoch = count.float() / max(steps_per_epoch, 1)
        warm = epoch / max(warmup_epochs, 1e-8)
        decay = torch.pow(decay_per_epoch, epoch - warmup_epochs)
        return base_lr * torch.where(epoch < warmup_epochs, warm, decay)
    return schedule


def _norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """‖grads‖ as an f64 device scalar: one multi-tensor norm of the
    tensors, then the norm of their norms, whatever the number of tensors.
    The f64 output keeps the CPU's norm exact: there each tensor's f32 norm
    is a plain sum, off by 1e-4 at a few M entries; on the card the
    multi-tensor kernel sums in f32 either way."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float64)))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Optional[List[bool]] = None, mesh=None) -> None:
    """Scale `grads` in place by max_norm / ‖grads‖ when the global norm is
    at least `max_norm` (no host synchronisation). `sharded[i]`: grads[i]
    is this rank's block of a parameter sharded over the mesh's `model`
    axis, whose squares are summed over it. A fixed handful of ops
    (`_norm`, the scale, one `_foreach_mul_`) for any number of tensors."""
    TRACER.count("clip_norms")
    if sharded is None or not any(sharded):
        norm = _norm(grads)
    else:
        from gemm_gan_tpu_torch.parallel import comm

        def square(gs):
            return _norm(gs).square() if gs else grads[0].new_zeros((), dtype=torch.float64)

        part = comm.all_reduce_(square([g for g, s in zip(grads, sharded) if s]),
                                mesh, "model")
        norm = torch.sqrt(square([g for g, s in zip(grads, sharded) if not s]) + part)
    norm = norm.to(grads[0].dtype)  # `_foreach_mul_` takes one launch for a scale of its dtype
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


class ScheduledOptimizer:
    """`cfg.optimizer` over `params` with the halving schedule (or
    `schedule`) and optional clipping.

    `update(grads)` takes one gradient per parameter, in order, and updates
    the parameters in place from device state alone; `apply(grads)` is
    `update` and `count += 1`. `nu` holds the second moments (RMSprop's and
    Adam's), `mu` Adam's first moments."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: TrainConfig,
                 lr: float, steps_per_epoch: int, clip_grad: Optional[float] = None,
                 schedule: Optional[Callable] = None, mesh=None,
                 sharded: Optional[List[bool]] = None):
        if cfg.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.kind = cfg.optimizer
        self.params = list(params)
        self.base_lr = lr
        self.steps_per_epoch = steps_per_epoch
        self.halve_every_epochs = cfg.lr_halve_every_epochs
        self.clip_grad = clip_grad
        self.schedule = schedule
        self.mesh = mesh
        self.sharded = sharded
        self.b1, self.b2, self.weight_decay = cfg.adam_b1, cfg.adam_b2, cfg.weight_decay
        self.count = 0
        device = self.params[0].device
        self.count_t = torch.zeros((), dtype=torch.int64, device=device)
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.mu = ([torch.zeros_like(p) for p in self.params] if self.kind != "rmsprop"
                   else None)

    @property
    def lr(self) -> float:
        """The rate the next update uses."""
        if self.schedule is not None:
            return self.schedule(self.count)
        return halving_lr(self.base_lr, self.count, self.steps_per_epoch,
                          self.halve_every_epochs)

    def _lr_t(self) -> torch.Tensor:
        """`lr` from `count_t`, on the device (f32)."""
        if self.schedule is not None:
            return self.schedule(self.count_t)
        epoch = torch.div(self.count_t, max(self.steps_per_epoch, 1), rounding_mode="floor")
        halvings = torch.div(epoch, self.halve_every_epochs, rounding_mode="floor")
        return self.base_lr * torch.pow(0.5, halvings.float())

    @torch.no_grad()
    def update(self, grads: Iterable[torch.Tensor]) -> None:
        grads = list(grads)
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if self.mesh is not None:
            from gemm_gan_tpu_torch.parallel import comm

            grads = comm.mean_over(grads, self.mesh, "data")
        if self.clip_grad is not None:
            clip_by_global_norm_(grads, self.clip_grad, self.sharded, self.mesh)
        if self.kind == "rmsprop":
            torch._foreach_mul_(self.nu, RMSPROP_ALPHA)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1 - RMSPROP_ALPHA)
            denom = torch._foreach_sqrt(self.nu)
            torch._foreach_add_(denom, EPS)
            step = torch._foreach_div(grads, denom)
        else:
            torch._foreach_mul_(self.mu, self.b1)
            torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
            torch._foreach_mul_(self.nu, self.b2)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
            n = (self.count_t + 1).float()
            mu_hat = torch._foreach_mul(self.mu, 1 / (1 - torch.pow(self.b1, n)))
            denom = torch._foreach_mul(self.nu, 1 / (1 - torch.pow(self.b2, n)))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, EPS)
            step = torch._foreach_div(mu_hat, denom)
            if self.kind == "adamw":
                torch._foreach_add_(step, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(step, self._lr_t())
        torch._foreach_sub_(self.params, step)
        self.count_t.add_(1)

    def apply(self, grads: Iterable[torch.Tensor]) -> None:
        self.update(grads)
        self.count += 1
