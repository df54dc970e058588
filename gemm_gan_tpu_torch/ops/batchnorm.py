"""Batch normalization over the feature axis, as Flax's `nn.BatchNorm`.

Counterpart of the `nn.BatchNorm(use_running_average=not train,
dtype=self.dtype)` of `gemm_gan_tpu/ops/mlp.py` with Flax's defaults
(momentum 0.99, epsilon 1e-5, fast variance, f32 reductions):

* `train=True` normalizes by the batch's statistics: the mean and the
  mean of squares over every axis but the last, in f32 (a bf16 input is
  upcast first), the variance E[x^2] - E[x]^2 clipped at 0 (the biased
  variance), and updates the running buffers as Flax's
  `mutable=["batch_stats"]` apply does: r = momentum r + (1 - momentum) s;
* otherwise it normalizes by the running buffers.

Either way y = (x - mean) * (rsqrt(var + eps) * weight) + bias in f32,
cast to the module's dtype at the end. `torch.nn.BatchNorm1d` is not a
drop-in: it updates the running variance with the unbiased variance.
The buffers (`running_mean`, `running_var`) are Flax's `batch_stats`
collection (`mean`, `var`); `convert.py` maps both ways.

Under a mesh with a `data` axis of more than one rank (`mesh`, set by
`models.gan`), each rank holds its rows of the batch, and the statistics
are the global batch's, as JAX's over its global arrays: each rank's sums
of x and x² and its row count are all-reduced over `data` (one call,
differentiable) before the f32 E[x²] - E[x]².
"""

from __future__ import annotations

import torch
from torch import nn


MOMENTUM, EPSILON = 0.99, 1e-5  # Flax's defaults, which the JAX trunk keeps


class BatchNorm(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.mesh = None  # batch statistics over the mesh's `data` axis

    def _moments(self, xf: torch.Tensor):
        """(E[x], E[x²]) over every axis but the last, in f32."""
        axes = tuple(range(xf.dim() - 1))
        mesh = self.mesh
        if mesh is None or mesh.shape["data"] == 1:
            return xf.mean(axes), xf.square().mean(axes)
        from gemm_gan_tpu_torch.parallel import comm

        rows = xf.new_full((1,), float(xf.numel() // xf.shape[-1]))
        sums = comm.all_reduce_sum(torch.cat([xf.sum(axes), xf.square().sum(axes), rows]),
                                   mesh, "data")
        F = xf.shape[-1]
        return sums[:F] / sums[-1], sums[F:2 * F] / sums[-1]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            mean, mean_sq = self._moments(xf)
            var = torch.clamp(mean_sq - mean.square(), min=0.0)
            with torch.no_grad():
                m = MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + EPSILON) * self.weight) + self.bias
        return y.to(self.dtype)
