"""MLP building blocks for the generator trunk.

Counterpart of `gemm_gan_tpu/ops/mlp.py`: Linear -> LeakyReLU blocks in the
compute dtype (`ops.linear.Linear`: bf16 under `compute_dtype="bfloat16"`,
the LeakyReLU on the bf16 values) and a final un-activated Linear head in
f32, as in JAX (`ops/mlp.py:57-59`), so samples and critic scores leave in
f32. `use_batchnorm=True` puts Flax's BatchNorm (`ops.batchnorm.BatchNorm`,
in the compute dtype) between each hidden Linear and its LeakyReLU; the
trunk's `train` flag is JAX's: batch statistics (and running-buffer
updates) when True, the running buffers otherwise.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from gemm_gan_tpu_torch.ops.batchnorm import BatchNorm
from gemm_gan_tpu_torch.ops.linear import Linear


class LinearBlock(nn.Module):
    def __init__(self, in_features: int, features: int, negative_slope: float = 0.0,
                 dtype: torch.dtype = torch.float32, use_batchnorm: bool = False):
        super().__init__()
        # the slope in the compute dtype, as JAX's weakly typed scalar is
        # taken (0.2 is 0.2001953125 in bf16)
        self.negative_slope = float(torch.tensor(negative_slope, dtype=dtype))
        self.linear = Linear(in_features, features, dtype)
        self.norm = BatchNorm(features, dtype) if use_batchnorm else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.linear(x)
        if self.norm is not None:
            x = self.norm(x, train)
        return F.leaky_relu(x, self.negative_slope)


class MLPTrunk(nn.Module):
    """Hidden (BatchNorm) LeakyReLU blocks in `dtype` followed by an f32
    linear head."""

    def __init__(self, in_features: int, hidden_dims: Sequence[int], out_dim: int,
                 negative_slope: float = 0.0, use_batchnorm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_features, *hidden_dims]
        self.blocks = nn.ModuleList(
            LinearBlock(i, o, negative_slope, dtype, use_batchnorm)
            for i, o in zip(dims[:-1], dims[1:]))
        self.head = Linear(dims[-1], out_dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, train)
        return self.head(x)
