"""MLP building blocks for the generator trunk.

Counterpart of `gemm_gan_tpu/ops/mlp.py`: Linear -> LeakyReLU blocks and a
final un-activated Linear head, all f32 (the slice serves
`compute_dtype="float32"` only). BatchNorm blocks are not ported yet:
`use_batchnorm=True` raises.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


class LinearBlock(nn.Module):
    def __init__(self, in_features: int, features: int, negative_slope: float = 0.0):
        super().__init__()
        self.negative_slope = negative_slope
        self.linear = nn.Linear(in_features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.linear(x), self.negative_slope)


class MLPTrunk(nn.Module):
    """Hidden LeakyReLU blocks followed by a linear output head."""

    def __init__(self, in_features: int, hidden_dims: Sequence[int], out_dim: int,
                 negative_slope: float = 0.0, use_batchnorm: bool = False):
        super().__init__()
        if use_batchnorm:
            raise NotImplementedError("MLPTrunk: use_batchnorm=True is not ported")
        dims = [in_features, *hidden_dims]
        self.blocks = nn.ModuleList(
            LinearBlock(i, o, negative_slope) for i, o in zip(dims[:-1], dims[1:]))
        self.head = nn.Linear(dims[-1], out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return self.head(x)
