"""FiLM (feature-wise linear modulation) of patch embeddings by text.

Counterpart of `gemm_gan_tpu/ops/film.py`: one Linear (in the compute
dtype) maps the text vector to (gamma, beta) over the raw patch feature
dim; gamma is tanh-squashed, beta clamped to +-clamp; patches become
gamma * patches + beta, which promotes to f32 when the patches are f32, as
in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from gemm_gan_tpu_torch.ops.linear import Linear


class FiLM(nn.Module):
    def __init__(self, text_dim: int, feature_dim: int, beta_clamp: float = 5.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.beta_clamp = beta_clamp
        self.film_proj = Linear(text_dim, 2 * feature_dim, dtype)

    def forward(self, text_vec: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
        # text_vec: [B, text_dim]; patches: [B, P, feature_dim]
        gamma, beta = self.film_proj(text_vec).chunk(2, dim=-1)
        gamma = torch.tanh(gamma)
        beta = beta.clamp(-self.beta_clamp, self.beta_clamp)
        return gamma[:, None, :] * patches + beta[:, None, :]
