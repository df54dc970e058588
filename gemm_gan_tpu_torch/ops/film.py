"""FiLM (feature-wise linear modulation) of patch embeddings by text.

Counterpart of `gemm_gan_tpu/ops/film.py`: one Linear maps the text vector
to (gamma, beta) over the raw patch feature dim; gamma is tanh-squashed,
beta clamped to +-clamp; patches become gamma * patches + beta.
"""

from __future__ import annotations

import torch
from torch import nn


class FiLM(nn.Module):
    def __init__(self, text_dim: int, feature_dim: int, beta_clamp: float = 5.0):
        super().__init__()
        self.beta_clamp = beta_clamp
        self.film_proj = nn.Linear(text_dim, 2 * feature_dim)

    def forward(self, text_vec: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
        # text_vec: [B, text_dim]; patches: [B, P, feature_dim]
        gamma, beta = self.film_proj(text_vec).chunk(2, dim=-1)
        gamma = torch.tanh(gamma)
        beta = beta.clamp(-self.beta_clamp, self.beta_clamp)
        return gamma[:, None, :] * patches + beta[:, None, :]
