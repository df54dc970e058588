"""Masked multi-head attention + transformer encoder.

Counterpart of `gemm_gan_tpu/ops/attention.py`: post-LayerNorm blocks with a
ReLU feed-forward. LayerNorm eps is 1e-6, Flax's value (torch's default is
1e-5). Masks use True = valid. The attention core is
`kernels.flash_attention.masked_mha`, which takes the CUDA kernels on the
card when `use_pallas` (the JAX config's name, kept so run dirs load).

Dropout sits where the JAX modules put it (the attention output, after the
FFN ReLU and after the FFN output) and is active in `train()` mode, as the
JAX modules' `deterministic=False`; the serving path runs in `eval()` mode.
Ring (sequence-parallel) attention is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from gemm_gan_tpu_torch.kernels.flash_attention import masked_mha

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


class MaskedMultiHeadAttention(nn.Module):
    """Cross/self attention with a key-padding mask.

    Call: (q_in [B, Lq, E], kv_in [B, Lk, E], kv_mask [B, Lk] or None)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 use_pallas: bool = True, flash_layout: str = "ble"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("num_heads must divide embed_dim")
        if flash_layout not in ("ble", "bhld"):
            raise ValueError(f"unknown flash_layout {flash_layout!r}")
        self.num_heads = num_heads
        self.use_pallas = use_pallas
        self.flash_layout = flash_layout
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.dropout = nn.Dropout(dropout)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self.q_proj(q_in), self.k_proj(kv_in), self.v_proj(kv_in)
        H = self.num_heads
        if self.flash_layout == "ble":
            out = masked_mha(q, k, v, kv_mask, use_pallas=self.use_pallas,
                             layout="ble", num_heads=H)
        else:
            B, Lq, E = q.shape

            def split(x):
                return x.reshape(B, x.shape[1], H, E // H).transpose(1, 2)

            out = masked_mha(split(q), split(k), split(v), kv_mask,
                             use_pallas=self.use_pallas)
            out = out.transpose(1, 2).reshape(B, Lq, E)
        return self.dropout(self.out_proj(out))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, ff_dim: int,
                 dropout: float = 0.1, use_pallas: bool = True,
                 flash_layout: str = "ble"):
        super().__init__()
        self.self_attn = MaskedMultiHeadAttention(
            embed_dim, num_heads, dropout=dropout, use_pallas=use_pallas,
            flash_layout=flash_layout)
        self.norm1 = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.linear1 = nn.Linear(embed_dim, ff_dim)
        self.linear2 = nn.Linear(ff_dim, embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, x, mask))
        h = self.dropout1(F.relu(self.linear1(x)))
        h = self.dropout2(self.linear2(h))
        return self.norm2(x + h)


class TransformerEncoder(nn.Module):
    """`num_layers` post-LayerNorm blocks. With `remat`, each layer's
    activations are recomputed in the backward instead of kept
    (`torch.utils.checkpoint`, non-reentrant), as the JAX encoder's
    `nn.remat` per layer: whole-slide patch counts need it. The dropout
    masks of the recompute are the forward's: the default generator's state
    is stashed when dropout is on."""

    def __init__(self, num_layers: int, embed_dim: int, num_heads: int,
                 ff_dim: int, dropout: float = 0.1, use_pallas: bool = True,
                 flash_layout: str = "ble", remat: bool = False):
        super().__init__()
        self.remat = remat
        self.dropout = dropout
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, num_heads, ff_dim, dropout,
                                    use_pallas=use_pallas,
                                    flash_layout=flash_layout)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            if self.remat:
                x = checkpoint(layer, x, mask, use_reentrant=False,
                               preserve_rng_state=self.training and self.dropout > 0)
            else:
                x = layer(x, mask)
        return x
