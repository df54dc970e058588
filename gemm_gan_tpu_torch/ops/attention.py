"""Masked multi-head attention + transformer encoder.

Counterpart of `gemm_gan_tpu/ops/attention.py`: post-LayerNorm blocks with a
ReLU feed-forward. LayerNorm eps is 1e-6, Flax's value (torch's default is
1e-5). Masks use True = valid. The attention core is
`kernels.flash_attention.masked_mha`, which takes the CUDA kernels on the
card when `use_pallas` (the JAX config's name, kept so run dirs load).

Under a bf16 compute dtype the q, k, v and out projections and the FFN
Linears compute in bf16 (`ops.linear.Linear`), attention takes bf16
operands (`mxu_bf16` passed through), and both LayerNorms run in f32 on
the residual sums, as JAX's `nn.LayerNorm(dtype=jnp.float32)`.

Dropout sits where the JAX modules put it (the attention output, after the
FFN ReLU and after the FFN output) and is active in `train()` mode, as the
JAX modules' `deterministic=False`; the serving path runs in `eval()` mode.

`mesh` (set by `models.gan` under `fusion.sequence_parallel`) routes a
self-attention (Lq == Lk) through ring attention
(`kernels.ring_attention.ring_mha`, the sequence sharded over `model`)
when the mesh has a `model` axis of more than one rank, as the JAX module
does; otherwise `masked_mha` and its kernels serve it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from gemm_gan_tpu_torch.kernels.flash_attention import masked_mha
from gemm_gan_tpu_torch.kernels.ring_attention import ring_mha
from gemm_gan_tpu_torch.ops.linear import Linear

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


class MaskedMultiHeadAttention(nn.Module):
    """Cross/self attention with a key-padding mask.

    Call: (q_in [B, Lq, E], kv_in [B, Lk, E], kv_mask [B, Lk] or None)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 use_pallas: bool = True, flash_layout: str = "ble",
                 mxu_bf16: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("num_heads must divide embed_dim")
        if flash_layout not in ("ble", "bhld"):
            raise ValueError(f"unknown flash_layout {flash_layout!r}")
        self.num_heads = num_heads
        self.use_pallas = use_pallas
        self.flash_layout = flash_layout
        self.mxu_bf16 = mxu_bf16
        self.q_proj = Linear(embed_dim, embed_dim, dtype)
        self.k_proj = Linear(embed_dim, embed_dim, dtype)
        self.v_proj = Linear(embed_dim, embed_dim, dtype)
        self.out_proj = Linear(embed_dim, embed_dim, dtype)
        self.dropout = nn.Dropout(dropout)
        self.mesh = None  # ring (sequence-parallel) self-attention over `model`

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self.q_proj(q_in), self.k_proj(kv_in), self.v_proj(kv_in)
        H = self.num_heads
        mesh = self.mesh
        if mesh is not None and q.shape[1] == k.shape[1] and mesh.shape["model"] > 1:
            B, Lq, E = q.shape

            def split(x):
                return x.reshape(B, x.shape[1], H, E // H).transpose(1, 2)

            # JAX shards the batch over `data` only when it divides evenly;
            # here each rank already holds its rows
            data_ax = mesh.shape["data"]
            batch_axis = "data" if data_ax > 1 and B % data_ax == 0 else None
            out = ring_mha(split(q), split(k), split(v), kv_mask, mesh=mesh,
                           axis="model", batch_axis=batch_axis)
            out = out.transpose(1, 2).reshape(B, Lq, E)
        elif self.flash_layout == "ble":
            out = masked_mha(q, k, v, kv_mask, use_pallas=self.use_pallas,
                             layout="ble", num_heads=H, mxu_bf16=self.mxu_bf16)
        else:
            B, Lq, E = q.shape

            def split(x):
                return x.reshape(B, x.shape[1], H, E // H).transpose(1, 2)

            out = masked_mha(split(q), split(k), split(v), kv_mask,
                             use_pallas=self.use_pallas, mxu_bf16=self.mxu_bf16)
            out = out.transpose(1, 2).reshape(B, Lq, E)
        return self.dropout(self.out_proj(out))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, ff_dim: int,
                 dropout: float = 0.1, use_pallas: bool = True,
                 flash_layout: str = "ble", mxu_bf16: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MaskedMultiHeadAttention(
            embed_dim, num_heads, dropout=dropout, use_pallas=use_pallas,
            flash_layout=flash_layout, mxu_bf16=mxu_bf16, dtype=dtype)
        self.norm1 = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.linear1 = Linear(embed_dim, ff_dim, dtype)
        self.linear2 = Linear(ff_dim, embed_dim, dtype)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm1((x + self.self_attn(x, x, mask)).float())
        h = self.dropout1(F.relu(self.linear1(x)))
        h = self.dropout2(self.linear2(h))
        return self.norm2((x + h).float())


class TransformerEncoder(nn.Module):
    """`num_layers` post-LayerNorm blocks. With `remat`, each layer's
    activations are recomputed in the backward instead of kept
    (`torch.utils.checkpoint`, non-reentrant), as the JAX encoder's
    `nn.remat` per layer: whole-slide patch counts need it. The dropout
    masks of the recompute are the forward's: the default generator's state
    is stashed when dropout is on."""

    def __init__(self, num_layers: int, embed_dim: int, num_heads: int,
                 ff_dim: int, dropout: float = 0.1, use_pallas: bool = True,
                 flash_layout: str = "ble", remat: bool = False,
                 mxu_bf16: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        self.dropout = dropout
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, num_heads, ff_dim, dropout,
                                    use_pallas=use_pallas,
                                    flash_layout=flash_layout,
                                    mxu_bf16=mxu_bf16, dtype=dtype)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            if self.remat:
                x = checkpoint(layer, x, mask, use_reentrant=False,
                               preserve_rng_state=self.training and self.dropout > 0)
            else:
                x = layer(x, mask)
        return x
