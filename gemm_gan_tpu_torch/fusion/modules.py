"""Conditioning / fusion modules.

Counterpart of `gemm_gan_tpu/fusion/modules.py`: one module per
conditioning architecture of the reference's ablation, each mapping a
conditioning dict to one [B, cond_dim] vector (2 * label_embed_dim for the
label oracle), in f32 or in the bf16 compute dtype (Linears in bf16, the
LayerNorms in f32, `flash_mxu_bf16` passed through to the attention).

Batch schema (True = valid masks everywhere):
  text_emb   [B, text_dim]          ModernBERT CLS vector
  tokens     [B, T, text_dim]       ModernBERT token embeddings
  token_mask [B, T] bool
  patches    [B, P, patch_dim]      UNI patch embeddings
  patch_mask [B, P] bool
  disease    [B] int, site [B] int

As in the JAX package, the pooled-attention variant normalises with a
LayerNorm where the reference has a BatchNorm (a batch-coupled norm breaks
the per-sample gradient penalty), and fully-masked attention rows give 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from gemm_gan_tpu_torch.config import FusionConfig
from gemm_gan_tpu_torch.ops.attention import (LAYER_NORM_EPS, MaskedMultiHeadAttention,
                                              TransformerEncoder)
from gemm_gan_tpu_torch.ops.film import FiLM
from gemm_gan_tpu_torch.ops.linear import Linear

Cond = Dict[str, torch.Tensor]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    # x: [B, L, D]; mask: [B, L] True=valid
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


def _attention(cfg: FusionConfig, dtype: torch.dtype) -> MaskedMultiHeadAttention:
    """A cross-attention block of the fusion (no dropout, as in JAX)."""
    return MaskedMultiHeadAttention(cfg.cond_dim, cfg.num_heads, use_pallas=cfg.use_pallas,
                                    flash_layout=cfg.flash_layout,
                                    mxu_bf16=cfg.flash_mxu_bf16, dtype=dtype)


class _PatchTransformer(nn.Module):
    """Patch-CLS trunk: encode patches, prepend a learnable CLS, run the
    encoder stack; returns (sequence_with_cls [B, P+1, E], mask [B, P+1]).

    With `encode_mlp` (the img_transformer) the patch Linear is followed by
    a ReLU and an f32 LayerNorm (`encode_norm`), so the sequence enters the
    encoder in f32 whatever the compute dtype, as in JAX; without it the
    sequence keeps the Linear's dtype. The CLS token takes the sequence's
    dtype."""

    def __init__(self, cfg: FusionConfig, in_dim: int, dtype: torch.dtype = torch.float32,
                 encode_mlp: bool = False):
        super().__init__()
        self.patches_encoder = Linear(in_dim, cfg.cond_dim, dtype)
        self.encode_norm = (nn.LayerNorm(cfg.cond_dim, eps=LAYER_NORM_EPS)
                            if encode_mlp else None)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.cond_dim))
        self.patches_transformer = TransformerEncoder(
            num_layers=cfg.num_layers, embed_dim=cfg.cond_dim,
            num_heads=cfg.num_heads, ff_dim=cfg.ff_dim, dropout=cfg.dropout,
            use_pallas=cfg.use_pallas, flash_layout=cfg.flash_layout,
            remat=cfg.remat_layers, mxu_bf16=cfg.flash_mxu_bf16, dtype=dtype)

    def forward(self, patches: torch.Tensor,
                patch_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.patches_encoder(patches)
        if self.encode_norm is not None:
            x = self.encode_norm(F.relu(x).float())
        B = x.shape[0]
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, -1), x], dim=1)
        mask = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=x.device),
                          patch_mask], dim=1)
        return self.patches_transformer(x, mask), mask


class ConcatFusion(nn.Module):
    """One Linear over the text CLS vector (`condition_type="text"`), or
    over the patches followed by their masked mean in the Linear's dtype
    (`"image"`)."""

    def __init__(self, cfg: FusionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image = cfg.condition_type != "text"
        in_dim = cfg.patch_dim if self.image else cfg.text_dim
        self.encoder = Linear(in_dim, cfg.cond_dim, dtype)

    def forward(self, cond: Cond) -> torch.Tensor:
        if not self.image:
            return self.encoder(cond["text_emb"])
        return _masked_mean(self.encoder(cond["patches"]), cond["patch_mask"])


class PooledAttentionFusion(nn.Module):
    """The encoded text CLS as the one query over the encoded patches (Lq 1:
    the plain reference, no kernel), then an f32 LayerNorm."""

    def __init__(self, cfg: FusionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.text_encoder = Linear(cfg.text_dim, cfg.cond_dim, dtype)
        self.patches_encoder = Linear(cfg.patch_dim, cfg.cond_dim, dtype)
        self.attention = _attention(cfg, dtype)
        self.attn_norm = nn.LayerNorm(cfg.cond_dim, eps=LAYER_NORM_EPS)

    def forward(self, cond: Cond) -> torch.Tensor:
        text = self.text_encoder(cond["text_emb"])
        patches = self.patches_encoder(cond["patches"])
        attn = self.attention(text[:, None, :], patches, cond["patch_mask"])
        return self.attn_norm(attn[:, 0].float())


class ImageTransformerFusion(nn.Module):
    """Image only: the patch transformer with its encoder MLP; CLS out."""

    def __init__(self, cfg: FusionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_transformer = _PatchTransformer(cfg, cfg.patch_dim, dtype, encode_mlp=True)

    def forward(self, cond: Cond) -> torch.Tensor:
        seq, _ = self.patch_transformer(cond["patches"], cond["patch_mask"])
        return seq[:, 0]


class FiLMFusion(nn.Module):
    """FiLM from the text CLS vector (`text_emb`) onto the raw patches, then
    the patch transformer; CLS out."""

    def __init__(self, cfg: FusionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.film = FiLM(cfg.text_dim, cfg.patch_dim, beta_clamp=cfg.film_beta_clamp,
                         dtype=dtype)
        self.patch_transformer = _PatchTransformer(cfg, cfg.patch_dim, dtype)

    def forward(self, cond: Cond) -> torch.Tensor:
        patches = self.film(cond["text_emb"], cond["patches"])
        seq, _ = self.patch_transformer(patches, cond["patch_mask"])
        return seq[:, 0]


class CrossAttentionFusion(nn.Module):
    """Token-level bidirectional cross-attention: the patch transformer;
    every encoded text token queries the patch sequence (padded tokens
    too, as in JAX); that output queries the text tokens under the token
    mask; the sum of the two first rows."""

    def __init__(self, cfg: FusionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.text_encoder = Linear(cfg.text_dim, cfg.cond_dim, dtype)
        self.patch_transformer = _PatchTransformer(cfg, cfg.patch_dim, dtype)
        self.patch2text_attention = _attention(cfg, dtype)
        self.text2patch_attention = _attention(cfg, dtype)

    def forward(self, cond: Cond) -> torch.Tensor:
        text = self.text_encoder(cond["tokens"])
        patch_seq, patch_mask = self.patch_transformer(cond["patches"], cond["patch_mask"])
        p2t = self.patch2text_attention(text, patch_seq, patch_mask)
        t2p = self.text2patch_attention(p2t, text, cond["token_mask"])
        return t2p[:, 0] + p2t[:, 0]


class FiLMCrossAttentionFusion(nn.Module):
    """The full GeMM-GAN fusion: FiLM from the text CLS token onto raw
    patches -> patch CLS transformer -> CLS-only-query cross-attention in
    both directions -> sum of the attended CLS vectors."""

    def __init__(self, cfg: FusionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.film = FiLM(cfg.text_dim, cfg.patch_dim, beta_clamp=cfg.film_beta_clamp,
                         dtype=dtype)
        self.text_encoder = Linear(cfg.text_dim, cfg.cond_dim, dtype)
        self.patch_transformer = _PatchTransformer(cfg, cfg.patch_dim, dtype)
        self.patch2text_attention = _attention(cfg, dtype)
        self.text2patch_attention = _attention(cfg, dtype)

    def forward(self, cond: Cond) -> torch.Tensor:
        tokens = cond["tokens"]
        patches = self.film(tokens[:, 0, :], cond["patches"])
        text = self.text_encoder(tokens)
        patch_seq, patch_mask = self.patch_transformer(patches, cond["patch_mask"])
        p2t = self.patch2text_attention(text[:, 0:1, :], patch_seq, patch_mask)
        t2p = self.text2patch_attention(p2t[:, 0:1, :], text, cond["token_mask"])
        return t2p[:, 0] + p2t[:, 0]


class LabelEmbedFusion(nn.Module):
    """The label oracle: disease and primary-site embeddings, concatenated,
    in f32 whatever the compute dtype."""

    def __init__(self, cfg: FusionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.disease_embed = nn.Embedding(cfg.n_disease_types, cfg.label_embed_dim)
        self.site_embed = nn.Embedding(cfg.n_primary_sites, cfg.label_embed_dim)

    def forward(self, cond: Cond) -> torch.Tensor:
        return torch.cat([self.disease_embed(cond["disease"]),
                          self.site_embed(cond["site"])], dim=-1).float()


_FUSIONS = {
    "concat": ConcatFusion,
    "attention": PooledAttentionFusion,
    "img_transformer": ImageTransformerFusion,
    "film": FiLMFusion,
    "xattn": CrossAttentionFusion,
    "film_xattn": FiLMCrossAttentionFusion,
    "labels": LabelEmbedFusion,
}


def cond_dim_of(cfg: FusionConfig) -> int:
    if cfg.kind == "none":
        return 0
    if cfg.kind == "labels":
        return 2 * cfg.label_embed_dim
    return cfg.cond_dim


def build_fusion(cfg: FusionConfig, dtype: torch.dtype = torch.float32) -> Optional[nn.Module]:
    if cfg.kind == "none":
        return None
    if cfg.kind not in _FUSIONS:
        raise ValueError(f"unknown fusion kind {cfg.kind!r}")
    return _FUSIONS[cfg.kind](cfg, dtype)
