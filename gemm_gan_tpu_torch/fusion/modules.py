"""Conditioning / fusion modules.

Counterpart of `gemm_gan_tpu/fusion/modules.py`. Each fusion maps a
conditioning dict to one [B, cond_dim] vector. This slice ports the
flagship `film_xattn` fusion (FiLM + patch CLS transformer + CLS-query
cross-attention both ways), in f32 or in the bf16 compute dtype (the CLS
token cast to the sequence's dtype, `flash_mxu_bf16` passed through to the
attention); the other kinds raise `NotImplementedError`.

Batch schema (True = valid masks everywhere):
  tokens     [B, T, text_dim]       ModernBERT token embeddings
  token_mask [B, T] bool
  patches    [B, P, patch_dim]      UNI patch embeddings
  patch_mask [B, P] bool
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from gemm_gan_tpu_torch.config import FusionConfig
from gemm_gan_tpu_torch.ops.attention import MaskedMultiHeadAttention, TransformerEncoder
from gemm_gan_tpu_torch.ops.film import FiLM
from gemm_gan_tpu_torch.ops.linear import Linear


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    # x: [B, L, D]; mask: [B, L] True=valid
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


class _PatchTransformer(nn.Module):
    """Patch-CLS trunk: encode patches, prepend a learnable CLS, run the
    encoder stack; returns (sequence_with_cls [B, P+1, E], mask [B, P+1])."""

    def __init__(self, cfg: FusionConfig, in_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patches_encoder = Linear(in_dim, cfg.cond_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.cond_dim))
        self.patches_transformer = TransformerEncoder(
            num_layers=cfg.num_layers, embed_dim=cfg.cond_dim,
            num_heads=cfg.num_heads, ff_dim=cfg.ff_dim, dropout=cfg.dropout,
            use_pallas=cfg.use_pallas, flash_layout=cfg.flash_layout,
            remat=cfg.remat_layers, mxu_bf16=cfg.flash_mxu_bf16, dtype=dtype)

    def forward(self, patches: torch.Tensor,
                patch_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.patches_encoder(patches)
        B = x.shape[0]
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, -1), x], dim=1)
        mask = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=x.device),
                          patch_mask], dim=1)
        return self.patches_transformer(x, mask), mask


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

        def cross():
            return MaskedMultiHeadAttention(cfg.cond_dim, cfg.num_heads,
                                            use_pallas=cfg.use_pallas,
                                            flash_layout=cfg.flash_layout,
                                            mxu_bf16=cfg.flash_mxu_bf16, dtype=dtype)

        self.patch2text_attention = cross()
        self.text2patch_attention = cross()

    def forward(self, cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        tokens = cond["tokens"]
        patches = self.film(tokens[:, 0, :], cond["patches"])
        text = self.text_encoder(tokens)
        patch_seq, patch_mask = self.patch_transformer(patches, cond["patch_mask"])
        p2t = self.patch2text_attention(text[:, 0:1, :], patch_seq, patch_mask)
        t2p = self.text2patch_attention(p2t[:, 0:1, :], text, cond["token_mask"])
        return t2p[:, 0] + p2t[:, 0]


_FUSIONS = {"film_xattn": FiLMCrossAttentionFusion}
_NOT_PORTED = ("concat", "attention", "img_transformer", "film", "xattn", "labels")


def cond_dim_of(cfg: FusionConfig) -> int:
    if cfg.kind == "none":
        return 0
    if cfg.kind == "labels":
        return 2 * cfg.label_embed_dim
    return cfg.cond_dim


def build_fusion(cfg: FusionConfig, dtype: torch.dtype = torch.float32) -> Optional[nn.Module]:
    if cfg.kind == "none":
        return None
    if cfg.kind in _NOT_PORTED:
        raise NotImplementedError(
            f"fusion kind {cfg.kind!r} is not ported yet; the port serves "
            f"{sorted(_FUSIONS)} and 'none'")
    if cfg.kind not in _FUSIONS:
        raise ValueError(f"unknown fusion kind {cfg.kind!r}")
    return _FUSIONS[cfg.kind](cfg, dtype)
