"""Synthetic multimodal datasets for tests and the on-card smoke run.

A copy of `synthetic_dataset` and `structured_dataset` from
`gemm_gan_tpu/data/synthetic.py` (numpy only), kept here so the port imports
nothing of the JAX package. Same seeds give the same arrays as the JAX
package's functions.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _randn_f32(rng, n: int, *dims: int) -> np.ndarray:
    """`rng.randn(n, *dims).astype(f32)` drawn in case-chunks.

    Value-identical to the single call (legacy `RandomState` keeps its
    cached-gaussian state across calls, so chunked draws consume the same
    stream) but never materializes the full f64 temporary: at whole-slide
    shapes the one-shot draw would be a multi-GB f64 spike."""
    per_case = int(np.prod(dims)) if dims else 1
    chunk = max(1, int(1.2e8 // max(per_case, 1)))
    if chunk >= n:
        return rng.randn(n, *dims).astype(np.float32)
    out = np.empty((n,) + tuple(dims), np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        out[s:e] = rng.randn(e - s, *dims)
    return out


def synthetic_dataset(n: int = 256, n_genes: int = 64, n_classes: int = 4,
                      n_sites: int = 3, num_patches: int = 16, patch_dim: int = 32,
                      num_tokens: int = 12, text_dim: int = 24,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """Mixture-of-gaussians expression matrix with class structure, plus
    class-correlated patch/token embeddings with ragged masks."""
    rng = np.random.RandomState(seed)
    disease = rng.randint(0, n_classes, size=n)
    site = rng.randint(0, n_sites, size=n)
    centers = rng.randn(n_classes, n_genes) * 2.0
    genes = centers[disease] + rng.randn(n, n_genes).astype(np.float32)

    text_centers = rng.randn(n_classes, text_dim)
    text_emb = (text_centers[disease] + 0.3 * rng.randn(n, text_dim)).astype(np.float32)
    tokens = (text_centers[disease][:, None, :]
              + 0.3 * rng.randn(n, num_tokens, text_dim)).astype(np.float32)
    token_len = rng.randint(2, num_tokens + 1, size=n)
    token_mask = np.arange(num_tokens)[None, :] < token_len[:, None]

    patch_centers = rng.randn(n_classes, patch_dim)
    patches = (patch_centers[disease][:, None, :]
               + 0.5 * rng.randn(n, num_patches, patch_dim)).astype(np.float32)
    patch_len = rng.randint(1, num_patches + 1, size=n)
    patch_mask = np.arange(num_patches)[None, :] < patch_len[:, None]
    patches = patches * patch_mask[:, :, None]

    return {
        "genes": genes.astype(np.float32),
        "text_emb": text_emb,
        "tokens": tokens,
        "token_mask": token_mask,
        "patches": patches,
        "patch_mask": patch_mask,
        "disease": disease.astype(np.int32),
        "site": site.astype(np.int32),
    }


def structured_dataset(n: int, n_genes: int = 2000, rank: int = 24,
                       n_classes: int = 8, n_sites: int = 4,
                       num_patches: int = 256, patch_dim: int = 1024,
                       num_tokens: int = 300, text_dim: int = 768,
                       seed: int = 7) -> Dict[str, np.ndarray]:
    """Low-rank gene-gene correlation + label-dependent means, with
    class-correlated patch/token embeddings at the canonical widths
    (256 x 1024 UNI patches, 300 x 768 ModernBERT tokens) and all-valid
    masks."""
    rng = np.random.RandomState(seed)
    disease = rng.randint(0, n_classes, size=n)
    site = rng.randint(0, n_sites, size=n)
    centers = rng.randn(n_classes, n_genes).astype(np.float32) * 1.5
    W = rng.randn(rank, n_genes).astype(np.float32) / np.sqrt(rank)
    z = rng.randn(n, rank).astype(np.float32)
    genes = (centers[disease] + 2.0 * (z @ W)
             + 0.5 * rng.randn(n, n_genes).astype(np.float32))

    text_centers = rng.randn(n_classes, text_dim).astype(np.float32)
    tokens = _randn_f32(rng, n, num_tokens, text_dim)
    tokens *= np.float32(0.3)
    tokens += text_centers[disease][:, None, :]
    token_mask = np.ones((n, num_tokens), dtype=bool)
    patch_centers = rng.randn(n_classes, patch_dim).astype(np.float32)
    patches = _randn_f32(rng, n, num_patches, patch_dim)
    patches *= np.float32(0.5)
    patches += patch_centers[disease][:, None, :]
    patch_mask = np.ones((n, num_patches), dtype=bool)
    return {"genes": genes, "tokens": tokens, "token_mask": token_mask,
            "patches": patches, "patch_mask": patch_mask,
            "disease": disease.astype(np.int32), "site": site.astype(np.int32)}
