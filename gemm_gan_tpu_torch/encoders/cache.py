"""Embedding caches: batched encoder inference -> the TCGA layout.

Counterpart of `gemm_gan_tpu/encoders/cache.py`; writes the files the JAX
package writes and `data/tcga.py`'s `load_tcga` reads:

  patch_embeddings_uni/{case}.npy                 [N_patches, E] UNI
  clinical_modernbert_embeddings.parquet          one CLS row per case
  clinical_modernbert_embeddings/{case}.npy       [L, E] tokens
  clinical_modernbert_embeddings/{case}_attention_mask.npy   [L] bool
  text_embeddings_contrastive_{d}/{case}.npy      projected tokens
  image_embeddings_contrastive.parquet, embeddings_contrastive.parquet

The encoder runs over fixed-size batches on the device (`batched_apply`:
the last batch padded by repeating its last row, the padding dropped from
the output), under `torch.inference_mode()`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from gemm_gan_tpu_torch.utils.device import DeviceLike, host, resolve_device


def batched_apply(fn: Callable, inputs: np.ndarray, batch_size: int = 64,
                  extra: Optional[Tuple[np.ndarray, ...]] = None,
                  device: DeviceLike = None) -> np.ndarray:
    """`fn(chunk[, *extra_chunks])` over fixed-size batches of `inputs` (and
    of the `extra` arrays beside them), each moved to `device` (the card
    unless "cpu"); the tail is padded to `batch_size` so every call has one
    shape. Returns the outputs, concatenated on the host."""
    dev = resolve_device(device)
    n = inputs.shape[0]
    outs = []
    with torch.inference_mode():
        for start in range(0, n, batch_size):
            chunk = inputs[start:start + batch_size]
            extras = tuple(e[start:start + batch_size] for e in (extra or ()))
            pad = batch_size - chunk.shape[0]
            if pad > 0:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)], axis=0)
                extras = tuple(np.concatenate([e, np.repeat(e[-1:], pad, axis=0)], axis=0)
                               for e in extras)
            out = host(fn(torch.as_tensor(chunk, device=dev),
                          *(torch.as_tensor(e, device=dev) for e in extras)))
            outs.append(out[:batch_size - pad] if pad > 0 else out)
    return np.concatenate(outs, axis=0) if outs else np.empty((0,))


def build_patch_cache(embed_fn: Callable, tiles_by_case: Dict[str, np.ndarray],
                      out_dir: str, batch_size: int = 64,
                      device: DeviceLike = None) -> Dict[str, str]:
    """Write `{out_dir}/{case_id}.npy` = [N_patches, E] embeddings.
    `embed_fn`: tiles [B, H, W, 3] -> [B, E], e.g. a `ViT`."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for case_id, tiles in tiles_by_case.items():
        emb = batched_apply(embed_fn, tiles, batch_size, device=device)
        path = os.path.join(out_dir, f"{case_id}.npy")
        np.save(path, emb.astype(np.float32))
        paths[case_id] = path
    return paths


def _encode_cases(encode_fn, ids_by_case, mask_by_case, batch_size, device):
    cases = sorted(ids_by_case)
    ids = np.stack([ids_by_case[c] for c in cases])
    mask = np.stack([mask_by_case[c] for c in cases])
    return cases, mask, batched_apply(encode_fn, ids, batch_size, extra=(mask,), device=device)


def build_text_cls_cache(encode_fn: Callable, ids_by_case: Dict[str, np.ndarray],
                         mask_by_case: Dict[str, np.ndarray], out_parquet: str,
                         batch_size: int = 32, device: DeviceLike = None) -> None:
    """Write one parquet of CLS vectors (columns = dims, index = case_id).
    `encode_fn`: (ids [B, L], mask [B, L]) -> hidden [B, L, E], e.g. a
    `ModernBert`."""
    import pandas as pd

    cases, _, hidden = _encode_cases(encode_fn, ids_by_case, mask_by_case, batch_size, device)
    df = pd.DataFrame(hidden[:, 0, :].astype(np.float32),
                      index=pd.Index(cases, name="case_id"))
    df.columns = [str(c) for c in df.columns]
    os.makedirs(os.path.dirname(out_parquet) or ".", exist_ok=True)
    df.to_parquet(out_parquet)


def build_text_token_cache(encode_fn: Callable, ids_by_case: Dict[str, np.ndarray],
                           mask_by_case: Dict[str, np.ndarray], out_dir: str,
                           batch_size: int = 32, device: DeviceLike = None) -> None:
    """Write `{case}.npy` [L, E] and `{case}_attention_mask.npy` [L] (True =
    valid) per case."""
    os.makedirs(out_dir, exist_ok=True)
    cases, mask, hidden = _encode_cases(encode_fn, ids_by_case, mask_by_case, batch_size,
                                        device)
    for i, case in enumerate(cases):
        np.save(os.path.join(out_dir, f"{case}.npy"), hidden[i].astype(np.float32))
        np.save(os.path.join(out_dir, f"{case}_attention_mask.npy"), mask[i].astype(bool))


def build_contrastive_caches(project_image: Callable, project_text: Callable,
                             patch_cache_dir: str, token_cache_dir: str,
                             out_root: str, emb_dim: int) -> None:
    """Project cached UNI / ModernBERT embeddings into the shared space
    (`project_*`: numpy -> numpy): `text_embeddings_contrastive_{d}/{case}.npy`,
    the mean-pooled `image_embeddings_contrastive.parquet` and the averaged
    `embeddings_contrastive.parquet`."""
    import pandas as pd

    text_out = os.path.join(out_root, f"text_embeddings_contrastive_{emb_dim}")
    os.makedirs(text_out, exist_ok=True)
    img_rows, both_rows, cases = [], [], []
    for fname in sorted(os.listdir(patch_cache_dir)):
        if not fname.endswith(".npy"):
            continue
        case = fname[:-4]
        patches = np.load(os.path.join(patch_cache_dir, fname))
        zi = np.asarray(project_image(patches)).mean(axis=0)
        zi /= max(np.linalg.norm(zi), 1e-8)
        tok_path = os.path.join(token_cache_dir, f"{case}.npy")
        if not os.path.exists(tok_path):
            continue
        zt_tokens = np.asarray(project_text(np.load(tok_path)))
        np.save(os.path.join(text_out, f"{case}.npy"), zt_tokens.astype(np.float32))
        cases.append(case)
        img_rows.append(zi)
        both_rows.append((zi + zt_tokens[0]) / 2.0)
    idx = pd.Index(cases, name="case_id")
    pd.DataFrame(np.asarray(img_rows, np.float32), index=idx).rename(columns=str).to_parquet(
        os.path.join(out_root, "image_embeddings_contrastive.parquet"))
    pd.DataFrame(np.asarray(both_rows, np.float32), index=idx).rename(columns=str).to_parquet(
        os.path.join(out_root, "embeddings_contrastive.parquet"))
