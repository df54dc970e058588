"""TCGA multimodal dataset assembly.

A copy of `gemm_gan_tpu/data/tcga.py` (numpy and pandas only), kept here so
the port imports nothing of the JAX package; the same data dir and seed give
the same arrays. What it reproduces of the reference's four loaders
(`data_loader.py`, `multi_patch_gan_dataloader.py`,
`multi_patch_multi_token_gan_dataloader.py`, `benchmark_gan_dataloader.py`
of the original GeMM-GAN code):

  * case-ID intersection across RNA / text / image modalities so every
    variant sees the same split;
  * drop genes with >90% zeros;
  * seeded 64/16/20 split, train-stat standardize or min-max with the
    zero-variance fillna(0) guard;
  * label encoding by sorted vocabulary;
  * patch subsample-to-256 / zero-pad with validity mask, done ONCE at
    assembly into a dense [N, P, 1024] array instead of per-item disk
    reads; masks are True=valid everywhere;
  * the gene_names.npy side effect.

All artifacts are produced by the JAX package's ingest pipeline
(`gemm_gan_tpu/ingest/`).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np

from gemm_gan_tpu_torch.data.splits import (
    drop_mostly_zero_genes,
    minmax,
    split_indices,
    standardize,
)


def _load_rna(data_dir: str):
    import pandas as pd

    df = pd.read_parquet(os.path.join(data_dir, "rna_seq.parquet"))
    return df


def _load_text_cls(data_dir: str):
    import pandas as pd

    return pd.read_parquet(
        os.path.join(data_dir, "clinical_modernbert_embeddings.parquet"))


def _case_ids_with_patches(data_dir: str):
    d = os.path.join(data_dir, "patch_embeddings_uni")
    if not os.path.isdir(d):
        return None
    return {f[:-4] for f in os.listdir(d) if f.endswith(".npy")}


def _load_patches(data_dir: str, case_ids, num_patches: int, seed: int,
                  bank: bool = False):
    """Dense [N, P, D] patch cache + True=valid mask.

    bank=False: seeded one-time subsample/pad to `num_patches` (host loader).
    bank=True: keep ALL patches padded to the cohort max (capped at
    4*num_patches) so `DeviceCache` can draw a FRESH subset per step on
    device, matching the reference's per-__getitem__ resampling
    (multi_patch_gan_dataloader.py:31-39).
    """
    rng = np.random.RandomState(seed)
    base = os.path.join(data_dir, "patch_embeddings_uni")

    def path_of(cid):
        return os.path.join(base, f"{cid}.npy")

    # header-only pass for shapes (mmap avoids loading every case at once)
    shapes = {cid: np.load(path_of(cid), mmap_mode="r").shape
              for cid in case_ids}
    D = shapes[case_ids[0]][1]
    P = (min(max(s[0] for s in shapes.values()), 4 * num_patches)
         if bank else num_patches)
    out = np.zeros((len(case_ids), P, D), np.float32)
    mask = np.zeros((len(case_ids), P), bool)
    for i, cid in enumerate(case_ids):
        p = np.load(path_of(cid)).astype(np.float32)
        k = p.shape[0]
        if k > P:
            sel = rng.choice(k, P, replace=False)
            out[i] = p[sel]
            mask[i] = True
        else:
            out[i, :k] = p
            mask[i, :k] = True
    return out, mask


def _load_tokens(data_dir: str, case_ids, max_tokens: int):
    """[N, T, 768] token cache + True=valid mask from per-case npys
    (HF mask convention preserved)."""
    base = os.path.join(data_dir, "clinical_modernbert_embeddings")
    first = np.load(os.path.join(base, f"{case_ids[0]}.npy"))
    D = first.shape[-1]
    out = np.zeros((len(case_ids), max_tokens, D), np.float32)
    mask = np.zeros((len(case_ids), max_tokens), bool)
    for i, cid in enumerate(case_ids):
        t = np.load(os.path.join(base, f"{cid}.npy")).astype(np.float32)
        t = t.reshape(-1, D)[:max_tokens]
        am_path = os.path.join(base, f"{cid}_attention_mask.npy")
        if os.path.exists(am_path):
            am = np.load(am_path).reshape(-1)[:max_tokens].astype(bool)
        else:
            am = np.ones(t.shape[0], bool)
        out[i, :t.shape[0]] = t
        mask[i, :am.shape[0]] = am
    return out, mask


def _encode_labels(metainfos: dict, case_ids) -> Tuple[np.ndarray, np.ndarray, list, list]:
    """Sorted-vocab integer encoding (parity: multi_patch_gan_dataloader.py:216-240)."""
    diseases = [metainfos[c].get("disease_type", "Unknown") for c in case_ids]
    sites = [metainfos[c].get("primary_site", "Unknown") for c in case_ids]
    d_vocab = sorted(set(diseases))
    s_vocab = sorted(set(sites))
    d_idx = {v: i for i, v in enumerate(d_vocab)}
    s_idx = {v: i for i, v in enumerate(s_vocab)}
    return (np.array([d_idx[d] for d in diseases], np.int32),
            np.array([s_idx[s] for s in sites], np.int32), d_vocab, s_vocab)


def load_tcga(data_dir: str, schema: str = "genes", num_patches: int = 256,
              max_tokens: int = 300, normalization: str = "standardize",
              zero_gene_threshold: float = 0.9, seed: int = 42,
              save_gene_names: bool = True, patch_bank: bool = False) -> Dict:
    """Assemble splits for a batch schema: genes|multi_patch|multi_token|labels.

    Returns {"train": dict, "val": dict, "test": dict, "meta": dict}; every
    split dict follows the standard batch schema of fusion/modules.py.
    `patch_bank=True` loads the full padded patch bank (for `DeviceCache`
    per-step resampling) instead of a one-time host subsample.
    """
    rna = _load_rna(data_dir)

    case_ids = list(rna.index.astype(str))
    need_text = schema in ("multi_patch",)
    need_tokens = schema == "multi_token"
    need_patches = schema in ("multi_patch", "multi_token")
    need_labels = schema in ("labels", "multi_patch", "multi_token")

    text_df = None
    if need_text or need_tokens or schema == "multi_patch":
        try:
            text_df = _load_text_cls(data_dir)
            case_ids = [c for c in case_ids if c in set(text_df.index.astype(str))]
        except FileNotFoundError:
            if need_text:
                raise
    if need_patches:
        with_patches = _case_ids_with_patches(data_dir)
        if with_patches is not None:
            case_ids = [c for c in case_ids if c in with_patches]

    metainfos = {}
    meta_path = os.path.join(data_dir, "metainfos.pkl")
    if os.path.exists(meta_path):
        with open(meta_path, "rb") as f:
            metainfos = pickle.load(f)
        if need_labels:
            case_ids = [c for c in case_ids if c in metainfos]

    rna = rna.loc[[c for c in case_ids]]
    expr = rna.to_numpy(np.float32)
    gene_names = np.asarray(rna.columns)
    expr, keep = drop_mostly_zero_genes(expr, zero_gene_threshold)
    gene_names = gene_names[keep]
    if save_gene_names:
        np.save(os.path.join(data_dir, "gene_names.npy"), gene_names)

    tr, va, te = split_indices(len(case_ids), seed=seed)
    if normalization == "standardize":
        (e_tr, e_va, e_te), stats = standardize(expr[tr], expr[va], expr[te])
    elif normalization == "minmax":
        (e_tr, e_va, e_te), stats = minmax(expr[tr], expr[va], expr[te])
    else:
        e_tr, e_va, e_te, stats = expr[tr], expr[va], expr[te], None

    splits = {"train": {"genes": e_tr}, "val": {"genes": e_va}, "test": {"genes": e_te}}
    idx_of = {"train": tr, "val": va, "test": te}

    if text_df is not None and schema == "multi_patch":
        text = text_df.loc[case_ids].to_numpy(np.float32)
        for s, idx in idx_of.items():
            splits[s]["text_emb"] = text[idx]
    if need_tokens:
        tokens, tmask = _load_tokens(data_dir, case_ids, max_tokens)
        for s, idx in idx_of.items():
            splits[s]["tokens"] = tokens[idx]
            splits[s]["token_mask"] = tmask[idx]
    if need_patches:
        patches, pmask = _load_patches(data_dir, case_ids, num_patches, seed,
                                       bank=patch_bank)
        for s, idx in idx_of.items():
            splits[s]["patches"] = patches[idx]
            splits[s]["patch_mask"] = pmask[idx]
    d_vocab = s_vocab = None
    if need_labels and metainfos:
        disease, site, d_vocab, s_vocab = _encode_labels(metainfos, case_ids)
        for s, idx in idx_of.items():
            splits[s]["disease"] = disease[idx]
            splits[s]["site"] = site[idx]

    splits["meta"] = {
        "case_ids": case_ids, "gene_names": gene_names, "norm_stats": stats,
        "n_genes": expr.shape[1], "disease_vocab": d_vocab, "site_vocab": s_vocab,
        "split_indices": idx_of,
    }
    # record modality dims so callers can size fusion configs from the data
    # (the reference supports non-canonical widths, e.g. 128-d contrastive
    # projections from src/preprocess_embeddings.py)
    train = splits["train"]
    if "patches" in train:
        splits["meta"]["patch_dim"] = int(train["patches"].shape[-1])
    if "tokens" in train:
        splits["meta"]["text_dim"] = int(train["tokens"].shape[-1])
        splits["meta"]["num_tokens"] = int(train["tokens"].shape[1])
    elif "text_emb" in train:
        splits["meta"]["text_dim"] = int(train["text_emb"].shape[-1])
    return splits
