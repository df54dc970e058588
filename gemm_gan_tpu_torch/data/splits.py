"""Dataset splitting and normalization.

A copy of `gemm_gan_tpu/data/splits.py` (numpy only), kept here so the port
imports nothing of the JAX package; the same inputs give the same arrays.
Parity with the reference loaders (`src/data_loader.py` of the original
GeMM-GAN code): a seeded 80/20 train/test shuffle split, then 20% of train
becomes validation (net 64/16/20); normalization statistics are computed on
the TRAIN split only; genes with zero variance (NaN after standardize) are
mapped to 0, matching the reference's `fillna(0)`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def split_indices(n: int, seed: int = 42, test_fraction: float = 0.2,
                  val_fraction: float = 0.2) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (train_idx, val_idx, test_idx) with the reference's 64/16/20 law.

    The seeded MT19937 permutation is consumed train-first, then validation,
    then test, with `int()`-truncated cut points
    `t_tr = int(train_rate*(1-val_rate)*n)` and
    `t_val = t_tr + int(train_rate*val_rate*n)`, as the reference's
    `split_data` does.
    """
    train_rate = 1.0 - test_fraction
    perm = np.random.RandomState(seed).permutation(n)
    t_tr = int(train_rate * (1.0 - val_fraction) * n)
    t_val = t_tr + int(train_rate * val_fraction * n)
    return perm[:t_tr], perm[t_tr:t_val], perm[t_val:]


def standardize(train: np.ndarray, *others: np.ndarray, eps: float = 0.0):
    """Z-score by train statistics; zero-variance features -> 0."""
    mean = train.mean(axis=0)
    std = train.std(axis=0)
    safe = np.where(std > eps, std, 1.0)

    def tf(x):
        out = (x - mean) / safe
        out[:, std <= eps] = 0.0
        return out.astype(np.float32)

    return (tf(train), *[tf(o) for o in others]), (mean, std)


def minmax(train: np.ndarray, *others: np.ndarray):
    """Min-max scale by train statistics; constant features -> 0."""
    lo = train.min(axis=0)
    hi = train.max(axis=0)
    rng = hi - lo
    safe = np.where(rng > 0, rng, 1.0)

    def tf(x):
        out = (x - lo) / safe
        out[:, rng <= 0] = 0.0
        return out.astype(np.float32)

    return (tf(train), *[tf(o) for o in others]), (lo, hi)


def inverse_standardize(x: np.ndarray, stats) -> np.ndarray:
    mean, std = stats
    return x * np.where(std > 0, std, 1.0) + mean


def drop_mostly_zero_genes(expr: np.ndarray, threshold: float = 0.9):
    """Drop genes whose zero-fraction exceeds `threshold`, as the reference
    loader does. Returns (filtered, keep_mask)."""
    zero_frac = (expr == 0).mean(axis=0)
    keep = zero_frac <= threshold
    return expr[:, keep], keep
