"""Gamma correlation score (Viñas et al.), the primary quality metric.

Counterpart of `gemm_gan_tpu/eval/gamma.py`: gene-gene Pearson-correlation
distance matrices of real and generated expression, then the Pearson
correlation between their condensed upper-triangular lists, with the
reference's zero-variance guard (a standardized value falls back to the
centered one).

Two paths:
  * numpy (`*_np`, the scipy extras and the TF-TG helpers): copies of the
    JAX package's;
  * blocked on the device (`gamma_coef`): each block of `block` genes takes
    its rows of the two correlation matrices as one GEMM each and adds the
    masked first, second and cross moments over the strict upper triangle
    into float64 sums, so no G x G matrix (1.4 GB in f32 at 18,868 genes)
    is ever built.
"""

from __future__ import annotations

import numpy as np
import torch

from gemm_gan_tpu_torch.utils.device import DeviceLike, as_f32


# ---------------------------------------------------------------- numpy path
def _standardize_np(a):
    mean = np.mean(a, axis=0)
    std = np.std(a, axis=0)
    s = (a - mean) / std
    nanmask = np.isnan(s)
    s[nanmask] = (a - mean)[nanmask]
    return s


def pearson_correlation(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Gene-gene correlation matrix between columns of x and y. Shape (Gx, Gy)."""
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"sample counts differ: {x.shape[0]} vs {y.shape[0]}")
    return np.dot(_standardize_np(x).T, _standardize_np(y)) / x.shape[0]


def upper_diag_list(m: np.ndarray) -> np.ndarray:
    """Condensed strict upper-triangle of a square matrix, row-major."""
    iu = np.triu_indices(m.shape[0], k=1)
    return np.asarray(m)[iu]


def correlations_list(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return upper_diag_list(pearson_correlation(x, y))


def gamma_coef_np(x: np.ndarray, y: np.ndarray) -> float:
    """Pure-numpy gamma (golden reference for tests)."""
    dists_x = 1 - correlations_list(x, x)
    dists_y = 1 - correlations_list(y, y)
    return float(pearson_correlation(dists_x[:, None], dists_y[:, None])[0, 0])


def gamma_coeff_score(x_test, x_gen, device: DeviceLike = None) -> float:
    return gamma_coef(x_test, x_gen, device=device)


# -------------------------------------------------------------- device path
def _standardize_cols(a: torch.Tensor) -> torch.Tensor:
    mean = a.mean(dim=0)
    std = a.std(dim=0, unbiased=False)
    centered = a - mean
    return torch.where(std > 0, centered / torch.where(std > 0, std, 1.0), centered)


def _gamma_moments(x: torch.Tensor, y: torch.Tensor, block: int) -> np.ndarray:
    """(count, sum dx, sum dy, sum dx², sum dy², sum dx dy) over the strict
    upper triangle of the distance matrices dx = 1 - corr(x), dy = 1 -
    corr(y), each correlation over its own samples (x and y may differ in
    sample count), block rows at a time; float64 sums of float32 blocks."""
    n_x, g = x.shape
    n_y = y.shape[0]
    xs, ys = _standardize_cols(x), _standardize_cols(y)
    total = torch.zeros(6, dtype=torch.float64, device=x.device)
    for s in range(0, g, block):
        e = min(s + block, g)
        dx = 1.0 - (xs[:, s:e].T @ xs) / n_x      # [rows, g]
        dy = 1.0 - (ys[:, s:e].T @ ys) / n_y
        # row s + i keeps columns > s + i
        mask = torch.ones_like(dx, dtype=torch.bool).triu_(s + 1)
        dx, dy = dx * mask, dy * mask
        total += torch.stack([mask.sum().double(), dx.sum().double(), dy.sum().double(),
                              (dx * dx).sum().double(), (dy * dy).sum().double(),
                              (dx * dy).sum().double()])
    return total.cpu().numpy()


def gamma_coef(x, y, block: int = 1024, device: DeviceLike = None) -> float:
    """Gamma between expression matrices x (real) and y (generated)."""
    x = as_f32(x, device)
    y = as_f32(y, x.device)
    block = min(block, x.shape[1])
    with torch.no_grad():
        cnt, sx, sy, sxx, syy, sxy = (float(v) for v in _gamma_moments(x, y, block))
    mx, my = sx / cnt, sy / cnt
    vx = sxx / cnt - mx * mx
    vy = syy / cnt - my * my
    cov = sxy / cnt - mx * my
    denom = np.sqrt(max(vx, 0.0)) * np.sqrt(max(vy, 0.0))
    if denom == 0:
        return float(cov)  # matches reference fallback: centered (not scaled)
    return float(cov / denom)


# ----------------------------------------------- dendrogram/cophenetic extras
def hierarchical_clustering(data: np.ndarray):
    """Complete-linkage clustering of genes on correlation distance."""
    from scipy.cluster.hierarchy import linkage

    y = 1 - correlations_list(data, data)
    return linkage(y, "complete")


def gamma_coefficients(expr_x: np.ndarray, expr_z: np.ndarray):
    """(gamma_dx_dz, gamma_dx_tx, gamma_dz_tz, gamma_tx_tz) incl. cophenetic
    tree distances."""
    from scipy.cluster.hierarchy import cophenet

    dists_x = 1 - correlations_list(expr_x, expr_x)
    dists_z = 1 - correlations_list(expr_z, expr_z)
    gamma_dx_dz = pearson_correlation(dists_x[:, None], dists_z[:, None])[0, 0]
    lx = hierarchical_clustering(expr_x)
    lz = hierarchical_clustering(expr_z)
    # scipy cophenet(Z, Y) returns (cophenetic corr coefficient, coph dists)
    c_x, coph_x = cophenet(lx, dists_x)
    c_z, coph_z = cophenet(lz, dists_z)
    gamma_tx_tz = pearson_correlation(coph_x[:, None], coph_z[:, None])[0, 0]
    return float(gamma_dx_dz), float(c_x), float(c_z), float(gamma_tx_tz)


# ------------------------------------------------------------------- TF-TG
def tf_tg_corrs(expr: np.ndarray, gene_names, tf_tg: dict):
    """Per-TF correlations with its target genes (compact dict form)."""
    idx = {g: i for i, g in enumerate(gene_names)}
    out = {}
    for tf, tgs in tf_tg.items():
        if tf not in idx:
            continue
        tg_idx = [idx[t] for t in tgs if t in idx]
        if not tg_idx:
            continue
        corr = pearson_correlation(expr[:, [idx[tf]]], expr[:, tg_idx])
        out[tf] = corr.ravel()
    return out


def load_tf_tg_graph(path: str) -> dict:
    """TF -> target genes from a TSV graph file of `tf \\t _ \\t tg` lines."""
    tf_tg = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            tf, _, tg = line.split("\t")
            tf_tg.setdefault(tf, []).append(tg)
    return tf_tg


def compute_tf_tg_corrs(expr: np.ndarray, gene_symbols, tf_tg: dict, flat: bool = True):
    """(TF-TG correlations, TG-TG correlations) per TF, optionally flattened:
    for each TF present in the expression matrix with at least one present
    target, the condensed TG-TG correlation list of its targets and the
    TF-vs-each-TG correlation list."""
    gene_symbols = np.asarray(gene_symbols)
    tf_tg_corr, tg_tg_corr = [], []
    for tf, tgs in tf_tg.items():
        tg_idxs = np.array([np.where(gene_symbols == tg)[0]
                            for tg in tgs if tg in gene_symbols]).ravel()
        if tf in gene_symbols and len(tg_idxs) > 0:
            expr_tgs = expr[:, tg_idxs.astype(int)]
            tg_tg_corr.append(correlations_list(expr_tgs, expr_tgs).tolist())
            tf_idx = int(np.argwhere(gene_symbols == tf)[0][0])
            corr = pearson_correlation(expr[:, [tf_idx]], expr_tgs).ravel()
            tf_tg_corr.append(corr.tolist())
    if flat:
        tf_tg_corr = [c for lst in tf_tg_corr for c in lst]
        tg_tg_corr = [c for lst in tg_tg_corr for c in lst]
    return tf_tg_corr, tg_tg_corr
