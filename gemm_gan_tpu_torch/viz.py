"""Visualization: loss curves, 2-D embeddings, real / generated panels,
gene distributions and distance matrices.

Counterpart of `gemm_gan_tpu/viz.py`. matplotlib is imported when a figure
is drawn, never when this module is imported, so the port runs where
matplotlib is not installed; `matplotlib_available` says whether it is, and
a figure asked for without it raises an `ImportError` that names it. Every
figure takes an `out_path` and draws with the Agg backend.

`umap_2d` runs the from-scratch UMAP of `utils/umap_lite.py` (umap-learn is
not among either machine's packages). `tsne_2d` runs `utils/tsne.py`, scikit-
learn's TSNE (Barnes-Hut's affinities, PCA init, its schedule) with the
exact gradient, on the card unless `device="cpu"` is asked for.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, Optional, Sequence

import numpy as np

from gemm_gan_tpu_torch.utils.device import DeviceLike


def matplotlib_available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    if not matplotlib_available():
        raise ImportError("matplotlib is not installed: the figures need it")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(plt, fig, out_path: Optional[str]):
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def plot_curves(history: Dict[str, Sequence[float]], out_path: Optional[str] = None,
                title: str = "training curves"):
    """Loss/metric curves, one line per key, against the index."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    for name, values in history.items():
        ax.plot(values, label=name)
    ax.set_xlabel("epoch")
    ax.legend()
    ax.set_title(title)
    return _save(plt, fig, out_path)


def tsne_2d(data: np.ndarray, perplexity: float = 30.0, seed: int = 42,
            device: DeviceLike = None) -> np.ndarray:
    """t-SNE embedding [n, 2] float32 (`utils.tsne.tsne`) with the JAX
    package's perplexity clamp, min(perplexity, max(2, (n - 1) / 3)).
    `seed` is kept for the JAX signature: the PCA init draws nothing, so
    the embedding does not depend on it."""
    from gemm_gan_tpu_torch.utils.tsne import tsne

    n = np.asarray(data).shape[0]
    perplexity = min(perplexity, max(2.0, (n - 1) / 3.0))
    return tsne(data, perplexity, device=device).embedding


def umap_2d(data: np.ndarray, n_neighbors: int = 15, seed: int = 42) -> np.ndarray:
    """UMAP embedding [n, 2] by `utils.umap_lite.umap_embed` (fuzzy kNN graph,
    spectral initialization, negative-sampling layout)."""
    from gemm_gan_tpu_torch.utils.umap_lite import umap_embed

    return umap_embed(np.asarray(data, np.float64), n_components=2,
                      n_neighbors=n_neighbors, seed=seed)


def plot_embedding_panels(real: np.ndarray, fake: np.ndarray,
                          labels: Optional[np.ndarray] = None,
                          method: str = "umap", out_path: Optional[str] = None,
                          label_names: Optional[Sequence[str]] = None,
                          device: DeviceLike = None):
    """A real / generated panel of one joint 2-D embedding (`method`
    "umap", or any other for t-SNE on `device`, as in JAX), and beside it
    the real points coloured by label when `labels` are given."""
    plt = _plt()
    both = np.concatenate([real, fake], axis=0)
    both = umap_2d(both) if method == "umap" else tsne_2d(both, device=device)
    er, ef = both[: len(real)], both[len(real):]

    ncols = 2 if labels is not None else 1
    fig, axes = plt.subplots(1, ncols, figsize=(6 * ncols, 5), squeeze=False)
    ax = axes[0, 0]
    ax.scatter(er[:, 0], er[:, 1], s=6, alpha=0.6, label="real")
    ax.scatter(ef[:, 0], ef[:, 1], s=6, alpha=0.6, label="generated")
    ax.legend()
    ax.set_title(f"{method}: real vs generated")
    if labels is not None:
        ax = axes[0, 1]
        labels = np.asarray(labels)
        for lab in np.unique(labels):
            pts = er[labels[: len(er)] == lab] if len(labels) >= len(er) else er
            name = (label_names[int(lab)] if label_names is not None else str(lab))
            ax.scatter(pts[:, 0], pts[:, 1], s=6, alpha=0.6, label=name)
        if len(np.unique(labels)) <= 12:
            ax.legend(fontsize=6)
        ax.set_title("real, colored by tissue")
    return _save(plt, fig, out_path)


def plot_gene_distributions(real: np.ndarray, fake: np.ndarray, gene_idx: Sequence[int],
                            out_path: Optional[str] = None):
    """Per-gene histograms of real against generated values."""
    plt = _plt()
    k = len(gene_idx)
    fig, axes = plt.subplots(1, k, figsize=(3 * k, 3), squeeze=False)
    for ax, g in zip(axes[0], gene_idx):
        ax.hist(real[:, g], bins=30, alpha=0.5, density=True, label="real")
        ax.hist(fake[:, g], bins=30, alpha=0.5, density=True, label="gen")
        ax.set_title(f"gene {g}", fontsize=8)
    axes[0, 0].legend(fontsize=6)
    return _save(plt, fig, out_path)


def plot_distance_matrix(real: np.ndarray, fake: np.ndarray, out_path: Optional[str] = None):
    """The sample-sample L2 distance matrix of [real | generated]."""
    plt = _plt()
    both = np.concatenate([real, fake], axis=0)
    d = np.sqrt(((both[:, None] - both[None, :]) ** 2).sum(-1))
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(d, cmap="magma")
    fig.colorbar(im, ax=ax)
    ax.axhline(len(real) - 0.5, color="w", lw=0.5)
    ax.axvline(len(real) - 0.5, color="w", lw=0.5)
    ax.set_title("pairwise distances [real | generated]")
    return _save(plt, fig, out_path)


def scatter_2d(data_2d: np.ndarray, labels: Sequence, out_path: Optional[str] = None,
               title: str = ""):
    """A 2-D embedding, one colour per label value, the legend outside."""
    plt = _plt()
    labels = np.asarray(labels)
    fig, ax = plt.subplots(figsize=(6, 5))
    for lab in np.unique(labels):
        m = labels == lab
        ax.scatter(data_2d[m, 0], data_2d[m, 1], s=8, alpha=0.7, label=str(lab))
    ax.legend(fontsize=6, bbox_to_anchor=(1.02, 1), loc="upper left")
    if title:
        ax.set_title(title)
    return _save(plt, fig, out_path)


def plot_distance_matrices(real: np.ndarray, fake: np.ndarray, out_path: Optional[str] = None):
    """Gene-gene correlation-distance matrices of real and generated
    expression side by side, and their difference."""
    plt = _plt()

    def corr_dist(a):
        s = (a - a.mean(0)) / (a.std(0) + 1e-8)
        return 1.0 - (s.T @ s) / a.shape[0]

    dr, df = corr_dist(real), corr_dist(fake)
    lo = min(dr.min(), df.min())
    hi = max(dr.max(), df.max())
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    for ax, (m, t) in zip(axes, ((dr, "real"), (df, "generated"),
                                 (np.abs(dr - df), "|difference|"))):
        im = ax.imshow(m, cmap="magma",
                       vmin=lo if t != "|difference|" else None,
                       vmax=hi if t != "|difference|" else None)
        ax.set_title(t)
        fig.colorbar(im, ax=ax, fraction=0.046)
    return _save(plt, fig, out_path)


def plot_learned_graph(adj: np.ndarray, out_dir: str, epoch: int):
    """Save a learned gene-graph adjacency as `learned_graph{epoch}.npy` and
    an inferno heatmap `learned_graph{epoch}.png` in `out_dir`; returns the
    png's path."""
    plt = _plt()
    adj = np.asarray(adj)
    np.save(os.path.join(out_dir, f"learned_graph{epoch}.npy"), adj)
    fig = plt.figure(figsize=(4, 4))
    im = plt.imshow(adj, cmap="inferno", interpolation="nearest", vmin=0, vmax=1.0)
    plt.colorbar(im, fraction=0.046, pad=0.04)
    plt.title("Learned graph")
    plt.axis("off")
    png = os.path.join(out_dir, f"learned_graph{epoch}.png")
    fig.savefig(png, bbox_inches="tight")
    plt.close(fig)
    return png
