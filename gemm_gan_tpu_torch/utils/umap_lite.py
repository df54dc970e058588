"""Minimal from-scratch UMAP (numpy + scipy), for `viz.umap_2d`.

The port's copy of `gemm_gan_tpu/utils/umap_lite.py`, unchanged below this
docstring, so the same seed gives the same embedding bit for bit. The
original code's embedding panels use umap-learn, which neither this port's
machines nor the JAX package's have; this is the UMAP algorithm (McInnes
et al. 2018), reduced to the pieces the visualization path needs:

  1. exact kNN graph (blocked squared-Euclidean distances);
  2. fuzzy simplicial set: per-point connectivity calibration — rho_i =
     nearest-neighbor distance, sigma_i binary-searched so the smoothed
     neighbor weights sum to log2(k) — then probabilistic t-conorm
     symmetrization  a + a' - a ∘ a';
  3. spectral initialization from the symmetric normalized graph Laplacian;
  4. stochastic layout: per-edge attraction sampled proportionally to edge
     weight, `negative_sample_rate` random repulsions per positive sample,
     under the smooth approximation  w(d) = (1 + a d^{2b})^{-1}  of the
     min_dist membership curve, with a linearly decaying learning rate.

Differences vs umap-learn, by design: exact (not NN-descent approximate)
kNN — fine at visualization sample sizes (<= a few thousand points); no
transform()/inverse_transform/supervised modes; (a, b) for the default
min_dist=0.1/spread=1.0 are the standard fitted constants rather than a
runtime curve fit.
"""

from __future__ import annotations

import numpy as np

# (a, b) minimizing ||(1 + a d^{2b})^{-1} - curve(min_dist, spread)|| for the
# default min_dist=0.1, spread=1.0 (umap-learn's find_ab_params output)
_AB = {"default": (1.57694346, 0.89506088)}


def _fit_ab(min_dist: float, spread: float):
    """Least-squares fit of (a, b) to the piecewise target curve
    exp(-(d - min_dist)/spread) for d > min_dist, 1 otherwise."""
    if abs(min_dist - 0.1) < 1e-9 and abs(spread - 1.0) < 1e-9:
        return _AB["default"]
    from scipy.optimize import curve_fit

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b)),
                          xv, yv, p0=(1.5, 0.9), maxfev=10000)
    return float(a), float(b)


def _knn(data: np.ndarray, k: int, block: int = 1024):
    """Exact kNN (excluding self): returns (indices [n,k], distances [n,k])."""
    n = data.shape[0]
    sq = np.einsum("ij,ij->i", data, data)
    idx = np.empty((n, k), np.int64)
    dst = np.empty((n, k), np.float64)
    for s in range(0, n, block):
        e = min(s + block, n)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * (data[s:e] @ data.T)
        np.maximum(d2, 0.0, out=d2)
        d2[np.arange(s, e) - s, np.arange(s, e)] = np.inf  # exclude self
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(d2, part, axis=1)
        order = np.argsort(pd, axis=1)
        idx[s:e] = np.take_along_axis(part, order, axis=1)
        dst[s:e] = np.sqrt(np.take_along_axis(pd, order, axis=1))
    return idx, dst


def _smooth_knn_weights(dists: np.ndarray, k: int, n_iter: int = 64):
    """Per-point (rho, sigma) calibration and membership strengths
    exp(-max(d - rho, 0)/sigma), with sum-per-row target log2(k)."""
    rho = dists[:, 0]
    target = np.log2(k)
    lo = np.zeros(len(dists))
    hi = np.full(len(dists), np.inf)
    sigma = np.ones(len(dists))
    adj = np.maximum(dists - rho[:, None], 0.0)
    for _ in range(n_iter):
        psum = np.exp(-adj / sigma[:, None]).sum(axis=1)
        high = psum > target
        hi = np.where(high, sigma, hi)
        lo = np.where(high, lo, sigma)
        sigma = np.where(np.isinf(hi), sigma * 2.0, (lo + hi) / 2.0)
    # umap-learn floors sigma at a fraction of the mean distance
    mean_d = dists.mean()
    sigma = np.maximum(sigma, 1e-3 * mean_d)
    return rho, sigma, np.exp(-adj / sigma[:, None])


def _fuzzy_graph(data: np.ndarray, k: int):
    """Symmetrized fuzzy simplicial set as COO edge arrays (heads, tails, w)."""
    from scipy.sparse import coo_matrix

    idx, dst = _knn(data, k)
    _, _, w = _smooth_knn_weights(dst, k)
    n = data.shape[0]
    rows = np.repeat(np.arange(n), k)
    a = coo_matrix((w.ravel(), (rows, idx.ravel())), shape=(n, n)).tocsr()
    at = a.T.tocsr()
    sym = a + at - a.multiply(at)          # probabilistic t-conorm
    sym = sym.tocoo()
    keep = sym.data > 0
    return sym.row[keep], sym.col[keep], sym.data[keep], n


def _spectral_init(heads, tails, weights, n: int, dim: int, seed: int):
    """Eigenvectors 2..dim+1 of the symmetric normalized Laplacian."""
    from scipy.sparse import coo_matrix, identity
    from scipy.sparse.linalg import eigsh

    g = coo_matrix((weights, (heads, tails)), shape=(n, n)).tocsr()
    deg = np.asarray(g.sum(axis=1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = identity(n) - g.multiply(dinv[:, None]).multiply(dinv[None, :])
    try:
        k = dim + 1
        _, vecs = eigsh(lap, k=k, which="SM", tol=1e-4,
                        v0=np.random.RandomState(seed).rand(n))
        emb = vecs[:, 1:k]
    except Exception:  # convergence failure on pathological graphs
        emb = np.random.RandomState(seed).randn(n, dim)
    # scale to the ~10-unit box umap-learn starts from
    emb = emb / (np.abs(emb).max() + 1e-12) * 10.0
    return emb.astype(np.float32)


def umap_embed(data: np.ndarray, n_components: int = 2, n_neighbors: int = 15,
               min_dist: float = 0.1, spread: float = 1.0,
               n_epochs: int = None, negative_sample_rate: int = 5,
               learning_rate: float = 1.0, seed: int = 42) -> np.ndarray:
    """UMAP layout of `data` [n, d] -> [n, n_components]."""
    data = np.asarray(data, np.float64)
    n = data.shape[0]
    k = int(min(n_neighbors, n - 1))
    if n <= n_components + 1:
        return np.zeros((n, n_components), np.float32)
    heads, tails, weights, _ = _fuzzy_graph(data, k)
    emb = _spectral_init(heads, tails, weights, n, n_components, seed)

    if n_epochs is None:
        n_epochs = 500 if n < 10000 else 200
    a, b = _fit_ab(min_dist, spread)

    # umap-learn's epoch scheduling: edge e is sampled every
    # n_epochs/(w_e/w_max * n_epochs) epochs; vectorized equivalent below
    # samples each edge Bernoulli(w_e/w_max) per epoch — same expected
    # counts, simpler bookkeeping
    wmax = weights.max()
    p_edge = weights / wmax
    rng = np.random.RandomState(seed)
    emb = emb.astype(np.float64)
    clip = 4.0
    for epoch in range(n_epochs):
        alpha = learning_rate * (1.0 - epoch / n_epochs)
        sel = rng.rand(len(p_edge)) < p_edge
        h, t = heads[sel], tails[sel]
        # attraction along sampled edges. Coincident endpoints (d2 == 0 —
        # e.g. duplicated rows that spectral init places identically) get
        # zero gradient, as in umap-learn's `if dist_squared > 0` guard:
        # with b < 1, d2**(b-1) at 0 is inf and the -inf coefficient times
        # the zero displacement would NaN-poison the whole layout.
        d = emb[h] - emb[t]
        d2 = np.einsum("ij,ij->i", d, d)
        safe = np.where(d2 > 0.0, d2, 1.0)
        gcoef = np.where(
            d2 > 0.0, (-2.0 * a * b * safe ** (b - 1.0)) / (1.0 + a * safe ** b),
            0.0)
        grad = np.clip(gcoef[:, None] * d, -clip, clip)
        np.add.at(emb, h, alpha * grad)
        np.add.at(emb, t, -alpha * grad)
        # negative sampling: repulsion from random points (head side only,
        # as in umap-learn)
        for _ in range(negative_sample_rate):
            neg = rng.randint(0, n, size=len(h))
            d = emb[h] - emb[neg]
            d2 = np.einsum("ij,ij->i", d, d)
            gcoef = (2.0 * b) / ((0.001 + d2) * (1.0 + a * d2 ** b))
            grad = np.clip(gcoef[:, None] * d, -clip, clip)
            np.add.at(emb, h, alpha * grad)
    return emb.astype(np.float32)
