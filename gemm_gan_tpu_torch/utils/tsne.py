"""t-SNE on the device, with scikit-learn's defaults.

The JAX package's `viz.tsne_2d` calls scikit-learn's
`TSNE(n_components=2, init="pca")`, whose default method is Barnes-Hut.
The card's machine has no scikit-learn, so this module computes the same
embedding in PyTorch on the device, in the same steps
(`sklearn/manifold/_t_sne.py`, scikit-learn 1.9):

* **Input affinities** (`joint_probabilities`): the k = min(n - 1,
  floor(3 perplexity + 1)) nearest neighbours of each point by squared
  euclidean distance (float64 products, rounded to float32 as scikit-learn
  hands them on), each row's conditional distribution fitted to the
  perplexity by the binary search of `_utils._binary_search_perplexity` in
  float64 (all rows at once; a row stops where scikit-learn's loop
  breaks), then P = (P_cond + P_cond^T) / sum, kept as its nonzero entries
  (`Affinities`, sorted by row).
* **Init** (`pca_init`): the two principal components (from the smaller
  of the Gram and the covariance matrix, by `torch.linalg.eigh` in
  float64) with `svd_flip`'s signs (each component's entry of largest
  magnitude positive), scaled so that column 0 has standard deviation
  1e-4. Nothing is drawn.
* **Optimizer** (`tsne`): Student-t with one degree of freedom, early
  exaggeration 12 for 250 iterations at momentum 0.5, then momentum 0.8
  up to 1,000 iterations, learning rate max(n / 12 / 4, 50), gains +0.2 /
  x0.8 with a floor of 0.01, each stage starting from zero update and unit
  gains; every 50 iterations the error and the gradient norm are read:
  the stage stops after more than its patience (250, then 300) iterations
  without a lower error, or at a gradient norm of at most 1e-7.
* **Gradient: exact**, O(n^2) per iteration, where scikit-learn
  approximates its repulsive half by Barnes-Hut: the repulsion and the
  normalisation Z over every pair, blocked over rows (at most
  `BLOCK_BYTES` of [rows, n] temporaries), the attraction over P's
  entries. The error is the exact KL(P || Q) over P's entries.

The embedding is computed in float32, as scikit-learn's is; the
attraction's per-row sums run as a float64 prefix sum and no sum depends
on the order of atomic adds, so a run repeats bit for bit on the same
device. It cannot be bitwise with scikit-learn
(another gradient): `tests/test_torch_tsne.py` holds the deterministic
parts exactly and the embedding by its quality.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gemm_gan_tpu_torch.utils.device import DeviceLike, resolve_device

EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERS = 250
MAX_ITER = 1000
N_ITER_CHECK = 50
N_ITER_WITHOUT_PROGRESS = 300
MIN_GRAD_NORM = 1e-7
MIN_GAIN = 0.01
BINARY_SEARCH_STEPS = 100
BLOCK_BYTES = 256 * 2 ** 20
# scikit-learn's C constants, single precision (`_utils.pyx`)
PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
EPSILON_DBL = float(np.float32(1e-8))
MACHINE_EPSILON = float(np.finfo(np.double).eps)
FLOAT32_TINY = float(np.finfo(np.float32).tiny)
_TEMPORARIES = 8  # [rows, n] float32 tensors alive at once in a gradient block


class Affinities(NamedTuple):
    """The joint probabilities' nonzero entries, sorted by row: `rows`,
    `cols` (int64), `vals` (float64), and `crow` [n + 1], the offset of
    each row's first entry."""
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    crow: torch.Tensor


class TSNEResult(NamedTuple):
    embedding: np.ndarray  # [n, 2] float32
    kl_divergence: float   # exact KL(P || Q) of the embedding
    n_iter: int            # the last iteration's index, as scikit-learn's n_iter_


def _row_blocks(n: int, bytes_per_row: int):
    rows = max(1, BLOCK_BYTES // max(1, bytes_per_row))
    return [(r0, min(n, r0 + rows)) for r0 in range(0, n, rows)]


def n_neighbors(n: int, perplexity: float) -> int:
    return min(n - 1, int(3.0 * perplexity + 1))


def nearest_neighbors(x: torch.Tensor, k: int):
    """(squared distances float32 [n, k], indices [n, k]) of each row's k
    nearest other rows of `x` (float64), by ||a||^2 + ||b||^2 - 2 a.b."""
    n = x.shape[0]
    sq = (x * x).sum(1)
    dist, idx = [], []
    for r0, r1 in _row_blocks(n, 2 * 8 * n):
        d = sq[r0:r1, None] + sq[None, :] - 2.0 * (x[r0:r1] @ x.T)
        d.clamp_(min=0.0)
        d[:, r0:r1].fill_diagonal_(math.inf)
        v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
        dist.append(v.float())
        idx.append(i)
    return torch.cat(dist), torch.cat(idx)


def conditional_probabilities(sq_dist: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Each row's p_{j|i} over its neighbours, float64 [n, k]: the binary
    search for the Gaussian's precision beta of scikit-learn's
    `_binary_search_perplexity`, all rows at once. A row whose entropy is
    within PERPLEXITY_TOLERANCE of log(perplexity) keeps that step's P and
    beta; the others halve the bracket, as the loop does."""
    d = sq_dist.double()
    n = d.shape[0]
    desired = math.log(float(np.float32(perplexity)))
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    active = torch.ones(n, dtype=torch.bool, device=d.device)
    out = torch.zeros_like(d)
    for step in range(BINARY_SEARCH_STEPS):
        p = torch.exp(-d * beta[:, None])
        s = p.sum(1)
        s = torch.where(s == 0.0, torch.full_like(s, EPSILON_DBL), s)
        p = p / s[:, None]
        diff = torch.log(s) + beta * (d * p).sum(1) - desired
        out = torch.where(active[:, None], p, out)
        go = active & (diff.abs() > PERPLEXITY_TOLERANCE)
        up = diff > 0.0
        new_beta = torch.where(
            up, torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            torch.where(torch.isinf(lo), beta / 2.0, (beta + lo) / 2.0))
        lo = torch.where(go & up, beta, lo)
        hi = torch.where(go & ~up, beta, hi)
        beta = torch.where(go, new_beta, beta)
        active = go
        if step % 10 == 9 and not bool(active.any()):
            break
    return out


def joint_probabilities(x: torch.Tensor, perplexity: float) -> Affinities:
    """scikit-learn's `_joint_probabilities_nn` over the kNN graph of `x`
    (float64 [n, d] on the device)."""
    n = x.shape[0]
    k = n_neighbors(n, perplexity)
    sq_dist, idx = nearest_neighbors(x, k)
    p = conditional_probabilities(sq_dist, perplexity)
    rows = torch.arange(n, device=x.device).repeat_interleave(k)
    cols = idx.reshape(-1)
    # P_cond + P_cond^T over the union of (i, j) and (j, i): each entry sums
    # at most two terms, so the sum does not depend on their order
    keys, where = torch.unique(torch.cat([rows * n + cols, cols * n + rows]), sorted=True,
                               return_inverse=True)
    vals = torch.zeros(len(keys), dtype=torch.float64, device=x.device)
    vals.index_add_(0, where, torch.cat([p.reshape(-1), p.reshape(-1)]))
    r, c = keys // n, keys % n
    vals = vals / max(float(vals.sum()), MACHINE_EPSILON)
    crow = torch.zeros(n + 1, dtype=torch.long, device=x.device)
    crow[1:] = torch.bincount(r, minlength=n).cumsum(0)
    return Affinities(r, c, vals, crow)


def pca_init(x: torch.Tensor) -> torch.Tensor:
    """scikit-learn's PCA init of `x` (float64 [n, d]): the scores of the
    two principal components with `svd_flip`'s signs, float32, scaled so
    that column 0 has standard deviation 1e-4."""
    n, d = x.shape
    xc = x - x.mean(0)
    if n <= d:  # the Gram matrix: U and S, then the components' rows
        evals, evecs = torch.linalg.eigh(xc @ xc.T)
        u, s = evecs[:, -2:].flip(1), evals[-2:].flip(0).clamp(min=0).sqrt()
        scores = u * s
        comps = (u.T @ xc) / torch.where(s > 0, s, torch.ones_like(s))[:, None]
    else:  # the covariance: the components, then the scores
        evals, evecs = torch.linalg.eigh(xc.T @ xc)
        comps = evecs[:, -2:].flip(1).T
        scores = xc @ comps.T
    signs = torch.sign(comps.gather(1, comps.abs().argmax(1, keepdim=True)))[:, 0]
    y = (scores * signs).float()
    return y / y[:, 0].double().std(unbiased=False).float() * 1e-4


def _edge_terms(y: torch.Tensor, P: Affinities):
    """Per entry of P: y_i - y_j [nnz, 2] and the Student-t kernel w_ij."""
    d = y[P.rows] - y[P.cols]
    return d, 1.0 / (1.0 + (d * d).sum(1))


def _normaliser_and_repulsion(y: torch.Tensor, with_repulsion: bool = True):
    """(Z = sum over pairs i != j of w_ij, as a float64 tensor, and
    sum_j w_ij^2 (y_i - y_j) [n, 2] float32), blocked over rows."""
    n = y.shape[0]
    z = torch.zeros((), dtype=torch.float64, device=y.device)
    rep = torch.empty_like(y) if with_repulsion else None
    for r0, r1 in _row_blocks(n, _TEMPORARIES * 4 * n):
        dx = y[r0:r1, 0:1] - y[None, :, 0]
        dy = y[r0:r1, 1:2] - y[None, :, 1]
        w = torch.reciprocal(1.0 + dx * dx + dy * dy)
        w[:, r0:r1].fill_diagonal_(0.0)
        z += w.sum(dtype=torch.float64)
        if with_repulsion:
            w2 = w * w
            rep[r0:r1, 0] = (w2 * dx).sum(1)
            rep[r0:r1, 1] = (w2 * dy).sum(1)
    return z, rep


def _kl(p32: torch.Tensor, w: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """sum over P's entries of p log(p / q), q = w / Z, both floored at
    float32's tiny (scikit-learn's error), in float64."""
    p, q = p32.double(), w.double() / z
    return (p * torch.log(p.clamp(min=FLOAT32_TINY) / q.clamp(min=FLOAT32_TINY))).sum()


def exact_kl(P: Affinities, y: torch.Tensor) -> float:
    """KL(P || Q) of the embedding `y` [n, 2] over P's entries, the
    normaliser Z over every pair."""
    z, _ = _normaliser_and_repulsion(y, with_repulsion=False)
    return float(_kl(P.vals.float(), _edge_terms(y, P)[1], z))


def _gradient(y: torch.Tensor, P: Affinities, p32: torch.Tensor, error: bool):
    """(dC/dy [n, 2] float32, the KL as a float64 tensor or None) of the
    exact t-SNE objective with one degree of freedom: 4 (sum_j p_ij w_ij
    (y_i - y_j) - sum_j w_ij^2 / Z (y_i - y_j))."""
    z, rep = _normaliser_and_repulsion(y)
    d, w = _edge_terms(y, P)
    # per-row sums as differences of a float64 prefix sum along the entries
    # (the inner dim: a scan along an outer dim of 2 columns runs serially)
    csum = torch.zeros((2, d.shape[0] + 1), dtype=torch.float64, device=y.device)
    csum[:, 1:] = ((p32 * w)[None, :] * d.T).double().cumsum(1)
    attract = (csum[:, P.crow[1:]] - csum[:, P.crow[:-1]]).T.float()
    grad = 4.0 * (attract - rep / z.float())
    return grad, (_kl(p32, w, z) if error else None)


def _descend(y, P, exaggeration, learning_rate, momentum, start, stop, patience):
    """scikit-learn's `_gradient_descent` from iteration `start` to `stop`
    (exclusive), in place on `y`. Returns (last error, last iteration)."""
    p32 = (P.vals * exaggeration).float()
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    error, best_error, best_iter, i = math.inf, math.inf, start, start
    for i in range(start, stop):
        check = (i + 1) % N_ITER_CHECK == 0
        grad, kl = _gradient(y, P, p32, check or i == stop - 1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_(min=MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y += update
        if kl is not None:
            error = float(kl)
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad.double()))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > patience:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return error, i


def tsne(data, perplexity: float = 30.0, device: DeviceLike = None) -> TSNEResult:
    """A 2-D t-SNE embedding of `data` [n, d] (cast to float32, as the JAX
    package hands it to scikit-learn) on `device` (the card unless "cpu"
    is asked for), with scikit-learn's defaults (module docstring)."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(data, np.float32), device=dev).double()
    n = x.shape[0]
    if n < 3 or x.shape[1] < 2:
        raise ValueError(f"t-SNE needs at least 3 points of 2 features, got {tuple(x.shape)}")
    if not perplexity < n:
        raise ValueError(f"perplexity ({perplexity}) must be less than n_samples ({n})")
    P = joint_probabilities(x, perplexity)
    y = pca_init(x)
    del x
    lr = max(n / EARLY_EXAGGERATION / 4.0, 50.0)
    _, it = _descend(y, P, EARLY_EXAGGERATION, lr, 0.5, 0, EXPLORATION_ITERS,
                     EXPLORATION_ITERS)
    _, it = _descend(y, P, 1.0, lr, 0.8, it + 1, MAX_ITER, N_ITER_WITHOUT_PROGRESS)
    return TSNEResult(y.cpu().numpy(), exact_kl(P, y), it)
