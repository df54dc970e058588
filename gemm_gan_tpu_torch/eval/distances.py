"""Distribution distances: exact and Sinkhorn Wasserstein, linear, polynomial
and RBF-mixture MMD.

Counterpart of `gemm_gan_tpu/eval/distances.py`, with the same formulas:

  * the exact 1- and 2-Wasserstein between two samples (uniform marginals,
    L2 cost, squared for power 2, the square root of the cost for power 2):
    a float64 cost matrix of true pairwise differences (`cost_matrix`),
    blocked over rows on the device, handed to the port's native network
    simplex (`native/ot.py`). There is no fallback: the library builds or
    the call raises;
  * Sinkhorn's transport cost in the log domain, on the device in f32,
    `torch.logsumexp` over JAX's 500 iterations;
  * the MMDs on the device in f32 (full-f32 products).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from gemm_gan_tpu_torch.native.ot import exact_emd2
from gemm_gan_tpu_torch.utils.device import DeviceLike, as_f32, resolve_device

min_var_est = 1e-8
# bytes of one block of the exact cost matrix's float64 differences
# ([rows, m, G]); see `cost_matrix`
COST_BLOCK_BYTES = 256 * 2 ** 20


# ---------------------------------------------------------------- transport
def _cdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x2 = (x * x).sum(1)[:, None]
    y2 = (y * y).sum(1)[None, :]
    return torch.sqrt(torch.clamp(x2 + y2 - 2.0 * (x @ y.T), min=0.0))


@torch.no_grad()
def sinkhorn_cost(M: torch.Tensor, a: torch.Tensor, b: torch.Tensor, reg: float = 0.05,
                  num_iters: int = 500) -> torch.Tensor:
    """Log-domain Sinkhorn transport cost <P, M> (as `ot.sinkhorn2`), on the
    tensors' device and in their dtype; a 0-d tensor."""
    logK = -M / reg
    loga, logb = torch.log(a), torch.log(b)
    f, g = torch.zeros_like(a), torch.zeros_like(b)
    for _ in range(num_iters):
        g = reg * (logb - torch.logsumexp(logK + f[:, None] / reg, dim=0))
        f = reg * (loga - torch.logsumexp(logK + g[None, :] / reg, dim=1))
    P = torch.exp((f[:, None] + g[None, :] - M) / reg)
    return (P * M).sum()


def emd2(a, b, M) -> float:
    """Exact optimal-transport cost <P*, M> with marginals a, b, in float64
    through the native network simplex."""
    return exact_emd2(np.asarray(a, np.float64), np.asarray(b, np.float64),
                      np.asarray(M, np.float64))


@torch.no_grad()
def cost_matrix(x0, x1, power: int = 2, device: DeviceLike = None) -> np.ndarray:
    """The exact path's [n, m] float64 cost: the L2 distance of true pairwise
    differences (squared for power 2), built on `device`.

    Not the Gram trick x² + y² - 2xy: in float32 its cancellation reaches
    about 0.2 on the diagonal of x against itself, which moves the optimum.
    The differences [rows, m, G] are taken a block of rows at a time,
    squared in place and summed, so the peak is one block of at most
    COST_BLOCK_BYTES (256 MiB; 11 rows at m 155 and G 18,868) besides the
    two samples and the result, where broadcasting all of them at once
    takes n·m·G·8 bytes (3.6 GB at 155 x 155 x 18,868)."""
    dev = resolve_device(device)
    h0 = torch.as_tensor(np.asarray(x0, np.float64).reshape(len(x0), -1), device=dev)
    h1 = torch.as_tensor(np.asarray(x1, np.float64).reshape(len(x1), -1), device=dev)
    m, g = h1.shape
    rows = max(1, COST_BLOCK_BYTES // (8 * m * g))
    out = torch.empty(len(h0), m, dtype=torch.float64, device=dev)
    for s in range(0, len(h0), rows):
        d = h0[s:s + rows, None, :] - h1[None, :, :]
        out[s:s + rows] = d.mul_(d).sum(-1)
    if power == 1:
        out.sqrt_()
    return out.cpu().numpy()


def wasserstein(x0, x1, method: Optional[str] = None, reg: float = 0.05,
                power: int = 2, device: DeviceLike = None) -> float:
    """1- or 2-Wasserstein between samples x0 [n, ...] and x1 [m, ...]:
    uniform marginals, L2 cost (squared for power 2), the square root of the
    cost for power 2. `method="sinkhorn"` takes the f32 Gram-trick cost and
    Sinkhorn on the device; the default is exact (`cost_matrix`, `emd2`)."""
    assert power in (1, 2)
    a = np.full(x0.shape[0], 1.0 / x0.shape[0])
    b = np.full(x1.shape[0], 1.0 / x1.shape[0])
    if method == "sinkhorn":
        x0t = as_f32(x0, device).reshape(x0.shape[0], -1)
        x1t = as_f32(x1, x0t.device).reshape(x1.shape[0], -1)
        with torch.no_grad():
            M = _cdist(x0t, x1t)
            if power == 2:
                M = M ** 2
            ret = float(sinkhorn_cost(M, as_f32(a, x0t.device), as_f32(b, x0t.device),
                                      reg=reg))
    else:
        ret = emd2(a, b, cost_matrix(x0, x1, power, device))
    return math.sqrt(ret) if power == 2 else ret


# --------------------------------------------------------------------- MMDs
@torch.no_grad()
def linear_mmd2(f_of_X, f_of_Y, device: DeviceLike = None) -> torch.Tensor:
    """Linear-time linear-kernel MMD²; a 0-d f32 tensor on the device."""
    X = as_f32(f_of_X, device)
    delta = X - as_f32(f_of_Y, X.device)
    return (delta[:-1] * delta[1:]).sum(1).mean()


@torch.no_grad()
def poly_mmd2(f_of_X, f_of_Y, d: int = 2, alpha: float = 1.0, c: float = 2.0,
              device: DeviceLike = None) -> torch.Tensor:
    """Linear-time polynomial-kernel MMD²; a 0-d f32 tensor on the device."""
    X = as_f32(f_of_X, device)
    Y = as_f32(f_of_Y, X.device)

    def k(u, v):
        return ((alpha * (u[:-1] * v[1:]).sum(1) + c) ** d).mean()

    return k(X, X) + k(Y, Y) - k(X, Y) - k(Y, X)


def _mix_rbf_kernel(X: torch.Tensor, Y: torch.Tensor, sigma_list):
    Z = torch.cat([X, Y], dim=0)
    ZZT = Z @ Z.T
    diag = torch.diagonal(ZZT)[:, None]
    exponent = diag - 2.0 * ZZT + diag.T
    K = sum(torch.exp(-(1.0 / (2.0 * s ** 2)) * exponent) for s in sigma_list)
    m = X.shape[0]
    return K[:m, :m], K[:m, m:], K[m:, m:], len(sigma_list)


def _mmd2(K_XX, K_XY, K_YY, const_diagonal=False, biased=False):
    m = K_XX.shape[0]
    if biased:
        return K_XX.mean() + K_YY.mean() - 2.0 * K_XY.mean()
    if const_diagonal is not False:
        sum_diag_X = sum_diag_Y = m * const_diagonal
    else:
        sum_diag_X = torch.diagonal(K_XX).sum()
        sum_diag_Y = torch.diagonal(K_YY).sum()
    return ((K_XX.sum() - sum_diag_X) / (m * (m - 1))
            + (K_YY.sum() - sum_diag_Y) / (m * (m - 1))
            - 2.0 * K_XY.mean())


@torch.no_grad()
def mix_rbf_mmd2(X, Y, sigma_list=(1.0, 2.0, 4.0, 8.0, 16.0), biased: bool = True,
                 device: DeviceLike = None) -> float:
    """Mixture-of-RBF-kernels MMD² over the full kernel matrices."""
    X = as_f32(X, device)
    Y = as_f32(Y, X.device)
    K_XX, K_XY, K_YY, _ = _mix_rbf_kernel(X, Y, sigma_list)
    val = float(_mmd2(K_XX, K_XY, K_YY, const_diagonal=False, biased=biased))
    # the biased estimator is >= 0 analytically; clamp fp cancellation noise
    return max(val, 0.0) if biased else val


@torch.no_grad()
def mix_rbf_mmd2_and_ratio(X, Y, sigma_list=(1.0, 2.0, 4.0, 8.0, 16.0),
                           biased: bool = True, device: DeviceLike = None):
    """(MMD², its variance-normalized ratio); `biased=True` is the original
    code's default: the biased MMD² over the same variance estimate."""
    X = as_f32(X, device)
    Y = as_f32(Y, X.device)
    K_XX, K_XY, K_YY, _ = _mix_rbf_kernel(X, Y, sigma_list)
    mmd2, var_est = _mmd2_and_variance(K_XX, K_XY, K_YY, biased=biased)
    ratio = mmd2 / torch.sqrt(torch.clamp(var_est, min=min_var_est))
    return float(mmd2), float(ratio)


def _mmd2_and_variance(K_XX, K_XY, K_YY, const_diagonal=False, biased=False):
    m = K_XX.shape[0]
    if const_diagonal is not False:
        diag_X = diag_Y = const_diagonal * torch.ones(m, device=K_XX.device)
    else:
        diag_X = torch.diagonal(K_XX)
        diag_Y = torch.diagonal(K_YY)
    sum_diag_X = diag_X.sum()
    sum_diag_Y = diag_Y.sum()
    sum_diag2_X = (diag_X ** 2).sum()
    sum_diag2_Y = (diag_Y ** 2).sum()

    Kt_XX_sums = K_XX.sum(1) - diag_X
    Kt_YY_sums = K_YY.sum(1) - diag_Y
    K_XY_sums_0 = K_XY.sum(0)
    K_XY_sums_1 = K_XY.sum(1)

    Kt_XX_sum = Kt_XX_sums.sum()
    Kt_YY_sum = Kt_YY_sums.sum()
    K_XY_sum = K_XY_sums_0.sum()

    Kt_XX_2_sum = (K_XX ** 2).sum() - sum_diag2_X
    Kt_YY_2_sum = (K_YY ** 2).sum() - sum_diag2_Y
    K_XY_2_sum = (K_XY ** 2).sum()

    if biased:
        mmd2 = ((Kt_XX_sum + sum_diag_X) / (m * m)
                + (Kt_YY_sum + sum_diag_Y) / (m * m)
                - 2.0 * K_XY_sum / (m * m))
    else:
        mmd2 = (Kt_XX_sum / (m * (m - 1)) + Kt_YY_sum / (m * (m - 1))
                - 2.0 * K_XY_sum / (m * m))
    var_est = (
        2.0 / (m ** 2 * (m - 1) ** 2)
        * (2 * (Kt_XX_sums ** 2).sum() - Kt_XX_2_sum
           + 2 * (Kt_YY_sums ** 2).sum() - Kt_YY_2_sum)
        - (4.0 * m - 6.0) / (m ** 3 * (m - 1) ** 3) * (Kt_XX_sum ** 2 + Kt_YY_sum ** 2)
        + 4.0 * (m - 2.0) / (m ** 3 * (m - 1) ** 2)
        * ((K_XY_sums_1 ** 2).sum() + (K_XY_sums_0 ** 2).sum())
        - 4.0 * (m - 3.0) / (m ** 3 * (m - 1) ** 2) * K_XY_2_sum
        - (8 * m - 12) / (m ** 5 * (m - 1)) * K_XY_sum ** 2
        + 8.0 / (m ** 3 * (m - 1))
        * (1.0 / m * (Kt_XX_sum + Kt_YY_sum) * K_XY_sum
           - Kt_XX_sums @ K_XY_sums_1
           - Kt_YY_sums @ K_XY_sums_0)
    )
    return mmd2, var_est


# ------------------------------------------------------------- orchestrator
def compute_distribution_distances(pred, true, device: DeviceLike = None) -> dict:
    """Exact 1- / 2-Wasserstein and linear / polynomial MMD of `pred`
    against `true` (the MMDs over the first min(n, m) rows of each). One
    squared cost matrix serves both Wasserstein distances."""
    pred = np.asarray(pred, np.float32)
    true = np.asarray(true, np.float32)
    min_size = min(pred.shape[0], true.shape[0])
    a = np.full(pred.shape[0], 1.0 / pred.shape[0])
    b = np.full(true.shape[0], 1.0 / true.shape[0])
    sq = cost_matrix(pred, true, power=2, device=device)
    w1 = emd2(a, b, np.sqrt(sq))
    w2 = math.sqrt(emd2(a, b, sq))
    mmd_lin = float(linear_mmd2(pred[:min_size], true[:min_size], device=device))
    mmd_poly = float(poly_mmd2(pred[:min_size], true[:min_size], device=device))
    return {"1-Wasserstein": w1, "2-Wasserstein": w2,
            "Linear_MMD": mmd_lin, "Poly_MMD": mmd_poly}
