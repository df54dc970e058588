"""The port's distribution distances (`eval/distances.py`, `native/ot.py`)
and correlation heatmap (`eval/heatmap.py`) against the JAX package's, on
the CPU, on the same numpy inputs.

Tolerances: the exact optimal transport and the exact Wasserstein distances
within 1e-12 relative (both in float64 through each package's own native
network simplex; the port's cost matrix blocked over rows, JAX's
broadcast); Sinkhorn within 1e-4; the linear and polynomial MMD² within
1e-5 relative; the heatmap's MSE within 1e-5.

The RBF-mixture MMD² and its ratio are held in two parts. Their formulas
(`_mmd2`, `_mmd2_and_variance` on the same float64 kernel matrices) within
1e-12 of JAX's (JAX's under `jax.enable_x64`; its `_mix_rbf_kernel` takes
f32 products even there). Their float32 entry points within
F32_RTOL (1e-4) relative of that float64 evaluation, the bar JAX's own
float32 results are held to beside them: the Gram trick's exponents and
the variance estimate cancel in float32, so on these inputs either
package's MMD² lands up to ≈1e-5 and its ratio up to ≈1e-5 from float64,
and the two packages up to 1.3e-5 from each other.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_gan_tpu.eval import distances as jdist
from gemm_gan_tpu.eval import heatmap as jheat
from gemm_gan_tpu.native import exact_emd2 as jax_exact_emd2
from gemm_gan_tpu_torch.eval import distances as tdist
from gemm_gan_tpu_torch.eval import heatmap as theat
from gemm_gan_tpu_torch.native import build as nbuild
from gemm_gan_tpu_torch.native import ot
from gemm_gan_tpu_torch.viz import matplotlib_available

CPU = "cpu"
EXACT_RTOL = 1e-12
SINKHORN_RTOL = 1e-4
MMD_RTOL = 1e-5
F32_RTOL = 1e-4
SIGMAS = (1.0, 2.0, 4.0, 8.0, 16.0)


def _samples(n, m, g=20, shift=1.0, seed=0):
    """Two samples whose MMD² is not a sum cancelling to f32's resolution:
    real N(0, 1) and generated N(shift, 1) in g dims."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, g).astype(np.float32),
            (rng.randn(m, g) + shift).astype(np.float32))


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


# ------------------------------------------------------------ exact transport
@pytest.mark.parametrize("n,m,uniform", [(12, 12, True), (9, 14, True), (11, 7, False)])
def test_exact_emd2_matches_the_jax_packages(n, m, uniform):
    rng = np.random.RandomState(n * m)
    M = rng.rand(n, m)
    a = np.full(n, 1.0 / n) if uniform else rng.rand(n)
    b = np.full(m, 1.0 / m) if uniform else rng.rand(m)
    a, b = a / a.sum(), b / b.sum()
    got, want = ot.exact_emd2(a, b, M), jax_exact_emd2(a, b, M)
    assert _rel(got, want) <= EXACT_RTOL, (got, want)
    if n == m and uniform:
        from scipy.optimize import linear_sum_assignment

        r, c = linear_sum_assignment(M)
        assert _rel(got, M[r, c].mean()) <= EXACT_RTOL


def test_exact_emd2_rejects_mismatched_marginals():
    with pytest.raises(ValueError, match="marginals"):
        ot.exact_emd2(np.ones(3) / 3, np.ones(4) / 4, np.ones((3, 5)))


def test_ot_library_is_built_from_the_checkout_or_raises(tmp_path):
    """The library is keyed by a hash of the source under the ignored build
    dir; a source that does not compile raises with the compiler's output
    (there is no assignment or Sinkhorn fallback)."""
    path = ot.build()
    assert path.startswith(nbuild.BUILD_DIR) and path == nbuild.library_path(ot.SOURCE, "otemd")
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="native build of .*broken.cpp failed"):
        nbuild.build_library(str(bad), "broken")
    assert not any("broken" in f for f in os.listdir(nbuild.BUILD_DIR))


@pytest.mark.parametrize("power", [1, 2])
@pytest.mark.parametrize("n,m", [(16, 16), (10, 13)])
def test_exact_wasserstein_blocked_matches_jax_broadcast(monkeypatch, power, n, m):
    """The port's cost matrix a few rows at a time (the block shrunk to
    three rows here) against JAX's broadcast [n, m, G] differences."""
    x0, x1 = _samples(n, m, seed=power)
    monkeypatch.setattr(tdist, "COST_BLOCK_BYTES", 3 * 8 * m * x0.shape[1])
    got = tdist.wasserstein(x0, x1, power=power, device=CPU)
    want = jdist.wasserstein(x0, x1, power=power)
    assert _rel(got, want) <= EXACT_RTOL, (got, want)


def test_cost_matrix_blocks_equal_the_broadcast(monkeypatch):
    x0, x1 = _samples(13, 9, g=33, seed=3)
    h0, h1 = x0.astype(np.float64), x1.astype(np.float64)
    want = np.sqrt(np.sum((h0[:, None, :] - h1[None, :, :]) ** 2, axis=-1))
    for rows in (1, 4, 13):
        monkeypatch.setattr(tdist, "COST_BLOCK_BYTES", rows * 8 * 9 * 33)
        got = tdist.cost_matrix(x0, x1, power=1, device=CPU)
        np.testing.assert_allclose(got, want, rtol=EXACT_RTOL, atol=0)
        np.testing.assert_allclose(tdist.cost_matrix(x0, x1, power=2, device=CPU),
                                   want ** 2, rtol=EXACT_RTOL, atol=0)
    # x against itself: exact zeros on the diagonal, where f32's Gram trick
    # does not give them
    assert np.all(np.diag(tdist.cost_matrix(x0, x0, device=CPU)) == 0)


# ------------------------------------------------------------------ Sinkhorn
@pytest.mark.parametrize("power", [1, 2])
def test_sinkhorn_wasserstein_matches_jax(power):
    x0, x1 = _samples(20, 17, seed=4)
    got = tdist.wasserstein(x0, x1, method="sinkhorn", power=power, device=CPU)
    want = jdist.wasserstein(x0, x1, method="sinkhorn", power=power)
    assert _rel(got, want) <= SINKHORN_RTOL, (got, want)


def test_sinkhorn_cost_matches_jax_on_the_same_cost():
    rng = np.random.RandomState(5)
    M = rng.rand(15, 11).astype(np.float32)
    a = np.full(15, 1 / 15, np.float32)
    b = np.full(11, 1 / 11, np.float32)
    for reg in (0.05, 0.5):
        got = tdist.sinkhorn_cost(torch.tensor(M), torch.tensor(a), torch.tensor(b), reg=reg)
        want = jdist.sinkhorn_cost(jnp.asarray(M), jnp.asarray(a), jnp.asarray(b), reg=reg)
        assert _rel(got, want) <= SINKHORN_RTOL, (reg, float(got), float(want))


# ---------------------------------------------------------------------- MMD
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_linear_and_poly_mmd_match_jax(seed):
    x, y = _samples(32, 32, seed=seed)
    assert _rel(tdist.linear_mmd2(x, y, device=CPU), jdist.linear_mmd2(x, y)) <= MMD_RTOL
    assert _rel(tdist.poly_mmd2(x, y, device=CPU), jdist.poly_mmd2(x, y)) <= MMD_RTOL
    assert _rel(tdist.poly_mmd2(x, y, d=3, alpha=0.5, c=1.0, device=CPU),
                jdist.poly_mmd2(x, y, d=3, alpha=0.5, c=1.0)) <= MMD_RTOL


def _float64_mmd(x, y, biased):
    """(MMD², ratio) of the float64 formula on the same inputs."""
    X, Y = (torch.tensor(a, dtype=torch.float64) for a in (x, y))
    K_XX, K_XY, K_YY, _ = tdist._mix_rbf_kernel(X, Y, SIGMAS)
    mmd2, var = tdist._mmd2_and_variance(K_XX, K_XY, K_YY, biased=biased)
    ratio = mmd2 / torch.sqrt(torch.clamp(var, min=tdist.min_var_est))
    return float(tdist._mmd2(K_XX, K_XY, K_YY, biased=biased)), float(mmd2), float(ratio)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix_rbf_mmd2_and_ratio_match_jax(seed):
    x, y = _samples(32, 32, g=8, seed=seed)
    for biased in (True, False):
        mmd2_only, mmd2, ratio = _float64_mmd(x, y, biased)
        for pkg, got in (("port", tdist.mix_rbf_mmd2(x, y, biased=biased, device=CPU)),
                         ("jax", jdist.mix_rbf_mmd2(x, y, biased=biased))):
            assert _rel(got, mmd2_only) <= F32_RTOL, (pkg, biased, got, mmd2_only)
        for pkg, got in (("port", tdist.mix_rbf_mmd2_and_ratio(x, y, biased=biased,
                                                               device=CPU)),
                         ("jax", jdist.mix_rbf_mmd2_and_ratio(x, y, biased=biased))):
            assert _rel(got[0], mmd2) <= F32_RTOL, (pkg, biased, got, mmd2)
            assert _rel(got[1], ratio) <= F32_RTOL, (pkg, biased, got, ratio)


def test_mmd_estimators_are_jaxs_formulas_in_float64():
    """The same kernel matrices through both packages' estimators in
    float64 (JAX's under `jax.enable_x64`)."""
    x, y = _samples(24, 24, g=6, seed=7)
    X, Y = (torch.tensor(a, dtype=torch.float64) for a in (x, y))
    K = tdist._mix_rbf_kernel(X, Y, SIGMAS)[:3]
    with jax.enable_x64(True):
        JK = [jnp.asarray(k.numpy(), jnp.float64) for k in K]
        for biased in (True, False):
            got = tdist._mmd2_and_variance(*K, biased=biased)
            want = jdist._mmd2_and_variance(*JK, biased=biased)
            for a, b in zip(got, want):
                assert _rel(a, b) <= EXACT_RTOL, (biased, float(a), float(b))
            assert _rel(tdist._mmd2(*K, biased=biased),
                        jdist._mmd2(*JK, biased=biased)) <= EXACT_RTOL


def test_compute_distribution_distances_matches_jax():
    x, y = _samples(14, 14, seed=8)
    got = tdist.compute_distribution_distances(x, y, device=CPU)
    want = jdist.compute_distribution_distances(x, y)
    assert list(got) == list(want)
    for k in ("1-Wasserstein", "2-Wasserstein"):
        assert _rel(got[k], want[k]) <= EXACT_RTOL, k
    for k in ("Linear_MMD", "Poly_MMD"):
        assert _rel(got[k], want[k]) <= MMD_RTOL, k
    # unequal sizes: the MMDs take the first min(n, m) rows of each
    got = tdist.compute_distribution_distances(x, y[:9], device=CPU)
    want = jdist.compute_distribution_distances(x, y[:9])
    for k in want:
        assert _rel(got[k], want[k]) <= (EXACT_RTOL if "Wasserstein" in k else MMD_RTOL), k


def test_device_defaults_to_the_card():
    """Without a card and without device="cpu" the entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x, y = _samples(4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.compute_distribution_distances(x, y)


# ------------------------------------------------------------------ heatmap
def test_correlation_heatmap_matches_jax(tmp_path):
    rng = np.random.RandomState(9)
    real = rng.randn(40, 12).astype(np.float32)
    gen = (real @ rng.randn(12, 12) * 0.3 + rng.randn(40, 12)).astype(np.float32)
    gen[:, 3] = 1.5  # a constant column: its correlations are 0, not NaN
    got = theat.CorrelationEvaluator(real, gen, device=CPU)
    want = jheat.CorrelationEvaluator(real, gen)
    np.testing.assert_allclose(got.corr_real, want.corr_real, atol=1e-6)
    np.testing.assert_allclose(got.corr_gen, want.corr_gen, atol=1e-6)
    assert abs(got.mse() - want.mse()) <= 1e-5 and np.isfinite(got.mse())
    if matplotlib_available():
        out = got.plot_diff(str(tmp_path / "diff.png"))
        assert (tmp_path / "diff.png").stat().st_size > 0 and out.endswith("diff.png")


def test_jax_runs_here_on_the_cpu():
    assert jax.default_backend() == "cpu"
