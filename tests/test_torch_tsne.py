"""`utils.tsne` and `viz.tsne_2d` against scikit-learn's TSNE, which the
JAX package's `viz.tsne_2d` calls (Barnes-Hut, PCA init), on the CPU at
160 points.

The deterministic parts are held exactly: the conditional probabilities
against scikit-learn's `_binary_search_perplexity` on the same float32
distances within 1e-12 (both float64); the joint P against
`_joint_probabilities_nn` over scikit-learn's kNN graph within 1e-6 (its
entries are about 1e-4); the PCA init against `PCA(2)` scaled as TSNE
scales it, within 1e-5 of its largest entry (scikit-learn's SVD runs in
float32). The embedding cannot be bitwise (an exact gradient against
Barnes-Hut's, other summation orders), so it is held by its quality
against the JAX package's embedding of the same data: its exact KL(P ||
Q) (one numpy KL over one P for both) at most 1.05 times JAX's, its
trustworthiness (k 5) at least JAX's - 0.02, its 5-NN label accuracy at
least JAX's - 0.05.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from sklearn.decomposition import PCA
from sklearn.manifold import _t_sne, trustworthiness
from sklearn.manifold._utils import _binary_search_perplexity
from sklearn.neighbors import NearestNeighbors

from gemm_gan_tpu import viz as jviz
from gemm_gan_tpu_torch import viz
from gemm_gan_tpu_torch.utils import tsne as T

CPU = "cpu"
KL_RATIO = 1.05
TRUST_SLACK = 0.02
KNN_SLACK = 0.05


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: tiny shapes are many small ops, which torch's
    thread pool only slows (and the suite runs files side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def clusters(n_per=40, k=4, dim=30, seed=0, spread=4.0):
    """k labelled Gaussian clusters of n_per points in `dim` dims."""
    rng = np.random.RandomState(seed)
    centers = spread * rng.randn(k, dim)
    x = np.concatenate([c + rng.randn(n_per, dim) for c in centers]).astype(np.float32)
    return x, np.repeat(np.arange(k), n_per)


def sklearn_p(x, perplexity):
    """scikit-learn's joint P (TSNE's Barnes-Hut path: NearestNeighbors'
    kNN graph, squared, then `_joint_probabilities_nn`)."""
    k = T.n_neighbors(len(x), perplexity)
    graph = NearestNeighbors(n_neighbors=k).fit(x).kneighbors_graph(mode="distance")
    graph.data **= 2
    return sp.csr_array(_t_sne._joint_probabilities_nn(graph, perplexity, 0))


def numpy_kl(P, y):
    """KL(P || Q) over P's entries, Q from every pair of `y`, in float64."""
    y = np.asarray(y, np.float64)
    w = 1.0 / (1.0 + ((y[:, None] - y[None]) ** 2).sum(-1))
    np.fill_diagonal(w, 0.0)
    P = P.tocoo()
    q = w[P.row, P.col] / w.sum()
    return float((P.data * np.log(P.data / q)).sum())


def knn_label_accuracy(y, labels, k=5):
    d = ((y[:, None] - y[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    return float((labels[np.argsort(d, 1)[:, :k]] == labels[:, None]).mean())


@pytest.fixture(scope="module")
def data():
    return clusters()


def _port_p(x, perplexity):
    P = T.joint_probabilities(torch.as_tensor(x).double(), perplexity)
    n = len(x)
    return sp.csr_array((P.vals.numpy(), (P.rows.numpy(), P.cols.numpy())), shape=(n, n))


@pytest.mark.parametrize("perplexity", [30.0, 5.0])
def test_conditional_probabilities_match_the_binary_search(data, perplexity):
    x = torch.as_tensor(data[0]).double()
    d, _ = T.nearest_neighbors(x, T.n_neighbors(len(x), perplexity))
    want = _binary_search_perplexity(d.numpy(), perplexity, 0)
    np.testing.assert_allclose(T.conditional_probabilities(d, perplexity).numpy(), want,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("perplexity", [30.0, 5.0])
def test_joint_probabilities_match_sklearn(data, perplexity):
    got, want = _port_p(data[0], perplexity), sklearn_p(data[0], perplexity)
    assert got.nnz == want.nnz
    assert abs(got - want).max() <= 1e-6
    assert abs(got.sum() - 1.0) < 1e-12


@pytest.mark.parametrize("shape", [(160, 30), (40, 60)])
def test_pca_init_matches_sklearn(shape):
    """Both of `pca_init`'s routes: the covariance (n > d) and the Gram
    matrix (n <= d)."""
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    x[:, 0] *= 3.0  # a clear leading component
    want = PCA(n_components=2).fit_transform(x).astype(np.float32)
    want = want / np.std(want[:, 0]) * 1e-4
    got = T.pca_init(torch.as_tensor(x).double()).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_tsne_embedding_quality_against_jax(data):
    x, labels = data
    got = viz.tsne_2d(x, device=CPU)
    want = jviz.tsne_2d(x)
    P = sklearn_p(x, 30.0)
    kl, kl_jax = numpy_kl(P, got), numpy_kl(P, want)
    trust = trustworthiness(x, got, n_neighbors=5)
    trust_jax = trustworthiness(x, want, n_neighbors=5)
    acc, acc_jax = knn_label_accuracy(got, labels), knn_label_accuracy(want, labels)
    print(f"KL port {kl:.5f} JAX {kl_jax:.5f}; trustworthiness {trust:.4f} / {trust_jax:.4f}; "
          f"5-NN accuracy {acc:.3f} / {acc_jax:.3f}")
    assert kl <= KL_RATIO * kl_jax, (kl, kl_jax)
    assert trust >= trust_jax - TRUST_SLACK, (trust, trust_jax)
    assert acc >= acc_jax - KNN_SLACK, (acc, acc_jax)
    # the reported error is the same exact KL; a rerun repeats bit for bit
    res = T.tsne(x, 30.0, device=CPU)
    np.testing.assert_array_equal(res.embedding, got)
    assert abs(res.kl_divergence - kl) <= 1e-5 * kl
    assert 250 <= res.n_iter <= T.MAX_ITER - 1


def test_perplexity_is_clamped_at_five_points():
    """n = 5: JAX's clamp gives min(30, max(2, 4 / 3)) = 2; every row's
    conditional distribution then has entropy log 2 (to the search's
    tolerance), and scikit-learn accepts the clamped value too."""
    x = np.random.RandomState(4).randn(5, 3).astype(np.float32)
    got = viz.tsne_2d(x, device=CPU)
    np.testing.assert_array_equal(got, T.tsne(x, 2.0, device=CPU).embedding)
    assert jviz.tsne_2d(x).shape == got.shape == (5, 2) and np.isfinite(got).all()
    d, _ = T.nearest_neighbors(torch.as_tensor(x).double(), T.n_neighbors(5, 2.0))
    p = T.conditional_probabilities(d, 2.0).numpy()
    entropy = -(p * np.log(p)).sum(1)
    np.testing.assert_allclose(entropy, np.log(2.0), atol=2e-5)
