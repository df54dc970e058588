"""The port's evaluation suite against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through each JAX evaluation
function and its counterpart in `gemm_gan_tpu_torch.eval`. Tolerances, per
test: Γ within 1e-5 (float32 blocks, float64 sums); counts-based metrics
(PRDC, k-NN P/R, DCR/NNDR, kNN detection) equal; realism within rtol 1e-5;
`MLPClassifier` probabilities within 1e-4 after the same fit from the same
initial weights; the native forest's predictions equal; the scikit-learn
stand-ins against scikit-learn: shuffle equal, metrics within 1e-12, PCA
projections within 1e-5 of `svd_solver="full"`, logistic-regression
coefficients within 1e-4 relative.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import importlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import gemm_gan_tpu.eval.classifiers as jcls
import gemm_gan_tpu.eval.gamma as jgamma
import gemm_gan_tpu.eval.knn_pr as jknn
import gemm_gan_tpu.eval.prdc as jprdc
from gemm_gan_tpu.native.forest import HistForestClassifier as JForest
from gemm_gan_tpu_torch.cli.experiment import _balanced_indices, _host_subsample_patches
from gemm_gan_tpu_torch.eval import _sklearn_free as skf
from gemm_gan_tpu_torch.eval import classifiers as tcls
from gemm_gan_tpu_torch.eval import detection as tdet
from gemm_gan_tpu_torch.eval import gamma as tgamma
from gemm_gan_tpu_torch.eval import knn_pr as tknn
from gemm_gan_tpu_torch.eval import prdc as tprdc
from gemm_gan_tpu_torch.eval import privacy as tpriv
from gemm_gan_tpu_torch.eval import utility as tutil
from gemm_gan_tpu_torch.native import forest as tforest

# the JAX eval package re-exports functions under its modules' names
jdet = importlib.import_module("gemm_gan_tpu.eval.detection")
jpriv = importlib.import_module("gemm_gan_tpu.eval.privacy")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
COUNT_TOL = 1e-6


def _same_counts(got, want):
    """Fractions of the same counts: they may differ only by the rounding of
    the float32 mean (1e-6), far below one count's share (1 / n)."""
    assert abs(got - want) < COUNT_TOL, (got, want)


def _same_prdc(got, want):
    assert got.keys() == want.keys()
    for k in want:
        _same_counts(got[k], want[k])


def _pair(n_real=40, n_fake=36, d=12, shift=0.0, seed=0):
    rng = np.random.RandomState(seed)
    real = rng.randn(n_real, d).astype(np.float32)
    fake = (rng.randn(n_fake, d) + shift).astype(np.float32)
    return real, fake


# --------------------------------------------------------------------- gamma
@pytest.mark.parametrize("n_x,n_y,g,block", [(30, 30, 20, 1024), (30, 22, 20, 7),
                                             (17, 40, 33, 8)])
def test_gamma_coef_matches_jax_and_numpy(n_x, n_y, g, block):
    rng = np.random.RandomState(g)
    base = rng.randn(4, g)
    x = (rng.randn(n_x, 4) @ base + 0.3 * rng.randn(n_x, g)).astype(np.float32)
    y = (rng.randn(n_y, 4) @ base + 0.5 * rng.randn(n_y, g)).astype(np.float32)
    got = tgamma.gamma_coef(x, y, block=block, device=CPU)
    assert abs(got - jgamma.gamma_coef(x, y, block=block)) < 1e-5
    if n_x == n_y:
        assert abs(got - jgamma.gamma_coef_np(x, y)) < 1e-5
    assert tgamma.gamma_coef_np(x[:, :10], x[:, :10]) == jgamma.gamma_coef_np(
        x[:, :10], x[:, :10])


def test_gamma_numpy_goldens_are_the_jax_packages():
    rng = np.random.RandomState(3)
    x, y = rng.randn(25, 9), rng.randn(25, 9)
    np.testing.assert_array_equal(tgamma.correlations_list(x, y),
                                  jgamma.correlations_list(x, y))
    np.testing.assert_array_equal(tgamma.gamma_coefficients(x, y),
                                  jgamma.gamma_coefficients(x, y))


# ---------------------------------------------------------- PRDC, k-NN P/R
@pytest.mark.parametrize("k", [3, 5])
def test_compute_prdc_matches_jax_and_numpy(k):
    real, fake = _pair(shift=0.4)
    got = tprdc.compute_prdc(real, fake, nearest_k=k, device=CPU)
    _same_prdc(got, jprdc.compute_prdc(real, fake, nearest_k=k))
    _same_prdc(got, tprdc.compute_prdc_np(real, fake, nearest_k=k))
    # blocks that divide neither the rows nor the features
    x = torch.from_numpy(real)
    np.testing.assert_allclose(tprdc._pairwise_l1(x, x, block=7, feat_block=5).numpy(),
                               np.abs(real[:, None] - real[None]).sum(-1), rtol=1e-6)


def test_knn_precision_recall_and_realism_match_jax():
    real, fake = _pair(shift=0.3, seed=1)
    got = tknn.knn_precision_recall_features(real, fake, nhood_sizes=(3, 5), device=CPU)
    want = jknn.knn_precision_recall_features(real, fake, nhood_sizes=(3, 5))
    for k in ("precision", "recall"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=COUNT_TOL)
    for a, b in zip(tknn.get_precision_recall(real, fake, (4,), device=CPU),
                    jknn.get_precision_recall(real, fake, (4,))):
        _same_counts(a, b)
    np.testing.assert_allclose(tknn.get_realism_score(real, fake, device=CPU),
                               jknn.get_realism_score(real, fake), rtol=1e-5)


def test_dcr_nndr_match_jax():
    real, fake = _pair(seed=2)
    test = np.random.RandomState(9).randn(30, 12).astype(np.float32)
    _same_counts(tpriv.dcr(real, fake, test, device=CPU), jpriv.dcr(real, fake, test))
    _same_counts(tpriv.nndr(real, fake, test, device=CPU), jpriv.nndr(real, fake, test))


def test_knn_detection_matches_jax():
    real, fake = _pair(shift=0.5, seed=3)
    rt, ft = _pair(n_real=20, n_fake=24, shift=0.5, seed=4)
    assert tdet.knn_detection(real, fake, rt, ft, device=CPU) == \
        jdet.knn_detection(real, fake, rt, ft)
    # device tensors in, as the validation proxy passes them
    t = [torch.from_numpy(a) for a in (real, fake, rt, ft)]
    assert tdet.knn_detection(*t) == jdet.knn_detection(real, fake, rt, ft)


# ------------------------------------------------------------- classifiers
def _labelled(n=96, d=20, k=3, seed=5):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, n)
    X = (rng.randn(n, d) + 0.8 * np.eye(k, d)[y] * 3).astype(np.float32)
    return X, y


@pytest.mark.parametrize("entry", ["LR", "MLP"])
def test_mlp_classifier_matches_jax_from_the_same_init(entry):
    """The suite's LR and MLP entries at dropout 0, the JAX initial weights
    carried across; one partial trailing batch per epoch (n = 96, batch
    40)."""
    kw = (dict(hidden=(), epochs=200, lr=1e-2, weight_decay=1e-4) if entry == "LR"
          else dict(hidden=(100,), epochs=60, lr=2e-3))
    X, y = _labelled()
    Xt, _ = _labelled(n=30, seed=6)
    j = jcls.MLPClassifier(**kw, dropout=0.0, batch_size=40).fit(X, y)
    dims = (X.shape[1], *kw["hidden"], 3)
    init = jax.device_get(jcls._init_params(jax.random.split(jax.random.key(42))[1], dims))
    t = tcls.MLPClassifier(**kw, dropout=0.0, batch_size=40, device=CPU)
    t.fit(X, y, init_params=init)
    np.testing.assert_allclose(t.predict_proba(Xt), j.predict_proba(Xt), atol=1e-4)
    np.testing.assert_array_equal(t.predict(Xt), j.predict(Xt))


def test_mlp_classifier_draws_nothing_from_the_default_generator():
    X, y = _labelled()
    torch.manual_seed(0)
    before = torch.get_rng_state()
    a = tcls.MLPClassifier(epochs=3, device=CPU).fit(X, y).predict_proba(X)
    assert torch.equal(before, torch.get_rng_state())
    b = tcls.MLPClassifier(epochs=3, device=CPU).fit(X, y).predict_proba(X)
    np.testing.assert_array_equal(a, b)


def test_native_forest_matches_the_jax_packages():
    """One thread: the source's per-worker feature pool carries over from
    one tree to the next a worker builds, so with several threads both
    builds depend on which thread takes which tree."""
    X, y = _labelled(n=120, d=16, seed=7)
    Xt, _ = _labelled(n=40, d=16, seed=8)
    got = tforest.HistForestClassifier(random_state=42, n_jobs=1).fit(X, y)
    want = JForest(random_state=42, n_jobs=1).fit(X, y)
    np.testing.assert_array_equal(got.predict(Xt), want.predict(Xt))
    np.testing.assert_array_equal(got.predict_proba(Xt), want.predict_proba(Xt))
    assert tforest.library_path().startswith(tforest.BUILD_DIR)


# ------------------------------------------------------ scikit-learn stand-ins
def test_shuffle_and_metrics_match_sklearn():
    from sklearn import metrics as m
    from sklearn.utils import shuffle

    rng = np.random.RandomState(11)
    a, b = rng.randn(37, 3), rng.randint(0, 4, 37)
    for got, want in zip(skf.shuffle(a, b, random_state=42), shuffle(a, b, random_state=42)):
        np.testing.assert_array_equal(got, want)
    yt, yp = rng.randint(0, 4, 80), rng.randint(0, 4, 80)
    yp[yp == 3] = 2  # a class never predicted: zero_division
    assert abs(skf.accuracy(yt, yp) - m.accuracy_score(yt, yp)) < 1e-12
    assert abs(skf.balanced_accuracy(yt, yp) - m.balanced_accuracy_score(yt, yp)) < 1e-12
    for avg in ("macro", "weighted"):
        for ours, theirs in ((skf.precision, m.precision_score), (skf.recall, m.recall_score),
                             (skf.f1, m.f1_score)):
            assert abs(ours(yt, yp, avg) - theirs(yt, yp, average=avg, zero_division=0)) < 1e-12
    bt, bp = rng.randint(0, 2, 60), rng.randint(0, 2, 60)
    for ours, theirs in ((skf.precision, m.precision_score), (skf.recall, m.recall_score),
                         (skf.f1, m.f1_score)):
        assert abs(ours(bt, bp) - theirs(bt, bp, zero_division=0)) < 1e-12
        assert ours(bt, np.zeros_like(bt)) == theirs(bt, np.zeros_like(bt), zero_division=0)
    scores = np.round(rng.rand(60), 1)  # many ties
    assert abs(skf.roc_auc(bt, scores) - m.roc_auc_score(bt, scores)) < 1e-12


def test_pca_matches_sklearn_full_solver():
    from sklearn.decomposition import PCA

    rng = np.random.RandomState(12)
    X = (rng.randn(50, 30) @ rng.randn(30, 30)).astype(np.float32)
    Y = rng.randn(20, 30).astype(np.float32)
    ours, theirs = skf.PCA(10), PCA(10, svd_solver="full")
    np.testing.assert_allclose(ours.fit_transform(X), theirs.fit_transform(X), atol=1e-5)
    np.testing.assert_allclose(ours.transform(Y), theirs.transform(Y), atol=1e-5)


@pytest.mark.parametrize("n_classes,n,d", [(2, 80, 30), (2, 40, 120), (4, 90, 25)])
def test_logistic_regression_matches_sklearn(n_classes, n, d):
    from sklearn.linear_model import LogisticRegression

    rng = np.random.RandomState(n + d)
    y = rng.randint(0, n_classes, n)
    X = rng.randn(n, d) + 0.5 * np.eye(n_classes, d)[y]
    Xt = rng.randn(40, d)
    ours = skf.LogisticRegression(C=1.0, max_iter=10000).fit(X, y)
    theirs = LogisticRegression(C=1.0, max_iter=10000).fit(X, y)
    scale = np.abs(theirs.coef_).max()
    assert np.abs(ours.coef_ - theirs.coef_).max() <= 1e-4 * scale
    assert np.abs(ours.intercept_ - theirs.intercept_).max() <= 1e-4 * scale
    margin = theirs.decision_function(Xt)
    sure = (np.abs(margin) >= 1e-6) if margin.ndim == 1 else np.ones(len(Xt), bool)
    np.testing.assert_array_equal(ours.predict(Xt)[sure], theirs.predict(Xt)[sure])


# -------------------------------------------------- detection and the suites
@pytest.fixture(scope="module", params=["separable", "identical"])
def fixture_pair(request):
    rng = np.random.RandomState(13)
    real = rng.randn(60, 10).astype(np.float32)
    real_test = rng.randn(30, 10).astype(np.float32)
    if request.param == "separable":
        return (real, (rng.randn(60, 10) + 3.0).astype(np.float32), real_test,
                (rng.randn(30, 10) + 3.0).astype(np.float32))
    return real, real.copy(), real_test, real_test.copy()


def test_detection_matches_jax(fixture_pair):
    got = tdet.detection(*fixture_pair, device=CPU)
    want = jdet.detection(*fixture_pair)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        assert abs(got[name]["accuracy"] - want[name]["accuracy"]) <= 0.02, (name, got, want)


def test_compute_evaluation_metrics_matches_jax(fixture_pair):
    got = tdet.compute_evaluation_metrics(*fixture_pair, nn=5, n_components=4, device=CPU)
    want = jdet.compute_evaluation_metrics(*fixture_pair, nn=5, n_components=4)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, list):  # [macro-F1, accuracy]
            assert abs(got[k][1] - v[1]) <= 0.02, (k, got[k], v)
        elif "PCA" not in k and not k.startswith("density"):  # PRDC, raw space
            assert got[k] == v, k
        elif "PCA" not in k:
            assert abs(got[k] - v) < 1e-6, k


def test_tissues_classification_keys_match_jax():
    X, y = _labelled(n=60, d=8, seed=14)
    Xg, yg = _labelled(n=40, d=8, seed=15)
    got = tdet.tissues_classification(X, y, Xg, yg, device=CPU)
    want = jdet.tissues_classification(X, y, Xg, yg)
    assert got.keys() == want.keys()
    assert all(got[k].keys() == want[k].keys() for k in want)


def test_utility_evaluator_reads_the_jax_dump_contract(tmp_path):
    from gemm_gan_tpu.eval import utility as jutil

    rng = np.random.RandomState(16)
    arrays = {f: rng.randn(24, 6).astype(np.float32) if "labels" not in f
              else rng.randint(0, 3, 24) for f in jutil.FILES}
    jutil.save_run_artifacts(str(tmp_path / "test_0_epoch_2"), arrays)
    ev = tutil.UtilityEvaluator(str(tmp_path), mlp_epochs=3, device=CPU)
    ev.evaluate()
    report = ev.report()
    assert set(report) == set(tutil.SETTINGS)
    for setting in report:
        for clf in ("MLP", "RandomForest"):
            assert set(report[setting][clf]) == set(tutil.METRICS)
    assert tutil.FILES == jutil.FILES
    fake, y = _labelled(n=80, d=10, k=4, seed=17)
    real, ry = _labelled(n=60, d=10, k=4, seed=18)
    assert tutil.tstr_transfer_accuracy(fake, y, real, ry) == \
        jutil.tstr_transfer_accuracy(fake, y, real, ry)
    assert tutil.class_mean_alignment(fake, y, real, ry) == \
        jutil.class_mean_alignment(fake, y, real, ry)


def test_experiment_helpers_match_jax():
    from gemm_gan_tpu.cli import experiment as jexp

    rng = np.random.RandomState(19)
    disease = rng.randint(0, 4, 50)
    np.testing.assert_array_equal(_balanced_indices(disease, 3, np.random.RandomState(1)),
                                  jexp._balanced_indices(disease, 3, np.random.RandomState(1)))
    split = {"patches": rng.randn(6, 10, 4).astype(np.float32),
             "patch_mask": rng.rand(6, 10) > 0.3}
    got, want = _host_subsample_patches(split, 5, 7), jexp._host_subsample_patches(split, 5, 7)
    for k in ("patches", "patch_mask"):
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------- without scikit-learn at all
def test_the_suite_runs_without_sklearn_or_matplotlib(tmp_path):
    """The card's machine has neither: block both and run the suites and a
    tiny Experiment.fit."""
    code = f"""
import sys
sys.modules["sklearn"] = None
sys.modules["matplotlib"] = None
import dataclasses, os
import numpy as np
from gemm_gan_tpu_torch.config import variant_config
from gemm_gan_tpu_torch.data.synthetic import synthetic_dataset
from gemm_gan_tpu_torch.cli.experiment import Experiment
from gemm_gan_tpu_torch.eval.detection import detection, compute_evaluation_metrics
from gemm_gan_tpu_torch.eval.utility import UtilityEvaluator, save_run_artifacts
rng = np.random.RandomState(0)
a, b = rng.randn(30, 8).astype(np.float32), rng.randn(30, 8).astype(np.float32) + 1
det = detection(a, b, a[:10], b[:10], device="cpu")
met = compute_evaluation_metrics(a, b, a[:10], b[:10], nn=3, n_components=4, device="cpu")
run = os.path.join({str(tmp_path)!r}, "u", "test_0_epoch_1")
save_run_artifacts(run, {{"data_real": a, "data_gen": b, "test_real": a, "test_gen": b,
    "train_labels_real": np.arange(30) % 2, "train_labels_gen": np.arange(30) % 2,
    "test_labels_real": np.arange(30) % 2, "test_labels_gen": np.arange(30) % 2}})
ev = UtilityEvaluator(os.path.dirname(run), mlp_epochs=2, device="cpu")
ev.evaluate()
cfg = variant_config("vanilla", n_genes=12)
cfg = dataclasses.replace(cfg, output_dir={str(tmp_path)!r}, run_name="e",
    model=dataclasses.replace(cfg.model, gen_dims=(16,), disc_dims=(16,), latent_dim=8),
    train=dataclasses.replace(cfg.train, n_critic=1, epochs=2, freq_compute_test=1,
                              batch_size=8),
    eval=dataclasses.replace(cfg.eval, n_runs=1, pca_components=3, nearest_k=3,
                             pr_nhood_sizes=()))
d = synthetic_dataset(n=40, n_genes=12, seed=1)
splits = {{s: {{"genes": d["genes"][i]}} for s, i in
          {{"train": slice(0, 24), "val": slice(24, 32), "test": slice(32, 40)}}.items()}}
res = Experiment(cfg, splits, device="cpu").fit()
assert np.isfinite(res["gamma_mean"])
assert not os.path.exists(os.path.join({str(tmp_path)!r}, "e", "validation_metrics.png"))
assert sys.modules["sklearn"] is None and sys.modules["matplotlib"] is None
print("ok", sorted(det), len(met))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok ['LR', 'MLP', 'RF']"), r.stdout
    assert "matplotlib is not installed" in r.stderr
