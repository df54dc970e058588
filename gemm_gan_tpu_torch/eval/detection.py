"""Real-vs-fake detection harness and the evaluation-metric orchestrator.

Counterpart of `gemm_gan_tpu/eval/detection.py`:
  * `detection`: LR / MLP / RF fit on shuffled real + fake train data,
    accuracy / F1 / AUC on the test pair (ideal: chance);
  * `compute_evaluation_metrics`: kNN / logistic / RF two-sample tests and
    PRDC, in raw space and in PCA space;
  * `knn_detection`: the in-loop proxy, distances on the device;
  * `tissues_classification`: TSTR-style tissue classification.

LR and MLP are the device `MLPClassifier`s, RF the native histogram forest,
the two-sample logistic regression, the PCA, the shuffle and the metrics
the numpy/scipy stand-ins of `eval._sklearn_free`. No scikit-learn.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gemm_gan_tpu_torch.eval import _sklearn_free as skf
from gemm_gan_tpu_torch.eval.classifiers import KNNClassifier, MLPClassifier
from gemm_gan_tpu_torch.eval.prdc import compute_prdc
from gemm_gan_tpu_torch.native.forest import HistForestClassifier
from gemm_gan_tpu_torch.utils.device import DeviceLike, as_f32, host

SEED = 42


def _rf():
    """The native C++ histogram forest (the suite's "RF")."""
    return HistForestClassifier(random_state=SEED, n_jobs=-1)


def _logistic():
    return skf.LogisticRegression(C=1.0, max_iter=10000)


def _two_sample(clf, X_real, X_fake, X_real_test, X_fake_test):
    """[macro-F1, accuracy] of a real-vs-fake two-sample classifier."""
    X = np.concatenate([X_real, X_fake], axis=0)
    y = np.concatenate([np.ones(len(X_real)), np.zeros(len(X_fake))])
    X_test = np.concatenate([X_real_test, X_fake_test], axis=0)
    y_test = np.concatenate([np.ones(len(X_real_test)), np.zeros(len(X_fake_test))])
    clf.fit(X, y)
    y_pred = clf.predict(X_test)
    return [skf.f1(y_test, y_pred, average="macro"), skf.accuracy(y_test, y_pred)]


def compute_knn_real_fake(X_real, X_fake, X_real_test, X_fake_test, n_neighbors=5,
                          device: DeviceLike = None):
    return _two_sample(KNNClassifier(n_neighbors, device=device), X_real, X_fake,
                       X_real_test, X_fake_test)


def compute_logistic_real_fake(X_real, X_fake, X_real_test, X_fake_test, **_):
    return _two_sample(_logistic(), X_real, X_fake, X_real_test, X_fake_test)


def compute_random_forest_real_fake(X_real, X_fake, X_real_test, X_fake_test, **_):
    return _two_sample(_rf(), X_real, X_fake, X_real_test, X_fake_test)


def compute_evaluation_metrics(data_real, data_gen, data_test, data_fake_test,
                               nn: int = 10, original_space: bool = True,
                               pca: bool = True, n_components: int = 100,
                               device: DeviceLike = None) -> Dict:
    """Two-sample tests + PRDC in raw and PCA space (numpy inputs; kNN and
    PRDC on `device`)."""
    data_real, data_gen, data_test, data_fake_test = (
        host(a) for a in (data_real, data_gen, data_test, data_fake_test))
    metrics: Dict = {}
    metrics["KNN results"] = compute_knn_real_fake(
        data_real, data_gen, data_test, data_fake_test, n_neighbors=nn, device=device)
    metrics["Logistic results"] = compute_logistic_real_fake(
        data_real, data_gen, data_test, data_fake_test)
    metrics["Random Forest"] = compute_random_forest_real_fake(
        data_real, data_gen, data_test, data_fake_test)

    for name, (a, b) in (("", (data_real, data_gen)),
                         ("_test", (data_test, data_fake_test))):
        for k, v in compute_prdc(a, b, nearest_k=nn, device=device).items():
            metrics[k + name] = v

    if pca:
        n_components = min(n_components, data_real.shape[0], data_real.shape[1])
        p = skf.PCA(n_components=n_components)
        pr = p.fit_transform(data_real)
        pg = p.transform(data_gen)
        pt = p.transform(data_test)
        pf = p.transform(data_fake_test)
        metrics["KNN PCA results"] = compute_knn_real_fake(pr, pg, pt, pf, n_neighbors=nn,
                                                           device=device)
        metrics["Logistic PCA results"] = compute_logistic_real_fake(pr, pg, pt, pf)
        metrics["Random Forest results"] = compute_random_forest_real_fake(pr, pg, pt, pf)
        for name, (a, b) in (("_PCA", (pr, pg)), ("_PCA_test", (pt, pf))):
            for k, v in compute_prdc(a, b, nearest_k=nn, device=device).items():
                metrics[k + name] = v
    return metrics


# ------------------------------------------------------------------ harness
def _classifier_suite(device: DeviceLike = None):
    """{LR: 0-hidden MLP, MLP: 100-hidden MLP, RF}."""
    return {
        "LR": lambda: MLPClassifier(hidden=(), epochs=200, lr=1e-2, weight_decay=1e-4,
                                    device=device),
        "MLP": lambda: MLPClassifier(hidden=(100,), epochs=60, lr=2e-3, device=device),
        "RF": _rf,
    }


def _single_class_eval(y_pred, y_test, y_scores, detection_mode: bool):
    """Metric report per classifier."""
    out = {}
    if detection_mode:
        out["auc"] = round(skf.roc_auc(y_test, y_scores), 5)
        avg = "binary"
    else:
        avg = "macro"
    out["balanced_accuracy"] = round(skf.balanced_accuracy(y_test, y_pred), 5)
    out["accuracy"] = round(skf.accuracy(y_test, y_pred), 5)
    out["precision"] = round(skf.precision(y_test, y_pred, average=avg), 5)
    out["recall"] = round(skf.recall(y_test, y_pred, average=avg), 5)
    out["f1_macro"] = round(skf.f1(y_test, y_pred, average=avg if detection_mode else "macro"), 5)
    out["f1_weighted"] = round(skf.f1(y_test, y_pred,
                                      average=avg if detection_mode else "weighted"), 5)
    return out


def classifiers_harness(train_X, train_y, test_X, test_y, detection_mode: bool,
                        device: DeviceLike = None) -> Dict:
    """Fit the LR / MLP / RF suite; per-model metric dict. The feature
    matrices go to the device once and are shared by the two
    `MLPClassifier`s; the native RF keeps the host arrays."""
    train_X, test_X = host(train_X), host(test_X)
    train_Xd = as_f32(train_X, device)
    test_Xd = as_f32(test_X, train_Xd.device)
    results = {}
    for name, make in _classifier_suite(train_Xd.device).items():
        clf = make()
        on_device = isinstance(clf, MLPClassifier)
        clf.fit(train_Xd if on_device else train_X, train_y)
        proba = clf.predict_proba(test_Xd if on_device else test_X)
        y_pred = clf.classes_[proba.argmax(axis=1)]
        y_scores = proba[:, 1] if proba.shape[1] == 2 else proba.max(axis=1)
        results[name] = _single_class_eval(y_pred, test_y, y_scores, detection_mode)
    return results


def detection(data_real, data_gen, data_real_test, data_fake_test,
              device: DeviceLike = None) -> Dict:
    """Real-vs-fake detection, real = 0, fake = 1."""
    data_real, data_gen, data_real_test, data_fake_test = (
        host(a) for a in (data_real, data_gen, data_real_test, data_fake_test))
    train_X = skf.shuffle(np.vstack([data_real, data_gen]), random_state=SEED)
    train_y = skf.shuffle(np.array([0] * len(data_real) + [1] * len(data_gen)),
                          random_state=SEED)
    test_X = skf.shuffle(np.vstack([data_real_test, data_fake_test]), random_state=SEED)
    test_y = skf.shuffle(np.array([0] * len(data_real_test) + [1] * len(data_fake_test)),
                         random_state=SEED)
    full = classifiers_harness(train_X, train_y, test_X, test_y, detection_mode=True,
                               device=device)
    return {name: {"accuracy": r["accuracy"], "f1": r["f1_macro"], "auc": r["auc"]}
            for name, r in full.items()}


def knn_detection(data_real, data_gen, data_real_test, data_fake_test,
                  n_neighbors: int = 5, device: DeviceLike = None) -> Dict:
    """kNN real-vs-fake two-sample test with the distances on the device:
    the in-loop proxy for `detection`. Inputs may be device tensors; only
    the [N_test, k] neighbour indices leave the device. Real = 0, fake = 1;
    no shuffle (kNN has no fit-order dependence)."""
    real = as_f32(data_real, device)
    dev = real.device
    train_X = torch.cat([real, as_f32(data_gen, dev)])
    train_y = np.array([0] * len(data_real) + [1] * len(data_gen))
    test_X = torch.cat([as_f32(data_real_test, dev), as_f32(data_fake_test, dev)])
    test_y = np.array([0] * len(data_real_test) + [1] * len(data_fake_test))
    pred = KNNClassifier(n_neighbors).fit(train_X, train_y).predict(test_X)
    tp = float(np.sum((pred == 1) & (test_y == 1)))
    fp = float(np.sum((pred == 1) & (test_y == 0)))
    fn = float(np.sum((pred == 0) & (test_y == 1)))
    f1 = 2 * tp / (2 * tp + fp + fn) if (2 * tp + fp + fn) else 0.0
    return {"KNN": {"accuracy": round(float(np.mean(pred == test_y)), 5),
                    "f1": round(f1, 5)}}


def tissues_classification(data_real, tissue_label_real, data_gen, tissue_label,
                           device: DeviceLike = None) -> Dict:
    """TSTR-style tissue classification."""
    full = classifiers_harness(data_real, tissue_label_real, data_gen, tissue_label,
                               detection_mode=False, device=device)
    return {name: {"balanced accuracy": r["balanced_accuracy"],
                   "accuracy": r["accuracy"],
                   "f1_weighted": r["f1_weighted"],
                   "f1": r["f1_macro"]}
            for name, r in full.items()}
