"""Utility (TSTR) evaluation over dumped `test_*` artifact directories.

Counterpart of `gemm_gan_tpu/eval/utility.py`: for every `test_*` run
directory, fit MLP and RF classifiers in three regimes (TRTR, TSTR, TR+TSR)
predicting `data_real` against `train_labels_real`, and report mean ± std of
weighted accuracy / F1 / precision / recall. The artifact contract (the
same npy file names) lets either package score the other's dumps.

MLP is the device `MLPClassifier`, RF the native histogram forest, and the
TSTR probe's logistic regression the numpy/scipy one of
`eval._sklearn_free`.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict

import numpy as np

from gemm_gan_tpu_torch.eval import _sklearn_free as skf
from gemm_gan_tpu_torch.eval.classifiers import MLPClassifier
from gemm_gan_tpu_torch.eval.detection import _rf
from gemm_gan_tpu_torch.utils.device import DeviceLike

FILES = ("data_real", "data_gen", "test_real", "test_gen",
         "train_labels_real", "train_labels_gen",
         "test_labels_real", "test_labels_gen")

SETTINGS = ("TRTR", "TSTR", "TR+TSR")
METRICS = ("Accuracy", "F1", "Precision", "Recall")


def load_data(folder: str, label_infix: str = "") -> Dict[str, np.ndarray]:
    """Load the 8-file artifact contract; label_infix='primary_site_' loads
    the primary-site label variants."""
    def name(f):
        if label_infix and "labels" in f:
            a, b = f.split("labels_")
            return f"{a}labels_primary_site_{b}" if label_infix == "primary_site_" else f
        return f

    return {f: np.load(os.path.join(folder, name(f) + ".npy")) for f in FILES}


def save_run_artifacts(run_dir: str, arrays: Dict[str, np.ndarray]):
    """Write the 8-file (12 with primary-site) npy contract."""
    os.makedirs(run_dir, exist_ok=True)
    for k, v in arrays.items():
        np.save(os.path.join(run_dir, f"{k}.npy"), np.asarray(v))


def _compute_metrics(y_true, y_pred) -> Dict[str, float]:
    return {
        "Accuracy": skf.accuracy(y_true, y_pred),
        "F1": skf.f1(y_true, y_pred, average="weighted"),
        "Precision": skf.precision(y_true, y_pred, average="weighted"),
        "Recall": skf.recall(y_true, y_pred, average="weighted"),
    }


def tstr_transfer_accuracy(fake, fake_y, real_te, real_te_y) -> float:
    """TSTR reduced to its conditioning-sensitive core: fit a linear
    classifier on (generated, condition label), score on held-out real.
    Materially-above-chance accuracy is direct evidence that generation is
    steered by the condition."""
    clf = skf.LogisticRegression(max_iter=500)
    clf.fit(fake, fake_y)
    return float((clf.predict(real_te) == real_te_y).mean())


def class_mean_alignment(fake, fake_y, real_te, real_te_y, n_perm: int = 8):
    """(aligned, shuffled): mean over classes of ||mean(fake | label=c) -
    mean(real | label=c)||, under the true generation labels vs the mean of
    `n_perm` label-shuffled controls."""
    classes = np.intersect1d(np.unique(fake_y), np.unique(real_te_y))
    mu_real = np.stack([real_te[real_te_y == c].mean(0) for c in classes])

    def dist(y):
        return float(np.mean([
            np.linalg.norm(fake[y == c].mean(0) - mu_real[i])
            for i, c in enumerate(classes)]))

    rng = np.random.RandomState(0)
    shuffled = float(np.mean([dist(rng.permutation(fake_y)) for _ in range(n_perm)]))
    return dist(fake_y), shuffled


class UtilityEvaluator:
    label_infix = ""

    def __init__(self, results_path: str, mlp_epochs: int = 50,
                 pattern: str = "test_*", device: DeviceLike = None):
        """`pattern` narrows the run dirs (e.g. `test_*_epoch_10` to score
        only the best-checkpoint dumps)."""
        self.results_dirs = sorted(glob(os.path.join(results_path, pattern)))
        self._make_classifiers = lambda: {
            "MLP": MLPClassifier(hidden=(100,), epochs=mlp_epochs, seed=42, device=device),
            "RandomForest": _rf(),
        }
        self.scores = {
            s: {c: {m: [] for m in METRICS} for c in ("MLP", "RandomForest")}
            for s in SETTINGS
        }

    def evaluate(self):
        for folder in self.results_dirs:
            data = load_data(folder, self.label_infix)
            for clf_name, clf in self._make_classifiers().items():
                regimes = {
                    "TRTR": (data["test_real"], data["test_labels_real"]),
                    "TSTR": (data["test_gen"], data["test_labels_gen"]),
                    "TR+TSR": (
                        np.concatenate([data["test_real"], data["test_gen"]]),
                        np.concatenate([data["test_labels_real"], data["test_labels_gen"]]),
                    ),
                }
                for setting, (X, y) in regimes.items():
                    clf.fit(X, y)
                    preds = clf.predict(data["data_real"])
                    for m, val in _compute_metrics(data["train_labels_real"], preds).items():
                        self.scores[setting][clf_name][m].append(val)
        return self.scores

    def report(self) -> Dict:
        out = {}
        for setting in self.scores:
            out[setting] = {}
            for clf_name in self.scores[setting]:
                out[setting][clf_name] = {}
                for m in METRICS:
                    vals = self.scores[setting][clf_name][m]
                    if vals:
                        out[setting][clf_name][m] = (float(np.mean(vals)),
                                                     float(np.std(vals)))
        return out


class UtilityEvaluatorPrimary(UtilityEvaluator):
    """Primary-site labels variant."""

    label_infix = "primary_site_"
