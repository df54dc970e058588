"""The few scikit-learn pieces the evaluation suite calls, in numpy / scipy.

The JAX package's evaluation calls scikit-learn for a shuffle, a handful of
classification metrics, PCA and logistic regression; the port's machines
need not have it. Each piece here computes what the scikit-learn 1.9 call
of the same name computes (the CPU tests hold them to it):

* `shuffle(*arrays, random_state)`: `RandomState(seed).shuffle(arange(n))`
  indexes every array, as `sklearn.utils.shuffle` draws it.
* `accuracy`, `balanced_accuracy`, `precision`, `recall`, `f1` (`average`
  "binary" with positive label 1, "macro" or "weighted", `zero_division=0`)
  and `roc_auc` (binary; tied scores count half, as the trapezoid over
  the ROC curve does).
* `PCA`: the exact components of a full SVD of the centred data
  (`scipy.linalg.svd`, as `svd_solver="full"`), each row's sign set so its
  entry of largest magnitude is positive (`svd_flip` on the rows of Vt, the
  basis PCA uses). scikit-learn's default solver is randomized and unseeded
  at the detection shapes, so only the "full" solver is reproducible.
* `LogisticRegression(C, max_iter, tol)`: the lbfgs objective, mean
  log-loss plus ||w||^2 / (2 C n) with the intercept not penalized
  (binomial for two classes, multinomial otherwise), minimized by
  `scipy.optimize.minimize(method="L-BFGS-B")` with scikit-learn's options
  from a zero start.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg, optimize, special, stats


# ------------------------------------------------------------------ shuffle
def shuffle(*arrays, random_state: int = 0):
    """The arrays reordered by one permutation of `random_state`."""
    n = len(arrays[0])
    idx = np.arange(n)
    np.random.RandomState(random_state).shuffle(idx)
    out = [np.asarray(a)[idx] for a in arrays]
    return out[0] if len(out) == 1 else out


# ------------------------------------------------------------------ metrics
def accuracy(y_true, y_pred) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def _confusion(y_true, y_pred, labels):
    """[len(labels), len(labels)] counts, rows true, columns predicted."""
    pos = {v: i for i, v in enumerate(labels.tolist())}
    t = np.array([pos[v] for v in np.asarray(y_true).tolist()], np.int64)
    p = np.array([pos[v] for v in np.asarray(y_pred).tolist()], np.int64)
    n = len(labels)
    return np.bincount(t * n + p, minlength=n * n).reshape(n, n)


def balanced_accuracy(y_true, y_pred) -> float:
    """Mean recall over the classes present in `y_true`."""
    labels = np.union1d(y_true, y_pred)
    c = _confusion(y_true, y_pred, labels)
    support = c.sum(axis=1)
    present = support > 0
    return float(np.mean(np.diag(c)[present] / support[present]))


def _divide(num, den):
    """num / den with 0 where den is 0 (zero_division=0)."""
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def _prf(y_true, y_pred, average: str):
    """(precision, recall, f1) averaged as scikit-learn's
    `precision_recall_fscore_support(zero_division=0)`."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(y_true, y_pred)
    if average == "binary":
        if len(labels) > 2:
            raise ValueError(f"average='binary' needs binary labels, got {labels}")
        if 1 not in labels.tolist() and len(labels) == 2:
            raise ValueError(f"pos_label=1 is not a valid label: {labels}")
        labels_used = np.array([1])
    elif average in ("macro", "weighted"):
        labels_used = labels
    else:
        raise ValueError(f"unsupported average {average!r}")
    tp = np.array([np.sum((y_pred == c) & (y_true == c)) for c in labels_used])
    pred = np.array([np.sum(y_pred == c) for c in labels_used])
    true = np.array([np.sum(y_true == c) for c in labels_used])
    p, r, f = _divide(tp, pred), _divide(tp, true), _divide(2 * tp, true + pred)
    if average == "binary":
        return float(p[0]), float(r[0]), float(f[0])
    w = true if average == "weighted" else None
    if w is not None and w.sum() == 0:
        w = None
    return tuple(float(np.average(v, weights=w)) for v in (p, r, f))


def precision(y_true, y_pred, average: str = "binary") -> float:
    return _prf(y_true, y_pred, average)[0]


def recall(y_true, y_pred, average: str = "binary") -> float:
    return _prf(y_true, y_pred, average)[1]


def f1(y_true, y_pred, average: str = "binary") -> float:
    return _prf(y_true, y_pred, average)[2]


def roc_auc(y_true, y_score) -> float:
    """Binary ROC AUC (the larger label positive): the Mann-Whitney U over
    n_pos * n_neg, tied scores at their mid-rank."""
    y_true = np.asarray(y_true)
    classes = np.unique(y_true)
    if len(classes) != 2:
        raise ValueError("Only one class is present in y_true. ROC AUC score "
                         "is not defined in that case.")
    pos = y_true == classes[1]
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    ranks = stats.rankdata(np.asarray(y_score, np.float64))
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


# ---------------------------------------------------------------------- PCA
class PCA:
    """Principal components from an exact SVD (`fit_transform`,
    `transform`; `components_`, `mean_`)."""

    def __init__(self, n_components: int):
        self.n_components = n_components

    def fit_transform(self, X):
        X = np.asarray(X)
        if not np.issubdtype(X.dtype, np.floating):
            X = X.astype(np.float64)
        n, d = X.shape
        k = self.n_components
        if not 0 <= k <= min(n, d):
            raise ValueError(f"n_components={k} must be between 0 and "
                             f"min(n_samples, n_features)={min(n, d)}")
        self.mean_ = X.mean(axis=0)
        U, S, Vt = linalg.svd(X - self.mean_, full_matrices=False)
        # svd_flip on the rows of Vt: each row's entry of largest magnitude
        # is made positive, and U's columns follow
        signs = np.sign(Vt[np.arange(len(Vt)), np.argmax(np.abs(Vt), axis=1)])
        U *= signs[None, :]
        Vt *= signs[:, None]
        self.components_ = Vt[:k]
        return U[:, :k] * S[:k]

    def transform(self, X):
        X = np.asarray(X)
        return X @ self.components_.T - (self.mean_[None, :] @ self.components_.T)


# ------------------------------------------------------- logistic regression
class LogisticRegression:
    """L2 logistic regression by L-BFGS-B (`fit`, `predict`,
    `predict_proba`, `decision_function`; `coef_`, `intercept_`,
    `classes_`). Computes in float64."""

    def __init__(self, C: float = 1.0, max_iter: int = 100, tol: float = 1e-4):
        self.C = C
        self.max_iter = max_iter
        self.tol = tol

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y)
        self.classes_, y_idx = np.unique(y, return_inverse=True)
        n, d = X.shape
        k = len(self.classes_)
        if k < 2:
            raise ValueError(f"needs samples of at least 2 classes, got {self.classes_}")
        l2 = 1.0 / (self.C * n)
        if k == 2:
            target = (y_idx == 1).astype(np.float64)
            w0 = np.zeros(d + 1)

            def fun(w):
                coef, b = w[:d], w[d]
                raw = X @ coef + b
                # log(1 + exp(raw)) - y raw
                loss = np.mean(np.logaddexp(0.0, raw) - target * raw)
                g = (special.expit(raw) - target) / n
                grad = np.empty_like(w)
                grad[:d] = X.T @ g + l2 * coef
                grad[d] = g.sum()
                return loss + 0.5 * l2 * coef @ coef, grad
        else:
            onehot = np.eye(k)[y_idx]
            # [k, d + 1] flattened in column-major order, scikit-learn's layout
            w0 = np.zeros((k, d + 1), order="F").ravel(order="F")

            def fun(w):
                W = w.reshape((k, d + 1), order="F")
                coef, b = W[:, :d], W[:, d]
                raw = X @ coef.T + b
                lse = special.logsumexp(raw, axis=1)
                loss = np.mean(lse - np.sum(onehot * raw, axis=1))
                g = (np.exp(raw - lse[:, None]) - onehot) / n
                grad = np.empty_like(W)
                grad[:, :d] = g.T @ X + l2 * coef
                grad[:, d] = g.sum(axis=0)
                return (loss + 0.5 * l2 * np.sum(coef * coef),
                        grad.ravel(order="F"))

        res = optimize.minimize(
            fun, w0, method="L-BFGS-B", jac=True,
            options={"maxiter": self.max_iter, "maxls": 50, "gtol": self.tol,
                     "ftol": 64 * np.finfo(float).eps})
        if k == 2:
            self.coef_ = res.x[None, :d]
            self.intercept_ = res.x[d:]
        else:
            W = res.x.reshape((k, d + 1), order="F")
            self.coef_, self.intercept_ = W[:, :d], W[:, d]
        return self

    def decision_function(self, X):
        raw = np.asarray(X, np.float64) @ self.coef_.T + self.intercept_
        return raw[:, 0] if raw.shape[1] == 1 else raw

    def predict_proba(self, X):
        raw = self.decision_function(X)
        if raw.ndim == 1:
            p = special.expit(raw)
            return np.stack([1.0 - p, p], axis=1)
        return special.softmax(raw, axis=1)

    def predict(self, X):
        raw = self.decision_function(X)
        idx = (raw > 0).astype(int) if raw.ndim == 1 else raw.argmax(axis=1)
        return self.classes_[idx]
