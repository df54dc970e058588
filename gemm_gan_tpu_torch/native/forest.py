"""ctypes binding for the native histogram random forest (`hist_forest.cpp`).

Counterpart of `gemm_gan_tpu/native/forest.py`: the sklearn-style estimator
the detection and utility suites use as their "RF". The library is built
from the source beside this file at first use by `native.build` (g++ into
the ignored `build/`, keyed by a hash of the source; a failed build raises
with the compiler's output; there is no fallback classifier).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from gemm_gan_tpu_torch.native.build import BUILD_DIR, build_library  # noqa: F401
from gemm_gan_tpu_torch.native.build import library_path as _library_path

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "hist_forest.cpp")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    return _library_path(SOURCE, "histforest")


def build() -> str:
    """Compile the library unless it exists; returns its path."""
    return build_library(SOURCE, "histforest")


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.hf_train.restype = ctypes.c_void_p
        lib.hf_train.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # X [n*d]
            ctypes.POINTER(ctypes.c_int32),   # y [n]
            ctypes.c_int64, ctypes.c_int64,   # n, d
            ctypes.c_int32,                   # n_classes
            ctypes.c_int32,                   # n_trees
            ctypes.c_int32,                   # max_depth
            ctypes.c_int32,                   # n_bins
            ctypes.c_double,                  # feature_fraction (<=0 => sqrt)
            ctypes.c_double,                  # bagging_fraction
            ctypes.c_int32,                   # min_leaf
            ctypes.c_uint64,                  # seed
            ctypes.c_int32,                   # n_threads
        ]
        lib.hf_predict_proba.restype = None
        lib.hf_predict_proba.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
        ]
        lib.hf_free.restype = None
        lib.hf_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def forest_available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _load() is not None


def _threads(n_jobs) -> int:
    return os.cpu_count() if n_jobs in (-1, 0, None) else n_jobs


class HistForestClassifier:
    """Native histogram random forest with the sklearn estimator surface
    (`fit` / `predict` / `predict_proba` / `classes_`)."""

    def __init__(self, n_estimators: int = 100, max_depth: int = 16,
                 n_bins: int = 64, feature_fraction: float = -1.0,
                 bagging_fraction: float = 1.0, min_samples_leaf: int = 1,
                 random_state: int = 0, n_jobs: int = -1):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.n_bins = n_bins
        self.feature_fraction = feature_fraction
        self.bagging_fraction = bagging_fraction
        self.min_samples_leaf = min_samples_leaf
        self.random_state = random_state
        self.n_jobs = n_jobs
        self._handle = None
        self._lib = None
        self.classes_ = None
        self._d = None

    def __del__(self):
        self._release()

    def _release(self):
        if self._handle is not None and self._lib is not None:
            self._lib.hf_free(self._handle)
            self._handle = None

    def fit(self, X, y):
        lib = _load()
        self._release()
        X = np.ascontiguousarray(X, np.float32)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D, got {X.shape}")
        self.classes_, y_idx = np.unique(np.asarray(y), return_inverse=True)
        n_classes = max(2, len(self.classes_))
        y_idx = np.ascontiguousarray(y_idx, np.int32)
        n, d = X.shape
        if len(y_idx) != n:
            raise ValueError(f"{len(y_idx)} labels for {n} rows")
        self._d = d
        handle = lib.hf_train(
            X.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            y_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, d, n_classes, self.n_estimators, self.max_depth, self.n_bins,
            self.feature_fraction, self.bagging_fraction,
            self.min_samples_leaf, self.random_state, _threads(self.n_jobs))
        if not handle:
            raise RuntimeError("hf_train failed (bad inputs?)")
        self._handle = handle
        self._lib = lib
        self._n_out = n_classes
        return self

    def predict_proba(self, X):
        if self._handle is None:
            raise RuntimeError("fit() before predict")
        X = np.ascontiguousarray(X, np.float32)
        if X.ndim != 2 or X.shape[1] != self._d:
            raise ValueError(f"X shape {X.shape} != (*, {self._d})")
        n = X.shape[0]
        out = np.empty((n, self._n_out), np.float32)
        self._lib.hf_predict_proba(
            self._handle, X.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), _threads(self.n_jobs))
        # restrict to the observed classes (binary-with-one-class edge case)
        return out[:, :len(self.classes_)] if len(self.classes_) < self._n_out else out

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]

    def score(self, X, y):
        return float(np.mean(self.predict(X) == np.asarray(y)))
