"""ctypes binding for the native exact optimal-transport solver (`ot_emd.cpp`).

Counterpart of `gemm_gan_tpu/native/__init__.py`'s `exact_emd2`. The
library is built from the source beside this file at first use by
`native.build` (g++ into the ignored `build/`, keyed by a hash of the
source). A failed build raises with the compiler's output: there is no
assignment or Sinkhorn fallback, as the JAX package has.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from gemm_gan_tpu_torch.native.build import build_library

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "ot_emd.cpp")

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile the library unless it exists; returns its path."""
    return build_library(SOURCE, "otemd")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.emd2.restype = ctypes.c_double
            lib.emd2.argtypes = [
                ctypes.POINTER(ctypes.c_double),  # a [n]
                ctypes.POINTER(ctypes.c_double),  # b [m]
                ctypes.POINTER(ctypes.c_double),  # M [n*m]
                ctypes.c_int,                     # n
                ctypes.c_int,                     # m
                ctypes.c_long,                    # max iterations
            ]
            _lib = lib
        return _lib


def exact_emd2(a: np.ndarray, b: np.ndarray, M: np.ndarray,
               num_iter_max: int = 10_000_000) -> float:
    """Exact OT cost <P*, M> with marginals a, b (summing to the same mass),
    all in float64."""
    lib = _load()
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    M = np.ascontiguousarray(M, np.float64)
    n, m = M.shape
    if a.shape != (n,) or b.shape != (m,):
        raise ValueError(f"marginals {a.shape}, {b.shape} for a cost matrix {M.shape}")
    ret = lib.emd2(a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                   b.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                   M.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                   n, m, num_iter_max)
    if ret < 0:
        raise RuntimeError("native OT solver failed to converge")
    return float(ret)
