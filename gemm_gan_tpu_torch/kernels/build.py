"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under `csrc/` have a plain C interface (no PyTorch headers).
One `nvcc -c` per `.cu` file there, all started together, compiles them in
parallel; one more `nvcc -shared` links the objects into a shared library,
which `ctypes` loads. Pointers and the stream cross as `c_void_p`, sizes as
`c_int`. Every entry point returns `cudaGetLastError()` after its launch;
:func:`launch` raises when that is not 0. A failed build raises with nvcc's
output. There is no fallback: a caller that wants the kernel gets it or an
exception.

The library is built at first use into `build/` beside this file (listed in
`.gitignore`), under a name keyed by a hash of every file under `csrc/`
(headers included) and the flags, so an edited source or header is rebuilt
and an unchanged tree is loaded as it is. Nothing here runs at import time:
the CPU tests import this module on machines with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# C entry points and their arguments: pointers (and the stream last) cross
# as c_void_p, sizes as c_int
_FWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# (q, k, v, mask, o, dout, lse, delta, dq, dk, dv, batch, lq, lk, heads,
#  head_dim, stream)
_BWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
ENTRY_POINTS = {
    # (q, k, v, mask, o, lse, batch, lq, lk, heads, head_dim, stream)
    "flash_fwd_ble": _FWD_ARGS,
    "flash_fwd_bhld": _FWD_ARGS,
    "flash_bwd_ble": _BWD_ARGS,
    "flash_bwd_bhld_fused": _BWD_ARGS,
    "flash_bwd_dq": _BWD_ARGS,
    "flash_bwd_dkv": _BWD_ARGS,
    # the bf16 modes of every kernel (csrc/flash_ops.cuh): bf16 refs with
    # f32-exact products; mxu_bf16, whose entry points take one more int, 1
    # for bf16 refs and 0 for f32 ones
    **{f"flash_fwd_{layout}_{mode}": _FWD_ARGS + extra
       for layout in ("ble", "bhld") for mode, extra in (("bf16", []), ("mxu", [ctypes.c_int]))},
    **{f"flash_bwd_{kernel}_{mode}": _BWD_ARGS + extra
       for kernel in ("ble", "bhld_fused", "dq", "dkv")
       for mode, extra in (("bf16", []), ("mxu", [ctypes.c_int]))},
}
# the tensor-core kernels (every entry point above), each with an entry
# `<name>_occupancy(head_dim, *smem_bytes, *blocks_per_sm)`
TENSOR_CORE_KERNELS = tuple(ENTRY_POINTS)
ENTRY_POINTS.update({name + "_occupancy": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                     for name in TENSOR_CORE_KERNELS})

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "CUDA kernels need the CUDA toolkit to build")


def sources() -> list:
    """The `.cu` files under `csrc/`, each compiled by its own nvcc."""
    return sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cu"))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        h.update(name.encode())
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgemm_gan_kernels_{h.hexdigest()[:16]}.so")


def _run(cmds):
    """Run the commands in parallel; raise with the output of the first that
    fails. Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {p.returncode}:\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Tuple[str, float, str]:
    """Compile the sources unless this exact build exists.

    Returns (library path, seconds spent, nvcc's output: ptxas register and
    spill lines; empty when the library was already built)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sources()
        objs = [os.path.join(tmp, s + ".o") for s in srcs]
        log = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, s)]
                    for s, obj in zip(srcs, objs)])
        lib = os.path.join(tmp, "lib.so")
        _run([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, path)  # atomic: a concurrent build leaves one good file
    return path, time.perf_counter() - t0, log


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()[0])
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.gemm_gan_error_string.argtypes = [ctypes.c_int]
            lib.gemm_gan_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call entry point `name` and raise if its launch was refused."""
    lib = load()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.gemm_gan_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err} ({msg})")


def occupancy(name: str, head_dim: int) -> Tuple[int, int]:
    """(dynamic shared memory bytes per block, resident blocks per SM) of
    tensor-core kernel `name` at `head_dim`, from the CUDA runtime."""
    lib = load()
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = getattr(lib, name + "_occupancy")(head_dim, ctypes.byref(smem), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{name} occupancy query failed: error {err} "
                           f"({lib.gemm_gan_error_string(err).decode()})")
    return smem.value, blocks.value
