"""Build a native source beside this file into a shared library at first use.

Counterpart of `gemm_gan_tpu/native/build.py`. Each library is compiled with
`g++ -O3 -std=c++17 -shared -fPIC -pthread` into `build/` beside this file
(listed in `.gitignore`) under a name keyed by a hash of the source and the
flags, so an edited source is rebuilt. The build writes a temporary file
and renames it, so concurrent processes never load a half-written library.
A failed build raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(HERE, "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path(source: str, stem: str) -> str:
    """Where the library `lib<stem>-<hash>.so` of `source` and the flags lives."""
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_library(source: str, stem: str) -> str:
    """Compile `source` unless its library exists; returns the library's path."""
    out = library_path(source, stem)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, source],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"native build of {source} failed:\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
