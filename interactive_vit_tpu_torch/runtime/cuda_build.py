"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. On first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` at the repository root and loaded with ``ctypes``.
The file name carries a hash of the source and the compiler flags, so an
edited source never loads a stale library. Nothing here runs at import
time: the CPU-only test environment imports this module but never builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler, from PATH or the toolkit's default location."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from source at first "
            "use and need the CUDA toolkit (nvcc on PATH or /usr/local/cuda)")
    return path


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, keyed by source and flags."""
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists; returns
    the library path."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private path, then rename: a process building at the
    # same time never loads a half-written library
    tmp = f"{so}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed. Loaded once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
