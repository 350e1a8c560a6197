"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. On first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` at the repository root and loaded with ``ctypes``.
The file name carries a hash of the source, of every shared header
``csrc/*.cuh`` and of the compiler flags, so an edited source or header
never loads a stale library. ``build_all`` compiles several sources at
once, one ``nvcc`` each. Nothing here runs at import time: the CPU-only
test environment imports this module but never builds.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

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
    """Where ``csrc/<name>.cu`` builds to, keyed by the source, the shared
    headers and the flags."""
    h = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, name + ".cu"),
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


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


def build_all(names: Sequence[str]) -> List[str]:
    """Compile the named sources side by side (one ``nvcc`` each); returns
    their library paths. Raises on the first failed build."""
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed. Loaded once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
