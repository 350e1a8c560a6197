"""Build the host library (``python -m
interactive_vit_tpu_torch.runtime.build``).

Compiles ``wirecodec.cpp`` (the wire codec's block scan and pack) and
``dataloader.cpp`` (the prefetching batch loader) with g++ into one shared
library under ``build/torch_native/`` at the repository root. The file name
carries a hash of the two sources, the compiler flags and the CPU model:
``-march=native`` makes the library specific to the CPU that built it, so
a build directory shared between two machines never loads a library that
would die with SIGILL, and an edited source never loads a stale one. The
build writes a private path and renames it, so a process that builds at
the same time never loads a half-written file. Nothing builds at import
time: ``runtime/native.py`` builds at first use.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("wirecodec.cpp", "dataloader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(HERE)), "build",
                         "torch_native")
# -pthread: dataloader.cpp uses std::thread and condition_variable; without
# it, hosts with glibc < 2.34 fail the dlopen or throw std::system_error at
# the first thread
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-march=native",
         "-pthread")


def cpu_model() -> str:
    """The CPU's model name from /proc/cpuinfo ("unknown" where absent)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def library_path() -> str:
    """Where the library builds to, keyed by the sources, the flags and the
    CPU model."""
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(HERE, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(FLAGS).encode() + b"\0" + cpu_model().encode())
    return os.path.join(BUILD_DIR, f"ivt_native-{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the sources unless the keyed library exists; returns its
    path. Raises ``RuntimeError`` with the compiler's message on failure."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", *FLAGS, "-o", tmp,
           *(os.path.join(HERE, name) for name in SOURCES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:  # no g++ at all
        raise RuntimeError(f"host library build failed: {err}") from err
    if res.returncode != 0:
        raise RuntimeError(f"host library build failed:\n{res.stderr}")
    os.replace(tmp, so)
    if verbose:
        print(f"built {so}")
    return so


if __name__ == "__main__":
    build(verbose=True)
