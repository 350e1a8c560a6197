"""Shape envelope of the key-tiled attention kernel in ``csrc/common.cuh``.

The headwise attention block and the row-resident flash attention both run
that kernel; this module is the one Python copy of its shared-memory
formula, which their dispatch envelopes (``fused_block.fits_headwise``,
``flash_attention.fits``) read. Each library that holds the kernel exports
the C formula as ``ivt_tiled_smem_bytes``, and ``check_library`` holds it
against this one after a build.
"""

from __future__ import annotations

import ctypes

# The card's shared memory per block (H100: 227 KB); the whole-image block
# kernel's envelope (``fused_block.fits``) reads it too.
SMEM_LIMIT = 232448
# Keys staged per K or V tile, and the widest head in whole float4s.
KT = 64
MAX_DH = 128


def smem_bytes(n: int, dh: int, qt: int) -> int:
    """Dynamic shared memory for n keys of width dh and qt query rows:
    scores [qt][n], Q [qt][dh], one K or V tile [64][dh+4], 1/rowsum [qt];
    all f32."""
    return 4 * (qt * n + qt * dh + KT * (dh + 4) + qt)


def query_tile(n: int, dh: int) -> int:
    """Query rows per block for n keys of width dh (32, or 16 where 32 rows
    of scores do not fit), 0 where the kernel does not run."""
    if n <= 0 or dh <= 0 or dh % 4 or dh > MAX_DH:
        return 0
    for qt in (32, 16):
        if smem_bytes(n, dh, qt) <= SMEM_LIMIT:
            return qt
    return 0


def check_smem_formula(lib_smem_bytes) -> None:
    """Raise unless ``lib_smem_bytes(n, dh)`` (bytes, 0 where the kernel
    does not run) is this module's formula."""
    for n, dh in ((1374, 64), (2048, 64), (3000, 64), (577, 64), (197, 64),
                  (17, 16), (50, 24), (300, 128), (300, 30)):
        qt = query_tile(n, dh)
        if lib_smem_bytes(n, dh) != (smem_bytes(n, dh, qt) if qt else 0):
            raise RuntimeError("csrc/common.cuh and ops/tiled_attention.py "
                               "disagree on the attention kernel's shared "
                               "memory")


def check_library(lib: ctypes.CDLL) -> None:
    """Hold a built library's ``ivt_tiled_smem_bytes`` against
    ``check_smem_formula``."""
    fn = lib.ivt_tiled_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_size_t
    check_smem_formula(fn)
