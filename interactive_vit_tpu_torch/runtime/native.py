"""ctypes bindings for the host library (``wirecodec.cpp``,
``dataloader.cpp``).

``get_lib()`` builds the library at first use (``runtime/build.py``) and
loads it once a process. A build or load that fails raises: no path falls
back to Python unasked. ``IVT_NATIVE=0`` in the environment is the one way
to ask for the Python tier (``enabled()`` reads it); the wire codec and the
loader's ``auto`` backend then never build the library.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_lib: Optional[ctypes.CDLL] = None
_error: Optional[BaseException] = None
_load_lock = threading.Lock()

MAX_BLOCKS = 65536

_ERRORS = {
    -1: "message too short",
    -2: "bad magic",
    -3: "truncated message",
    -4: "tensor block size mismatch",
    -5: "too many tensor blocks",
}


def enabled() -> bool:
    """False where ``IVT_NATIVE=0`` asks for the Python tier."""
    return os.environ.get("IVT_NATIVE", "1") != "0"


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built first where needed. Raises
    ``RuntimeError`` (the compiler's message, and how to ask for the Python
    tier instead) when it cannot be built or loaded."""
    if _lib is not None:
        return _lib
    with _load_lock:
        return _get_lib_locked()


def _get_lib_locked() -> ctypes.CDLL:
    # under the lock: the build takes seconds of g++, and a concurrent
    # first caller waits for it instead of building a second copy
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise RuntimeError(str(_error)) from _error
    from interactive_vit_tpu_torch.runtime import build

    try:
        path = build.build()
        lib = ctypes.CDLL(path)
        _bind(lib)
    except Exception as err:  # noqa: BLE001 — re-raised with the remedy
        _error = RuntimeError(
            f"the host library (wire codec and data loader) could not be "
            f"built or loaded: {err}\nSet IVT_NATIVE=0 to run the Python "
            f"tier instead.")
        raise _error from err
    logger.info("host library loaded: %s", path)
    _lib = lib
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.ivt_scan.restype = ctypes.c_int
    lib.ivt_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32, u64p, u64p, u32p,
        u64p, u64p, ctypes.c_int]
    lib.ivt_encoded_size.restype = ctypes.c_uint64
    lib.ivt_encoded_size.argtypes = [ctypes.c_uint64, u32p, u64p,
                                     ctypes.c_int]
    lib.ivt_pack.restype = ctypes.c_uint64
    lib.ivt_pack.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_char_p), u32p,
        ctypes.POINTER(ctypes.c_char_p), u64p, ctypes.c_int]
    lib.ivt_loader_open.restype = ctypes.c_void_p
    lib.ivt_loader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
        ctypes.c_int]
    lib.ivt_loader_next.restype = ctypes.c_int64
    lib.ivt_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p]
    lib.ivt_loader_borrow.restype = ctypes.c_int64
    lib.ivt_loader_borrow.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))]
    lib.ivt_loader_release.restype = None
    lib.ivt_loader_release.argtypes = [ctypes.c_void_p]
    lib.ivt_loader_close.restype = None
    lib.ivt_loader_close.argtypes = [ctypes.c_void_p]


class _ScanScratch(threading.local):
    """Per-thread output arrays for ``scan``: five MAX_BLOCKS-entry ctypes
    arrays (~1.8 MB) made once a serving thread (the HTTP server decodes
    concurrently) instead of once a request."""

    def __init__(self) -> None:
        n = MAX_BLOCKS
        self.json_out = (ctypes.c_uint64 * 2)()
        self.dims_off = (ctypes.c_uint64 * n)()
        self.dim_cnt = (ctypes.c_uint32 * n)()
        self.data_off = (ctypes.c_uint64 * n)()
        self.elem_cnt = (ctypes.c_uint64 * n)()


_scratch = _ScanScratch()


def scan(buf, expect_magic: int
         ) -> Tuple[Tuple[int, int], List[Tuple[int, int, int, int]]]:
    """Native block scan: ``((json_off, json_size), [(dims_off, dim_cnt,
    data_off, elem_cnt), ...])``. Raises ValueError on a malformed
    message."""
    lib = get_lib()
    if isinstance(buf, bytearray):
        buf = (ctypes.c_char * len(buf)).from_buffer(buf)  # no copy
    elif not isinstance(buf, bytes):
        # a memoryview or other buffer: copied once (a read-only view
        # cannot be wrapped writable; the offsets index the same content)
        buf = bytes(buf)
    s = _scratch
    rc = lib.ivt_scan(buf, len(buf), expect_magic, s.json_out, s.dims_off,
                      s.dim_cnt, s.data_off, s.elem_cnt, MAX_BLOCKS)
    if rc < 0:
        raise ValueError(_ERRORS.get(rc, f"scan error {rc}"))
    blocks = [(s.dims_off[i], s.dim_cnt[i], s.data_off[i], s.elem_cnt[i])
              for i in range(rc)]
    return (s.json_out[0], s.json_out[1]), blocks


def pack(magic: int, json_utf8: bytes, tensors: List[np.ndarray]
         ) -> bytearray:
    """One message written into one allocation: each tensor's bytes are
    copied once, straight into the returned ``bytearray``."""
    lib = get_lib()
    tensors = [np.asarray(t, dtype=np.float32) for t in tensors]
    n = len(tensors)
    dims_arrs = [np.asarray(t.shape, dtype=np.uint32) for t in tensors]
    dim_cnt = (ctypes.c_uint32 * n)(*(d.size for d in dims_arrs))
    elem_cnt = (ctypes.c_uint64 * n)(*(t.size for t in tensors))
    dims_bytes = [d.tobytes() for d in dims_arrs]  # kept alive below
    dims_ptrs = (ctypes.c_char_p * n)(*dims_bytes)
    data_bufs = [t if (t.flags.c_contiguous or t.ndim == 0)
                 else np.ascontiguousarray(t) for t in tensors]
    data_ptrs = (ctypes.c_void_p * n)(*(t.ctypes.data for t in data_bufs))
    size = lib.ivt_encoded_size(len(json_utf8), dim_cnt, elem_cnt, n)
    if size > 0xFFFFFFFF:
        # check the u32 framing before allocating a > 4 GB buffer
        raise ValueError(
            f"message too large for the wire format (total {size} bytes)")
    out = bytearray(size)
    out_ref = (ctypes.c_char * size).from_buffer(out)
    written = lib.ivt_pack(out_ref, magic, json_utf8, len(json_utf8),
                           dims_ptrs, dim_cnt,
                           ctypes.cast(data_ptrs,
                                       ctypes.POINTER(ctypes.c_char_p)),
                           elem_cnt, n)
    del out_ref  # the buffer export ends here: the bytearray is usable
    if written != size:
        # 0: a block exceeds the u32 framing; fail loudly, as the Python
        # encoder's struct.error does, never emit wrapped sizes
        raise ValueError(
            f"message too large for the wire format (total {size} bytes)")
    return out
