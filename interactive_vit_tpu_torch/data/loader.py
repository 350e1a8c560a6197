"""Batch loader over .npy arrays: native C++ prefetch, or its Python twin.

The port's copy of ``interactive_vit_tpu/data/loader.py``. The training
loop (``tools/train.py``) is bound by the device; the host's only job is
to have the next batch's bytes contiguous before the step returns. The
native backend (``runtime/dataloader.cpp``, built at first use by
``runtime/build.py``) mmaps the arrays and fills a bounded ring of batch
slots from worker threads: a per-epoch seeded shuffle, a per-sample
deterministic horizontal flip, batches delivered strictly in order, so
the stream is reproducible and bit-identical to the single-threaded
Python backend (``tests/test_torch_loader.py`` pins both against the JAX
package's loader).

``backend="auto"`` is the native backend. The Python one runs only where
the caller asks for it (``backend="python"``) or ``IVT_NATIVE=0`` is set;
a native backend that cannot be built raises.

Data format: two .npy files — images ``[N, C, H, W] float32`` and labels
``[N] int64`` (``save_dataset`` writes them). Deliberately mmap-friendly
raw arrays instead of a record container: the loader never parses
per-sample framing, and shards concatenate with ``np.concatenate`` on
disk.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from interactive_vit_tpu_torch.runtime import native


def _npy_meta(path: str) -> Tuple[Tuple[int, ...], np.dtype, int]:
    """(shape, dtype, data_offset) of an .npy without loading it."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        # public per-version readers (the private _read_array_header has
        # been reshuffled across numpy majors)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        if fortran:
            raise ValueError(f"{path}: fortran-order arrays unsupported")
        return shape, dtype, f.tell()


def save_dataset(prefix: str, images: np.ndarray, labels: np.ndarray) -> None:
    """Write ``{prefix}_images.npy`` / ``{prefix}_labels.npy`` in the
    loader's contract dtypes."""
    images = np.ascontiguousarray(images, np.float32)
    labels = np.ascontiguousarray(labels, np.int64)
    assert images.ndim == 4 and labels.shape == (images.shape[0],)
    np.save(prefix + "_images.npy", images)
    np.save(prefix + "_labels.npy", labels)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _epoch_perm(n: int, seed: int, epoch: int) -> np.ndarray:
    """The C++ loader's Fisher-Yates over mt19937_64(seed+epoch),
    replicated exactly (the cross-tier determinism contract; python's
    random / numpy's MT19937 are the 32-bit variant, so the 64-bit
    engine is implemented below)."""
    perm = np.arange(n, dtype=np.uint64)
    rng = _MT19937_64(seed + epoch)
    for i in range(n, 1, -1):
        j = rng.next() % i
        perm[i - 1], perm[j] = perm[j], perm[i - 1]
    return perm.astype(np.int64)


class _MT19937_64:
    """std::mt19937_64 (the C++ loader's shuffle engine)."""

    N, M = 312, 156
    MATRIX_A = 0xB5026F5AA96619E9
    UPPER = 0xFFFFFFFF80000000
    LOWER = 0x7FFFFFFF
    MASK = 0xFFFFFFFFFFFFFFFF

    def __init__(self, seed: int):
        self.mt = [0] * self.N
        self.mt[0] = seed & self.MASK
        for i in range(1, self.N):
            self.mt[i] = (6364136223846793005
                          * (self.mt[i - 1] ^ (self.mt[i - 1] >> 62))
                          + i) & self.MASK
        self.idx = self.N

    def next(self) -> int:
        if self.idx >= self.N:
            for i in range(self.N):
                x = ((self.mt[i] & self.UPPER)
                     | (self.mt[(i + 1) % self.N] & self.LOWER))
                xa = x >> 1
                if x & 1:
                    xa ^= self.MATRIX_A
                self.mt[i] = self.mt[(i + self.M) % self.N] ^ xa
            self.idx = 0
        y = self.mt[self.idx]
        self.idx += 1
        y ^= (y >> 29) & 0x5555555555555555
        y ^= (y << 17) & 0x71D67FFFEDA60000
        y ^= (y << 37) & 0xFFF7EEE000000000
        y ^= y >> 43
        return y & self.MASK


class Loader:
    """Iterate (images [B,C,H,W] f32, labels [B] i64, epoch) batches.

    ``backend="auto"`` is the native prefetcher unless ``IVT_NATIVE=0``
    asks for the Python backend; both produce the identical deterministic
    stream."""

    def __init__(self, images_path: str, labels_path: str, batch: int,
                 seed: int = 0, flip: bool = False, threads: int = 2,
                 depth: int = 4, backend: str = "auto",
                 borrow: bool = False):
        """``borrow=True`` (native only): batches VIEW the prefetch slot
        with zero copies — each next() invalidates the PREVIOUS batch's
        arrays, so copy them out (a blocking copy to the device) before
        iterating again. The train loop does; general callers should keep
        the copying default."""
        if backend not in ("auto", "native", "python"):
            # a typo'd backend silently selecting the slow Python one
            # would read as a mysterious training-throughput regression
            raise ValueError(f"unknown backend {backend!r} "
                             "(auto | native | python)")
        ishape, idtype, ioff = _npy_meta(images_path)
        lshape, ldtype, loff = _npy_meta(labels_path)
        if len(ishape) != 4 or idtype != np.float32:
            raise ValueError(
                f"{images_path}: expected [N,C,H,W] float32, got "
                f"{ishape} {idtype}")
        if lshape != (ishape[0],) or ldtype != np.int64:
            raise ValueError(
                f"{labels_path}: expected [{ishape[0]}] int64, got "
                f"{lshape} {ldtype}")
        if not 0 < batch <= ishape[0]:
            raise ValueError(f"batch {batch} vs {ishape[0]} samples")
        self.n, self.c, self.h, self.w = ishape
        self.batch = batch
        self.seed = seed
        self.flip = flip
        self.batches_per_epoch = self.n // batch
        self.borrow = borrow
        self._borrowed = False
        self._handle = None
        self._lib = None
        if backend == "native" or (backend == "auto" and native.enabled()):
            lib = native.get_lib()  # raises where it cannot be built
            self._handle = lib.ivt_loader_open(
                images_path.encode(), ioff, labels_path.encode(), loff,
                self.n, self.c, self.h, self.w, batch, depth, threads,
                seed, int(flip))
            if not self._handle:
                self._handle = None
                raise RuntimeError(
                    f"native loader could not open {images_path} / "
                    f"{labels_path} (truncated or unreadable files?)")
            self._lib = lib
        else:
            # the Python backend: mmap and replay the same stream
            self._images = np.load(images_path, mmap_mode="r")
            self._labels = np.load(labels_path, mmap_mode="r")
            self._cursor = 0

    @property
    def native(self) -> bool:
        return self._handle is not None

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        return self

    def __next__(self):
        if self._handle is not None:
            if self.borrow:
                if self._borrowed:
                    self._lib.ivt_loader_release(self._handle)
                    self._borrowed = False
                ip = ctypes.POINTER(ctypes.c_float)()
                lp = ctypes.POINTER(ctypes.c_int64)()
                epoch = self._lib.ivt_loader_borrow(
                    self._handle, ctypes.byref(ip), ctypes.byref(lp))
                if epoch < 0:
                    raise RuntimeError(
                        "native loader worker failed (host memory "
                        "pressure?) — restart or use backend='python'")
                self._borrowed = True
                images = np.ctypeslib.as_array(
                    ip, (self.batch, self.c, self.h, self.w))
                labels = np.ctypeslib.as_array(lp, (self.batch,))
                return images, labels, int(epoch)
            images = np.empty((self.batch, self.c, self.h, self.w),
                              np.float32)
            labels = np.empty((self.batch,), np.int64)
            epoch = self._lib.ivt_loader_next(
                self._handle, images.ctypes.data_as(ctypes.c_void_p),
                labels.ctypes.data_as(ctypes.c_void_p))
            if epoch < 0:
                raise RuntimeError(
                    "native loader worker failed (host memory "
                    "pressure?) — restart or use backend='python'")
            return images, labels, int(epoch)
        # the Python backend
        epoch, b = divmod(self._cursor, self.batches_per_epoch)
        perm = getattr(self, "_perm", None)
        if perm is None or self._perm_epoch != epoch:
            self._perm = _epoch_perm(self.n, self.seed, epoch)
            self._perm_epoch = epoch
        idx = self._perm[b * self.batch:(b + 1) * self.batch]
        images = np.ascontiguousarray(self._images[idx], np.float32)
        labels = np.ascontiguousarray(self._labels[idx], np.int64)
        if self.flip:
            for k, i in enumerate(idx):
                if _splitmix64(self.seed ^ (epoch * 0x9E37) ^ int(i)) & 1:
                    images[k] = images[k, :, :, ::-1]
        self._cursor += 1
        return images, labels, epoch

    def close(self) -> None:
        if self._handle is not None:
            if self._borrowed:
                self._lib.ivt_loader_release(self._handle)
                self._borrowed = False
            self._lib.ivt_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
