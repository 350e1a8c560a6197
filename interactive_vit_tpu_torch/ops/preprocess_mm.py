"""Eval preprocessing as matmuls: resize + centre crop + normalise.

Counterpart of ``interactive_vit_tpu/ops/preprocess_mm.py``. An
antialiased resize is separable, so ``resize(x)`` is ``R_h @ x @ R_w^T``
with small dense matrices; the centre crop keeps only the rows of R that
survive it, and the per-channel normalisation is a trailing affine.

The resampling matrices use half-pixel centres and a kernel dilated by the
scale factor when downsampling (antialiasing), rows renormalised:
"bilinear" (triangle kernel) replicates ``jax.image.resize(...,
"bilinear")``; "bicubic" is the Keys kernel with a=-0.5 and support 2
(PIL's BICUBIC), which Swin's eval transform uses. They are built with
numpy exactly as in the JAX package, so the two sides' matrices are equal
bit for bit.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from interactive_vit_tpu_torch.ops.layers import target_dims


def _triangle(t: float) -> float:
    t = abs(t)
    return 1.0 - t if t < 1.0 else 0.0


def _cubic(t: float, a: float = -0.5) -> float:
    """Keys cubic kernel, a=-0.5 (PIL's bicubic); support 2."""
    t = abs(t)
    if t < 1.0:
        return (a + 2.0) * t * t * t - (a + 3.0) * t * t + 1.0
    if t < 2.0:
        return a * (t * t * t - 5.0 * t * t + 8.0 * t - 4.0)
    return 0.0


# method -> (kernel, its support at scale 1)
_KERNELS = {"bilinear": (_triangle, 1.0), "bicubic": (_cubic, 2.0)}


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int,
                  method: str = "bilinear") -> np.ndarray:
    """[out_size, in_size] antialiased resampling matrix (f32) for
    ``method`` "bilinear" or "bicubic"."""
    kernel, base_support = _KERNELS[method]
    scale = in_size / out_size
    fscale = max(1.0, scale)  # kernel dilation when downsampling
    support = base_support * fscale
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        for j in range(max(0, lo), min(in_size, hi + 1)):
            w[i, j] = kernel((j - center) / fscale)
        s = w[i].sum()
        if s > 0:
            w[i] /= s
    w.setflags(write=False)  # shared by every caller through the cache
    return w


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_mm(images: torch.Tensor, size: int,
                  resize_to: Optional[int] = None,
                  method: str = "bilinear") -> torch.Tensor:
    """resize -> centre crop -> ImageNet normalise via two matmuls.

    [B, C, H, W] or [C, H, W] in [0, 1] -> [..., C, size, size], in the
    input's dtype (the products accumulate in f32). ``resize_to``: the
    shorter side's target (default size*256/224); ``method``: "bilinear"
    or "bicubic"."""
    squeeze = images.ndim == 3
    if squeeze:
        images = images[None]
    b, c, h, w = images.shape
    nh, nw = target_dims(h, w, size, resize_to)
    top, left = (nh - size) // 2, (nw - size) // 2
    dev = images.device
    rh = torch.from_numpy(resize_matrix(h, nh, method)[top:top + size].copy()).to(dev)
    rw = torch.from_numpy(resize_matrix(w, nw, method)[left:left + size].copy()).to(dev)

    x = images.reshape(b * c, h, w).float()
    x = torch.matmul(rh, x)                  # [B*C, size, W]
    x = torch.matmul(x, rw.t())              # [B*C, size, size]
    x = x.reshape(b, c, size, size).to(images.dtype)

    m = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=dev)
    s = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=dev)
    x = (x - m.reshape(1, -1, 1, 1)) / s.reshape(1, -1, 1, 1)
    return x[0] if squeeze else x
