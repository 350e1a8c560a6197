"""Eval preprocessing as matmuls: resize + centre crop + normalise.

Counterpart of ``interactive_vit_tpu/ops/preprocess_mm.py`` (bilinear
only; the bicubic kernel waits). An antialiased bilinear resize is
separable, so ``resize(x)`` is ``R_h @ x @ R_w^T`` with small dense
matrices; the centre crop keeps only the rows of R that survive it, and
the per-channel normalisation is a trailing affine.

The resampling matrices replicate ``jax.image.resize(..., "bilinear")``:
half-pixel centres, a triangle kernel dilated by the scale factor when
downsampling (antialiasing), rows renormalised.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from interactive_vit_tpu_torch.ops.layers import target_dims


def _triangle(t: float) -> float:
    t = abs(t)
    return 1.0 - t if t < 1.0 else 0.0


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] antialiased bilinear resampling matrix (f32)."""
    scale = in_size / out_size
    fscale = max(1.0, scale)  # kernel dilation when downsampling
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        lo = int(np.floor(center - fscale))
        hi = int(np.ceil(center + fscale))
        for j in range(max(0, lo), min(in_size, hi + 1)):
            w[i, j] = _triangle((j - center) / fscale)
        s = w[i].sum()
        if s > 0:
            w[i] /= s
    w.setflags(write=False)  # shared by every caller through the cache
    return w


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_mm(images: torch.Tensor, size: int) -> torch.Tensor:
    """resize -> centre crop -> ImageNet normalise via two matmuls.

    [B, C, H, W] or [C, H, W] in [0, 1] -> [..., C, size, size], in the
    input's dtype (the products accumulate in f32)."""
    squeeze = images.ndim == 3
    if squeeze:
        images = images[None]
    b, c, h, w = images.shape
    nh, nw = target_dims(h, w, size)
    top, left = (nh - size) // 2, (nw - size) // 2
    dev = images.device
    rh = torch.from_numpy(resize_matrix(h, nh)[top:top + size].copy()).to(dev)
    rw = torch.from_numpy(resize_matrix(w, nw)[left:left + size].copy()).to(dev)

    x = images.reshape(b * c, h, w).float()
    x = torch.matmul(rh, x)                  # [B*C, size, W]
    x = torch.matmul(x, rw.t())              # [B*C, size, size]
    x = x.reshape(b, c, size, size).to(images.dtype)

    m = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=dev)
    s = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=dev)
    x = (x - m.reshape(1, -1, 1, 1)) / s.reshape(1, -1, 1, 1)
    return x[0] if squeeze else x
