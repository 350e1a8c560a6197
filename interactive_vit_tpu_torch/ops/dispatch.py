"""Kernel dispatch: the hand-written CUDA block kernel or the plain path.

Counterpart of ``interactive_vit_tpu/ops/dispatch.py::default_block_impl``.
Policy names:

    "auto"       the fused block kernel for every model on a CUDA device
                 whose shape the kernel takes (``fused_block.fits``), in
                 bf16 and in f32; None (the unfused plain path) otherwise
    "fused"      always the fused block wrapper (its plain version on CPU)
    "reference"  None: the unfused plain path

Unlike the JAX policy, f32 is not excluded on CUDA: that exclusion worked
around HIGHEST-precision dots compiling slowly inside Mosaic, which has no
counterpart here. The decision is made by shape and device at dispatch
time, never by whether a build or launch succeeds.
"""

from __future__ import annotations

from typing import Optional

import torch

_DTYPES = (torch.float32, torch.bfloat16)


def default_block_impl(name: str = "auto", dtype=None, n: int = 0,
                       d: int = 0, heads: int = 0, device=None):
    """Resolve the fused attention-block policy to a callable or None."""
    if name in ("none", "reference"):
        return None
    from interactive_vit_tpu_torch.ops.fused_block import fits, fused_attn_block

    if name == "fused":
        return fused_attn_block
    if name == "auto":
        dev: Optional[torch.device] = (torch.device(device)
                                       if device is not None else None)
        if (dev is not None and dev.type == "cuda" and dtype in _DTYPES
                and fits(n, d, heads)):
            return fused_attn_block
        return None
    raise ValueError(f"unknown block impl {name!r}")
