"""Kernel dispatch: the hand-written CUDA kernels or the plain path.

Counterpart of ``interactive_vit_tpu/ops/dispatch.py``'s
``default_block_impl``, ``default_window_impl``, ``default_mlp_impl``,
``default_attn_impl`` and ``auto_attention``.

Block policy names (``default_block_impl``):

    "auto"       on a CUDA device, in bf16 and in f32: the whole-image block
                 kernel where its shape fits (``fused_block.fits``), else the
                 headwise block kernel where that fits
                 (``fused_block.fits_headwise``: vit_l16 at 384 px); None (the
                 unfused path) otherwise
    "fused"      always the whole-image block wrapper (its plain version on
                 CPU)
    "headwise"   always the headwise block wrapper
    "reference"  None: the unfused path

Attention policy names (``default_attn_impl``), for blocks that run the
unfused path (LayerScale models such as DINOv2, or shapes no block kernel
takes):

    "auto"       ``auto_attention``: the flash kernel for CUDA tensors with
                 N >= ``FLASH_MIN_SEQ``, ``attention_reference`` otherwise
    "flash"      always the flash wrapper (its plain version on CPU)
    "reference"  None: ``attention_reference``

Window policy names (``default_window_impl``), for the Swin family:

    "auto"       on a CUDA device, in bf16 and in f32: the fused window
                 kernel when every stage of the config fits it
                 (``fused_window.fits``); None (the unfused path) otherwise
    "fused"      always the fused window wrapper (its plain version on CPU)
    "reference"  None: the unfused path

MLP policy names (``default_mlp_impl``):

    "auto"       None for dense models, as in the JAX package (there the
                 fused MLP is an opt-in; "auto" only ever selected the int8
                 variant, which is not ported)
    "fused"      the fused MLP wrapper (its plain version on CPU); raises
                 where the shape does not fit the kernel
    "reference"  None: the unfused MLP
    "w8a8"       not ported (TPU kernel ``fused_mlp_w8a8_block``): raises

Unlike the JAX policy, f32 is not excluded on CUDA: that exclusion worked
around HIGHEST-precision dots compiling slowly inside Mosaic, which has no
counterpart here. The decision is made by shape and device at dispatch
time, never by whether a build or launch succeeds.
"""

from __future__ import annotations

from typing import Optional

import torch

_DTYPES = (torch.float32, torch.bfloat16)

# The JAX package's threshold, measured on a TPU (XLA's fused attention
# chain against the Pallas kernel); not re-tuned for the card.
FLASH_MIN_SEQ = 256


def auto_attention(q, k, v, want_attn=False, n_real=None):
    """Sequence-length- and device-aware attention: the flash kernel for
    CUDA tensors of at least ``FLASH_MIN_SEQ`` tokens."""
    from interactive_vit_tpu_torch.ops.attention import attention_reference
    from interactive_vit_tpu_torch.ops.flash_attention import flash_mhsa

    if q.device.type == "cuda" and q.shape[2] >= FLASH_MIN_SEQ:
        return flash_mhsa(q, k, v, want_attn=want_attn, n_real=n_real)
    return attention_reference(q, k, v, want_attn=want_attn, n_real=n_real)


def default_attn_impl(name: str = "auto"):
    """Resolve an attention policy name to a callable
    ``(q, k, v, want_attn, n_real=None) -> (out, probs | None)``, or None
    for ``attention_reference``."""
    if name == "reference":
        return None
    if name == "flash":
        from interactive_vit_tpu_torch.ops.flash_attention import flash_mhsa

        return flash_mhsa
    if name == "auto":
        return auto_attention
    raise ValueError(f"unknown attention impl {name!r}")


def default_block_impl(name: str = "auto", dtype=None, n: int = 0,
                       d: int = 0, heads: int = 0, device=None):
    """Resolve the fused attention-block policy to a callable or None."""
    if name in ("none", "reference"):
        return None
    from interactive_vit_tpu_torch.ops.fused_block import (
        fits, fits_headwise, fused_attn_block, headwise_attn_block,
    )

    if name == "fused":
        return fused_attn_block
    if name == "headwise":
        return headwise_attn_block
    if name == "auto":
        dev: Optional[torch.device] = (torch.device(device)
                                       if device is not None else None)
        if dev is not None and dev.type == "cuda" and dtype in _DTYPES:
            if fits(n, d, heads):
                return fused_attn_block
            if fits_headwise(n, d, heads):
                return headwise_attn_block
        return None
    raise ValueError(f"unknown block impl {name!r}")


def default_window_impl(name: str = "auto", dtype=None, cfg=None,
                        device=None):
    """Resolve the fused Swin window-attention policy to a callable
    ``(y, p, heads, window, bias, mask, want_attn) -> (a, probs | None)``
    or None. ``cfg``: the ``SwinConfig`` whose stages "auto" checks."""
    if name in ("none", "reference"):
        return None
    from interactive_vit_tpu_torch.ops.fused_window import (
        fits, fused_window_attn,
    )

    if name == "fused":
        return fused_window_attn
    if name == "auto":
        dev: Optional[torch.device] = (torch.device(device)
                                       if device is not None else None)
        if (dev is not None and dev.type == "cuda" and dtype in _DTYPES
                and cfg is not None
                and all(fits(cfg.stage_res(s), cfg.window, cfg.stage_dim(s),
                             cfg.heads[s])
                        for s in range(len(cfg.depths)))):
            return fused_window_attn
        return None
    raise ValueError(f"unknown window impl {name!r}")


def default_mlp_impl(name: str = "auto", dtype=None, d: int = 0,
                     mlp_dim: int = 0, quant: str = "", device=None):
    """Resolve the fused MLP-branch policy to a callable
    ``(x, p, eps) -> y`` or None. ``dtype`` and ``device`` are accepted for
    the JAX signature's sake; no policy reads them yet ("auto" is None for
    every dense model)."""
    if name in ("none", "reference"):
        return None
    if name == "w8a8" or quant == "w8a8":
        raise NotImplementedError(
            "the W8A8 MLP kernel (interactive_vit_tpu/ops/fused_mlp.py:154 "
            "fused_mlp_w8a8_block) is not ported to CUDA yet")
    if name == "auto":
        return None
    if name == "fused":
        from interactive_vit_tpu_torch.ops import fused_mlp as fm

        if d and mlp_dim and not fm.fits(d, mlp_dim):
            raise ValueError(
                f"fused MLP kernel does not take d={d}, mlp_dim={mlp_dim}; "
                f"use mlp_impl='auto'/'reference'")
        return fm.fused_mlp_block
    raise ValueError(f"unknown mlp impl {name!r}")
