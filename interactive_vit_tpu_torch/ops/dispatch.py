"""Kernel dispatch: the hand-written CUDA kernels or the plain path.

Counterpart of ``interactive_vit_tpu/ops/dispatch.py``'s
``default_block_impl``, ``default_window_impl``, ``default_mlp_impl``,
``default_attn_impl`` and ``auto_attention``, by the same policy names.

Block policy names (``default_block_impl``):

    "auto"       on a CUDA device, in bf16 and in f32: the whole-image block
                 kernel where its shape fits (``fused_block.fits``), else the
                 headwise block kernel where that fits
                 (``fused_block.fits_headwise``: vit_l16 at 384 px); None (the
                 unfused path) otherwise
    "fused"      always the whole-image block wrapper (its plain version on
                 CPU)
    "headwise"   always the headwise block wrapper
    "int8-scores"     the s8 mode of the whole-image block
                 (``fused_block.fused_attn_block_s8``, s8 score and PV
                 products); raises where the s8 envelope
                 (``fused_block.fits(..., int8_scores=True)``) does not hold:
                 the headwise kernel has no s8 mode
    "int8-scores-qk"  the same with s8 scores and a dense PV product
    "reference"  None: the unfused path

Attention policy names (``default_attn_impl``), for blocks that run the
unfused path (LayerScale models such as DINOv2, or shapes no block kernel
takes):

    "auto"       ``auto_attention``: the flash kernel for CUDA tensors with
                 N >= ``FLASH_MIN_SEQ`` (the online-softmax kernel above
                 ``flash_attention.ROWFULL_MAX_N`` with maps off),
                 ``attention_reference`` otherwise
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
                 fused MLP is an opt-in); for a W8A8 model (``quant=
                 "w8a8"``) on a CUDA device, in bf16 and in f32, the W8A8
                 MLP kernel where its shape fits (``fused_mlp.fits_w8a8``),
                 else None (``layers.linear`` runs ``quant.linear_w8a8``)
    "fused"      the fused MLP wrapper (its plain version on CPU); raises
                 where the shape does not fit the kernel
    "w8a8"       the W8A8 MLP wrapper (its plain version on CPU); raises
                 where the shape does not fit the kernel
    "reference"  None: the unfused MLP

Train attention policy names (``default_train_attn_impl``), for train
steps (``parallel/train.py``):

    "auto"       on a CUDA device, in bf16 and in f32:
                 ``attention_vjp.trainable_flash_mhsa`` (the forward and
                 backward kernels); None (``attention_reference`` under
                 autograd) otherwise, the CPU included
    "flash_vjp"  always ``trainable_flash_mhsa`` (its plain versions on CPU)
    "reference"  None ("none" too)

Swin trains its windowed attention: "auto" gives None for a Swin config
and "flash_vjp" raises, as in the JAX package.

Unlike the JAX policy, f32 is not excluded on CUDA: that exclusion worked
around HIGHEST-precision dots compiling slowly inside Mosaic, which has no
counterpart here. So "auto" picks the kernels in f32 too, "int8-scores"
takes an f32 model where the JAX policy raises, and "auto" with
``quant="w8a8"`` picks the W8A8 kernel in f32 where the JAX policy returns
None. The decision is made by shape, dtype and device at dispatch time,
never by whether a build or launch succeeds.
"""

from __future__ import annotations

import functools
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
    if name in ("int8-scores", "int8-scores-qk"):
        from interactive_vit_tpu_torch.ops.fused_block import (
            fused_attn_block_s8,
        )

        if d and n and not fits(n, d, heads, int8_scores=True):
            raise ValueError(
                f"{name} fused block does not fit shared memory for n={n}, "
                f"d={d}; the headwise kernel has no s8 mode")
        return functools.partial(fused_attn_block_s8,
                                 int8_pv=(name == "int8-scores"))
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
    ``(x, p, eps) -> y`` or None."""
    if name in ("none", "reference"):
        return None
    from interactive_vit_tpu_torch.ops import fused_mlp as fm

    if name == "fused":
        if d and mlp_dim and not fm.fits(d, mlp_dim):
            raise ValueError(
                f"fused MLP kernel does not take d={d}, mlp_dim={mlp_dim}; "
                f"use mlp_impl='auto'/'reference'")
        return fm.fused_mlp_block
    if name == "w8a8":
        if d and mlp_dim and not fm.fits_w8a8(d, mlp_dim,
                                               dtype or torch.bfloat16):
            raise ValueError(
                f"W8A8 MLP kernel does not take d={d}, mlp_dim={mlp_dim} in "
                f"{dtype}; use mlp_impl='auto' for the unfused W8A8 path")
        return fm.fused_mlp_w8a8_block
    if name == "auto":
        dev: Optional[torch.device] = (torch.device(device)
                                       if device is not None else None)
        if (quant == "w8a8" and dev is not None and dev.type == "cuda"
                and dtype in _DTYPES and fm.fits_w8a8(d, mlp_dim, dtype)):
            return fm.fused_mlp_w8a8_block
        return None
    raise ValueError(f"unknown mlp impl {name!r}")


def default_train_attn_impl(name: str = "auto", dtype=None, cfg=None,
                            device=None, n_devices: int = 1,
                            model_axis: int = 1):
    """Resolve the attention of a train step to a callable (the
    ``attention.mhsa`` contract, with ``.packed`` / ``.packed_ok``) or
    None. ``cfg``: the model config, when known; ``device``: where the
    step runs (a rank's device on a mesh).

    The mesh rule: "auto" gives the kernels by dtype, device and shape
    whatever the number of devices (``n_devices``), except where the
    mesh's model axis is above 1 (``model_axis``): there the weights are
    DTensors, which the kernels do not take, so it gives the plain
    attention, and an explicit "flash_vjp" raises. Where the model axis is
    1 every rank holds whole weights as plain tensors and its step is the
    one-device step on its rows. (The JAX function keeps Pallas off any
    mesh of more than one device because GSPMD cannot partition a Pallas
    call; per-rank code has no such limit.)"""
    if cfg is not None:
        from interactive_vit_tpu_torch.models import swin

        if isinstance(cfg, swin.SwinConfig):
            if name == "flash_vjp":
                raise ValueError(
                    "swin trains shifted-window attention; the flash_vjp "
                    "train kernels do not apply")
            return None
    if name in ("reference", "none"):
        return None
    from interactive_vit_tpu_torch.ops.attention_vjp import (
        trainable_flash_mhsa,
    )

    if name == "flash_vjp":
        if model_axis > 1:
            raise ValueError(
                f"the flash_vjp train kernels take no DTensor: a mesh with "
                f"model={model_axis} trains the plain attention (--attn "
                f"auto or reference)")
        return trainable_flash_mhsa
    if name == "auto":
        dev: Optional[torch.device] = (torch.device(device)
                                       if device is not None else None)
        if (model_axis == 1 and dev is not None and dev.type == "cuda"
                and dtype in _DTYPES):
            return trainable_flash_mhsa
        return None
    raise ValueError(f"unknown train attention impl {name!r}")


def mesh_serving_options(model_axis: int) -> dict:
    """The kernel rule of serving on a mesh (``serving/server.build_app``'s
    ``--mesh``), the train steps' rule above: where the mesh's model axis
    is 1 every rank holds whole plain weights and serves the one-device
    models, the kernels chosen by "auto" ({}: nothing changes); where it is
    above 1 the weights are DTensors, which no kernel takes, so the makers
    get ``kernels=False``, the plain ViTs their head-major qkv layout
    (``tp_layout``) and the attention policy is "reference", as the JAX
    server forces on its mesh."""
    if model_axis == 1:
        return {}
    return {"kernels": False, "tp_layout": True, "attn": "reference"}
