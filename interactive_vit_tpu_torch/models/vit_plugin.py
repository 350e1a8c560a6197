"""ViT model plugin: a ViT variant as ``depth + 4`` tappable node kinds.

Counterpart of ``interactive_vit_tpu/models/vit_plugin.py``:

    <name>:transform   eval preprocessing (resize/crop/normalize)
    <name>:embed       patchify + patch-embed matmul + CLS + pos
    <name>:blocks.i    transformer block, extra taps "attn", "r", "cls"
    <name>:norm        final LayerNorm
    <name>:head        classifier on the CLS token

``make_vit_model`` takes the ``@<pixels>p<patch>`` geometries (a native
checkpoint adapts on load) and the int8 serving modes: weight-only
(``quantize="w8"``, the unfused path) and W8A8 (``quantize="w8a8"``: fc1
and fc2 int8, the W8A8 MLP kernel beside the dense or s8 block kernel).
The tensor-parallel qkv layout, the attention-attribution node and the
gradient twins are not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.models.labels import class_names
from interactive_vit_tpu_torch.models.model_plugin import TorchModel
from interactive_vit_tpu_torch.ops.dispatch import (
    default_block_impl, default_mlp_impl,
)
from interactive_vit_tpu_torch.ops.quant import quantize_tree
from interactive_vit_tpu_torch.runtime.device import require_device


def make_vit_model(
    variant: str = "vit_t16",
    params: Optional[Any] = None,
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
    block_kernel: str = "auto",
    attn_impl=None,
    quantize=False,
) -> TorchModel:
    """Build a registerable ``TorchModel`` for a ViT variant on ``device``
    (the card unless the caller asks for the CPU; raises without a card).

    ``variant`` may carry a ``@[<pixels>][p<patch>]`` suffix
    (``vit.resolve_variant``). ``params=None`` -> random init from
    ``torch.Generator`` seeded with ``seed`` at the derived geometry; given
    params (e.g. ``models/weights.from_jax``) must already be on ``device``
    in ``dtype`` and are adapted from their own geometry
    (``vit.adapt_checkpoint``). ``block_kernel`` is an
    ``ops/dispatch.default_block_impl`` policy name ("auto", "fused",
    "headwise", "int8-scores", "int8-scores-qk", "reference"): under "auto"
    a CUDA model runs the whole-image block kernel when its shape fits,
    else the headwise one. ``attn_impl`` (``ops/dispatch.default_attn_impl``)
    is the attention of blocks that run the unfused path -- LayerScale
    (DINOv2) blocks always do.

    ``quantize`` (as the JAX maker's): ``True`` / ``"w8"`` stores qkv,
    proj, fc1 and fc2 as weight-only int8 and runs the unfused path;
    ``"w8a8"`` stores fc1 and fc2 only, as W8A8, so the block kernel
    (dense, or s8 with ``block_kernel="int8-scores"``) keeps dense
    attention weights and the MLP runs ``default_mlp_impl("auto",
    quant="w8a8")``: the W8A8 kernel on a CUDA device where it fits.
    LayerScale configs refuse "w8a8" (their blocks cannot take the fused
    MLP kernel)."""
    mode = (quantize if isinstance(quantize, str) else "w8") \
        if quantize else ""
    if mode not in ("", "w8", "w8a8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if block_kernel not in ("auto", "none", "reference") and mode == "w8":
        # w8a8 is exempt: it quantizes fc1/fc2 only, the attention block
        # stays dense, so the block kernels compose with it
        raise ValueError(
            f"block_kernel={block_kernel!r} requires dense attention "
            f"weights (weight-only int8 runs the unfused path)")
    device = require_device(device)
    cfg = vit.resolve_variant(variant)
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = vit.init_params(cfg, gen, dtype=dtype, device=device)
    else:
        params = vit.adapt_checkpoint(params, cfg)
    if cfg.layer_scale and mode == "w8a8":
        raise ValueError("w8a8 needs the fused MLP kernel, which "
                         "LayerScale (DINOv2) configs disable")
    mlp_impl = None
    if mode == "w8":
        params = quantize_tree(params, mode=mode)
        block_impl = None
    else:
        if mode == "w8a8":
            params = quantize_tree(
                params, names=frozenset({"fc1_w", "fc2_w"}), mode=mode)
            mlp_impl = default_mlp_impl(
                "auto", dtype=dtype, d=cfg.width, mlp_dim=cfg.mlp_dim,
                quant="w8a8", device=device)
        block_impl = default_block_impl(
            block_kernel, dtype=dtype, n=cfg.tokens, d=cfg.width,
            heads=cfg.heads, device=device)
    if cfg.layer_scale:
        # the fused kernel bakes in the plain residual add; LayerScale
        # (DINOv2) blocks run the unfused path
        block_impl = None
    descriptions = {
        "transform": f"Resize+CenterCrop({cfg.img_size})+Normalize",
        "embed": f"PatchEmbed p={cfg.patch} d={cfg.width} + CLS + pos",
        "norm": "LayerNorm",
        "head": (f"Linear({cfg.width} -> {cfg.num_classes})"
                 if cfg.num_classes else
                 f"CLS features [{cfg.width}] (self-supervised: "
                 f"no classifier)"),
        **{f"blocks.{i}": f"TransformerBlock d={cfg.width} h={cfg.heads}"
           for i in range(cfg.depth)},
    }
    cats = class_names(cfg.num_classes) if cfg.num_classes else None
    return TorchModel(
        name=variant,
        layers=vit.layer_fns(cfg, attn_impl=attn_impl,
                             block_impl=block_impl, mlp_impl=mlp_impl),
        params=params,
        layer_params_fn=vit.layer_params,
        descriptions=descriptions,
        category_names=cats,
    )
