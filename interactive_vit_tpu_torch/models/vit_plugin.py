"""ViT model plugin: a ViT variant as ``depth + 4`` tappable node kinds.

Counterpart of ``interactive_vit_tpu/models/vit_plugin.py``:

    <name>:transform   eval preprocessing (resize/crop/normalize)
    <name>:embed       patchify + patch-embed matmul + CLS + pos
    <name>:blocks.i    transformer block, extra taps "attn", "r", "cls"
    <name>:norm        final LayerNorm
    <name>:head        classifier on the CLS token

Weight-only and W8A8 quantization, the tensor-parallel qkv layout, the
attention-attribution node and gradient twins are not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.models.labels import class_names
from interactive_vit_tpu_torch.models.model_plugin import TorchModel
from interactive_vit_tpu_torch.ops.dispatch import default_block_impl
from interactive_vit_tpu_torch.runtime.device import require_device


def make_vit_model(
    variant: str = "vit_t16",
    params: Optional[Any] = None,
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
    block_kernel: str = "auto",
    attn_impl=None,
) -> TorchModel:
    """Build a registerable ``TorchModel`` for a ViT variant on ``device``
    (the card unless the caller asks for the CPU; raises without a card).

    ``params=None`` -> random init from ``torch.Generator`` seeded with
    ``seed``; given params (e.g. ``models/weights.from_jax``) must already
    be on ``device`` in ``dtype``. ``block_kernel`` is an
    ``ops/dispatch.default_block_impl`` policy name ("auto", "fused",
    "headwise", "reference"): under "auto" a CUDA model runs the
    whole-image block kernel when its shape fits, else the headwise one.
    ``attn_impl`` (``ops/dispatch.default_attn_impl``) is the attention of
    blocks that run the unfused path -- LayerScale (DINOv2) blocks always
    do."""
    device = require_device(device)
    cfg = vit.resolve_variant(variant)
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = vit.init_params(cfg, gen, dtype=dtype, device=device)
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
                             block_impl=block_impl),
        params=params,
        layer_params_fn=vit.layer_params,
        descriptions=descriptions,
        category_names=cats,
    )
