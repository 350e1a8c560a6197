"""MoE-ViT plugin: the routed family's tappable node surface.

Counterpart of ``interactive_vit_tpu/models/moe_plugin.py``: registers
``vit_moe_s16:<layer>`` node kinds (the ViT chain); the MoE blocks also
tap "experts", the router's gate probabilities as per-expert heatmaps.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from interactive_vit_tpu_torch.models import moe
from interactive_vit_tpu_torch.models.labels import class_names
from interactive_vit_tpu_torch.models.model_plugin import TorchModel
from interactive_vit_tpu_torch.runtime.device import require_device


def make_moe_model(variant: str = "vit_moe_s16",
                   params: Optional[Any] = None, seed: int = 0,
                   dtype=torch.float32, device="cuda", attn_impl=None,
                   cfg: Optional[moe.MoEViTConfig] = None,
                   with_categories: bool = True) -> TorchModel:
    """Build a registerable MoE ViT on ``device`` (the card unless the
    caller asks for the CPU; raises without a card). ``cfg`` overrides the
    variant table (the tests' narrow ones); ``params=None`` draws a random
    init from ``torch.Generator`` seeded with ``seed``; given params must
    already be on ``device``. ``attn_impl`` (``ops/dispatch.
    default_attn_impl``) is every block's attention: ``flash_mhsa`` runs
    the flash kernel, which has no backward, so with an ``attn_impl`` the
    gradient kinds replay the plain layers (``grad_layers``), as the JAX
    maker's twins."""
    device = require_device(device)
    cfg = cfg or moe.VARIANTS[variant]
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = moe.init_params(cfg, gen, dtype=dtype, device=device)
    cats = (class_names(1000)
            if with_categories and cfg.num_classes == 1000 else None)
    descriptions = {
        "transform": f"Resize+CenterCrop({cfg.img_size})+Normalize",
        "embed": f"patchify {cfg.patch}px + cls + pos "
                 f"[B,{cfg.tokens},{cfg.width}]",
        "norm": "final LayerNorm",
        "head": f"classifier Linear({cfg.width}, {cfg.num_classes})",
        **{
            f"blocks.{i}": (
                f"MoE block d={cfg.width} h={cfg.heads} "
                f"E={cfg.n_experts} top-1 routed MLP (tap 'experts' "
                f"for per-patch assignment)"
                if cfg.is_moe(i) else
                f"dense block d={cfg.width} h={cfg.heads}")
            for i in range(cfg.depth)
        },
    }
    grad_layers = None
    if attn_impl is not None:
        grad_layers = {ln: f for ln, _extra, f in moe.layer_fns(cfg)}
    return TorchModel(
        name=cfg.name,
        layers=moe.layer_fns(cfg, attn_impl=attn_impl),
        params=params,
        layer_params_fn=moe.layer_params,
        descriptions=descriptions,
        category_names=cats,
        grad_layers=grad_layers,
    )
