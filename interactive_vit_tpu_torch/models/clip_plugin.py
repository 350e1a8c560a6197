"""CLIP ViT-B/32 image-encoder plugin (the embedding-extraction node path).

Counterpart of ``interactive_vit_tpu/models/clip_plugin.py``: registers
``clip_b32:transform``, ``:embed``, ``:blocks.0-11`` (tap "attn") and
``:embedding`` (the L2-normalised [B, 512] vector; no category sink).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from interactive_vit_tpu_torch.models import clip
from interactive_vit_tpu_torch.models.model_plugin import TorchModel
from interactive_vit_tpu_torch.ops.dispatch import default_block_impl
from interactive_vit_tpu_torch.runtime.device import require_device


def make_clip_model(params: Optional[Any] = None, seed: int = 0,
                    dtype=torch.float32, device="cuda", attn_impl=None,
                    cfg: Optional[clip.CLIPVisionConfig] = None,
                    kernels: bool = True) -> TorchModel:
    """Build the registerable CLIP image tower on ``device`` (the card
    unless the caller asks for the CPU; raises without a card).
    ``params=None`` draws a random init from ``torch.Generator`` seeded
    with ``seed``; given params must already be on ``device``. The block
    kernel is ``default_block_impl("auto")`` at the tower's shape: on a
    CUDA device ``fused_attn_block`` in every block (at ViT-B/32 N=50,
    768 wide, 12 heads: the bf16 tensor cores or split TF32 in f32), on
    the CPU the unfused path (``attn_impl`` its attention). Where a kernel
    or ``attn_impl`` is in the chain, every layer has its plain twin for
    gradient replays (``grad_layers``). ``kernels=False`` keeps the block
    kernel out (a mesh whose model axis is above 1: DTensor weights), as
    the JAX maker's flag does."""
    device = require_device(device)
    cfg = cfg or clip.CLIPVisionConfig()
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = clip.init_params(cfg, gen, dtype=dtype, device=device)
    block_impl = default_block_impl(
        "auto", dtype=params["proj"].dtype, n=cfg.tokens, d=cfg.width,
        heads=cfg.heads, device=device) if kernels else None
    descriptions = {
        "transform": f"Resize+CenterCrop({cfg.img_size})+CLIP-Normalize",
        "embed": f"PatchEmbed p={cfg.patch} + CLS + pos + ln_pre",
        "embedding": f"ln_post + proj -> L2-normed [{cfg.embed_dim}]",
        **{f"blocks.{i}": f"CLIPBlock d={cfg.width} h={cfg.heads} "
                          f"(QuickGELU)" for i in range(cfg.depth)},
    }
    # a kernel has no backward: gradient replays run the plain layers
    grad_layers = None
    if block_impl is not None or attn_impl is not None:
        grad_layers = {ln: f for ln, _extra, f in clip.layer_fns(cfg)}
    return TorchModel(
        name=cfg.name,
        layers=clip.layer_fns(cfg, attn_impl=attn_impl,
                              block_impl=block_impl),
        params=params,
        layer_params_fn=clip.layer_params,
        descriptions=descriptions,
        category_names=None,  # the embedding path has no category sink
        grad_layers=grad_layers,
    )
