"""ConvNeXt plugin: the tappable stage / block surface as graph node kinds.

Counterpart of ``interactive_vit_tpu/models/convnext_plugin.py``: 25 nodes
for convnext_t (transform, stem, stages.{s}.{b}, downsample.{1..3},
avgpool, head) and the category sink in the generated graph. Every layer
is plain PyTorch (cuDNN convolutions, no kernel of this package), so the
gradient replays (saliency, dream, Grad-CAM) differentiate the serving
fns themselves: no gradient twins.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from interactive_vit_tpu_torch.models import convnext
from interactive_vit_tpu_torch.models.labels import class_names
from interactive_vit_tpu_torch.models.model_plugin import TorchModel
from interactive_vit_tpu_torch.runtime.device import require_device


def make_convnext_model(variant: str = "convnext_t",
                        params: Optional[Any] = None, seed: int = 0,
                        dtype=torch.float32, device="cuda",
                        cfg: Optional[convnext.ConvNeXtConfig] = None,
                        with_categories: bool = True) -> TorchModel:
    """Build a registerable ConvNeXt on ``device`` (the card unless the
    caller asks for the CPU; raises without a card). ``cfg`` overrides the
    variant table (the tests' narrow geometries); ``params=None`` draws a
    random init from ``torch.Generator`` seeded with ``seed``; given
    params must already be on ``device``."""
    device = require_device(device)
    cfg = cfg or convnext.VARIANTS[variant]
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = convnext.init_params(cfg, gen, dtype=dtype, device=device)
    cats = (class_names(cfg.num_classes)
            if with_categories and cfg.num_classes == 1000 else None)
    descriptions = {
        "transform": (f"Resize({cfg.resize_to})+CenterCrop({cfg.img_size})"
                      f"+Normalize"),
        "stem": f"4x4/4 patchify conv + LN ({cfg.dims[0]} ch)",
        "avgpool": "global average pool",
        "head": f"LN + Linear({cfg.dims[-1]}, {cfg.num_classes})",
    }
    for s, depth in enumerate(cfg.depths):
        for b in range(depth):
            descriptions[f"stages.{s}.{b}"] = (
                f"CNBlock dw7x7 + MLP ({cfg.dims[s]} ch, "
                f"{cfg.stage_res(s)}x{cfg.stage_res(s)})")
        if s + 1 < len(cfg.depths):
            descriptions[f"downsample.{s + 1}"] = (
                f"LN + 2x2/2 conv ({cfg.dims[s]} -> {cfg.dims[s + 1]} ch)")
    return TorchModel(
        name=cfg.name,
        layers=convnext.layer_fns(cfg),
        params=params,
        layer_params_fn=convnext.layer_params,
        descriptions=descriptions,
        category_names=cats,
    )
