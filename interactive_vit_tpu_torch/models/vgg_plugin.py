"""VGG16 plugin: the reference's 42-node surface as graph node kinds.

Counterpart of ``interactive_vit_tpu/models/vgg_plugin.py``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from interactive_vit_tpu_torch.models import vgg
from interactive_vit_tpu_torch.models.labels import class_names
from interactive_vit_tpu_torch.models.model_plugin import TorchModel
from interactive_vit_tpu_torch.runtime.device import require_device


def make_vgg16_model(params: Optional[Any] = None, seed: int = 0,
                     dtype=torch.float32, device="cuda",
                     with_categories: bool = True) -> TorchModel:
    """Build the registerable VGG16 on ``device`` (the card unless the
    caller asks for the CPU; raises without a card). ``params=None`` draws
    a random init (138 M parameters) from ``torch.Generator`` seeded with
    ``seed``; given params must already be on ``device``. The category
    sink carries ImageNet's class names (the reference's
    ``weights.meta["categories"]``)."""
    device = require_device(device)
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = vgg.init_params(gen, dtype=dtype, device=device)
    descriptions = {"transform": "Resize+CenterCrop(224)+Normalize",
                    "avgpool": "AdaptiveAvgPool2d((7,7))",
                    "flatten": "Flatten"}
    return TorchModel(
        name="vgg16",
        layers=vgg.layer_fns(),
        params=params,
        layer_params_fn=vgg.layer_params,
        descriptions=descriptions,
        category_names=class_names(1000) if with_categories else None,
    )
