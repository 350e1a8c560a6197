"""ResNet-50 plugin: the 21-node tappable surface as graph node kinds.

Counterpart of ``interactive_vit_tpu/models/resnet_plugin.py``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from interactive_vit_tpu_torch.models import resnet
from interactive_vit_tpu_torch.models.labels import class_names
from interactive_vit_tpu_torch.models.model_plugin import TorchModel
from interactive_vit_tpu_torch.runtime.device import require_device


def make_resnet50_model(params: Optional[Any] = None, seed: int = 0,
                        dtype=torch.float32, device="cuda",
                        with_categories: bool = True) -> TorchModel:
    """Build the registerable ResNet-50 on ``device`` (the card unless the
    caller asks for the CPU; raises without a card). ``params=None`` draws
    a random init from ``torch.Generator`` seeded with ``seed``; given
    params must already be on ``device``. No layer launches a kernel, so
    no layer needs a gradient twin."""
    device = require_device(device)
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = resnet.init_params(gen, dtype=dtype, device=device)
    descriptions = {
        "transform": "Resize(256)+CenterCrop(224)+Normalize",
        "conv1": "7x7/2 conv + BN + ReLU",
        "maxpool": "3x3/2 max pool",
        "avgpool": "global average pool",
        "fc": "classifier Linear(2048, 1000)",
    }
    for si, (blocks, width) in enumerate(resnet.STAGES):
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            descriptions[f"layer{si + 1}.{bi}"] = (
                f"bottleneck {width}->{width * resnet.EXPANSION}"
                + (f", stride {stride}" if stride != 1 else ""))
    return TorchModel(
        name="resnet50",
        layers=resnet.layer_fns(),
        params=params,
        layer_params_fn=resnet.layer_params,
        descriptions=descriptions,
        category_names=class_names(1000) if with_categories else None,
    )
