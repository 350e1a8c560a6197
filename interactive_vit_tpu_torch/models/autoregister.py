"""The one variant -> model-maker dispatch.

Counterpart of ``interactive_vit_tpu/models/autoregister.py`` for the
families this package has: the plain ViTs (``vit_*``, ``dino_*``,
``deit_*``, ``dinov2_*``, each also at an ``@<pixels>p<patch>`` geometry)
and Swin (``swin_*``). A variant of a family that is not ported yet raises
with the family's name.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

# Families the JAX package serves that this package does not yet: prefix
# (or whole name) -> what it is.
_UNPORTED = {
    "clip_": "CLIP", "vgg16": "VGG-16", "resnet50": "ResNet-50",
    "convnext_": "ConvNeXt", "vit_moe": "ViT-MoE", "mae_": "MAE",
}


def _unported_family(variant: str) -> Optional[str]:
    if "_tome" in variant:
        return "ToMe"
    return next((family for prefix, family in _UNPORTED.items()
                 if variant.startswith(prefix)), None)


def known_variants() -> List[str]:
    """Every variant name ``make_model`` accepts (sorted)."""
    from interactive_vit_tpu_torch.models import swin, vit

    return sorted(set(vit.VARIANTS) | set(swin.VARIANTS))


def make_model(
    variant: str,
    params: Optional[Any] = None,
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
    attn_impl=None,
    quantize=False,
    block_kernel: str = "auto",
):
    """Build the registerable ``TorchModel`` for ``variant`` on ``device``
    (the card unless the caller asks for the CPU). ``attn_impl`` is the
    attention of plain-ViT blocks on the unfused path; ``quantize`` and
    ``block_kernel`` go to ``make_vit_model`` for the plain-ViT family
    (``@<pixels>p<patch>`` geometries included). Swin refuses the ``@``
    suffix and a ``block_kernel`` other than "auto", as in the JAX package,
    and its quantized modes are not ported (``make_swin_model`` raises)."""
    if variant.startswith("swin_"):
        from interactive_vit_tpu_torch.models.swin_plugin import (
            make_swin_model,
        )

        if "@" in variant:
            raise ValueError(
                f"{variant!r}: the @<pixels>p<patch> suffix is for the "
                f"plain-ViT family; swin's stage geometry is "
                f"resolution-specific")
        if variant not in known_variants():
            raise ValueError(f"unknown model variant {variant!r}; known: "
                             f"{known_variants()}")
        if block_kernel != "auto":
            raise ValueError(
                f"block_kernel={block_kernel!r} applies to the plain-ViT "
                f"family only (the fused block kernel); {variant} has no "
                f"s8-scores variant")
        return make_swin_model(variant, params=params, seed=seed,
                               dtype=dtype, device=device, quantize=quantize)
    family = _unported_family(variant.partition("@")[0])
    if family is not None:
        raise NotImplementedError(
            f"{variant!r}: the {family} family is not ported to the torch "
            f"package yet; known: {known_variants()}")
    from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model

    return make_vit_model(variant, params=params, seed=seed, dtype=dtype,
                          device=device, attn_impl=attn_impl,
                          quantize=quantize, block_kernel=block_kernel)
