"""The one variant -> model-maker dispatch.

Counterpart of ``interactive_vit_tpu/models/autoregister.py`` for the
families this package has: the plain ViTs (``vit_*``, ``dino_*``,
``deit_*``, ``dinov2_*``, each also at an ``@<pixels>p<patch>`` geometry),
Swin (``swin_*``), ToMe (``*_tome*``), the CLIP towers (``clip_b32``,
``clip_text_b32``) and VGG16 (``vgg16``). A variant of a family that is not
ported yet raises with the family's name.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

import torch

logger = logging.getLogger(__name__)

# Families the JAX package serves that this package does not yet: prefix
# (or whole name) -> what it is.
_UNPORTED = {
    "resnet50": "ResNet-50", "convnext_": "ConvNeXt", "vit_moe": "ViT-MoE",
    "mae_": "MAE",
}
# The families of one variant each
_SINGLE = frozenset({"clip_b32", "clip_text_b32", "vgg16"})


def _unported_family(variant: str) -> Optional[str]:
    return next((family for prefix, family in _UNPORTED.items()
                 if variant.startswith(prefix)), None)


def plain_vit_family(variant: str) -> bool:
    """True when ``variant`` (its ``@`` suffix aside) names the plain-ViT
    family, the only one with the block kernels' policies
    (``block_kernel``): not Swin, not ToMe, not CLIP or VGG16, not a
    family that is not ported. The JAX package's
    ``_family_maker(variant.partition("@")[0]) is None``."""
    base = variant.partition("@")[0]
    return not (base.startswith("swin_") or "_tome" in base
                or base in _SINGLE or _unported_family(base) is not None)


def known_variants() -> List[str]:
    """Every variant name ``make_model`` accepts (sorted)."""
    from interactive_vit_tpu_torch.models import swin, tome, vit

    return sorted(set(vit.VARIANTS) | set(swin.VARIANTS) | set(tome.VARIANTS)
                  | set(_SINGLE))


def _check_family_options(variant: str, block_kernel: str) -> None:
    """The refusals of a non-plain-ViT family, as in the JAX package: no
    ``@`` suffix, no ``block_kernel`` other than "auto", a known name."""
    if "@" in variant:
        raise ValueError(
            f"{variant!r}: the @<pixels>p<patch> suffix is for the "
            f"plain-ViT family; this family's geometry is "
            f"resolution-specific")
    if variant not in known_variants():
        raise ValueError(f"unknown model variant {variant!r}; known: "
                         f"{known_variants()}")
    if block_kernel != "auto":
        raise ValueError(
            f"block_kernel={block_kernel!r} applies to the plain-ViT "
            f"family only (the fused block kernel); {variant} has no "
            f"s8-scores variant")


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
    (``@<pixels>p<patch>`` geometries included). Swin and ToMe refuse the
    ``@`` suffix and a ``block_kernel`` other than "auto", as in the JAX
    package; Swin's quantized modes are not ported (``make_swin_model``
    raises) and ToMe, CLIP and VGG16, as in JAX, log a warning for
    ``quantize`` and serve the float ``dtype``. The CLIP image tower takes
    ``attn_impl`` for its unfused path."""
    if variant.startswith("swin_"):
        from interactive_vit_tpu_torch.models.swin_plugin import (
            make_swin_model,
        )

        _check_family_options(variant, block_kernel)
        return make_swin_model(variant, params=params, seed=seed,
                               dtype=dtype, device=device, quantize=quantize)
    if "_tome" in variant:
        from interactive_vit_tpu_torch.models.tome_plugin import (
            make_tome_model,
        )

        _check_family_options(variant, block_kernel)
        if quantize:
            logger.warning("int8 not wired for %s; serving %s", variant,
                           dtype)
        return make_tome_model(variant, params=params, seed=seed,
                               dtype=dtype, device=device)
    if variant.partition("@")[0] in _SINGLE:
        _check_family_options(variant, block_kernel)
        if quantize:
            logger.warning("int8 not wired for %s; serving %s", variant,
                           dtype)
        kw = dict(params=params, seed=seed, dtype=dtype, device=device)
        if variant == "clip_b32":
            from interactive_vit_tpu_torch.models.clip_plugin import (
                make_clip_model,
            )

            return make_clip_model(attn_impl=attn_impl, **kw)
        if variant == "clip_text_b32":
            from interactive_vit_tpu_torch.models.clip_text_plugin import (
                make_clip_text_model,
            )

            return make_clip_text_model(**kw)
        from interactive_vit_tpu_torch.models.vgg_plugin import (
            make_vgg16_model,
        )

        return make_vgg16_model(**kw)
    family = _unported_family(variant.partition("@")[0])
    if family is not None:
        raise NotImplementedError(
            f"{variant!r}: the {family} family is not ported to the torch "
            f"package yet; known: {known_variants()}")
    from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model

    return make_vit_model(variant, params=params, seed=seed, dtype=dtype,
                          device=device, attn_impl=attn_impl,
                          quantize=quantize, block_kernel=block_kernel)
