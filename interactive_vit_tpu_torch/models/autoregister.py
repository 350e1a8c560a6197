"""The one variant -> model-maker dispatch.

Counterpart of ``interactive_vit_tpu/models/autoregister.py``, every
family of the JAX package: the plain ViTs (``vit_*``, ``dino_*``,
``deit_*``, ``dinov2_*``, each also at an ``@<pixels>p<patch>``
geometry), Swin (``swin_*``), ToMe (``*_tome*``), the CLIP towers
(``clip_b32``, ``clip_text_b32``), VGG16 (``vgg16``), ResNet-50
(``resnet50``), ConvNeXt (``convnext_*``), the MoE ViT (``vit_moe_*``) and
MAE (``mae_*``, also at an ``@`` geometry of its encoder).
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

import torch

logger = logging.getLogger(__name__)

# The families of one variant each
_SINGLE = frozenset({"clip_b32", "clip_text_b32", "vgg16", "resnet50"})
# The prefixes of the other families that are not plain ViTs
_PREFIXES = ("swin_", "convnext_", "vit_moe", "mae_")


def plain_vit_family(variant: str) -> bool:
    """True when ``variant`` (its ``@`` suffix aside) names the plain-ViT
    family, the only one with the block kernels' policies
    (``block_kernel``): not Swin, ToMe, CLIP, VGG16, ResNet-50, ConvNeXt,
    MoE or MAE. The JAX package's
    ``_family_maker(variant.partition("@")[0]) is None``."""
    base = variant.partition("@")[0]
    return not (base.startswith(_PREFIXES) or "_tome" in base
                or base in _SINGLE)


def known_variants() -> List[str]:
    """Every variant name ``make_model`` accepts (sorted)."""
    from interactive_vit_tpu_torch.models import (
        convnext, mae, moe, swin, tome, vit,
    )

    return sorted(set(vit.VARIANTS) | set(moe.VARIANTS) | set(tome.VARIANTS)
                  | set(swin.VARIANTS) | set(convnext.VARIANTS)
                  | set(mae.VARIANTS) | set(_SINGLE))


def _check_family_options(variant: str, block_kernel: str) -> None:
    """The refusals of a non-plain-ViT family, as in the JAX package: no
    ``@`` suffix (MAE's resolves through its encoder's grammar), no
    ``block_kernel`` other than "auto", a known name."""
    base = variant.partition("@")[0]
    if "@" in variant and not base.startswith("mae_"):
        raise ValueError(
            f"{variant!r}: the @<pixels>p<patch> suffix is for the "
            f"plain-ViT family; this family's geometry is "
            f"resolution-specific")
    if base not in known_variants():
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
    kernels: bool = True,
    tp_layout: bool = False,
):
    """Build the registerable ``TorchModel`` for ``variant`` on ``device``
    (the card unless the caller asks for the CPU). ``attn_impl`` is the
    attention of blocks on the unfused path: the plain ViTs', CLIP's and
    every MoE block's. ``quantize`` and ``block_kernel`` go to
    ``make_vit_model`` for the plain-ViT family (``@<pixels>p<patch>``
    geometries included). The other families refuse the ``@`` suffix
    (MAE's names its encoder's geometry) and a ``block_kernel`` other than
    "auto", as in the JAX package; ``quantize`` goes to ``make_swin_model``
    for Swin (both int8 modes), and every other family, as in JAX, logs a
    warning for it and serves the float ``dtype``. ``kernels`` goes to every
    family maker that has it (the plain ViTs, Swin, ToMe and CLIP's image
    tower; the others launch no kernel of the port) and ``tp_layout`` to
    the plain ViTs' (``make_vit_model``), as in JAX."""
    if plain_vit_family(variant):
        from interactive_vit_tpu_torch.models.vit_plugin import (
            make_vit_model,
        )

        return make_vit_model(variant, params=params, seed=seed,
                              dtype=dtype, device=device,
                              attn_impl=attn_impl, quantize=quantize,
                              block_kernel=block_kernel, kernels=kernels,
                              tp_layout=tp_layout)
    _check_family_options(variant, block_kernel)
    kw = dict(params=params, seed=seed, dtype=dtype, device=device)
    if variant.startswith("swin_"):
        from interactive_vit_tpu_torch.models.swin_plugin import (
            make_swin_model,
        )

        return make_swin_model(variant, quantize=quantize, kernels=kernels,
                               **kw)
    if quantize:
        logger.warning("int8 not wired for %s; serving %s", variant, dtype)
    if "_tome" in variant:
        from interactive_vit_tpu_torch.models.tome_plugin import (
            make_tome_model,
        )

        return make_tome_model(variant, kernels=kernels, **kw)
    if variant == "clip_b32":
        from interactive_vit_tpu_torch.models.clip_plugin import (
            make_clip_model,
        )

        return make_clip_model(attn_impl=attn_impl, kernels=kernels, **kw)
    if variant == "clip_text_b32":
        from interactive_vit_tpu_torch.models.clip_text_plugin import (
            make_clip_text_model,
        )

        return make_clip_text_model(**kw)
    if variant == "vgg16":
        from interactive_vit_tpu_torch.models.vgg_plugin import (
            make_vgg16_model,
        )

        return make_vgg16_model(**kw)
    if variant == "resnet50":
        from interactive_vit_tpu_torch.models.resnet_plugin import (
            make_resnet50_model,
        )

        return make_resnet50_model(**kw)
    if variant.startswith("convnext_"):
        from interactive_vit_tpu_torch.models.convnext_plugin import (
            make_convnext_model,
        )

        return make_convnext_model(variant, **kw)
    if variant.startswith("vit_moe"):
        from interactive_vit_tpu_torch.models.moe_plugin import (
            make_moe_model,
        )

        return make_moe_model(variant, attn_impl=attn_impl, **kw)
    from interactive_vit_tpu_torch.models.mae_plugin import make_mae_model

    return make_mae_model(variant, **kw)
