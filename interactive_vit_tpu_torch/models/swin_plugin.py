"""Swin model plugin: the hierarchical windowed-attention node surface.

Counterpart of ``interactive_vit_tpu/models/swin_plugin.py``. 20 nodes for
swin_t:

    <name>:transform     eval preprocessing (bicubic resize 232, crop 224)
    <name>:patch_embed   patchify matmul + LayerNorm -> NHWC map
    <name>:stages.s.b    Swin block, extra tap "attn" = window maps
                         [B, nW, heads, T, T]; node params ``attn_heads``
                         (a JSON head list) and ``attn_win`` (one window
                         index, collapsing the tap to [B, heads, T, T])
    <name>:merge.s       patch merging between stages
    <name>:norm / :pool / :head

With the window kernel each layer has a plain PyTorch twin for gradient
replays (``grad_layers``). Quantization is not ported yet.
"""

from __future__ import annotations

import html
from typing import Any, Optional

import torch

from interactive_vit_tpu_torch.models import swin
from interactive_vit_tpu_torch.models.labels import class_names
from interactive_vit_tpu_torch.models.model_plugin import (
    LayerNodeKind, TorchModel,
)
from interactive_vit_tpu_torch.ops.dispatch import default_window_impl
from interactive_vit_tpu_torch.runtime.device import require_device


class _SwinBlockKind(LayerNodeKind):
    """Swin block node: the shared attn_heads control plus a window
    selector (attn_win collapses the [B, nW, h, T, T] tap to [B, h, T, T],
    the rank the client's head-grid renderer draws)."""

    def contents(self, params):
        cur = params.get("attn_win", "")
        return super().contents(params) + (
            f" <label>tap window <input data-param=\"attn_win\" "
            f"type=\"text\" size=\"4\" value=\"{html.escape(cur)}\" "
            f"placeholder=\"all\"></label>")


class SwinTorchModel(TorchModel):
    def _kind_cls(self, layer_name: str) -> type:
        return (_SwinBlockKind if layer_name.startswith("stages.")
                else LayerNodeKind)


def make_swin_model(
    variant: str = "swin_t",
    params: Optional[Any] = None,
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
    cfg: Optional[swin.SwinConfig] = None,
    with_categories: bool = True,
    kernels: bool = True,
    quantize=False,
) -> TorchModel:
    """Build a registerable ``TorchModel`` for a Swin variant on ``device``
    (the card unless the caller asks for the CPU; raises without a card).

    ``cfg`` overrides the variant table (tests use tiny geometries);
    ``params=None`` -> random init from ``torch.Generator`` seeded with
    ``seed``; given params (e.g. ``models/weights.from_jax``) must already
    be on ``device`` in ``dtype``. With ``kernels`` a CUDA model runs the
    fused window kernel in every block when every stage fits it
    (``ops/dispatch.default_window_impl("auto")``); ``kernels=False``
    forces the unfused window path. ``quantize`` is not ported."""
    if quantize:
        raise NotImplementedError(
            "quantized Swin serving (weight-only int8 and the W8A8 MLP "
            "kernel) is not ported to the torch package yet")
    device = require_device(device)
    cfg = cfg or swin.VARIANTS[variant]
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = swin.init_params(cfg, gen, dtype=dtype, device=device)
    window_impl = (default_window_impl("auto", dtype=dtype, cfg=cfg,
                                       device=device) if kernels else None)
    descriptions = {
        "transform": (f"Resize({int(cfg.img_size * 232 / 224)}, bicubic)"
                      f"+CenterCrop({cfg.img_size})+Normalize"),
        "patch_embed": (f"PatchEmbed p={cfg.patch} d={cfg.embed_dim} "
                        f"+ LayerNorm"),
        "norm": "LayerNorm",
        "pool": "global average pool",
        "head": (f"Linear({cfg.stage_dim(len(cfg.depths) - 1)} "
                 f"-> {cfg.num_classes})"),
    }
    for s, depth in enumerate(cfg.depths):
        res = cfg.stage_res(s)
        for b in range(depth):
            shift = cfg.stage_shift(s, b)
            descriptions[f"stages.{s}.{b}"] = (
                f"SwinBlock {res}x{res} d={cfg.stage_dim(s)} "
                f"h={cfg.heads[s]} win={cfg.window}"
                + (f" shift={shift}" if shift else ""))
        if s + 1 < len(cfg.depths):
            descriptions[f"merge.{s}"] = (
                f"PatchMerging {res}x{res} -> {res // 2}x{res // 2}, "
                f"{cfg.stage_dim(s)} -> {cfg.stage_dim(s + 1)}")
    cats = (class_names(cfg.num_classes)
            if with_categories and cfg.num_classes else None)
    # the window kernel has no backward: gradient replays run the plain
    # path's layers
    grad_layers = ({ln: f for ln, _extra, f in swin.layer_fns(cfg)}
                   if window_impl is not None else None)
    return SwinTorchModel(
        name=cfg.name,
        layers=swin.layer_fns(cfg, window_impl=window_impl),
        params=params,
        layer_params_fn=swin.layer_params,
        descriptions=descriptions,
        category_names=cats,
        grad_layers=grad_layers,
    )
