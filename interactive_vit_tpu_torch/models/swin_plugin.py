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

With the window kernel, the W8A8 MLP kernel or int8 weights each layer has
a plain PyTorch twin for gradient replays (``grad_layers``; int8 leaves
dequantized inline).
"""

from __future__ import annotations

import html
from typing import Any, Optional

import torch

from interactive_vit_tpu_torch.models import swin
from interactive_vit_tpu_torch.models.labels import class_names
from interactive_vit_tpu_torch.models.model_plugin import (
    LayerNodeKind, TorchModel, dequant_grad_twin,
)
from interactive_vit_tpu_torch.ops.dispatch import (
    default_mlp_impl, default_window_impl,
)
from interactive_vit_tpu_torch.ops.quant import quantize_mode, quantize_tree
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
    forces the unfused window path.

    ``quantize`` (the JAX maker's contract): ``True`` / ``"w8"`` stores
    every block linear (qkv, proj, fc1, fc2) as weight-only int8 and turns
    the window kernel off (it takes dense qkv); ``"w8a8"`` stores fc1 and
    fc2 only, as W8A8: the window kernel stays on, and each stage's MLP
    runs ``default_mlp_impl("auto", quant="w8a8")`` -- on a card the W8A8
    kernel where the stage fits it (every stage of swin_t / s / b in bf16),
    None elsewhere (``mlp_impls`` None where no stage fits), the unfused
    ``quant.linear_w8a8`` then. The two paths round the activations
    differently, each as its JAX twin: the kernel and its plain version
    half up (the Pallas kernel's ``floor(x + 0.5)``), the unfused path (the
    CPU's: "auto" gives no kernel there) half to even (``jnp.round``, as
    JAX's unfused path off the TPU). ``"w8a8"`` with ``kernels=False``
    raises, as in JAX."""
    mode = quantize_mode(quantize)
    if mode == "w8a8" and not kernels:
        # as the JAX maker: without the MLP kernel the quantized fc1 / fc2
        # would pay the accuracy cost on the slower unfused chain
        raise ValueError(
            "swin w8a8 needs the Pallas MLP kernel (kernels=True); "
            "mesh-sharded serving should use bfloat16 or int8 weight-only")
    device = require_device(device)
    cfg = cfg or swin.VARIANTS[variant]
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = swin.init_params(cfg, gen, dtype=dtype, device=device)
    mlp_impls = None
    if mode == "w8a8":
        params = quantize_tree(params, names=frozenset({"fc1_w", "fc2_w"}),
                               mode=mode)
        mlp_impls = [default_mlp_impl(
            "auto", dtype=dtype, d=cfg.stage_dim(s),
            mlp_dim=cfg.stage_dim(s) * cfg.mlp_ratio, quant="w8a8",
            device=device) for s in range(len(cfg.depths))]
        if not any(mlp_impls):
            mlp_impls = None
    elif mode == "w8":
        params = quantize_tree(params, mode=mode)
        kernels = False  # quantized qkv dicts cannot feed the window kernel
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
    # the kernels have no backward and int8 activations round (zero
    # gradient almost everywhere): gradient replays run the plain path's
    # layers, int8 weights dequantized inline
    grad_layers = None
    if window_impl is not None or mlp_impls is not None or mode:
        grad_layers = {ln: (dequant_grad_twin(f) if mode else f)
                       for ln, _extra, f in swin.layer_fns(cfg)}
    return SwinTorchModel(
        name=cfg.name,
        layers=swin.layer_fns(cfg, window_impl=window_impl,
                              mlp_impls=mlp_impls),
        params=params,
        layer_params_fn=swin.layer_params,
        descriptions=descriptions,
        category_names=cats,
        grad_layers=grad_layers,
    )
