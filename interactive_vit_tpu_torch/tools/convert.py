"""Checkpoint conversion: torch state dicts -> the port's checkpoint
directories.

Counterpart of ``interactive_vit_tpu/tools/convert.py`` for the families
this package serves:

    python -m interactive_vit_tpu_torch.tools.convert \
        --model vit_b16 --layout torchvision \
        --input vit_b_16.pth --output ckpts/vit_b16

writes a directory of ``utils/checkpoint.py`` (not an orbax one), which the
server's and ``run_graph``'s ``--ckpt MODEL=DIR`` serve. ``convert`` is
also what those flags run on a ``.safetensors`` or ``.pth`` file, for every
family: torchvision's naming for VGG16, ResNet-50, Swin and ConvNeXt,
OpenAI's for the CLIP towers, torchvision's or timm's for the ViTs, and the
native "/" naming (the JAX package's export) for any model, MAE's and the
MoE ViT's included.
"""

from __future__ import annotations

import argparse

import torch

VALID_LAYOUTS = {
    "vgg16": {"torchvision", "native"},
    "resnet50": {"torchvision", "native"},
    "swin_t": {"torchvision", "native"},
    "swin_s": {"torchvision", "native"},
    "swin_b": {"torchvision", "native"},
    "convnext_t": {"torchvision", "native"},
    "convnext_s": {"torchvision", "native"},
    "convnext_b": {"torchvision", "native"},
    "clip_b32": {"openai", "native"},
    "clip_text_b32": {"openai", "native"},
    # MAE trees exist only in the JAX package's own export naming
    "mae_t16": {"native"},
    "mae_s16": {"native"},
    "mae_b16": {"native"},
    # every ViT variant accepts either framework naming, or our own
    "_vit": {"torchvision", "timm", "native"},
}

def load_state_dict(path: str):
    """Load a checkpoint file into {name: numpy array}.

    ``.safetensors`` files through ``utils/safetensors_io`` (BF16 read as
    exact f32); anything else through ``torch.load(weights_only=True)``,
    or ``torch.jit.load`` for a TorchScript archive (how OpenAI distributes
    CLIP), which ``torch.load`` refuses with ``weights_only``."""
    if path.endswith(".safetensors"):
        from interactive_vit_tpu_torch.utils.safetensors_io import load_file

        return load_file(path)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except RuntimeError:
        obj = torch.jit.load(path, map_location="cpu")
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    return {k: v.numpy() for k, v in obj.items()}


def _sniff_vit_layout(sd) -> str:
    """The state dict's naming from its keys: our native export uses
    "/"-joined tree paths; timm ViTs (DINO releases too) ``blocks.N.`` /
    ``patch_embed.``; torchvision ``encoder.layers.`` / ``conv_proj``.
    Defaults to torchvision when no family's markers are present (the
    converter then names the missing key)."""
    keys = sd.keys()
    if any("/" in k for k in keys):
        return "native"
    if any(k.startswith(("blocks.", "patch_embed.")) for k in keys):
        return "timm"
    return "torchvision"


def convert(model: str, layout: str, sd, dtype=torch.float32, device="cpu"):
    """``sd`` ({name: array}) in ``layout`` ("auto" sniffs it) -> the
    port's tree for ``model``, each entry read as f32 on the host, then a
    tensor of ``dtype`` on ``device`` (the CPU default is a staging place:
    a loader that serves passes its device)."""
    allowed = VALID_LAYOUTS.get(model, VALID_LAYOUTS["_vit"])
    if layout == "auto":
        if any("/" in k for k in sd.keys()):
            layout = "native"  # our own export naming, any model
        elif model in VALID_LAYOUTS:
            layout = (sorted(allowed - {"native"}) or ["native"])[-1]
        else:
            layout = _sniff_vit_layout(sd)  # ViT: tv vs timm by keys
    if layout not in allowed:
        raise ValueError(
            f"layout {layout!r} is not valid for {model} "
            f"(expected one of {sorted(allowed)}, or 'auto')")
    kw = dict(dtype=dtype, device=device)
    if layout == "native":
        from interactive_vit_tpu_torch.models.weights import from_native_flat

        params = from_native_flat(sd, **kw)
        if (model not in ("vgg16", "clip_b32", "clip_text_b32", "resnet50")
                and not model.startswith(("swin_", "convnext_", "mae_"))):
            # ViT only (MAE's maker puts back its encoder's head itself):
            # empty containers do not survive flattening, so put back the
            # optional classifier head ({} = feature extractor) and a
            # depth-0 trunk
            params.setdefault("head", {})
            params.setdefault("blocks", [])
        return params
    if model == "vgg16":
        from interactive_vit_tpu_torch.models import vgg

        return vgg.from_torchvision(sd, **kw)
    if model == "resnet50":
        from interactive_vit_tpu_torch.models import resnet

        return resnet.from_torchvision(sd, **kw)
    if model.startswith("swin_"):
        from interactive_vit_tpu_torch.models import swin

        return swin.from_torch(sd, swin.VARIANTS[model], **kw)
    if model.startswith("convnext_"):
        from interactive_vit_tpu_torch.models import convnext

        return convnext.from_torchvision(sd, convnext.VARIANTS[model], **kw)
    if model == "clip_b32":
        from interactive_vit_tpu_torch.models import clip

        return clip.from_openai(sd, clip.CLIPVisionConfig(), **kw)
    if model == "clip_text_b32":
        from interactive_vit_tpu_torch.models import clip_text

        return clip_text.from_openai(sd, clip_text.CLIPTextConfig(), **kw)
    from interactive_vit_tpu_torch.models import vit, weights

    # "@res" / "@p" targets: convert in the checkpoint's own geometry, then
    # adapt (position table resampled, patch kernel resized; the identity
    # when the geometry already matches)
    cfg = vit.resolve_variant(model)
    if layout == "timm":
        params = weights.from_timm(sd, cfg, **kw)
    else:
        params = weights.from_torchvision(sd, cfg, **kw)
    return vit.adapt_checkpoint(params, cfg)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", required=True,
                        help="vit_t16|vit_s16|vit_b16|vit_l16|...|clip_b32|"
                             "clip_text_b32|vgg16|resnet50|swin_*|"
                             "convnext_*|vit_moe_s16|mae_*")
    parser.add_argument("--layout", default="auto",
                        choices=["auto", "torchvision", "timm", "openai",
                                 "native"])
    parser.add_argument("--input", required=True,
                        help="checkpoint path (.safetensors, or a torch "
                             ".pth)")
    parser.add_argument("--output", required=True,
                        help="checkpoint directory to write "
                             "(utils/checkpoint.py)")
    args = parser.parse_args(argv)

    from interactive_vit_tpu_torch.utils.checkpoint import save_params

    params = convert(args.model, args.layout, load_state_dict(args.input))
    save_params(args.output, params)
    print(f"converted {args.input} ({args.layout}) -> {args.output}")


if __name__ == "__main__":
    main()
