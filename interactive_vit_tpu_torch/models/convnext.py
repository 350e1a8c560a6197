"""ConvNeXt (tiny / small / base) as plain functions on dicts of tensors.

Counterpart of ``interactive_vit_tpu/models/convnext.py``: torchvision's
``convnext_tiny/small/base`` (a 4 x 4 / 4 stem, four stages of CNBlocks:
7 x 7 depthwise conv -> channel LayerNorm -> pointwise MLP with erf GELU
-> layer-scale residual; LayerNorm + 2 x 2 / 2 downsampling between
stages; avgpool -> LayerNorm -> Linear), eval mode (stochastic depth is
the identity).

The parameter layout is the JAX package's, so a JAX tree converts by
``models/weights.from_jax`` and the native "/" names round-trip: conv
kernels HWIO (the depthwise one [7, 7, 1, C]), linear weights ``[D_in,
D_out]``, LayerNorms ``{"g", "b"}`` in f32, the layer scale ``gamma`` in
f32. Activations stay NHWC between layers, and the stage taps are NHWC
``[B, H, W, C]`` on the wire, the JAX contract; a convolution sees them as
a channels-last NCHW view (no copy of the activation) and the HWIO kernel
as an OIHW view.

No Pallas kernel is on the JAX path, so none of this package's kernels is
on this one: cuDNN serves the convolutions. Each runs on the f32 upcasts
of its operands, adds its bias in f32 and casts to the weight dtype once,
as the JAX conv with ``preferred_element_type=f32`` does; in f32 the 1e-4
contract needs TF32 off (``runtime/device.exact_f32_matmuls``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from interactive_vit_tpu_torch.models.model_plugin import image_entry
from interactive_vit_tpu_torch.ops import layers as L

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    name: str
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    num_classes: int = 1000
    img_size: int = 224
    # torchvision's eval recipe: bilinear shorter-side resize to this, then
    # a centre crop of img_size
    resize_to: int = 236
    ln_eps: float = 1e-6
    layer_scale: float = 1e-6

    def stage_res(self, s: int) -> int:
        return self.img_size // 4 // (2 ** s)


VARIANTS: Dict[str, ConvNeXtConfig] = {
    "convnext_t": ConvNeXtConfig("convnext_t"),
    "convnext_s": ConvNeXtConfig("convnext_s", depths=(3, 3, 27, 3),
                                 resize_to=230),
    "convnext_b": ConvNeXtConfig("convnext_b", depths=(3, 3, 27, 3),
                                 dims=(128, 256, 512, 1024),
                                 resize_to=232),
}


def _ensure_batched(x: torch.Tensor):
    return (x[None], True) if x.ndim == 3 else (x, False)


def _ln(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """LayerNorm over the channel (last) axis, f32 statistics."""
    return L.layer_norm(x, p["g"], p["b"], eps)


def _conv_nchw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               stride: int, padding: int, groups: int = 1) -> torch.Tensor:
    """An NCHW (or channels-last NCHW view) input x an HWIO kernel: x cast
    to the weight dtype, the products summed in f32, the bias added in
    f32, the result cast to the weight dtype; returned NHWC."""
    x = x.to(w.dtype)
    y = F.conv2d(x.float(), w.float().permute(3, 2, 0, 1), stride=stride,
                 padding=padding, groups=groups)
    return (y.permute(0, 2, 3, 1) + b.float()).to(w.dtype)


def _conv_nhwc(x, w, b, stride: int, padding: int, groups: int = 1):
    """NHWC x HWIO -> NHWC (``_conv_nchw`` on the channels-last view)."""
    return _conv_nchw(x.permute(0, 3, 1, 2), w, b, stride, padding, groups)


def stem(p: Params, images: torch.Tensor, cfg: ConvNeXtConfig
         ) -> torch.Tensor:
    """[B, 3, H, W] -> NHWC patch features [B, H/4, W/4, C0] (the 4 x 4 / 4
    conv + channel LN, torchvision's ``features.0``)."""
    return _ln(_conv_nchw(images, p["w"], p["b"], 4, 0), p["ln"],
               cfg.ln_eps)


def block(p: Params, x: torch.Tensor, cfg: ConvNeXtConfig) -> torch.Tensor:
    """CNBlock: dw 7 x 7 -> LN -> Linear(4C) -> erf GELU (f32) -> Linear(C)
    -> layer scale (f32) -> + residual (torchvision CNBlock, eval mode)."""
    c = x.shape[-1]
    y = _conv_nhwc(x, p["dw_w"], p["dw_b"], 1, 3, groups=c)
    y = _ln(y, p["ln"], cfg.ln_eps)
    y = L.linear(y, p["fc1"]["w"], p["fc1"]["b"])
    y = F.gelu(y.float(), approximate="none").to(y.dtype)
    y = L.linear(y, p["fc2"]["w"], p["fc2"]["b"])
    return x + (p["gamma"].float() * y.float()).to(x.dtype)


def downsample(p: Params, x: torch.Tensor, cfg: ConvNeXtConfig
               ) -> torch.Tensor:
    """Between stages: channel LN, then the 2 x 2 / 2 conv (torchvision's
    ``features.{2,4,6}``)."""
    return _conv_nhwc(_ln(x, p["ln"], cfg.ln_eps), p["w"], p["b"], 2, 0)


def avgpool(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, C], the mean in f32."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)


def head(p: Params, pooled: torch.Tensor, cfg: ConvNeXtConfig
         ) -> torch.Tensor:
    """[B, C] pooled features -> logits (LN -> Linear; torchvision's
    ``classifier.{0,2}``: the LN sits after the global pool)."""
    return L.linear(_ln(pooled, p["ln"], cfg.ln_eps), p["fc"]["w"],
                    p["fc"]["b"])


def _trunc_normal(generator: torch.Generator, shape, std: float
                  ) -> torch.Tensor:
    """Normal draws truncated to [-2, 2] (inverse-CDF on uniforms), times
    ``std``."""
    lo, hi = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2, 2))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return (z.clamp(-2.0, 2.0) * std).float()


def init_params(cfg: ConvNeXtConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> Params:
    """torchvision's init: truncated-normal (0.02) conv and linear weights,
    zero biases, unit LN scales, ``layer_scale``-filled gammas. Draws on
    the CPU from ``generator`` (the numbers differ from ``jax.random``'s);
    ``device``: where the tensors are put."""
    def tn(shape):
        return _trunc_normal(generator, shape, 0.02).to(device=device,
                                                        dtype=dtype)

    def zeros(c):
        return torch.zeros(c, device=device, dtype=dtype)

    def ln(c):
        return {"g": torch.ones(c, device=device),
                "b": torch.zeros(c, device=device)}

    dims = cfg.dims
    params: Params = {
        "stem": {"w": tn((4, 4, 3, dims[0])), "b": zeros(dims[0]),
                 "ln": ln(dims[0])},
        "stages": [], "downs": [],
    }
    for s, depth in enumerate(cfg.depths):
        c = dims[s]
        params["stages"].append([{
            "dw_w": tn((7, 7, 1, c)), "dw_b": zeros(c), "ln": ln(c),
            "fc1": {"w": tn((c, 4 * c)), "b": zeros(4 * c)},
            "fc2": {"w": tn((4 * c, c)), "b": zeros(c)},
            "gamma": torch.full((c,), cfg.layer_scale, device=device),
        } for _ in range(depth)])
        if s + 1 < len(cfg.depths):
            params["downs"].append({"ln": ln(c),
                                    "w": tn((2, 2, c, dims[s + 1])),
                                    "b": zeros(dims[s + 1])})
    params["head"] = {"ln": ln(dims[-1]),
                      "fc": {"w": tn((dims[-1], cfg.num_classes)),
                             "b": zeros(cfg.num_classes)}}
    return params


def from_torchvision(sd: Dict[str, Any], cfg: ConvNeXtConfig,
                     dtype=torch.float32, device="cpu") -> Params:
    """torchvision ``convnext_*`` state dict ({name: array}) -> our tree.

    Feature indices: the stem at 0, stages at 1/3/5/7, downsamples at
    2/4/6; a block's ``block.{0,2,3,5}`` and ``layer_scale``; the
    classifier's ``{0,2}``. Conv weights go OIHW -> HWIO (the depthwise
    [C, 1, 7, 7] becomes [7, 7, 1, C]); LayerNorms and gammas stay f32."""
    def get(name):
        if name not in sd:
            raise KeyError(f"state dict missing {name!r}")
        return np.asarray(sd[name], np.float32)

    def put(arr, dt=dtype):
        return torch.from_numpy(np.array(arr, order="C")).to(
            device=device, dtype=dt)

    def conv_w(name):
        return put(get(name).transpose(2, 3, 1, 0))

    def ln(pre):
        return {"g": put(get(pre + ".weight"), torch.float32),
                "b": put(get(pre + ".bias"), torch.float32)}

    def lin(pre):
        return {"w": put(get(pre + ".weight").T), "b": put(get(pre + ".bias"))}

    params: Params = {
        "stem": {"w": conv_w("features.0.0.weight"),
                 "b": put(get("features.0.0.bias")), "ln": ln("features.0.1")},
        "stages": [], "downs": [],
    }
    for s, depth in enumerate(cfg.depths):
        fi = 1 + 2 * s
        stage = []
        for b in range(depth):
            pre = f"features.{fi}.{b}."
            stage.append({
                "dw_w": conv_w(pre + "block.0.weight"),
                "dw_b": put(get(pre + "block.0.bias")),
                "ln": ln(pre + "block.2"),
                "fc1": lin(pre + "block.3"),
                "fc2": lin(pre + "block.5"),
                "gamma": put(get(pre + "layer_scale").reshape(-1),
                             torch.float32),
            })
        params["stages"].append(stage)
        if s + 1 < len(cfg.depths):
            di = fi + 1
            params["downs"].append({
                "ln": ln(f"features.{di}.0"),
                "w": conv_w(f"features.{di}.1.weight"),
                "b": put(get(f"features.{di}.1.bias")),
            })
    params["head"] = {"ln": ln("classifier.0"), "fc": lin("classifier.2")}
    return params


def forward(params: Params, images: torch.Tensor, cfg: ConvNeXtConfig,
            block_wrapper=None) -> torch.Tensor:
    """[B, 3, H, W] (or [3, H, W]) -> logits [B, num_classes].

    ``block_wrapper``: the training hook: each CNBlock runs as one ``(p,
    x) -> y`` unit wrapped by it (``parallel/train.remat_wrapper``). The
    gradients of the HWIO kernels come back HWIO: the convolutions see
    them through permuted views, whose backward permutes back."""
    x, squeeze = _ensure_batched(images)
    x = stem(params["stem"], x, cfg)
    one = functools.partial(block, cfg=cfg)
    if block_wrapper is not None:
        one = block_wrapper(one)
    for s, stage in enumerate(params["stages"]):
        for blk in stage:
            x = one(blk, x)
        if s < len(params["downs"]):
            x = downsample(params["downs"][s], x, cfg)
    logits = head(params["head"], avgpool(x), cfg)
    return logits[0] if squeeze else logits


# -- the node surface ---------------------------------------------------------


def layer_fns(cfg: ConvNeXtConfig) -> List[Tuple[str, List[str], Callable]]:
    """Ordered (name, extra_outs, fn) specs: transform, stem,
    stages.{s}.{b}, downsample.{s} (s = 1..3, the stage it feeds),
    avgpool, head: 25 nodes for convnext_t. Stage taps are NHWC [B, H, W,
    C]. Each layer keeps an unbatched input unbatched (rank 3, or 1 for
    the pooled features), which a stacked group folds into its batch."""
    def batched(op, rank=3):
        def fn(p, ins):
            x = ins["o"]
            squeeze = x.ndim == rank
            y = op(p, x[None] if squeeze else x)
            return {"o": y[0] if squeeze else y}

        return image_entry(fn, True, rank)

    def transform_fn(p, ins):
        from interactive_vit_tpu_torch.ops.preprocess_mm import preprocess_mm

        return {"o": preprocess_mm(ins["o"], cfg.img_size,
                                   resize_to=cfg.resize_to)}

    layers: List[Tuple[str, List[str], Callable]] = [
        ("transform", [], image_entry(transform_fn, True)),
        ("stem", [], batched(lambda p, x: stem(p, x, cfg))),
    ]
    for s, depth in enumerate(cfg.depths):
        for b in range(depth):
            layers.append((f"stages.{s}.{b}", [], batched(
                lambda p, x: block(p, x, cfg))))
        if s + 1 < len(cfg.depths):
            layers.append((f"downsample.{s + 1}", [], batched(
                lambda p, x: downsample(p, x, cfg))))
    layers.append(("avgpool", [], batched(lambda p, x: avgpool(x))))
    layers.append(("head", [], batched(lambda p, x: head(p, x, cfg),
                                       rank=1)))
    return layers


def layer_params(params: Params, layer_name: str):
    if layer_name in ("transform", "avgpool"):
        return None
    if layer_name == "stem":
        return params["stem"]
    if layer_name == "head":
        return params["head"]
    if layer_name.startswith("stages."):
        _, s, b = layer_name.split(".")
        return params["stages"][int(s)][int(b)]
    if layer_name.startswith("downsample."):
        return params["downs"][int(layer_name.split(".")[1]) - 1]
    raise KeyError(layer_name)
