"""ResNet-50 as plain functions on dicts of tensors.

Counterpart of ``interactive_vit_tpu/models/resnet.py``: torchvision's
``resnet50`` as 21 tappable layers, one node a bottleneck block,

    resnet50:transform, conv1, maxpool, layer1.0 .. layer4.2,
    avgpool, fc

with the JAX package's parameter layout (conv weights OIHW, as torch's;
eval-mode batch norm folded to ``{"s", "b"}`` with s = gamma / sqrt(var +
eps), b = beta - mean * s; the classifier ``[D_in, D_out]``), so a JAX
tree converts by ``models/weights.from_jax``. An input may be [3, H, W]
or [B, 3, H, W]; an unbatched one stays unbatched down the chain.

The JAX package computes the convolutions in plain XLA, outside any
Pallas kernel, so here cuDNN serves them: no kernel of this package runs
on the path. A convolution runs on the f32 upcasts of its operands (a
bf16 model's products are exact and sum in f32, as the JAX conv's
``preferred_element_type=f32``) and casts back to the weight dtype once;
in f32 it keeps the 1e-4 contract only with TF32 off
(``runtime/device.exact_f32_matmuls``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from interactive_vit_tpu_torch.models.model_plugin import image_entry
from interactive_vit_tpu_torch.ops import layers as L

Params = Dict[str, Any]

# bottleneck counts and widths a stage (torchvision resnet50)
STAGES = [(3, 64), (4, 128), (6, 256), (3, 512)]
EXPANSION = 4
BN_EPS = 1e-5


def _ensure_batched(x: torch.Tensor):
    return (x[None], True) if x.ndim == 3 else (x, False)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    """NCHW / OIHW convolution with symmetric ``padding``, x cast to the
    weight dtype, the products summed in f32 and the result cast back.

    The JAX function's 1 x 1 convolutions pass ``"SAME"``, which pads
    nothing for a 1 x 1 kernel at any stride (the stride-2 downsample
    included: out = ceil(H / 2) = the unpadded count on these even grids);
    its 3 x 3 and 7 x 7 ones pass the explicit symmetric pads, as here."""
    x = x.to(w.dtype)
    y = F.conv2d(x.float(), w.float(), stride=stride, padding=padding)
    return y.to(w.dtype)


def bn(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Eval-mode batch norm as its folded affine, s and b cast to x's
    dtype first (the JAX function's cast points)."""
    s = p["s"].reshape(1, -1, 1, 1).to(x.dtype)
    b = p["b"].reshape(1, -1, 1, 1).to(x.dtype)
    return x * s + b


def fold_bn(gamma, beta, mean, var, eps: float = BN_EPS, device="cpu"
            ) -> Params:
    """Fold a batch norm's statistics into ``{"s", "b"}`` (f32), on the
    host in numpy as the JAX function does."""
    gamma, beta, mean, var = (np.asarray(a, np.float32)
                              for a in (gamma, beta, mean, var))
    s = gamma / np.sqrt(var + eps)
    return {"s": torch.from_numpy(np.array(s)).to(device),
            "b": torch.from_numpy(np.array(beta - mean * s)).to(device)}


def maxpool3_s2(x: torch.Tensor) -> torch.Tensor:
    """torchvision's maxpool: kernel 3, stride 2, padding 1 (-inf pads)."""
    return F.max_pool2d(x, 3, 2, 1)


def bottleneck(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """conv1x1 -> BN -> relu -> conv3x3(stride) -> BN -> relu -> conv1x1
    -> BN -> + identity or downsample -> relu (torchvision Bottleneck)."""
    idn = x
    y = torch.relu(bn(conv(x, p["conv1_w"]), p["bn1"]))
    y = torch.relu(bn(conv(y, p["conv2_w"], stride=stride, padding=1),
                      p["bn2"]))
    y = bn(conv(y, p["conv3_w"]), p["bn3"])
    if "down_w" in p:
        idn = bn(conv(x, p["down_w"], stride=stride), p["down_bn"])
    return torch.relu(y + idn.to(y.dtype))


def global_avgpool(x: torch.Tensor) -> torch.Tensor:
    return x.float().mean(dim=(2, 3)).to(x.dtype)


def stem(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The 7 x 7 / 2 convolution (pad 3) + BN + relu."""
    return torch.relu(bn(conv(x, p["conv1_w"], stride=2, padding=3),
                         p["bn1"]))


def init_params(generator: torch.Generator, num_classes: int = 1000,
                dtype=torch.float32, device="cpu") -> Params:
    """He-style random init (normal over sqrt(fan_in / 2)) with identity
    BN folds and a classifier over sqrt(fan_in), the JAX package's scales.
    Draws on the CPU from ``generator`` (the numbers differ from
    ``jax.random``'s); ``device``: where the tensors are put."""
    def kconv(cin, cout, k):
        w = torch.randn((cout, cin, k, k), generator=generator) \
            * (2.0 / (cin * k * k)) ** 0.5
        return w.to(device=device, dtype=dtype)

    def ident_bn(c):
        return {"s": torch.ones(c, device=device),
                "b": torch.zeros(c, device=device)}

    params: Params = {"conv1_w": kconv(3, 64, 7), "bn1": ident_bn(64),
                      "layers": []}
    cin = 64
    for si, (blocks, width) in enumerate(STAGES):
        stage = []
        cout = width * EXPANSION
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = {"conv1_w": kconv(cin, width, 1), "bn1": ident_bn(width),
                   "conv2_w": kconv(width, width, 3), "bn2": ident_bn(width),
                   "conv3_w": kconv(width, cout, 1), "bn3": ident_bn(cout)}
            if stride != 1 or cin != cout:
                blk["down_w"] = kconv(cin, cout, 1)
                blk["down_bn"] = ident_bn(cout)
            stage.append(blk)
            cin = cout
        params["layers"].append(stage)
    w = torch.randn((cin, num_classes), generator=generator) * cin ** -0.5
    params["fc"] = {"w": w.to(device=device, dtype=dtype),
                    "b": torch.zeros(num_classes, device=device, dtype=dtype)}
    return params


def from_torchvision(sd: Dict[str, Any], dtype=torch.float32,
                     device="cpu") -> Params:
    """torchvision ``resnet50().state_dict()`` ({name: array}) -> our tree:
    batch norms folded (f32), conv weights as they are, the classifier
    transposed to [D_in, D_out]."""
    def get(name):
        if name not in sd:
            raise KeyError(f"state dict missing {name!r}")
        return np.asarray(sd[name], np.float32)

    def put(arr):
        # a C-ordered copy: the transposed classifier would keep Fortran
        # order otherwise
        return torch.from_numpy(np.array(arr, order="C")).to(
            device=device, dtype=dtype)

    def get_bn(pre):
        return fold_bn(get(pre + ".weight"), get(pre + ".bias"),
                       get(pre + ".running_mean"), get(pre + ".running_var"),
                       device=device)

    params: Params = {"conv1_w": put(get("conv1.weight")),
                      "bn1": get_bn("bn1"), "layers": []}
    for si, (blocks, _w) in enumerate(STAGES):
        stage = []
        for bi in range(blocks):
            pre = f"layer{si + 1}.{bi}."
            blk = {"conv1_w": put(get(pre + "conv1.weight")),
                   "bn1": get_bn(pre + "bn1"),
                   "conv2_w": put(get(pre + "conv2.weight")),
                   "bn2": get_bn(pre + "bn2"),
                   "conv3_w": put(get(pre + "conv3.weight")),
                   "bn3": get_bn(pre + "bn3")}
            if (pre + "downsample.0.weight") in sd:
                blk["down_w"] = put(get(pre + "downsample.0.weight"))
                blk["down_bn"] = get_bn(pre + "downsample.1")
            stage.append(blk)
        params["layers"].append(stage)
    params["fc"] = {"w": put(get("fc.weight").T), "b": put(get("fc.bias"))}
    return params


def forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] (or [3, H, W]) -> logits [B, num_classes]."""
    x, squeeze = _ensure_batched(images)
    x = maxpool3_s2(stem(params, x))
    for si, stage in enumerate(params["layers"]):
        for bi, blk in enumerate(stage):
            x = bottleneck(blk, x, 2 if (si > 0 and bi == 0) else 1)
    logits = L.linear(global_avgpool(x), params["fc"]["w"],
                      params["fc"]["b"])
    return logits[0] if squeeze else logits


# -- the 21-node surface -----------------------------------------------------


def layer_fns() -> List[Tuple[str, List[str], Callable]]:
    """Ordered (name, extra_outs, fn) specs: transform, conv1, maxpool,
    layer{s}.{b}, avgpool, fc. Each layer keeps an unbatched input
    unbatched (rank 3 an image or a feature map, rank 1 the pooled
    features), which a stacked group folds into its batch."""
    def batched(op, rank=3):
        def fn(p, ins):
            x = ins["o"]
            squeeze = x.ndim == rank
            y = op(p, x[None] if squeeze else x)
            return {"o": y[0] if squeeze else y}

        return image_entry(fn, True, rank)

    def transform_fn(p, ins):
        from interactive_vit_tpu_torch.ops.preprocess_mm import preprocess_mm

        return {"o": preprocess_mm(ins["o"], 224)}

    layers: List[Tuple[str, List[str], Callable]] = [
        ("transform", [], image_entry(transform_fn, True)),
        ("conv1", [], batched(stem)),
        ("maxpool", [], batched(lambda p, x: maxpool3_s2(x))),
    ]
    for si, (blocks, _w) in enumerate(STAGES):
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            layers.append((f"layer{si + 1}.{bi}", [], batched(
                lambda p, x, s=stride: bottleneck(p, x, s))))
    layers.append(("avgpool", [], batched(lambda p, x: global_avgpool(x))))
    layers.append(("fc", [], batched(
        lambda p, x: L.linear(x, p["w"], p["b"]), rank=1)))
    return layers


def layer_params(params: Params, layer_name: str):
    if layer_name in ("transform", "maxpool", "avgpool"):
        return None
    if layer_name == "conv1":
        return {"conv1_w": params["conv1_w"], "bn1": params["bn1"]}
    if layer_name == "fc":
        return params["fc"]
    if layer_name.startswith("layer"):
        stage, bi = layer_name[5:].split(".")
        return params["layers"][int(stage) - 1][int(bi)]
    raise KeyError(layer_name)
