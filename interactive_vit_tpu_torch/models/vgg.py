"""VGG16, the reference app's own model, as a tappable node plugin.

Counterpart of ``interactive_vit_tpu/models/vgg.py``. The reference
exploded torchvision's VGG16 into 42 graph nodes, ``vgg16:transform``,
``vgg16:features.0`` .. ``features.30``, ``vgg16:avgpool``,
``vgg16:flatten`` and ``vgg16:classifier.0`` .. ``classifier.6``, and saved
that chain as ``static/graphs/vgg16.json``; this module has the same node
surface. Eval semantics: dropout is the identity; an input may be [3, H, W]
(the reference ran unbatched) or [B, 3, H, W].

The JAX package computes the convolutions in plain XLA, outside any Pallas
kernel, so here cuDNN serves them (``torch.nn.functional.conv2d``): no
kernel of this package runs on the path. In f32 they keep the 1e-4
contract only with TF32 off (``runtime/device.exact_f32_matmuls``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from interactive_vit_tpu_torch.models.model_plugin import image_entry
from interactive_vit_tpu_torch.ops import layers as L

Params = Dict[str, Any]

# torchvision vgg16.features: (layer kind, out channels) at each index
_FEATURES: List[Tuple[str, int]] = []
for _v in [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]:
    if _v == "M":
        _FEATURES.append(("maxpool", 0))
    else:
        _FEATURES.append(("conv", _v))
        _FEATURES.append(("relu", 0))
del _v

# classifier: Linear, ReLU, Dropout, Linear, ReLU, Dropout, Linear
_CLASSIFIER = ["linear", "relu", "dropout", "linear", "relu", "dropout",
               "linear"]
_CLASSIFIER_DIMS = [(25088, 4096), None, None, (4096, 4096), None, None,
                    (4096, 1000)]


def _ensure_batched(x: torch.Tensor):
    return (x[None], True) if x.ndim == 3 else (x, False)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """3x3 same-pad convolution, NCHW / OIHW, as the JAX function: x cast
    to the weight dtype, the products summed in f32 (f32 operands: the
    convolution itself; bf16: of their exact f32 upcasts), cast back, then
    the bias added in x's dtype (after the cast, not folded into the
    convolution, which would move the bf16 rounding point)."""
    x = x.to(w.dtype)
    xb, squeeze = _ensure_batched(x)
    y = F.conv2d(xb.float(), w.float(), padding=1).to(x.dtype)
    y = y + b.reshape(1, -1, 1, 1).to(x.dtype)
    return y[0] if squeeze else y


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    xb, squeeze = _ensure_batched(x)
    y = F.max_pool2d(xb, 2, 2)
    return y[0] if squeeze else y


def adaptive_avgpool7(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((7, 7)) with torch's windows, out[i] =
    mean(x[floor(i H / 7) : ceil((i + 1) H / 7)]), each axis in turn as in
    the JAX function (the identity at a 224 input's 7 x 7 map)."""
    xb, squeeze = _ensure_batched(x)

    def pool_axis(t, axis, out_size):
        size_in = t.shape[axis]
        parts = []
        for i in range(out_size):
            s = (i * size_in) // out_size
            e = -(-((i + 1) * size_in) // out_size)
            parts.append(t.narrow(axis, s, e - s).mean(dim=axis,
                                                        keepdim=True))
        return torch.cat(parts, dim=axis)

    if tuple(xb.shape[-2:]) != (7, 7):
        xb = pool_axis(pool_axis(xb, -2, 7), -1, 7)
    return xb[0] if squeeze else xb


def flatten(x: torch.Tensor) -> torch.Tensor:
    """``torch.flatten`` as the reference used it: the whole of an
    unbatched input, each sample of a batched one."""
    if x.ndim == 3:
        return x.reshape(-1)
    return x.reshape(x.shape[0], -1)


def init_params(generator: torch.Generator, dtype=torch.float32,
                device="cpu") -> Params:
    """Random He-style init in torchvision's layout (conv weights normal
    over sqrt(fan_in / 2), linear ones over sqrt(fan_in), zero biases),
    the JAX package's scales. Draws on the CPU from ``generator``;
    ``device``: where the tensors are put."""
    def put(t):
        return t.to(device=device, dtype=dtype)

    def normal(shape, std):
        return put(torch.randn(shape, generator=generator,
                               dtype=torch.float32) * std)

    params: Params = {"features": {}, "classifier": {}}
    in_ch = 3
    for idx, (kind, out_ch) in enumerate(_FEATURES):
        if kind == "conv":
            params["features"][str(idx)] = {
                "w": normal((out_ch, in_ch, 3, 3), (2.0 / (in_ch * 9)) ** 0.5),
                "b": put(torch.zeros(out_ch)),
            }
            in_ch = out_ch
    for idx, dims in enumerate(_CLASSIFIER_DIMS):
        if dims is not None:
            params["classifier"][str(idx)] = {
                "w": normal(dims, (1.0 / dims[0]) ** 0.5),
                "b": put(torch.zeros(dims[1])),
            }
    return params


def from_torchvision(sd: Dict[str, Any], dtype=torch.float32,
                     device="cpu") -> Params:
    """torchvision ``vgg16().state_dict()`` (numpy, or anything
    ``np.asarray`` takes) -> our tree: conv weights as they are, linear
    weights transposed to [D_in, D_out]."""
    def get(name, transpose=False):
        arr = np.asarray(sd[name], dtype=np.float32)
        # a C-ordered writable copy (order "K" would keep the transpose's
        # Fortran order, and the kernels take contiguous weights only)
        arr = np.array(arr.T if transpose else arr, order="C")
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    params: Params = {"features": {}, "classifier": {}}
    for idx, (kind, _) in enumerate(_FEATURES):
        if kind == "conv":
            params["features"][str(idx)] = {
                "w": get(f"features.{idx}.weight"),
                "b": get(f"features.{idx}.bias")}
    for idx, dims in enumerate(_CLASSIFIER_DIMS):
        if dims is not None:
            params["classifier"][str(idx)] = {
                "w": get(f"classifier.{idx}.weight", True),
                "b": get(f"classifier.{idx}.bias")}
    return params


# -- the 42-node surface ------------------------------------------------------


def layer_fns():
    """Ordered (name, extra_outs, fn) specs of the reference's node list:
    transform, features.0-30, avgpool, flatten, classifier.0-6."""
    layers = []

    def transform_fn(p, ins):
        from interactive_vit_tpu_torch.ops.preprocess_mm import preprocess_mm

        return {"o": preprocess_mm(ins["o"], 224)}

    layers.append(("transform", [], image_entry(transform_fn, True)))

    def conv_fn(p, ins):
        return {"o": conv2d(ins["o"], p["w"], p["b"])}

    def relu_fn(p, ins):
        return {"o": torch.relu(ins["o"])}

    def maxpool_fn(p, ins):
        return {"o": maxpool2(ins["o"])}

    # an unbatched image stays unbatched through the whole chain, as in
    # the reference: each layer is marked with the rank of its unbatched
    # input, which a stacked group of such requests folds into the batch
    def entry(fn, rank):
        return image_entry(lambda p, ins: fn(p, ins), True, rank)

    fns = {"conv": conv_fn, "relu": relu_fn, "maxpool": maxpool_fn}
    for idx, (kind, _) in enumerate(_FEATURES):
        layers.append((f"features.{idx}", [], entry(fns[kind], 3)))

    layers.append(("avgpool", [], entry(
        lambda p, ins: {"o": adaptive_avgpool7(ins["o"])}, 3)))
    layers.append(("flatten", [], entry(
        lambda p, ins: {"o": flatten(ins["o"])}, 3)))

    def linear_fn(p, ins):
        return {"o": L.linear(ins["o"], p["w"], p["b"])}

    def identity_fn(p, ins):
        return {"o": ins["o"]}

    fns = {"linear": linear_fn, "relu": relu_fn, "dropout": identity_fn}
    for idx, kind in enumerate(_CLASSIFIER):
        layers.append((f"classifier.{idx}", [], entry(fns[kind], 1)))
    return layers


def layer_params(params: Params, layer_name: str) -> Any:
    if layer_name.startswith("features."):
        return params["features"].get(layer_name.split(".", 1)[1], {})
    if layer_name.startswith("classifier."):
        return params["classifier"].get(layer_name.split(".", 1)[1], {})
    return {}


def forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """The logits through the same layer fns (no transform)."""
    env = {"o": images}
    for name, _, fn in layer_fns():
        if name == "transform":
            continue
        env = fn(layer_params(params, name), env)
    return env["o"]
