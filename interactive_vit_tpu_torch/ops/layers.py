"""Transformer layer ops in plain PyTorch.

Counterpart of ``interactive_vit_tpu/ops/layers.py`` with the same
numerics: f32 LayerNorm statistics, a dtype-keyed GELU, and linear layers
that accumulate in f32 and cast back to the activation dtype once.

Conventions (kept from the JAX package so parameters convert by a
tree-map): activations are ``[B, N, D]``; linear weights are
``[D_in, D_out]``; parameters are plain dicts of tensors.
"""

from __future__ import annotations

import math

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from interactive_vit_tpu_torch.ops.quant import (
    QKEY, SKEY, is_quantized, is_w8a8, linear_w8a8,
)
from interactive_vit_tpu_torch.runtime.constants import device_constant

Params = Dict[str, torch.Tensor]


@device_constant(maxsize=256)
def index_on(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``values`` as an int64 index tensor on ``device``, built once. A
    head subset selected with it (``index_select``) uploads nothing in a
    pass, where indexing with a Python list uploads the list each time,
    which a CUDA graph capture refuses. Built outside inference mode, so
    that a caller under autograd can use the cached tensor too."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.long, device=device)


def split_last(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """The last dim of ``x`` reshaped into ``dims`` (the heads' split of a
    fused qkv activation). A DTensor sharded on that dim (a mesh's model
    axis, ``parallel/mesh.py``) whose shard would not fall evenly on
    ``dims[0]`` is gathered first: where GSPMD reshards at the reshape in
    the JAX package (Swin's and a teacher's flat qkv columns)."""
    placements = getattr(x, "placements", None)
    if placements is not None:
        mesh, last = x.device_mesh, x.ndim - 1
        if any(getattr(pl, "dim", None) == last and dims[0] % mesh.size(i)
               for i, pl in enumerate(placements)):
            from torch.distributed.tensor import Replicate

            x = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    return x.reshape(*x.shape[:-1], *dims)


def merge_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` dims of ``x`` merged into one (the heads' merge of an
    attention output). A DTensor result is pinned to its placements with
    a redistribute, whose backward hands the gradient back so placed: a
    product's backward may otherwise give a gradient sharded where the
    merge's backward view cannot split it (heads that do not divide the
    model axis)."""
    x = x.reshape(*x.shape[:-n], math.prod(x.shape[-n:]))
    placements = getattr(x, "placements", None)
    if placements is not None:
        x = x.redistribute(x.device_mesh, placements)
    return x


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis, f32 statistics regardless of x dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU keyed on dtype, as in the JAX package: exact erf GELU in f32
    (the 1e-4 parity path), the tanh approximation in reduced precision."""
    return F.gelu(x, approximate="none" if x.dtype == torch.float32
                  else "tanh")


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor]) -> torch.Tensor:
    """x @ w + b accumulated in f32, cast back to x's dtype once.

    ``w`` is a dense ``[D_in, D_out]`` tensor or an int8 leaf-dict
    (``ops/quant.py``). Weight-only int8 multiplies by the int8 weight cast
    to x's dtype and rescales the f32 accumulator by the column scale (the
    scale commutes with the product); W8A8 goes to ``quant.linear_w8a8``.
    The product runs on f32 upcasts, so bf16 operands multiply exactly and
    sum in f32 like the JAX ``preferred_element_type=f32`` dot; on CUDA
    this assumes TF32 is off for matmuls (PyTorch's default)."""
    if is_w8a8(w):
        return linear_w8a8(x, w, b)
    if is_quantized(w):
        y = torch.matmul(x.float(), w[QKEY].to(x.dtype).float()) * w[SKEY]
    else:
        y = torch.matmul(x.float(), w.float())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Transformer MLP: linear -> GELU -> linear."""
    h = gelu(linear(x, p["fc1_w"], p["fc1_b"]))
    return linear(h, p["fc2_w"], p["fc2_b"])


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, N, C*patch*patch], patches row-major over the
    image and features flattened (C, ph, pw) like a conv kernel."""
    b, c, h, w = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, gh, gw, C, ph, pw]
    return x.reshape(b, gh * gw, c * patch * patch)


def patch_embed(images: torch.Tensor, p: Params, patch: int) -> torch.Tensor:
    """Patchify + project: one [B*N, C*p*p] @ [C*p*p, D] matmul."""
    return linear(patchify(images, patch), p["w"], p["b"])


def add_cls_and_pos(x: torch.Tensor, cls_token: torch.Tensor,
                    pos_emb: torch.Tensor) -> torch.Tensor:
    """Prepend prefix token(s) [1, P, D] and add positional embeddings
    [1, N+P, D]."""
    b = x.shape[0]
    cls = cls_token.to(x.dtype).expand(b, cls_token.shape[1], x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    return x + pos_emb.to(x.dtype)


def target_dims(h: int, w: int, size: int,
                resize_to: Optional[int] = None):
    """Shorter-side resize target (nh, nw) for the eval transform. The
    default ``resize_to`` is the ImageNet recipe (shorter side to
    size*256/224, then crop ``size``); Swin's recipe passes 232 for 224."""
    if resize_to is None:
        resize_to = int(size * 256 / 224)
    if h < w:
        return resize_to, max(resize_to, int(round(w * resize_to / h)))
    return max(resize_to, int(round(h * resize_to / w))), resize_to
