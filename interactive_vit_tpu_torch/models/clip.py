"""CLIP image encoder (ViT-B/32): the embedding-extraction node path.

Counterpart of ``interactive_vit_tpu/models/clip.py`` (BASELINE config 4).
The chain ends in an L2-normalised [B, 512] embedding node instead of a
classifier head.

OpenAI CLIP's visual tower: a stride-32 patch projection without bias,
class embedding and learned positions, ``ln_pre`` before the blocks,
pre-LN blocks with QuickGELU (x * sigmoid(1.702 x)), ``ln_post`` on the
CLS token, then a bias-free projection into the shared embedding space.
The attention branch of a block is a ViT block's, so ``block_impl`` (the
whole-image block kernel, ``ops/fused_block.fused_attn_block``) takes it:
at ViT-B/32, N = 50 tokens of width 768 in 12 heads 64 wide.
``from_openai`` converts OpenAI's state dict (``visual.*`` keys).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from interactive_vit_tpu_torch.models.model_plugin import image_entry
from interactive_vit_tpu_torch.ops import attention as attn_ops
from interactive_vit_tpu_torch.ops import layers as L

Params = Dict[str, Any]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    name: str = "clip_b32"
    img_size: int = 224
    patch: int = 32
    width: int = 768
    depth: int = 12
    heads: int = 12
    embed_dim: int = 512
    ln_eps: float = 1e-5

    @property
    def tokens(self) -> int:
        return (self.img_size // self.patch) ** 2 + 1

    @property
    def mlp_dim(self) -> int:
        return self.width * 4


@functools.lru_cache(maxsize=8)
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX casts a Python scalar that
    multiplies an array (1.702 is 1.703125 in bf16)."""
    return float(torch.tensor(value, dtype=dtype))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's activation, x * sigmoid(1.702 x), in x's dtype: each
    op rounds to it, the constant too, as in the JAX function."""
    return x * torch.sigmoid(_in_dtype(1.702, x.dtype) * x)


def block_params(d: int, md: int, put, dense) -> Params:
    """One pre-LN block's weights (ones / zeros for the norms and biases,
    ``dense`` draws for the four matrices), shared by both CLIP towers."""
    def const(value, *shape):
        return put(torch.full(shape, float(value)))

    return {
        "ln1_s": const(1, d), "ln1_b": const(0, d),
        "qkv_w": dense(d, (d, 3 * d)), "qkv_b": const(0, 3 * d),
        "proj_w": dense(d, (d, d)), "proj_b": const(0, d),
        "ln2_s": const(1, d), "ln2_b": const(0, d),
        "fc1_w": dense(d, (d, md)), "fc1_b": const(0, md),
        "fc2_w": dense(md, (md, d)), "fc2_b": const(0, d),
    }


def init_params(cfg: CLIPVisionConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> Params:
    """Random init with the JAX package's layout and scales (weights
    normal over sqrt(fan_in), the class embedding over sqrt(width), 0.01
    positions). Draws on the CPU from ``generator``; the numbers differ
    from ``jax.random``'s. ``device``: where the tensors are put."""
    d, md = cfg.width, cfg.mlp_dim
    pdim = 3 * cfg.patch * cfg.patch

    def put(t):
        return t.to(device=device, dtype=dtype)

    def normal(shape, std):
        return put(torch.randn(shape, generator=generator,
                               dtype=torch.float32) * std)

    def dense(fan_in, shape):
        return normal(shape, fan_in ** -0.5)

    params: Params = {
        "patch_embed": {"w": dense(pdim, (pdim, d))},  # no bias
        "cls_token": normal((1, 1, d), d ** -0.5),
        "pos_emb": normal((1, cfg.tokens, d), 0.01),
        "ln_pre": {"s": put(torch.ones(d)), "b": put(torch.zeros(d))},
        "blocks": [],
        "ln_post": {"s": put(torch.ones(d)), "b": put(torch.zeros(d))},
        "proj": dense(d, (d, cfg.embed_dim)),  # no bias
    }
    params["blocks"] = [block_params(d, md, put, dense)
                        for _ in range(cfg.depth)]
    return params


def mlp_quickgelu(x: torch.Tensor, p: Params) -> torch.Tensor:
    h = quick_gelu(L.linear(x, p["fc1_w"], p["fc1_b"]))
    return L.linear(h, p["fc2_w"], p["fc2_b"])


def block(p: Params, x: torch.Tensor, cfg: CLIPVisionConfig,
          want_attn: bool = False, attn_impl=None, block_impl=None
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-LN block with a QuickGELU MLP; returns (y, probs | None).
    ``block_impl``: the fused attention-branch kernel
    (``fused_attn_block``'s signature) in place of LN1 + QKV + attention +
    projection + residual; ``attn_impl``: the unfused path's attention."""
    if block_impl is not None:
        x, probs = block_impl(x, p, cfg.heads, cfg.ln_eps, want_attn)
    else:
        h, probs = attn_ops.mhsa(
            L.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.ln_eps), p,
            cfg.heads, want_attn=want_attn, attn_impl=attn_impl)
        x = x + h
    x = x + mlp_quickgelu(
        L.layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.ln_eps), p)
    return x, probs


def embed(params: Params, images: torch.Tensor, cfg: CLIPVisionConfig
          ) -> torch.Tensor:
    """[B, 3, H, W] -> [B, N, D]: the bias-free patch projection (f32
    products, cast back), CLS and positions, then ``ln_pre``. Activations
    adopt the weight dtype here."""
    w = params["patch_embed"]["w"]
    x = L.linear(L.patchify(images.to(w.dtype), cfg.patch), w, None)
    x = L.add_cls_and_pos(x, params["cls_token"], params["pos_emb"])
    return L.layer_norm(x, params["ln_pre"]["s"], params["ln_pre"]["b"],
                        cfg.ln_eps)


def normalized_projection(x: torch.Tensor, proj: torch.Tensor,
                          normalize: bool, dtype) -> torch.Tensor:
    """x @ proj in f32, L2-normalised in f32 when ``normalize``, cast to
    ``dtype``: the last step of both towers."""
    emb = torch.matmul(x.float(), proj.float())
    if normalize:
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb.to(dtype)


def project(params: Params, x: torch.Tensor, cfg: CLIPVisionConfig,
            normalize: bool = True) -> torch.Tensor:
    """ln_post on CLS -> bias-free projection -> (optional) L2 norm."""
    cls = L.layer_norm(x[:, 0], params["ln_post"]["s"],
                       params["ln_post"]["b"], cfg.ln_eps)
    return normalized_projection(cls, params["proj"], normalize, x.dtype)


def forward(params: Params, images: torch.Tensor, cfg: CLIPVisionConfig,
            want_attn: bool = False, attn_impl=None) -> Dict[str, Any]:
    """{"embedding": [B, embed_dim]} and, with ``want_attn``, "attn": a
    tuple of per-layer [B, H, N, N] maps in the activation dtype."""
    x = embed(params, images, cfg)
    attns: List[torch.Tensor] = []
    for p in params["blocks"]:
        x, probs = block(p, x, cfg, want_attn=want_attn, attn_impl=attn_impl)
        if want_attn:
            attns.append(probs.to(x.dtype))
    out: Dict[str, Any] = {"embedding": project(params, x, cfg)}
    if want_attn:
        out["attn"] = tuple(attns)
    return out


# -- node decomposition ------------------------------------------------------


def layer_fns(cfg: CLIPVisionConfig, attn_impl=None, block_impl=None):
    """transform -> embed -> blocks.i (extra tap "attn") -> embedding."""
    layers: List[Tuple[str, List[str], Callable]] = []

    def transform_fn(p, ins):
        from interactive_vit_tpu_torch.ops.preprocess_mm import preprocess_mm

        # OpenAI CLIP resizes the shorter side straight to img_size
        # (bicubic) and centre-crops: resize_to=img_size keeps its framing
        return {"o": preprocess_mm(ins["o"], cfg.img_size, CLIP_MEAN,
                                   CLIP_STD, resize_to=cfg.img_size,
                                   method="bicubic")}

    def embed_fn(p, ins):
        x = ins["o"]
        if x.ndim == 3:  # unbatched [C,H,W] input gets a batch dim
            x = x[None]
        return {"o": embed(p, x, cfg)}

    layers.append(("transform", [], image_entry(transform_fn, True)))
    layers.append(("embed", [], image_entry(embed_fn, False)))

    def block_fn(p, ins, want=frozenset()):
        y, probs = block(p, ins["o"], cfg, want_attn=bool(want),
                         attn_impl=attn_impl, block_impl=block_impl)
        outs = {"o": y}
        if probs is not None:
            outs["attn"] = probs
        return outs

    for i in range(cfg.depth):
        layers.append((f"blocks.{i}", ["attn"], block_fn))

    layers.append(("embedding", [], lambda p, ins: {
        "o": project(p, ins["o"], cfg)}))
    return layers


def layer_params(params: Params, layer_name: str) -> Any:
    if layer_name.startswith("blocks."):
        return params["blocks"][int(layer_name.split(".", 1)[1])]
    if layer_name == "embed":
        return {k: params[k]
                for k in ("patch_embed", "cls_token", "pos_emb", "ln_pre")}
    if layer_name == "embedding":
        return {"ln_post": params["ln_post"], "proj": params["proj"]}
    return {}


def openai_block(get, pre: str) -> Params:
    """One ``resblocks.<i>`` of an OpenAI CLIP state dict in our layout
    (linear weights transposed to [D_in, D_out]); ``get(name)`` reads a
    tensor. Shared by both towers."""
    return {
        "ln1_s": get(pre + "ln_1.weight"), "ln1_b": get(pre + "ln_1.bias"),
        "qkv_w": get(pre + "attn.in_proj_weight", True),
        "qkv_b": get(pre + "attn.in_proj_bias"),
        "proj_w": get(pre + "attn.out_proj.weight", True),
        "proj_b": get(pre + "attn.out_proj.bias"),
        "ln2_s": get(pre + "ln_2.weight"), "ln2_b": get(pre + "ln_2.bias"),
        "fc1_w": get(pre + "mlp.c_fc.weight", True),
        "fc1_b": get(pre + "mlp.c_fc.bias"),
        "fc2_w": get(pre + "mlp.c_proj.weight", True),
        "fc2_b": get(pre + "mlp.c_proj.bias"),
    }


def state_dict_reader(sd: Dict[str, Any], dtype, device):
    """``get(name, transpose=False)``: the entry of ``sd`` (numpy or
    anything ``np.asarray`` takes) through f32, as a tensor of ``dtype``
    on ``device``."""
    def get(name, transpose=False):
        arr = np.asarray(sd[name], dtype=np.float32)
        # a C-ordered writable copy (order "K" would keep the transpose's
        # Fortran order, and the kernels take contiguous weights only)
        arr = np.array(arr.T if transpose else arr, order="C")
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    return get


def from_openai(sd: Dict[str, Any], cfg: CLIPVisionConfig,
                dtype=torch.float32, device="cpu") -> Params:
    """OpenAI CLIP state dict (``visual.*`` keys) -> our tree, tensors of
    ``dtype`` on ``device``."""
    get = state_dict_reader(sd, dtype, device)
    d = cfg.width
    conv = np.asarray(sd["visual.conv1.weight"], dtype=np.float32)
    return {
        "patch_embed": {"w": torch.from_numpy(np.array(
            conv.reshape(d, -1).T, order="C")).to(device=device, dtype=dtype)},
        "cls_token": get("visual.class_embedding").reshape(1, 1, d),
        "pos_emb": get("visual.positional_embedding")[None],
        "ln_pre": {"s": get("visual.ln_pre.weight"),
                   "b": get("visual.ln_pre.bias")},
        "blocks": [openai_block(get, f"visual.transformer.resblocks.{i}.")
                   for i in range(cfg.depth)],
        "ln_post": {"s": get("visual.ln_post.weight"),
                    "b": get("visual.ln_post.bias")},
        "proj": get("visual.proj"),
    }
