"""Swin Transformer as plain functions on dicts of tensors.

Counterpart of ``interactive_vit_tpu/models/swin.py``: the same configs,
parameter layout (``stages`` a list of lists of block dicts, ``merges`` a
list, linear weights ``[D_in, D_out]``, qkv columns ``[3][heads][dh]``),
per-layer functions and monolithic forward, so a JAX parameter tree
converts by a tree-map (``models/weights.from_jax``) and both packages
compute the same thing.

Activations flow NHWC ``[B, H, W, C]``: window partition and merge are
reshapes and transposes, the shifted-window roll is ``torch.roll`` with
static shifts, and the relative-position index and the seam mask are
static numpy tables (this module keeps its own copy of them). The
torchvision checkpoint converter and the training hook
(``block_wrapper``) are not ported.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from interactive_vit_tpu_torch.ops import layers as L
from interactive_vit_tpu_torch.ops.fused_window import (
    window_merge, window_partition,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    name: str
    img_size: int = 224
    patch: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: int = 4
    num_classes: int = 1000
    in_chans: int = 3
    ln_eps: float = 1e-5  # torch nn.LayerNorm default (the ViT family: 1e-6)

    def stage_res(self, s: int) -> int:
        """Feature-map side length at stage ``s`` (56/28/14/7 at 224)."""
        return self.img_size // self.patch // (2 ** s)

    def stage_dim(self, s: int) -> int:
        return self.embed_dim * (2 ** s)

    def stage_shift(self, s: int, b: int) -> int:
        """Shift of block ``b`` of stage ``s``: odd blocks shift by
        window//2, clamped to 0 when the window covers the whole map
        (stage 3 at 224 is one 7x7 window; torchvision clamps the same
        way)."""
        if b % 2 == 0 or self.window >= self.stage_res(s):
            return 0
        return self.window // 2


VARIANTS: Dict[str, SwinConfig] = {
    "swin_t": SwinConfig("swin_t", depths=(2, 2, 6, 2)),
    "swin_s": SwinConfig("swin_s", depths=(2, 2, 18, 2)),
    "swin_b": SwinConfig("swin_b", embed_dim=128, depths=(2, 2, 18, 2),
                         heads=(4, 8, 16, 32)),
}


# -- static tables -------------------------------------------------------------


def relative_position_index(window: int) -> np.ndarray:
    """[T, T] int index into the (2w-1)^2 relative-position bias table:
    for token pair (i, j) of a w x w window it encodes
    (dy + w - 1) * (2w - 1) + (dx + w - 1)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))  # [2, w, w]
    flat = coords.reshape(2, -1)  # [2, T]
    rel = flat[:, :, None] - flat[:, None, :]  # [2, T, T]
    rel = rel.transpose(1, 2, 0).astype(np.int64)  # [T, T, 2]
    rel[..., 0] += window - 1
    rel[..., 1] += window - 1
    rel[..., 0] *= 2 * window - 1
    return rel.sum(-1)  # [T, T]


def shift_attn_mask(res: int, window: int, shift: int) -> Optional[np.ndarray]:
    """Additive attention mask [nW, T, T] for shifted windows, or None.

    After rolling by -shift, windows on the bottom and right edges hold
    tokens from disconnected image regions; pairs from different regions
    get -100 (the torch implementations' value: the softmax underflows it
    to 0 in f32 and bf16), so attention never crosses the wrap seam."""
    if shift == 0:
        return None
    img = np.zeros((res, res), np.int32)
    cnt = 0
    bounds = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in bounds:
        for ws in bounds:
            img[hs, ws] = cnt
            cnt += 1
    n = res // window
    wins = img.reshape(n, window, n, window).transpose(0, 2, 1, 3)
    wins = wins.reshape(n * n, window * window)  # [nW, T]
    mask = (wins[:, None, :] != wins[:, :, None]).astype(np.float32) * -100.0
    return mask  # [nW, T, T]


@functools.lru_cache(maxsize=64)
def _bias_index(window: int, device: torch.device) -> torch.Tensor:
    """``relative_position_index`` flattened, as an index tensor on
    ``device`` (a few KB per window size and device, built once). Built
    outside inference mode, so a later caller under autograd can use the
    cached tensor too."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            relative_position_index(window).reshape(-1)).to(device)


@functools.lru_cache(maxsize=64)
def _mask_on(res: int, window: int, shift: int,
             device: torch.device) -> Optional[torch.Tensor]:
    """``shift_attn_mask`` as an f32 tensor on ``device`` (at most 0.6 MB
    per stage geometry and device, built once; outside inference mode, as
    ``_bias_index``)."""
    mask = shift_attn_mask(res, window, shift)
    if mask is None:
        return None
    with torch.inference_mode(False):
        return torch.from_numpy(mask).to(device)


# -- attention -------------------------------------------------------------------


def gather_bias(p: Params, bias_idx, t: int, heads: int) -> torch.Tensor:
    """[heads, T, T] relative-position bias from the (2w-1)^2 table, in the
    table's dtype; shared by the unfused path and the fused window kernel.
    ``bias_idx``: ``relative_position_index(window)`` as a numpy array, or
    already an index tensor on the table's device (``block`` passes a
    cached one, so serving does no host-to-device copy per block)."""
    table = p["bias_table"]
    idx = torch.as_tensor(bias_idx, device=table.device).reshape(-1)
    bias = table[idx]  # [T*T, heads]
    return bias.reshape(t, t, heads).permute(2, 0, 1)


def window_attention(
    p: Params,
    xw: torch.Tensor,
    heads: int,
    bias_idx,
    mask,
    want_attn: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """W-MSA over [B, nW, T, C] windows (the unfused path); returns
    ``(out, probs | None)`` with probs [B, nW, heads, T, T] (f32 softmax,
    emitted in the activation dtype). Torch order, as the JAX function:
    (q * scale) @ k^T + bias (+ mask) -> softmax -> @ v -> proj, with q
    scaled in the activation dtype BEFORE the dot and every product
    accumulated in f32. ``bias_idx`` as in ``gather_bias``; ``mask``: the
    [nW, T, T] seam mask (numpy array or f32 tensor) or None."""
    b, nw, t, c = xw.shape
    dh = c // heads
    qkv = L.linear(xw, p["qkv_w"], p["qkv_b"])  # [B, nW, T, 3C]
    qkv = qkv.reshape(b, nw, t, 3, heads, dh)
    q, k, v = (qkv[:, :, :, i].transpose(2, 3) for i in range(3))
    # the scale is rounded to the activation dtype first, as jnp.asarray does
    q = q * torch.tensor(dh ** -0.5, dtype=q.dtype, device=q.device)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores + gather_bias(p, bias_idx, t, heads).float()
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32, device=xw.device)
        scores = scores + mask[None, :, None]
    probs = torch.softmax(scores, dim=-1).to(xw.dtype)
    out = torch.matmul(probs.float(), v.float()).to(xw.dtype)
    out = out.transpose(2, 3).reshape(b, nw, t, c)
    out = L.linear(out, p["proj_w"], p["proj_b"])
    return out, (probs if want_attn else None)


def block(
    p: Params,
    x: torch.Tensor,
    cfg: SwinConfig,
    stage: int,
    shift: int,
    want_attn: bool = False,
    window_impl=None,
    mlp_impl=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One Swin block over [B, H, W, C]: x + W-MSA(LN(x)) then
    x + MLP(LN(x)), windows (shifted by ``shift``) inside the attention.

    Returns ``(y, probs [B, nW, heads, T, T] | None)``; probs are in the
    pre-roll window order when shifted (window w of a shifted block covers
    the rolled tile, seam pairs masked to 0).

    ``window_impl``: a fused W-MSA branch kernel
    (``ops/fused_window.fused_window_attn`` signature) that consumes the
    rolled LN'd map directly; None = the unfused path. ``mlp_impl``: a
    fused MLP-branch kernel (``ops/fused_mlp.fused_mlp_block`` signature)
    replacing LN2+fc1+GELU+fc2+residual on the map flattened to
    [B, H*W, C]."""
    res = cfg.stage_res(stage)
    if x.shape[1] != res or x.shape[2] != res:
        raise ValueError(
            f"stage {stage} expects {res}x{res} maps, got "
            f"{x.shape[1]}x{x.shape[2]}")
    if res % cfg.window:
        raise ValueError(
            f"feature map {res} not divisible by window {cfg.window}")
    y = L.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.ln_eps)
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    mask = _mask_on(res, cfg.window, shift, x.device)
    bias_idx = _bias_index(cfg.window, x.device)
    if window_impl is not None:
        bias = gather_bias(p, bias_idx, cfg.window * cfg.window,
                           cfg.heads[stage])
        a, probs = window_impl(y, p, cfg.heads[stage], cfg.window, bias,
                               mask, want_attn=want_attn)
    else:
        yw = window_partition(y, cfg.window)
        aw, probs = window_attention(p, yw, cfg.heads[stage], bias_idx,
                                     mask, want_attn=want_attn)
        a = window_merge(aw, cfg.window, res, res)
    if shift:
        a = torch.roll(a, (shift, shift), dims=(1, 2))
    x = x + a
    if mlp_impl is not None:
        # the MLP branch is row-local: the map flattens to the [B, N, C]
        # token layout the kernel takes (a view)
        b_, hh, ww, c = x.shape
        x = mlp_impl(x.reshape(b_, hh * ww, c), p,
                     eps=cfg.ln_eps).reshape(b_, hh, ww, c)
    else:
        x = x + L.mlp(
            L.layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.ln_eps), p)
    return x, probs


def patch_merging(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Downsample 2x: concat each 2x2 neighbourhood -> LN(4C) ->
    Linear(4C, 2C, no bias). Concat order (torch): (0,0), (1,0), (0,1),
    (1,1) -- row offset fastest."""
    x0 = x[:, 0::2, 0::2]
    x1 = x[:, 1::2, 0::2]
    x2 = x[:, 0::2, 1::2]
    x3 = x[:, 1::2, 1::2]
    y = torch.cat([x0, x1, x2, x3], dim=-1)
    y = L.layer_norm(y, p["ln_s"], p["ln_b"], 1e-5)
    return L.linear(y, p["w"], None)


def patch_embed(p: Params, images: torch.Tensor,
                cfg: SwinConfig) -> torch.Tensor:
    """[B, C, H, W] -> [B, H/p, W/p, D]: patchify matmul + LayerNorm.
    Activations adopt the weight dtype here, the model's single entry."""
    images = images.to(p["w"].dtype)
    if images.ndim == 3:
        images = images[None]
    x = L.patch_embed(images, p, cfg.patch)  # [B, N, D]
    g = cfg.img_size // cfg.patch
    x = x.reshape(x.shape[0], g, g, cfg.embed_dim)
    return L.layer_norm(x, p["ln_s"], p["ln_b"], cfg.ln_eps)


def final_norm(p: Params, x: torch.Tensor, cfg: SwinConfig) -> torch.Tensor:
    return L.layer_norm(x, p["s"], p["b"], cfg.ln_eps)


def global_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, C] mean pool (f32 accumulation)."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)


def head(p: Params, x: torch.Tensor) -> torch.Tensor:
    return L.linear(x, p["w"], p["b"])


# -- init ----------------------------------------------------------------------


def init_params(cfg: SwinConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> Params:
    """Random init with the JAX package's layout and scales (normal weights
    scaled by fan_in^-0.5, zero biases, a 0.02 bias table). Draws on the
    CPU from ``generator`` so a seed gives the same weights on any device;
    the numbers differ from ``jax.random``'s. ``device`` is where the
    tensors are put: callers pass it explicitly."""
    pdim = cfg.in_chans * cfg.patch * cfg.patch

    def put(t):
        return t.to(device=device, dtype=dtype)

    def normal(shape, std):
        return put(torch.randn(shape, generator=generator,
                               dtype=torch.float32) * std)

    def dense(fan_in, shape):
        return normal(shape, fan_in ** -0.5)

    def zeros(*shape):
        return put(torch.zeros(shape))

    def ones(*shape):
        return put(torch.ones(shape))

    d0 = cfg.embed_dim
    params: Params = {
        "patch_embed": {"w": dense(pdim, (pdim, d0)), "b": zeros(d0),
                        "ln_s": ones(d0), "ln_b": zeros(d0)},
        "stages": [],
        "merges": [],
        "norm": {},
        "head": {},
    }
    tbl = (2 * cfg.window - 1) ** 2
    for s, depth in enumerate(cfg.depths):
        c = cfg.stage_dim(s)
        md = c * cfg.mlp_ratio
        blocks = []
        for _ in range(depth):
            blocks.append({
                "ln1_s": ones(c), "ln1_b": zeros(c),
                "qkv_w": dense(c, (c, 3 * c)), "qkv_b": zeros(3 * c),
                "bias_table": normal((tbl, cfg.heads[s]), 0.02),
                "proj_w": dense(c, (c, c)), "proj_b": zeros(c),
                "ln2_s": ones(c), "ln2_b": zeros(c),
                "fc1_w": dense(c, (c, md)), "fc1_b": zeros(md),
                "fc2_w": dense(md, (md, c)), "fc2_b": zeros(c),
            })
        params["stages"].append(blocks)
        if s + 1 < len(cfg.depths):
            params["merges"].append({
                "ln_s": ones(4 * c), "ln_b": zeros(4 * c),
                "w": dense(4 * c, (4 * c, 2 * c)),
            })
    cf = cfg.stage_dim(len(cfg.depths) - 1)
    params["norm"] = {"s": ones(cf), "b": zeros(cf)}
    if cfg.num_classes:
        params["head"] = {"w": dense(cf, (cf, cfg.num_classes)),
                          "b": zeros(cfg.num_classes)}
    return params


# -- monolithic forward -----------------------------------------------------------


def forward(
    params: Params,
    images: torch.Tensor,
    cfg: SwinConfig,
    want_attn: bool = False,
    window_impl=None,
    mlp_impls=None,
) -> Dict[str, Any]:
    """Full forward: [B,3,H,W] -> {"logits": [B,K]} (+ "attn": a tuple of
    per-block [B, nW, heads, T, T] window maps when requested; a tuple
    because the shapes differ per stage). ``window_impl`` as in ``block``;
    ``mlp_impls``: one fused MLP kernel (or None) per stage."""
    x = patch_embed(params["patch_embed"], images, cfg)
    attns: List[torch.Tensor] = []
    for s, blocks in enumerate(params["stages"]):
        for bi, p in enumerate(blocks):
            x, probs = block(p, x, cfg, s, cfg.stage_shift(s, bi),
                             want_attn=want_attn, window_impl=window_impl,
                             mlp_impl=(mlp_impls[s] if mlp_impls else None))
            if want_attn:
                attns.append(probs)
        if s < len(params["merges"]):
            x = patch_merging(params["merges"][s], x)
    x = final_norm(params["norm"], x, cfg)
    feats = global_pool(x)
    out: Dict[str, Any] = {"logits": (head(params["head"], feats)
                                      if cfg.num_classes else feats)}
    if want_attn:
        out["attn"] = tuple(attns)
    return out


# -- graph-node decomposition -----------------------------------------------------


def layer_fns(cfg: SwinConfig, window_impl=None, mlp_impls=None):
    """The model as ordered named tappable layers (see ``vit.layer_fns``):
    transform, patch_embed, stages.{s}.{b} (extra channel "attn" =
    [B, nW, heads, T, T] window maps), merge.{s} between stages, norm,
    pool, head -- 20 nodes for swin_t. ``window_impl`` / ``mlp_impls`` as
    in ``forward``."""
    layers: List[Tuple[str, List[str], Callable]] = []

    def transform_fn(p, ins):
        from interactive_vit_tpu_torch.ops.preprocess_mm import preprocess_mm

        # torchvision's swin eval recipe: bicubic shorter-side resize to
        # 232 (not the 256/224 ImageNet default), centre crop 224
        return {"o": preprocess_mm(
            ins["o"], cfg.img_size,
            resize_to=int(cfg.img_size * 232 / 224), method="bicubic")}

    def embed_fn(p, ins):
        return {"o": patch_embed(p, ins["o"], cfg)}

    layers.append(("transform", [], transform_fn))
    layers.append(("patch_embed", [], embed_fn))

    def make_block_fn(s, b):
        shift = cfg.stage_shift(s, b)
        heads = cfg.heads[s]
        nw = (cfg.stage_res(s) // cfg.window) ** 2

        def block_fn(p, ins, want=frozenset(), node_params=None):
            y, probs = block(p, ins["o"], cfg, s, shift,
                             want_attn="attn" in want,
                             window_impl=window_impl,
                             mlp_impl=(mlp_impls[s] if mlp_impls else None))
            outs = {"o": y}
            if "attn" in want:
                # selective taps: attn_heads = JSON head list (the control
                # every transformer family shares), attn_win = one window
                # index, which collapses the tap to [B, |sel|, T, T]
                from interactive_vit_tpu_torch.models.vit import (
                    parse_attn_heads,
                )

                sel = parse_attn_heads(node_params)
                if sel is not None:
                    if any(h < 0 or h >= heads for h in sel):
                        raise ValueError(
                            f"attn_heads {sorted(sel)} out of range for "
                            f"{heads} heads")
                    probs = probs[:, :, list(sel)]
                win = (node_params or {}).get("attn_win", "")
                if win != "":
                    w = int(float(win))
                    if not 0 <= w < nw:
                        raise ValueError(
                            f"attn_win {w} out of range for {nw} windows")
                    probs = probs[:, w]
                outs["attn"] = probs
            return outs

        return block_fn

    def merge_fn(p, ins):
        return {"o": patch_merging(p, ins["o"])}

    for s, depth in enumerate(cfg.depths):
        for b in range(depth):
            layers.append((f"stages.{s}.{b}", ["attn"], make_block_fn(s, b)))
        if s + 1 < len(cfg.depths):
            layers.append((f"merge.{s}", [], merge_fn))

    def norm_fn(p, ins):
        return {"o": final_norm(p, ins["o"], cfg)}

    def pool_fn(p, ins):
        return {"o": global_pool(ins["o"])}

    layers.append(("norm", [], norm_fn))
    layers.append(("pool", [], pool_fn))
    if cfg.num_classes:
        def head_fn(p, ins):
            return {"o": head(p, ins["o"])}

        layers.append(("head", [], head_fn))
    return layers


def layer_params(params: Params, layer_name: str) -> Any:
    """Select the param subtree a named layer closes over."""
    if layer_name.startswith("stages."):
        _, s, b = layer_name.split(".")
        return params["stages"][int(s)][int(b)]
    if layer_name.startswith("merge."):
        return params["merges"][int(layer_name.split(".", 1)[1])]
    if layer_name in ("patch_embed", "norm", "head"):
        return params[layer_name]
    return {}  # transform and pool have no params
