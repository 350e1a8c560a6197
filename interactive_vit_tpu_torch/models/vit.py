"""Vision Transformer as plain functions on dicts of tensors.

Counterpart of ``interactive_vit_tpu/models/vit.py``: the same configs,
parameter layout (linear weights ``[D_in, D_out]``, qkv columns
``[3][H][dh]``), per-layer functions and monolithic forward, so a JAX
parameter tree converts by a tree-map (``models/weights.from_jax``) and
both packages compute the same thing, including the
``@<pixels>p<patch>`` geometries (``resolve_variant``) and the adaptation
of a native checkpoint to them (``adapt_checkpoint``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from interactive_vit_tpu_torch.models.model_plugin import image_entry
from interactive_vit_tpu_torch.ops import attention as attn_ops
from interactive_vit_tpu_torch.ops import layers as L

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str
    img_size: int = 224
    patch: int = 16
    width: int = 192
    depth: int = 12
    heads: int = 3
    mlp_ratio: int = 4
    num_classes: int = 1000
    in_chans: int = 3
    ln_eps: float = 1e-6
    # DeiT: a second learned prefix token; heads average at inference
    distilled: bool = False
    # DINOv2-reg: pos-free register tokens inserted after CLS
    registers: int = 0
    # DINOv2 LayerScale init (0 = off); such blocks run the unfused path
    layer_scale: float = 0.0

    def __post_init__(self):
        if self.distilled and self.registers:
            raise ValueError(
                f"{self.name}: distilled + registers is not a published "
                f"configuration (head_dist reads token 1, which a "
                f"register would occupy)")

    @property
    def prefix_tokens(self) -> int:
        return (2 if self.distilled else 1) + self.registers

    @property
    def tokens(self) -> int:
        return (self.img_size // self.patch) ** 2 + self.prefix_tokens

    @property
    def pos_tokens(self) -> int:
        """Rows of the position table: CLS(+DIST) + patch grid."""
        return self.tokens - self.registers

    @property
    def mlp_dim(self) -> int:
        return self.width * self.mlp_ratio


VARIANTS: Dict[str, ViTConfig] = {
    "vit_t16": ViTConfig("vit_t16", 224, 16, 192, 12, 3),
    "vit_s16": ViTConfig("vit_s16", 224, 16, 384, 12, 6),
    "vit_b16": ViTConfig("vit_b16", 224, 16, 768, 12, 12),
    "vit_b32": ViTConfig("vit_b32", 224, 32, 768, 12, 12),
    "vit_l16": ViTConfig("vit_l16", 384, 16, 1024, 24, 16),
    "vit_h14": ViTConfig("vit_h14", 224, 14, 1280, 32, 16),
    "dino_s16": ViTConfig("dino_s16", 224, 16, 384, 12, 6, num_classes=0),
    "dino_s8": ViTConfig("dino_s8", 224, 8, 384, 12, 6, num_classes=0),
    "dino_b16": ViTConfig("dino_b16", 224, 16, 768, 12, 12, num_classes=0),
    "deit_t16": ViTConfig("deit_t16", 224, 16, 192, 12, 3, distilled=True),
    "deit_s16": ViTConfig("deit_s16", 224, 16, 384, 12, 6, distilled=True),
    "deit_b16": ViTConfig("deit_b16", 224, 16, 768, 12, 12, distilled=True),
    "dinov2_s14": ViTConfig("dinov2_s14", 518, 14, 384, 12, 6,
                            num_classes=0, layer_scale=1e-5),
    "dinov2_b14": ViTConfig("dinov2_b14", 518, 14, 768, 12, 12,
                            num_classes=0, layer_scale=1e-5),
    "dinov2_s14_reg": ViTConfig("dinov2_s14_reg", 518, 14, 384, 12, 6,
                                num_classes=0, layer_scale=1e-5,
                                registers=4),
    "dinov2_b14_reg": ViTConfig("dinov2_b14_reg", 518, 14, 768, 12, 12,
                                num_classes=0, layer_scale=1e-5,
                                registers=4),
}


def resolve_variant(name: str) -> ViTConfig:
    """``"vit_b16"``, ``"vit_b16@384"``, ``"vit_b16@p8"`` or
    ``"vit_b16@384p32"`` -> config. The ``@[<pixels>][p<patch>]`` suffix
    serves a known variant at another resolution and/or patch size; width,
    depth and heads are unchanged, and a checkpoint of the native geometry
    adapts on load (``adapt_checkpoint``). The very ``VARIANTS`` entry comes
    back when the suffix changes nothing. Errors as the JAX function's."""
    base, sep, suffix = name.partition("@")
    if base not in VARIANTS:
        raise ValueError(
            f"unknown ViT variant {base!r}; known: {sorted(VARIANTS)}")
    cfg = VARIANTS[base]
    if sep:
        res, psep, patch = suffix.partition("p")
        ok = (res.isdigit() or (not res and psep)) \
            and (patch.isdigit() or not psep)
        if not ok:
            raise ValueError(
                f"bad resolution suffix in {name!r}: expected "
                f"<variant>@<pixels>, <variant>@p<patch>, or "
                f"<variant>@<pixels>p<patch> (e.g. vit_b16@384, "
                f"dino_s16@p8, vit_b16@384p32)")
        img = int(res) if res else cfg.img_size
        p = int(patch) if psep else cfg.patch
        if img % p:
            raise ValueError(
                f"{name!r}: resolution {img} must be a multiple of the "
                f"patch size {p}")
        if (img, p) != (cfg.img_size, cfg.patch):
            cfg = dataclasses.replace(cfg, name=f"{base}@{suffix}",
                                      img_size=img, patch=p)
    return cfg


def adapt_pos_embed(params: Params, cfg: ViTConfig) -> Params:
    """Resample a checkpoint's position table to ``cfg``'s grid.

    timm's ``resample_abs_pos_embed`` construction: the prefix rows (CLS,
    DIST; registers carry no position) pass through, the grid part is
    resampled bicubically per side with ``preprocess_mm.resize_matrix``,
    in f32, and cast back. Identity when the token count already matches."""
    pe = params["pos_emb"]
    if pe.shape[1] == cfg.pos_tokens:
        return params
    from interactive_vit_tpu_torch.ops.preprocess_mm import resize_matrix

    prefix = cfg.prefix_tokens - cfg.registers
    d = pe.shape[2]
    g_sq = pe.shape[1] - prefix
    g_old = int(round(g_sq ** 0.5))
    if g_old * g_old != g_sq:
        raise ValueError(
            f"cannot adapt pos_emb of {pe.shape[1]} tokens to "
            f"{cfg.name}: grid part ({g_sq} rows after {prefix} prefix "
            f"tokens) is not square")
    g_new = cfg.img_size // cfg.patch
    r = torch.from_numpy(resize_matrix(g_old, g_new, "bicubic").copy()).to(
        pe.device)
    grid = pe[0, prefix:].float().reshape(g_old, g_old, d)
    grid = torch.einsum("sh,hwd->swd", r, grid)
    grid = torch.einsum("tw,swd->std", r, grid)
    new_pe = torch.cat([pe[:, :prefix].float(),
                        grid.reshape(1, g_new * g_new, d)], dim=1)
    return {**params, "pos_emb": new_pe.to(pe.dtype)}


def adapt_patch_embed(params: Params, cfg: ViTConfig) -> Params:
    """FlexiViT pseudo-inverse resize of the patch-embedding kernel (Beyer
    et al. 2023): with ``B`` the bilinear patch resize p0 -> p1, the new
    kernel is ``(B^+)^T w``, applied per spatial axis, in host numpy as
    the JAX function does. Identity when the patch size already matches;
    refuses a quantized kernel (adapt before quantizing)."""
    pe = params["patch_embed"]
    w = pe["w"]
    if not isinstance(w, torch.Tensor):
        raise ValueError("adapt_patch_embed needs float weights "
                         "(load/adapt the checkpoint before quantizing)")
    import numpy as np

    c = cfg.in_chans
    pdim, d = w.shape
    p0 = int(round((pdim // c) ** 0.5))
    if c * p0 * p0 != pdim:
        raise ValueError(
            f"patch_embed rows {pdim} are not {c} x p x p -- cannot "
            f"infer the checkpoint's patch size")
    if p0 == cfg.patch:
        return params
    from interactive_vit_tpu_torch.ops.preprocess_mm import resize_matrix

    r = resize_matrix(p0, cfg.patch, "bilinear")        # [p1, p0]
    pinv_t = np.linalg.pinv(r).T.astype(np.float32)     # [p1, p0]
    w4 = w.detach().to("cpu", torch.float32).numpy().reshape(c, p0, p0, d)
    w_new = np.einsum("ai,bj,cijd->cabd", pinv_t, pinv_t, w4,
                      optimize=True)
    w_new = torch.from_numpy(np.ascontiguousarray(
        w_new.reshape(c * cfg.patch * cfg.patch, d), dtype=np.float32))
    return {**params, "patch_embed": {
        "w": w_new.to(device=w.device, dtype=w.dtype), "b": pe["b"]}}


def adapt_checkpoint(params: Params, cfg: ViTConfig) -> Params:
    """Adapt a plain-ViT checkpoint of the native geometry to a derived
    ``@<pixels>p<patch>`` config: the patch kernel first, then the position
    table to the resulting grid. Identity when nothing changed."""
    return adapt_pos_embed(adapt_patch_embed(params, cfg), cfg)


# -- init ----------------------------------------------------------------------


def init_params(cfg: ViTConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> Params:
    """Random init with the JAX package's layout and scales (normal weights
    scaled by fan_in^-0.5, zero biases, 0.02 position table). Draws on the
    CPU from ``generator`` so a seed gives the same weights on any device;
    the numbers differ from ``jax.random``'s. ``device`` is where the
    tensors are put: callers pass it explicitly (the model plugin passes
    its serving device); the CPU default is a staging place only."""
    d, md = cfg.width, cfg.mlp_dim
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

    params: Params = {
        "patch_embed": {"w": dense(pdim, (pdim, d)), "b": zeros(d)},
        "cls_token": zeros(1, 1, d),
        "pos_emb": normal((1, cfg.pos_tokens, d), 0.02),
        "blocks": [],
        "norm": {"s": ones(d), "b": zeros(d)},
        "head": ({"w": dense(d, (d, cfg.num_classes)),
                  "b": zeros(cfg.num_classes)} if cfg.num_classes else {}),
    }
    if cfg.distilled:
        params["dist_token"] = zeros(1, 1, d)
        if cfg.num_classes:
            params["head_dist"] = {"w": dense(d, (d, cfg.num_classes)),
                                   "b": zeros(cfg.num_classes)}
    if cfg.registers:
        params["reg_tokens"] = normal((1, cfg.registers, d), 0.02)
    for _ in range(cfg.depth):
        blk = {
            "ln1_s": ones(d), "ln1_b": zeros(d),
            "qkv_w": dense(d, (d, 3 * d)), "qkv_b": zeros(3 * d),
            "proj_w": dense(d, (d, d)), "proj_b": zeros(d),
            "ln2_s": ones(d), "ln2_b": zeros(d),
            "fc1_w": dense(d, (d, md)), "fc1_b": zeros(md),
            "fc2_w": dense(md, (md, d)), "fc2_b": zeros(d),
        }
        if cfg.layer_scale:
            blk["ls1"] = put(torch.full((d,), cfg.layer_scale))
            blk["ls2"] = put(torch.full((d,), cfg.layer_scale))
        params["blocks"].append(blk)
    return params


# -- per-layer functions -------------------------------------------------------


def embed(params: Params, images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Patch-embed + CLS + position embeddings: [B,C,H,W] -> [B,N,D].
    Activations adopt the weight dtype here, the model's single entry."""
    pe = params["patch_embed"]
    images = images.to(pe["w"].dtype)
    x = L.patch_embed(images, pe, cfg.patch)
    prefix = params["cls_token"]
    if "dist_token" in params:
        prefix = torch.cat([prefix, params["dist_token"].to(prefix.dtype)],
                           dim=1)
    x = L.add_cls_and_pos(x, prefix, params["pos_emb"])
    if "reg_tokens" in params:
        regs = params["reg_tokens"].to(x.dtype).expand(
            x.shape[0], *params["reg_tokens"].shape[1:])
        x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
    return x


def block(
    p: Params,
    x: torch.Tensor,
    cfg: ViTConfig,
    want_attn: bool = False,
    attn_impl=None,
    n_real: Optional[int] = None,
    block_impl=None,
    mlp_impl=None,
    want_mean: bool = False,
    qkv_head_major: bool = False,
    attn_heads=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Pre-LN transformer block; returns ``(y, probs, mean)``.

    probs [B,H|sel,N,N] when ``want_attn``; mean [B,N,N] head-meaned maps
    (the rollout's input) when ``want_mean``. ``block_impl``: a fused
    attention-branch kernel (``ops/fused_block.fused_attn_block``
    signature) replacing LN1+QKV+attention+proj+residual. ``mlp_impl``: a
    fused MLP-branch kernel (``ops/fused_mlp.fused_mlp_block`` signature)
    replacing LN2+fc1+GELU+fc2+residual. ``attn_impl``: the attention of
    the unfused path (``ops/attention.mhsa``)."""
    pmean = None
    if qkv_head_major and block_impl is not None:
        raise ValueError("qkv_head_major is incompatible with fused block "
                         "kernels (mesh serving disables them)")
    if "ls1" in p and (block_impl is not None or mlp_impl is not None):
        # the fused kernels bake in the plain residual add
        raise ValueError("LayerScale blocks (DINOv2) require the unfused "
                         "block path (dispatch disables fused kernels for "
                         "layer_scale configs)")
    if n_real is not None and block_impl is not None:
        raise ValueError("padded-domain execution (n_real) is not "
                         "supported by the fused block kernels; use the "
                         "unfused path, which masks keys")
    sel = (tuple(sorted(set(int(h) for h in attn_heads)))
           if attn_heads is not None else None)
    if sel is not None and any(h < 0 or h >= cfg.heads for h in sel):
        raise ValueError(
            f"attn_heads {sorted(sel)} out of range for {cfg.heads} heads")
    if block_impl is not None:
        kw = {"attn_heads": sel} if sel is not None else {}
        if want_mean:
            x, probs, pmean = block_impl(x, p, cfg.heads, cfg.ln_eps,
                                         want_attn, want_mean=True, **kw)
        else:
            x, probs = block_impl(x, p, cfg.heads, cfg.ln_eps, want_attn,
                                  **kw)
    else:
        h, probs = attn_ops.mhsa(
            L.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.ln_eps),
            p, cfg.heads, want_attn=want_attn or want_mean, n_real=n_real,
            head_major=qkv_head_major, attn_impl=attn_impl,
        )
        if "ls1" in p:
            h = h * p["ls1"].to(h.dtype)
        x = x + h
        if want_mean and probs is not None:
            # f32 head-mean, emitted in the maps' own dtype
            pmean = probs.float().mean(dim=1).to(probs.dtype)
        if not want_attn:
            probs = None
        elif sel is not None and probs is not None:
            probs = probs.index_select(1, L.index_on(tuple(sel),
                                                     probs.device))
    if mlp_impl is not None:
        return mlp_impl(x, p, cfg.ln_eps), probs, pmean
    m = L.mlp(L.layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.ln_eps), p)
    if "ls2" in p:
        m = m * p["ls2"].to(m.dtype)
    return x + m, probs, pmean


def final_norm(params: Params, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    return L.layer_norm(x, params["norm"]["s"], params["norm"]["b"], cfg.ln_eps)


def head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Classifier on the CLS token: [B,N,D] -> [B,num_classes]. Feature
    extractors (no head weights) emit the CLS token; distilled variants
    average the class and distillation heads."""
    hp = params.get("head") or {}
    if "w" not in hp:
        return x[:, 0]
    logits = L.linear(x[:, 0], hp["w"], hp["b"])
    hd = params.get("head_dist") or {}
    if "w" in hd:
        logits = (logits + L.linear(x[:, 1], hd["w"], hd["b"])) * 0.5
    return logits


# -- monolithic forward ---------------------------------------------------------


def forward(
    params: Params,
    images: torch.Tensor,
    cfg: ViTConfig,
    want_attn: bool = False,
    want_cls_trajectory: bool = False,
    attn_impl=None,
    block_impl=None,
    mlp_impl=None,
    attn_heads=None,
    qkv_head_major: bool = False,
    block_wrapper=None,
) -> Dict[str, Any]:
    """Full forward with optional taps.

    Returns {"logits": [B,K]} plus, when requested, "attn" (a tuple of
    per-layer [B,H|sel,N,N] maps in the activation dtype), "rollout"
    [B,N,N] and "cls" [L+1,B,D]. An empty ``attn_heads`` means
    rollout-only.

    ``qkv_head_major``: the qkv columns are ``[H][3][dh]``
    (``parallel/mesh.permute_qkv_head_major``). ``block_wrapper``: the
    training hook; each block runs as one ``(p, x) -> x`` unit wrapped by
    it (``parallel/train.remat_wrapper``), so the trained trunk is this
    one. Taps do not compose with it."""
    x = embed(params, images, cfg)
    if block_wrapper is not None:
        if want_attn or want_cls_trajectory:
            raise ValueError("block_wrapper requires taps off")

        def one(p, x):
            y, _, _ = block(p, x, cfg, attn_impl=attn_impl,
                            block_impl=block_impl, mlp_impl=mlp_impl,
                            qkv_head_major=qkv_head_major)
            return y

        one = block_wrapper(one)
        for p in params["blocks"]:
            x = one(p, x)
        return {"logits": head(
            params, final_norm(params, x[:, : cfg.prefix_tokens], cfg))}
    n_real = x.shape[1]
    attns: List[torch.Tensor] = []
    means: List[torch.Tensor] = []
    cls_traj: List[torch.Tensor] = [x[:, 0]]
    want_probs = want_attn and (attn_heads is None or len(attn_heads) > 0)
    for p in params["blocks"]:
        x, probs, pmean = block(
            p, x, cfg, want_attn=want_probs, attn_impl=attn_impl,
            block_impl=block_impl, mlp_impl=mlp_impl, want_mean=want_attn,
            attn_heads=attn_heads if want_probs else None,
            qkv_head_major=qkv_head_major,
        )
        if want_probs:
            attns.append(probs[..., :n_real, :n_real].to(x.dtype))
        if want_attn:
            means.append(pmean[..., :n_real, :n_real])
        if want_cls_trajectory:
            cls_traj.append(x[:, 0])
    out: Dict[str, Any] = {
        "logits": head(
            params, final_norm(params, x[:, : cfg.prefix_tokens], cfg))
    }
    if want_attn:
        if want_probs:
            out["attn"] = tuple(attns)
        out["rollout"] = attn_ops.attention_rollout(means)
    if want_cls_trajectory:
        out["cls"] = torch.stack(cls_traj)
    return out


# -- graph-node decomposition ---------------------------------------------------


def parse_attn_heads(node_params) -> Optional[Tuple[int, ...]]:
    """attn_heads node param -> head tuple, or None for all heads ("[]"
    and "" also mean all heads)."""
    if node_params and node_params.get("attn_heads"):
        parsed = json.loads(node_params["attn_heads"])
        return tuple(int(h) for h in parsed) if parsed else None
    return None


def rollout_carry(pmean: torch.Tensor, ins, x: torch.Tensor) -> torch.Tensor:
    """The "r" channel: r_out = rollout_step(head_mean, r_in); an unwired r
    input means identity (this is the first tapped block)."""
    b, n = x.shape[0], x.shape[1]
    r_in = ins.get("r")
    if r_in is None:
        r_in = torch.eye(n, dtype=torch.float32,
                         device=x.device).expand(b, n, n)
    return attn_ops.rollout_step(pmean, r_in).to(x.dtype)


def layer_fns(cfg: ViTConfig, attn_impl=None, block_impl=None,
              mlp_impl=None):
    """The model as an ordered list of ``(layer_name, extra_out_channels,
    fn(params_subtree, ins) -> outs)``; channel "o" carries the flowing
    activation, the block extras "attn", "r" and "cls" carry taps.
    ``attn_impl`` / ``block_impl`` / ``mlp_impl`` as in ``block``."""
    layers: List[Tuple[str, List[str], Callable]] = []

    def transform_fn(p, ins):
        from interactive_vit_tpu_torch.ops.preprocess_mm import preprocess_mm

        return {"o": preprocess_mm(ins["o"], cfg.img_size)}

    def embed_fn(p, ins):
        x = ins["o"]
        if x.ndim == 3:  # unbatched [C,H,W] input gets a batch dim
            x = x[None]
        return {"o": embed(p, x, cfg)}

    layers.append(("transform", [], image_entry(transform_fn, True)))
    layers.append(("embed", [], image_entry(embed_fn, False)))

    def block_fn(p, ins, want=frozenset(), node_params=None):
        x = ins["o"]
        sel = parse_attn_heads(node_params)
        y, probs, pmean = block(
            p, x, cfg, want_attn="attn" in want, attn_impl=attn_impl,
            block_impl=block_impl, mlp_impl=mlp_impl, want_mean="r" in want,
            attn_heads=sel,
        )
        outs = {"o": y}
        if probs is not None and "attn" in want:
            outs["attn"] = probs
        if "r" in want:
            outs["r"] = rollout_carry(pmean, ins, x)
        if "cls" in want:
            outs["cls"] = y[:, 0]
        return outs

    for i in range(cfg.depth):
        layers.append((f"blocks.{i}", ["attn", "r", "cls"], block_fn))

    def norm_fn(p, ins):
        return {"o": final_norm({"norm": p}, ins["o"], cfg)}

    def head_fn(p, ins):
        return {"o": head(p if "head" in p else {"head": p}, ins["o"])}

    layers.append(("norm", [], norm_fn))
    layers.append(("head", [], head_fn))
    return layers


def layer_params(params: Params, layer_name: str) -> Any:
    """Select the param subtree a named layer closes over."""
    if layer_name.startswith("blocks."):
        return params["blocks"][int(layer_name.split(".", 1)[1])]
    if layer_name == "embed":
        sub = {k: params[k] for k in ("patch_embed", "cls_token", "pos_emb")}
        for k in ("dist_token", "reg_tokens"):
            if k in params:
                sub[k] = params[k]
        return sub
    if layer_name == "norm":
        return params["norm"]
    if layer_name == "head":
        if "head_dist" in params:
            return {"head": params["head"], "head_dist": params["head_dist"]}
        return params["head"]
    return {}  # transform has no params
