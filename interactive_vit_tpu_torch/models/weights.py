"""Parameter conversion: torchvision / timm ViT state dicts, the native
"/"-joined naming, and the JAX package's parameter trees.

The two packages share one parameter layout (``models/vit.py`` and
``models/swin.py``: linear weights ``[D_in, D_out]``, qkv columns
``[3][H][dh]``, dicts and lists of leaves), so conversion is a tree-map of
numpy arrays to tensors. The Swin tree nests further than the ViT one
(``stages`` is a list of lists of block dicts, ``merges`` a list, and a
headless config's ``head`` is an empty dict); the map keeps every
container as it is. The JAX
package's own converters (torchvision, timm, safetensors) produce that
tree, and this is the one bridge the tests use to make both packages
compute the same thing. A quantized tree (``ops/quant.quantize_tree``)
maps one to one too: its leaf-dicts carry the same keys in both.

The state-dict converters are the port's copies of the JAX package's
(``interactive_vit_tpu/models/weights.py``): ``from_torchvision`` and
``from_timm`` take ``{name: array}`` (numpy, or anything ``np.asarray``
takes), read each leaf as f32 on the host and give a tensor of ``dtype`` on
``device`` (the CPU default is a staging place; a loader that serves passes
its own device). ``to_torchvision`` and ``to_native_flat`` take the port's
tree and return numpy. Conventions: our linear weights are ``[D_in,
D_out]`` (torch stores ``[D_out, D_in]``, so they transpose), qkv columns
are packed q|k|v as torch MHA's ``in_proj_weight`` rows, and the patch
kernel ``[D, C, p, p]`` reshapes to ``[C*p*p, D]``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from interactive_vit_tpu_torch.ops.quant import AQKEY, ASKEY, QKEY, SKEY

_INT8_KEYS = {QKEY: torch.int8, AQKEY: torch.int8, SKEY: torch.float32,
              ASKEY: torch.float32}


def _int8_leaf(v: Any, key: str, device) -> torch.Tensor:
    """An int8 leaf-dict's weight (int8) or column scale (f32), unchanged."""
    arr = np.array(v, dtype=np.int8 if _INT8_KEYS[key] == torch.int8
                   else np.float32)
    return torch.from_numpy(arr).to(device)


def from_jax(params_np: Any, device="cpu", dtype=torch.float32) -> Any:
    """Map a JAX ViT or Swin parameter tree (leaves as numpy arrays, or
    anything ``np.asarray`` takes) to tensors on ``device`` in ``dtype``.

    Leaves go through f32 on the host, so bf16 numpy leaves (``ml_dtypes``)
    convert exactly. Callers pass ``device`` explicitly; the CPU default is
    a staging place (the tests' CPU path), not where a model serves.

    Int8 leaf-dicts (``ops/quant.py``) keep their types: the int8 weight
    as ``torch.int8``, its column scale as f32, whatever ``dtype`` is."""
    if isinstance(params_np, dict):
        return {k: (_int8_leaf(v, k, device) if k in _INT8_KEYS
                    else from_jax(v, device, dtype))
                for k, v in params_np.items()}
    if isinstance(params_np, (list, tuple)):
        return type(params_np)(from_jax(v, device, dtype) for v in params_np)
    arr = np.array(params_np, dtype=np.float32)  # a writable copy
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


# -- torchvision / timm state dicts -------------------------------------------


def _reader(sd: Dict[str, Any], dtype, device):
    """``get(name, transpose=False)``: the entry as f32 on the host, then a
    tensor of ``dtype`` on ``device``; a missing name raises KeyError."""
    def get(name, transpose=False):
        if name not in sd:
            raise KeyError(f"state dict missing {name!r}")
        arr = np.asarray(sd[name], dtype=np.float32)
        # a C-ordered writable copy (order "K" would keep the transpose's
        # Fortran order, and the kernels take contiguous weights only)
        arr = np.array(arr.T if transpose else arr, order="C")
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    return get


def _patch_kernel(get, name: str, d: int) -> torch.Tensor:
    """A conv patch kernel [D, C, p, p] as the patchify matrix [C*p*p, D]."""
    w = get(name)
    return w.reshape(d, -1).t().contiguous()


def from_torchvision(sd: Dict[str, Any], cfg, dtype=torch.float32,
                     device="cpu"):
    """torchvision ``vit_b_16``-style state dict -> our tree."""
    get = _reader(sd, dtype, device)
    params = {
        "patch_embed": {"w": _patch_kernel(get, "conv_proj.weight",
                                           cfg.width),
                        "b": get("conv_proj.bias")},
        "cls_token": get("class_token"),
        "pos_emb": get("encoder.pos_embedding"),
        "blocks": [],
        "norm": {"s": get("encoder.ln.weight"),
                 "b": get("encoder.ln.bias")},
        "head": ({"w": get("heads.head.weight", True),
                  "b": get("heads.head.bias")} if cfg.num_classes else {}),
    }
    for i in range(cfg.depth):
        pre = f"encoder.layers.encoder_layer_{i}."
        params["blocks"].append({
            "ln1_s": get(pre + "ln_1.weight"),
            "ln1_b": get(pre + "ln_1.bias"),
            "qkv_w": get(pre + "self_attention.in_proj_weight", True),
            "qkv_b": get(pre + "self_attention.in_proj_bias"),
            "proj_w": get(pre + "self_attention.out_proj.weight", True),
            "proj_b": get(pre + "self_attention.out_proj.bias"),
            "ln2_s": get(pre + "ln_2.weight"),
            "ln2_b": get(pre + "ln_2.bias"),
            "fc1_w": get(pre + "mlp.0.weight", True),
            "fc1_b": get(pre + "mlp.0.bias"),
            "fc2_w": get(pre + "mlp.3.weight", True),
            "fc2_b": get(pre + "mlp.3.bias"),
        })
    return params


def _np(t) -> np.ndarray:
    """A leaf as an f32 numpy array on the host."""
    return np.asarray(_leaf_np(t), dtype=np.float32)


def _leaf_np(node) -> np.ndarray:
    """A leaf as numpy in its own dtype, a copy on the host; a bf16 tensor
    as exact f32 (numpy has no bfloat16)."""
    if isinstance(node, torch.Tensor):
        t = node.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(node)


def to_torchvision(params, cfg) -> Dict[str, np.ndarray]:
    """Our tree -> torchvision-naming state dict (numpy f32). Inverse of
    ``from_torchvision``."""
    d, p, c = cfg.width, cfg.patch, cfg.in_chans
    sd: Dict[str, np.ndarray] = {
        "conv_proj.weight": np.ascontiguousarray(
            _np(params["patch_embed"]["w"]).T.reshape(d, c, p, p)),
        "conv_proj.bias": _np(params["patch_embed"]["b"]),
        "class_token": _np(params["cls_token"]),
        "encoder.pos_embedding": _np(params["pos_emb"]),
        "encoder.ln.weight": _np(params["norm"]["s"]),
        "encoder.ln.bias": _np(params["norm"]["b"]),
    }
    if "w" in (params.get("head") or {}):
        sd["heads.head.weight"] = np.ascontiguousarray(
            _np(params["head"]["w"]).T)
        sd["heads.head.bias"] = _np(params["head"]["b"])
    names = (("ln_1.weight", "ln1_s", False), ("ln_1.bias", "ln1_b", False),
             ("self_attention.in_proj_weight", "qkv_w", True),
             ("self_attention.in_proj_bias", "qkv_b", False),
             ("self_attention.out_proj.weight", "proj_w", True),
             ("self_attention.out_proj.bias", "proj_b", False),
             ("ln_2.weight", "ln2_s", False), ("ln_2.bias", "ln2_b", False),
             ("mlp.0.weight", "fc1_w", True), ("mlp.0.bias", "fc1_b", False),
             ("mlp.3.weight", "fc2_w", True), ("mlp.3.bias", "fc2_b", False))
    for i, blk in enumerate(params["blocks"]):
        pre = f"encoder.layers.encoder_layer_{i}."
        for tv_name, ours, transpose in names:
            arr = _np(blk[ours])
            sd[pre + tv_name] = np.ascontiguousarray(arr.T) if transpose \
                else arr
    return sd


def from_timm(sd: Dict[str, Any], cfg, dtype=torch.float32, device="cpu"):
    """timm ``vit_*_patch*`` naming -> our tree: ``cls_token`` [1,1,D],
    ``pos_embed`` [1,N+1,D], fused ``blocks.i.attn.qkv``,
    ``blocks.i.mlp.fc1/fc2``, the conv ``patch_embed.proj``; DeiT's
    distillation token and head, DINOv2's register tokens and LayerScale
    gammas where the config has them."""
    get = _reader(sd, dtype, device)
    params = {
        "patch_embed": {"w": _patch_kernel(get, "patch_embed.proj.weight",
                                           cfg.width),
                        "b": get("patch_embed.proj.bias")},
        "cls_token": get("cls_token"),
        "pos_emb": get("pos_embed"),
        "blocks": [],
        "norm": {"s": get("norm.weight"), "b": get("norm.bias")},
        # DINO / self-supervised timm checkpoints ship no classifier head
        "head": ({"w": get("head.weight", True), "b": get("head.bias")}
                 if cfg.num_classes else {}),
    }
    if getattr(cfg, "distilled", False):
        params["dist_token"] = get("dist_token")
        if cfg.num_classes:
            params["head_dist"] = {"w": get("head_dist.weight", True),
                                   "b": get("head_dist.bias")}
    if getattr(cfg, "registers", 0):
        # some reg checkpoints store a pos table of grid rows only
        # (no_embed_class): a zero CLS row is the same model, and keeps the
        # [CLS-row, grid-rows] convention
        params["reg_tokens"] = get("reg_token")
        pe = params["pos_emb"]
        grid = (cfg.img_size // cfg.patch) ** 2
        if pe.shape[1] == grid:
            params["pos_emb"] = torch.cat(
                [torch.zeros((1, 1, pe.shape[2]), dtype=pe.dtype,
                             device=pe.device), pe], dim=1)
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        blk = {
            "ln1_s": get(pre + "norm1.weight"),
            "ln1_b": get(pre + "norm1.bias"),
            "qkv_w": get(pre + "attn.qkv.weight", True),
            "qkv_b": get(pre + "attn.qkv.bias"),
            "proj_w": get(pre + "attn.proj.weight", True),
            "proj_b": get(pre + "attn.proj.bias"),
            "ln2_s": get(pre + "norm2.weight"),
            "ln2_b": get(pre + "norm2.bias"),
            "fc1_w": get(pre + "mlp.fc1.weight", True),
            "fc1_b": get(pre + "mlp.fc1.bias"),
            "fc2_w": get(pre + "mlp.fc2.weight", True),
            "fc2_b": get(pre + "mlp.fc2.bias"),
        }
        if getattr(cfg, "layer_scale", 0.0):
            blk["ls1"] = get(pre + "ls1.gamma")
            blk["ls2"] = get(pre + "ls2.gamma")
        params["blocks"].append(blk)
    return params


# -- native flat layout -------------------------------------------------------
# The framework's own safetensors naming: tree paths joined with "/"
# ("blocks/0/qkv_w", "patch_embed/w", ...), the JAX package's. The trainer's
# --export-safetensors writes it and the server's --ckpt sniffs it (keys
# holding "/"), in both packages.


def to_native_flat(params, keep_bf16: bool = False
                   ) -> Dict[str, np.ndarray]:
    """Flatten a tree to {path: numpy array} with "/"-joined keys. Empty
    containers flatten to nothing; Python scalars to 0-d arrays.
    ``keep_bf16``: a bf16 leaf stays a host ``torch.bfloat16`` tensor (which
    ``utils/safetensors_io.save_file`` writes as its bits under the BF16
    tag) instead of its exact f32 upcast."""
    out: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}" if prefix else str(i), v)
        elif (keep_bf16 and isinstance(node, torch.Tensor)
              and node.dtype == torch.bfloat16):
            out[prefix] = node.detach().to("cpu", copy=True)
        else:
            out[prefix] = _leaf_np(node)

    walk("", params)
    return out


def from_native_flat(sd: Dict[str, Any], dtype=torch.float32, device="cpu"):
    """Rebuild the tree from "/"-joined keys (all-digit keys -> list
    positions): floating leaves as f32 on the host, then tensors of
    ``dtype`` on ``device``; other leaves keep their dtype. Inverse of
    ``to_native_flat`` up to empty containers (a headless ViT's ``head``
    flattens to nothing: ``tools/convert.convert`` puts the known optional
    ones back)."""
    root: Dict[str, Any] = {}
    for key, val in sd.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"native key conflict at {key!r}")
        arr = np.asarray(val)
        if np.issubdtype(arr.dtype, np.floating):
            leaf = torch.from_numpy(np.array(arr, dtype=np.float32)).to(
                device=device, dtype=dtype)
        else:
            leaf = torch.from_numpy(np.array(arr)).to(device)
        node[parts[-1]] = leaf

    def densify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            idx = sorted(node, key=int)
            if [int(k) for k in idx] != list(range(len(idx))):
                raise ValueError("native list keys are not contiguous")
            return [densify(node[k]) for k in idx]
        return {k: densify(v) for k, v in node.items()}

    return densify(root)
