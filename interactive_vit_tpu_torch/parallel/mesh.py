"""The qkv column layouts of the ViT parameter tree.

Counterpart of ``permute_qkv_head_major`` and ``unpermute_qkv_head_major``
in ``interactive_vit_tpu/parallel/mesh.py``. The canonical layout of every
block's fused qkv weight ``[D, 3D]`` and bias ``[3D]`` is torch's
``[3][H][dh]``; the head-major layout ``[H][3][dh]`` puts each head's q, k
and v side by side, which is what the packed train kernel
(``ops/attention_vjp.attention_train_packed``) reads. The device mesh of
the JAX module is not ported: the port trains on one card.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def _repack_w(w: torch.Tensor, heads: int, src: str) -> torch.Tensor:
    d = w.shape[0]
    dh = d // heads
    shape = (d, 3, heads, dh) if src == "canonical" else (d, heads, 3, dh)
    return w.reshape(shape).transpose(1, 2).reshape(d, 3 * d)


def _repack_b(b: torch.Tensor, heads: int, src: str) -> torch.Tensor:
    d = b.shape[0] // 3
    dh = d // heads
    shape = (3, heads, dh) if src == "canonical" else (heads, 3, dh)
    return b.reshape(shape).transpose(0, 1).reshape(3 * d)


def _repack(params: Params, heads: int, src: str) -> Params:
    out = dict(params)
    out["blocks"] = [
        {**blk,
         "qkv_w": _repack_w(blk["qkv_w"], heads, src),
         "qkv_b": _repack_b(blk["qkv_b"], heads, src)}
        for blk in params["blocks"]
    ]
    return out


def permute_qkv_head_major(params: Params, heads: int) -> Params:
    """Re-pack every block's qkv columns [3][H][dh] -> [H][3][dh] (new
    tensors; the other leaves are shared). Pair with
    ``vit.forward(..., qkv_head_major=True)``."""
    return _repack(params, heads, "canonical")


def unpermute_qkv_head_major(params: Params, heads: int) -> Params:
    """Inverse of ``permute_qkv_head_major``: [H][3][dh] -> [3][H][dh], the
    canonical layout every converter and the serving forward expect."""
    return _repack(params, heads, "head_major")
