"""Multi-head self-attention with attention-map taps, in plain PyTorch.

Counterpart of ``interactive_vit_tpu/ops/attention.py``: the unfused
reference path (f32 logits and softmax, probs returned in f32 when asked)
and attention rollout over the head-meaned maps.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from interactive_vit_tpu_torch.ops.layers import (
    linear, merge_last, split_last,
)

Params = Dict[str, torch.Tensor]


def qkv_proj(x: torch.Tensor, p: Params, heads: int, head_major: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused QKV projection -> per-head tensors [B, H, N, Dh].

    The weight columns are packed [3][H][Dh] (torch-compatible), or
    [H][3][Dh] with ``head_major=True``."""
    b, n, d = x.shape
    dh = d // heads
    qkv = linear(x, p["qkv_w"], p["qkv_b"])
    if head_major:
        qkv = split_last(qkv, heads, 3, dh)
        return tuple(qkv[:, :, :, i].transpose(1, 2) for i in range(3))
    qkv = split_last(qkv, 3, heads, dh)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on [B, H, ...]. A DTensor (heads sharded over a mesh's
    model axis) multiplies heads first: the batched product flattens its
    two leading dims, and a flatten whose shard is on the second dim is a
    view some torch versions' DTensor refuses."""
    if getattr(a, "placements", None) is None:
        return torch.matmul(a, b)
    return torch.matmul(a.transpose(0, 1), b.transpose(0, 1)).transpose(0, 1)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    want_attn: bool = False,
    n_real: Optional[int] = None,
    key_bias: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """softmax(q k^T / sqrt(dh)) v with f32 softmax, inputs [B, H, N, Dh].

    ``n_real``: keys beyond it are masked out (padded token domain).
    ``key_bias``: a [B, N] logit bias per key, shared by every head and
    query, added in f32 after the scale -- ToMe's proportional attention
    (``softmax(q k^T / sqrt(dh) + log s)``, ``models/tome.py``).
    ``causal``: keys strictly after the query masked out (the CLIP text
    tower), before the ``n_real`` mask and with the same constant, as in
    the JAX function."""
    dh = q.shape[-1]
    # a host 0-d tensor: a scalar argument, no upload per pass
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))
    logits = _matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
    neg = -0.7 * torch.finfo(torch.float32).max
    col = None
    if causal or (n_real is not None and n_real < q.shape[2]):
        col = torch.arange(logits.shape[-1], device=logits.device)
    if causal:
        row = torch.arange(logits.shape[-2], device=logits.device)
        logits = torch.where(col[None, :] <= row[:, None], logits,
                             torch.full_like(logits, neg))
    if n_real is not None and n_real < q.shape[2]:
        logits = torch.where(col < n_real, logits,
                             torch.full_like(logits, neg))
    probs = torch.softmax(logits, dim=-1)
    out = _matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)
    return out, (probs if want_attn else None)


def mhsa(
    x: torch.Tensor,
    p: Params,
    heads: int,
    want_attn: bool = False,
    n_real: Optional[int] = None,
    head_major: bool = False,
    attn_impl=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full MHSA: fused QKV -> attention -> output projection.

    ``attn_impl`` swaps in another attention (``ops/flash_attention.
    flash_mhsa``, ``ops/dispatch.auto_attention``); it takes
    ``(q, k, v, want_attn, n_real=None)`` and keeps the contract of
    ``attention_reference``. An ``attn_impl`` with a ``packed`` attribute
    (``ops/attention_vjp.trainable_flash_mhsa``) takes the head-major qkv
    activation whole when ``head_major`` is set, maps are off and its
    ``packed_ok`` holds: no per-head split or transpose around it."""
    b, n, d = x.shape
    packed = getattr(attn_impl, "packed", None)
    if (packed is not None and head_major and not want_attn
            and attn_impl.packed_ok(heads, d // heads, n)):
        out = packed(linear(x, p["qkv_w"], p["qkv_b"]), n_real)
        return linear(out, p["proj_w"], p["proj_b"]), None
    q, k, v = qkv_proj(x, p, heads, head_major=head_major)
    impl = attn_impl or attention_reference
    out, probs = impl(q, k, v, want_attn, n_real=n_real)
    out = merge_last(out.transpose(1, 2), 2)
    return linear(out, p["proj_w"], p["proj_b"]), probs


def rollout_step(attn: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """One layer of attention rollout: fold the maps into [B, N, N].

    ``attn`` is per-head maps [B, H, N, N] (meaned here) or head-meaned
    maps [B, N, N]; ``carry`` is the rollout so far (identity at layer 0).
    """
    mean_heads = attn.float()
    if mean_heads.ndim == 4:
        mean_heads = mean_heads.mean(dim=1)
    n = mean_heads.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=attn.device)
    aug = 0.5 * mean_heads + 0.5 * eye
    aug = aug / aug.sum(dim=-1, keepdim=True)
    return torch.matmul(aug, carry.float())


def attention_rollout(attns) -> torch.Tensor:
    """Attention rollout (Abnar & Zuidema 2020) over per-layer maps, each
    [B, H, N, N] or head-meaned [B, N, N]. Returns [B, N, N] f32."""
    attns = list(attns)
    b, n = attns[0].shape[0], attns[0].shape[-1]
    rollout = torch.eye(n, dtype=torch.float32,
                        device=attns[0].device).expand(b, n, n)
    for a in attns:
        rollout = rollout_step(a, rollout)
    return rollout
