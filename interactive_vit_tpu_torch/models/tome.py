"""ToMe-ViT: token merging as a servable model family.

Counterpart of ``interactive_vit_tpu/models/tome.py``. A plain ViT trunk
(the same parameter tree as ``models/vit.py``, so any ViT checkpoint of
the geometry loads unchanged) that merges the ``r`` most similar token
pairs after every block's attention (``ops/tome_ops``): block ``i`` runs
its MLP on ``N - r (i + 1)`` tokens, clamped per block.

The block kernel takes ToMe's two operands
(``ops/fused_block.fused_attn_block(key_bias=, want_metric=)``): the
proportional-attention bias ``log s`` and the head-meaned keys that the
matching scores. Without a kernel the block runs the unfused path
(``attention_reference(key_bias=)``, keys meaned in f32).

Graph surface, as in the JAX package:

* token sizes flow between block nodes on an ``s`` channel ([B, N_i] f32)
  that the generated graph wires along the chain; unwired, a block assumes
  unmerged inputs (ones);
* the original-token -> current-token assignment flows on an ``a`` channel
  ([B, N0] int32);
* ``merge`` taps the assignment as a colour map [B, 3, g, g];
* ``attn`` taps are the block's pre-merge maps [B, H, N_i, N_i];
* the rollout ``r`` carry is [B, N_cur, N_tap0] and its rows merge
  size-weighted with the same ``apply_merge`` as the tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.ops import attention as attn_ops
from interactive_vit_tpu_torch.ops import layers as L
from interactive_vit_tpu_torch.ops import tome_ops

Params = Any


@dataclasses.dataclass(frozen=True)
class ToMeViTConfig(vit.ViTConfig):
    """ViT config + ``r``: token pairs merged after each block's attention
    (clamped per block by ``tome_ops.merge_counts``)."""

    r: int = 8

    def n_tokens(self, i: int) -> int:
        """Token count entering block ``i`` (0-based)."""
        n = self.tokens
        for _ in range(i):
            n -= tome_ops.merge_counts(n, self.r)
        return n


VARIANTS: Dict[str, ToMeViTConfig] = {
    # ViT-B/16 trunk: N walks 197 -> 109 over 12 blocks (r=8) or 197 -> 21
    # (r=16; the last blocks clamp)
    "vit_b16_tome": ToMeViTConfig("vit_b16_tome", 224, 16, 768, 12, 12, r=8),
    "vit_b16_tome16": ToMeViTConfig("vit_b16_tome16", 224, 16, 768, 12, 12,
                                    r=16),
    "vit_s16_tome": ToMeViTConfig("vit_s16_tome", 224, 16, 384, 12, 6, r=8),
}


def init_params(cfg: ToMeViTConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> Params:
    """The same tree as ``vit.init_params``: merging has no weights."""
    return vit.init_params(cfg, generator, dtype=dtype, device=device)


def block(
    p: Params,
    x: torch.Tensor,
    s: Optional[torch.Tensor],
    cfg: ToMeViTConfig,
    want_attn: bool = False,
    want_mean: bool = False,
    block_impl=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
           Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One ToMe block: proportional attention -> merge -> MLP.

    ``s`` [B, N] f32 token sizes (None = unmerged). Returns ``(y [B,N-r,D],
    s_new [B,N-r], lut [B,N], probs, pmean)``; probs and pmean are the
    pre-merge maps over this block's input tokens. ``block_impl``: the
    block kernel (``fused_attn_block`` signature, with ``key_bias`` and
    ``want_metric``); None = the unfused path."""
    b, n, d = x.shape
    if s is None:
        s = torch.ones((b, n), dtype=torch.float32, device=x.device)
    kb = torch.log(torch.clamp(s, min=1e-6))
    if block_impl is not None:
        res = block_impl(x, p, cfg.heads, cfg.ln_eps, want_attn=want_attn,
                         want_mean=want_mean, key_bias=kb, want_metric=True)
        x, probs = res[0], res[1]
        pmean = res[2] if want_mean else None
        metric = res[-1]
    else:
        xa = L.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.ln_eps)
        q, k, v = attn_ops.qkv_proj(xa, p, cfg.heads)
        out, probs = attn_ops.attention_reference(
            q, k, v, want_attn=want_attn or want_mean, key_bias=kb)
        out = out.transpose(1, 2).reshape(b, n, d)
        x = x + L.linear(out, p["proj_w"], p["proj_b"])
        pmean = None
        if want_mean and probs is not None:
            pmean = probs.float().mean(dim=1).to(probs.dtype)
        if not want_attn:
            probs = None
        # the published metric: the head-meaned attention keys
        metric = k.float().mean(dim=1)                    # [B, N, dh]
    lut, n_new = tome_ops.bipartite_matching(metric, cfg.r)
    if n_new != n:
        x, s = tome_ops.apply_merge(x, s, lut, n_new)
    x = x + L.mlp(L.layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.ln_eps), p)
    return x, s, lut, probs, pmean


def forward(
    params: Params,
    images: torch.Tensor,
    cfg: ToMeViTConfig,
    want_attn: bool = False,
    block_impl=None,
) -> Dict[str, Any]:
    """Monolithic forward: logits, and with ``want_attn`` "attn" (a tuple
    of per-layer [B, H, N_i, N_i] maps, ragged across layers) and
    "rollout" ([B, N_last, N0]: the surviving tokens' cumulative
    attribution to the original tokens; merged rows fold size-weighted)."""
    x = vit.embed(params, images, cfg)
    b, n0 = x.shape[0], x.shape[1]
    s = torch.ones((b, n0), dtype=torch.float32, device=x.device)
    attns: List[torch.Tensor] = []
    rollout = (torch.eye(n0, dtype=torch.float32, device=x.device)
               .expand(b, n0, n0) if want_attn else None)
    for p in params["blocks"]:
        n_in, s_prev = x.shape[1], s
        x, s, lut, probs, pmean = block(
            p, x, s, cfg, want_attn=want_attn, want_mean=want_attn,
            block_impl=block_impl)
        if want_attn:
            attns.append(probs.to(x.dtype))
            rollout = attn_ops.rollout_step(pmean, rollout)
            if x.shape[1] != n_in:
                # merged carry rows combine with the pre-merge sizes, the
                # weights the token values merged with
                rollout, _ = tome_ops.apply_merge(rollout, s_prev, lut,
                                                  x.shape[1])
    out: Dict[str, Any] = {
        "logits": vit.head(params, vit.final_norm(params, x[:, :1], cfg))}
    if want_attn:
        out["attn"] = tuple(attns)
        out["rollout"] = rollout
    return out


# -- graph-node decomposition ---------------------------------------------------


def layer_fns(cfg: ToMeViTConfig, block_impl=None):
    """The tappable layer list (``vit.layer_fns``' contract) with the ToMe
    channels: blocks chain ``s`` (sizes) and ``a`` (assignment) beside
    ``o`` and add the ``merge`` colour-map tap."""
    base = vit.layer_fns(cfg)
    layers: List[Tuple[str, List[str], Callable]] = [base[0], base[1]]

    def block_fn(p, ins, want=frozenset(), node_params=None):
        x = ins["o"]
        b, n = x.shape[0], x.shape[1]
        s = ins.get("s")
        if s is None:
            s = torch.ones((b, n), dtype=torch.float32, device=x.device)
        sel = vit.parse_attn_heads(node_params)
        if sel is not None and any(h < 0 or h >= cfg.heads for h in sel):
            raise ValueError(f"attn_heads {sorted(sel)} out of range for "
                             f"{cfg.heads} heads")
        s_prev = s
        y, s, lut, probs, pmean = block(
            p, x, s, cfg, want_attn="attn" in want, want_mean="r" in want,
            block_impl=block_impl)
        outs = {"o": y, "s": s}
        if probs is not None and "attn" in want:
            if sel is not None:
                probs = probs[:, sorted(set(sel))]
            outs["attn"] = probs
        if "r" in want:
            rolled = vit.rollout_carry(pmean, ins, x)
            if y.shape[1] != n:
                rolled, _ = tome_ops.apply_merge(rolled, s_prev, lut,
                                                 y.shape[1])
            outs["r"] = rolled.to(y.dtype)
        if "a" in want or "merge" in want:
            a = ins.get("a")
            if a is None:
                if n != cfg.tokens:
                    raise ValueError(
                        f"merge/assignment taps need the 'a' channel wired "
                        f"from the first block (the saved {cfg.name}.json "
                        f"wires it); got an unwired 'a' at N={n} != "
                        f"N0={cfg.tokens}")
                a = torch.arange(n, dtype=torch.int32,
                                 device=x.device).expand(b, n)
            a = torch.gather(lut, 1, a.long())
            outs["a"] = a
            if "merge" in want:
                outs["merge"] = tome_ops.merge_map_render(a).to(y.dtype)
        if "cls" in want:
            outs["cls"] = y[:, 0]
        return outs

    for i in range(cfg.depth):
        layers.append((f"blocks.{i}", ["s", "a", "attn", "r", "cls", "merge"],
                       block_fn))
    layers.append(base[-2])  # norm
    layers.append(base[-1])  # head
    return layers


layer_params = vit.layer_params  # the same tree layout
