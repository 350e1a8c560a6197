"""Mixture-of-Experts ViT as plain functions on dicts of tensors.

Counterpart of ``interactive_vit_tpu/models/moe.py``: a ViT whose odd
blocks run a Switch-style routed MLP (top-1, capacity dropping, routed
per image) in place of the dense one, with the JAX package's parameter
layout (the ViT's, each MoE block's ``fc1_*`` / ``fc2_*`` replaced by
``router_w`` [D, E] and the expert stacks ``exp_fc1_w`` [E, D, M],
``exp_fc1_b`` [E, M], ``exp_fc2_w`` [E, M, D], ``exp_fc2_b`` [E, D]), so
a JAX tree converts by ``models/weights.from_jax``.

Routing, a group per image (``route``): router logits ``x @ router_w`` in
f32, softmax gates [B, N, E]; each token goes to its argmax expert (the
first maximum wins, as ``jnp.argmax``); a token's slot is its 1-based
rank among the image's tokens sent to that expert (a cumsum in token
order, so earlier tokens win capacity), and tokens past the capacity
``C = ceil(f N / E)`` are dropped: their MLP branch is 0 and the
residual passes them through. Dispatch and combine are the dense one-hot
[B, N, E, C] products of the JAX formulation, summed in f32: a token's
expert input is its activation exactly, and its output is exactly its
gate times the expert's output.

Every block keeps the unfused attention path (``ops/attention.mhsa``)
with the caller's ``attn_impl``: under the server's ``--attn flash`` that
is ``flash_mhsa``, this package's row-resident flash kernel (at
vit_moe_s16's N = 197, 6 heads of 64); the dense blocks are not fused
either, as in the JAX family. Each MoE block taps ``experts``: the gate
probabilities as per-expert patch-grid heatmaps [B, E, gh, gw] in bf16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.ops import attention as attn_ops
from interactive_vit_tpu_torch.ops import layers as L

Params = Any


@dataclasses.dataclass(frozen=True)
class MoEViTConfig(vit.ViTConfig):
    """ViT whose odd blocks (``moe_every``-strided) use a routed MLP."""

    n_experts: int = 8
    moe_every: int = 2          # blocks.i is MoE iff i % moe_every == 1
    capacity_factor: float = 1.25

    def is_moe(self, i: int) -> bool:
        return i % self.moe_every == (self.moe_every - 1)

    def capacity(self, n_tokens: int) -> int:
        """Expert buffer slots an image (``n_tokens``: tokens an image)."""
        return max(1, math.ceil(
            self.capacity_factor * n_tokens / self.n_experts))


VARIANTS: Dict[str, MoEViTConfig] = {
    # the ViT-S/16 trunk with 8 experts in every other block
    "vit_moe_s16": MoEViTConfig("vit_moe_s16", 224, 16, 384, 12, 6,
                                n_experts=8),
}


def init_params(cfg: MoEViTConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> Params:
    """``vit.init_params`` with each MoE block's MLP swapped for a router
    and the expert stacks (normal over sqrt(fan_in), zero biases, the JAX
    package's scales). Draws on the CPU from ``generator``."""
    params = vit.init_params(cfg, generator, dtype=dtype, device=device)
    d, md, e = cfg.width, cfg.mlp_dim, cfg.n_experts

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator) * fan_in ** -0.5
        return w.to(device=device, dtype=dtype)

    for i in range(cfg.depth):
        if not cfg.is_moe(i):
            continue
        b = params["blocks"][i]
        for name in ("fc1_w", "fc1_b", "fc2_w", "fc2_b"):
            del b[name]
        b["router_w"] = dense(d, (d, e))
        b["exp_fc1_w"] = dense(d, (e, d, md))
        b["exp_fc1_b"] = torch.zeros((e, md), device=device, dtype=dtype)
        b["exp_fc2_w"] = dense(md, (e, md, d))
        b["exp_fc2_b"] = torch.zeros((e, d), device=device, dtype=dtype)
    return params


# -- the routed MLP -----------------------------------------------------------


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside [0, n)
    gives a zero row (``jax.nn.one_hot``'s rule), with no host check."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).float()


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEViTConfig):
    """Top-1 capacity routing, per image. ``x`` [B, N, D] (after LN).

    Returns ``(dispatch [B,N,E,C], combine [B,N,E,C], gates [B,N,E] f32)``:
    dispatch is the 0/1 token -> slot assignment, combine is dispatch
    times the token's gate."""
    n = x.shape[1]
    e, c = cfg.n_experts, cfg.capacity(n)
    logits = torch.matmul(x.float(), router_w.float())     # [B, N, E]
    gates = torch.softmax(logits, dim=-1)
    onehot = _one_hot(torch.argmax(gates, dim=-1), e)      # [B, N, E]
    pos = torch.cumsum(onehot, dim=1) * onehot             # 1-based rank
    kept = onehot * (pos <= c).float()                     # overflow drops
    slot = _one_hot(((pos - 1.0) * onehot).long(), c)      # [B, N, E, C]
    dispatch = kept.unsqueeze(-1) * slot
    top_gate = (gates * kept).sum(dim=-1)                  # 0 when dropped
    combine = dispatch * top_gate[..., None, None]
    return dispatch, combine, gates


def moe_mlp(x: torch.Tensor, p: Params, cfg: MoEViTConfig
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routed MLP branch on [B, N, D] (the LN'ed input, no residual).

    Returns ``(y [B,N,D], gates [B,N,E] f32, aux f32)``; a dropped token's
    y is 0. The products run on f32 upcasts (a bf16 model's are exact and
    sum in f32, the JAX einsums' ``preferred_element_type``); the expert
    hidden layer is cast to x's dtype before the GELU, as there. ``aux``
    is the Switch load-balance term E * sum_e f_e P_e, f_e the raw routed
    fraction (before capacity drops)."""
    dispatch, combine, gates = route(x, p["router_w"], cfg)
    expert_in = torch.einsum("bnec,bnd->becd", dispatch,
                             x.float()).to(x.dtype)
    h = (torch.einsum("becd,edm->becm", expert_in.float(),
                      p["exp_fc1_w"].float())
         + p["exp_fc1_b"].float()[None, :, None, :])
    h = L.gelu(h.to(x.dtype))
    out = (torch.einsum("becm,emd->becd", h.float(), p["exp_fc2_w"].float())
           + p["exp_fc2_b"].float()[None, :, None, :])
    y = torch.einsum("bnec,becd->bnd", combine, out).to(x.dtype)
    assign = _one_hot(torch.argmax(gates, dim=-1), cfg.n_experts)
    frac = assign.mean(dim=(0, 1))
    prob = gates.mean(dim=(0, 1))
    aux = cfg.n_experts * (frac * prob).sum()
    return y, gates, aux


def moe_mlp_reference(x: torch.Tensor, p: Params,
                      cfg: MoEViTConfig) -> torch.Tensor:
    """The semantic reference: a loop over each image's tokens in numpy
    (the tests' yardstick), capacity an image as ``route``'s."""
    bsz, n, _ = x.shape
    xf = x.detach().float().cpu().numpy()
    rw = p["router_w"].detach().float().cpu().numpy()
    w1, b1, w2, b2 = (p[k].detach().float().cpu().numpy() for k in
                      ("exp_fc1_w", "exp_fc1_b", "exp_fc2_w", "exp_fc2_b"))
    c = cfg.capacity(n)
    y = np.zeros_like(xf)
    for b_i in range(bsz):
        logits = xf[b_i] @ rw
        gates = np.exp(logits - logits.max(-1, keepdims=True))
        gates /= gates.sum(-1, keepdims=True)
        expert = gates.argmax(-1)
        counts = np.zeros(cfg.n_experts, dtype=int)
        for t in range(n):
            e_i = int(expert[t])
            if counts[e_i] >= c:
                continue  # dropped: the residual passes it through
            counts[e_i] += 1
            h = xf[b_i, t] @ w1[e_i] + b1[e_i]
            h = L.gelu(torch.from_numpy(h).to(x.dtype)).float().numpy()
            y[b_i, t] = gates[t, e_i] * (h @ w2[e_i] + b2[e_i])
    return torch.from_numpy(y).to(x.dtype)


# -- block / forward ----------------------------------------------------------


def block(p: Params, x: torch.Tensor, cfg: MoEViTConfig, i: int,
          want_attn: bool = False, want_mean: bool = False, attn_impl=None,
          qkv_head_major: bool = False):
    """Pre-LN block on the unfused attention path; returns ``(y, probs,
    mean, moe_out)`` with ``moe_out`` = (gates, aux) for an MoE block, else
    None."""
    h, probs = attn_ops.mhsa(
        L.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.ln_eps), p, cfg.heads,
        want_attn=want_attn or want_mean, attn_impl=attn_impl,
        head_major=qkv_head_major)
    x = x + h
    pmean = None
    if want_mean and probs is not None:
        pmean = probs.float().mean(dim=1).to(probs.dtype)
    if not want_attn:
        probs = None
    h = L.layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.ln_eps)
    if cfg.is_moe(i):
        y, gates, aux = moe_mlp(h, p, cfg)
        return x + y, probs, pmean, (gates, aux)
    return x + L.mlp(h, p), probs, pmean, None


def forward(params: Params, images: torch.Tensor, cfg: MoEViTConfig,
            want_attn: bool = False, want_aux: bool = False,
            attn_impl=None, block_wrapper=None,
            qkv_head_major: bool = False) -> Dict[str, Any]:
    """The monolithic forward: {"logits"} plus "attn" (a tuple of per-block
    maps) with ``want_attn`` and "aux" (the load-balance term averaged over
    the MoE blocks) with ``want_aux``. ``qkv_head_major``: the qkv columns
    are ``[H][3][dh]`` (``parallel/mesh.permute_qkv_head_major``).
    ``block_wrapper``: the training hook (``vit.forward``'s contract): each
    block runs as one ``(p, x) -> (y, aux)`` unit wrapped by it, aux 0 for
    a dense block; taps do not compose with it."""
    if block_wrapper is not None and want_attn:
        raise ValueError("block_wrapper requires taps off")
    x = vit.embed(params, images, cfg)
    attns, aux_sum = [], 0.0
    for i in range(cfg.depth):
        if block_wrapper is not None:
            def one(p, x, i=i):
                y, _, _, moe_out = block(p, x, cfg, i, attn_impl=attn_impl,
                                         qkv_head_major=qkv_head_major)
                return y, (moe_out[1] if moe_out is not None
                           else x.new_zeros((), dtype=torch.float32))

            x, aux = block_wrapper(one)(params["blocks"][i], x)
            aux_sum = aux_sum + aux
            continue
        x, probs, _, moe_out = block(params["blocks"][i], x, cfg, i,
                                     want_attn=want_attn,
                                     attn_impl=attn_impl,
                                     qkv_head_major=qkv_head_major)
        if want_attn:
            attns.append(probs)
        if moe_out is not None:
            aux_sum = aux_sum + moe_out[1]
    out: Dict[str, Any] = {
        "logits": vit.head(params, vit.final_norm(params, x, cfg))}
    if want_attn:
        out["attn"] = tuple(attns)
    if want_aux:
        n_moe = sum(cfg.is_moe(i) for i in range(cfg.depth))
        out["aux"] = aux_sum / max(1, n_moe)
    return out


# -- graph-node decomposition -------------------------------------------------


def layer_fns(cfg: MoEViTConfig, attn_impl=None
              ) -> List[Tuple[str, List[str], Callable]]:
    """The ``vit.layer_fns`` contract: transform and embed from the ViT
    family, the blocks with the "attn" and "r" taps (MoE blocks also
    "experts"), norm and head."""
    base = vit.layer_fns(cfg, attn_impl=attn_impl)
    layers: List[Tuple[str, List[str], Callable]] = [base[0], base[1]]
    gh = cfg.img_size // cfg.patch

    def make_block_fn(i):
        def block_fn(p, ins, want=frozenset(), node_params=None):
            x = ins["o"]
            sel = vit.parse_attn_heads(node_params)
            if sel is not None and any(h < 0 or h >= cfg.heads for h in sel):
                raise ValueError(f"attn_heads {sorted(sel)} out of range "
                                 f"for {cfg.heads} heads")
            y, probs, pmean, moe_out = block(
                p, x, cfg, i, want_attn="attn" in want,
                want_mean="r" in want, attn_impl=attn_impl)
            outs = {"o": y}
            if probs is not None and "attn" in want:
                if sel is not None:
                    probs = probs.index_select(1, L.index_on(
                        tuple(sorted(set(sel))), probs.device))
                outs["attn"] = probs
            if "r" in want:
                outs["r"] = vit.rollout_carry(pmean, ins, x)
            if moe_out is not None and "experts" in want:
                # per-expert gate heatmaps over the patch grid (CLS
                # dropped), render-ready for a multi_view node
                gates = moe_out[0][:, 1:, :]
                outs["experts"] = (gates.transpose(1, 2)
                                   .reshape(gates.shape[0], cfg.n_experts,
                                            gh, gh)
                                   .to(torch.bfloat16))
            return outs

        return block_fn

    for i in range(cfg.depth):
        extras = ["attn", "r"] + (["experts"] if cfg.is_moe(i) else [])
        layers.append((f"blocks.{i}", extras, make_block_fn(i)))
    layers.append(base[-2])  # norm
    layers.append(base[-1])  # head
    return layers


layer_params = vit.layer_params  # the ViT tree's layout

