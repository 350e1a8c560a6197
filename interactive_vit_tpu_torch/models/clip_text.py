"""CLIP text encoder, the second tower of the CLIP family.

Counterpart of ``interactive_vit_tpu/models/clip_text.py``. OpenAI CLIP's
text transformer at ViT-B/32 scale: token embedding + learned positions
over a 77-token context, 12 pre-LN blocks 512 wide in 8 heads with
QuickGELU MLPs and causal attention, ``ln_final``, the features at each
sequence's end-of-text position, then a bias-free projection into the
shared 512-d space, L2-normalised. The zero-shot graph joins it to the
image tower (``models/clip.py``) at a ``similarity`` node.

As in the JAX package this tower runs no kernel: at N=77 its causal
attention is the plain ``attention_reference(causal=True)`` (f32 logits
and softmax).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from interactive_vit_tpu_torch.models.clip import (
    block_params, normalized_projection, openai_block, quick_gelu,
    state_dict_reader,
)
from interactive_vit_tpu_torch.ops import layers as L
from interactive_vit_tpu_torch.ops.attention import (
    attention_reference, qkv_proj,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    name: str = "clip_text_b32"
    vocab_size: int = 49408
    context: int = 77
    width: int = 512
    depth: int = 12
    heads: int = 8
    embed_dim: int = 512
    ln_eps: float = 1e-5

    @property
    def mlp_dim(self) -> int:
        return self.width * 4


def init_params(cfg: CLIPTextConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> Params:
    """Random init with the JAX package's layout and scales (a 0.02 token
    table, 0.01 positions, weights normal over sqrt(fan_in)). Draws on the
    CPU from ``generator``; ``device``: where the tensors are put."""
    d, md = cfg.width, cfg.mlp_dim

    def put(t):
        return t.to(device=device, dtype=dtype)

    def normal(shape, std):
        return put(torch.randn(shape, generator=generator,
                               dtype=torch.float32) * std)

    def dense(fan_in, shape):
        return normal(shape, fan_in ** -0.5)

    params: Params = {
        "token_emb": normal((cfg.vocab_size, d), 0.02),
        "pos_emb": normal((cfg.context, d), 0.01),
        "ln_final": {"s": put(torch.ones(d)), "b": put(torch.zeros(d))},
        "proj": dense(d, (d, cfg.embed_dim)),  # no bias
    }
    params["blocks"] = [block_params(d, md, put, dense)
                        for _ in range(cfg.depth)]
    return params


def block(p: Params, x: torch.Tensor, cfg: CLIPTextConfig,
          want_attn: bool = False
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-LN block, causal attention over the whole padded context (a
    position never sees the padding after it, so the pooled eot features
    do not depend on it); returns (y, probs | None)."""
    b, n, d = x.shape
    h = L.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.ln_eps)
    q, k, v = qkv_proj(h, p, cfg.heads)
    out, probs = attention_reference(q, k, v, want_attn=want_attn,
                                     causal=True)
    out = out.transpose(1, 2).reshape(b, n, d)
    x = x + L.linear(out, p["proj_w"], p["proj_b"])
    h = L.layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.ln_eps)
    x = x + L.linear(quick_gelu(L.linear(h, p["fc1_w"], p["fc1_b"])),
                     p["fc2_w"], p["fc2_b"])
    return x, probs


def embed(params: Params, tokens: torch.Tensor, cfg: CLIPTextConfig
          ) -> torch.Tensor:
    """Token ids [P, N] (any integer dtype) -> [P, N, D]: the table's rows
    plus the positions."""
    table = params["token_emb"]
    x = table.index_select(0, tokens.reshape(-1).long()).reshape(
        *tokens.shape, table.shape[1])
    return x + params["pos_emb"][None, : tokens.shape[1]].to(x.dtype)


def pool_project(params: Params, x: torch.Tensor, eot: torch.Tensor,
                 cfg: CLIPTextConfig, normalize: bool = True
                 ) -> torch.Tensor:
    """ln_final -> the features at each prompt's eot position [P] ->
    projection -> L2 norm. The gather takes its int64 index on the device
    (no host read, so a CUDA graph captures it). ``forward`` passes
    ``argmax(tokens)`` (eot is the vocabulary's largest id and padding is
    0, ``clip_bpe``); the graph ships the host's on the embed node's
    ``eot`` channel."""
    x = L.layer_norm(x, params["ln_final"]["s"], params["ln_final"]["b"],
                     cfg.ln_eps)
    idx = eot.long().reshape(-1, 1, 1).expand(-1, 1, x.shape[-1])
    pooled = torch.gather(x, 1, idx)[:, 0]
    return normalized_projection(pooled, params["proj"], normalize, x.dtype)


def forward(params: Params, tokens: torch.Tensor, cfg: CLIPTextConfig,
            want_attn: bool = False) -> Dict[str, Any]:
    """{"embedding": [P, embed_dim]} and, with ``want_attn``, "attn": a
    tuple of per-layer causal [P, H, N, N] maps in the activation dtype."""
    x = embed(params, tokens, cfg)
    attns: List[torch.Tensor] = []
    for p in params["blocks"]:
        x, probs = block(p, x, cfg, want_attn=want_attn)
        if want_attn:
            attns.append(probs.to(x.dtype))
    out: Dict[str, Any] = {"embedding": pool_project(
        params, x, torch.argmax(tokens.long(), dim=-1), cfg)}
    if want_attn:
        out["attn"] = tuple(attns)
    return out


# -- node decomposition ------------------------------------------------------


def layer_fns(cfg: CLIPTextConfig):
    """embed (the prompts live here; extra channel "eot") -> blocks.i
    (tap "attn") -> embedding (inputs "o" and "eot").

    The embed node has no tensor input: its tokens and each prompt's eot
    index arrive as captures built from the node's ``prompts`` param
    (``clip_text_plugin``), under ``weights`` / ``tokens`` / ``eot``."""
    layers: List[Tuple[str, List[str], Callable]] = []

    def embed_fn(p, ins, want=frozenset()):
        outs = {"o": embed(p["weights"], p["tokens"], cfg)}
        if "eot" in want:
            outs["eot"] = p["eot"]
        return outs

    layers.append(("embed", ["eot"], embed_fn))

    def block_fn(p, ins, want=frozenset()):
        y, probs = block(p, ins["o"], cfg, want_attn="attn" in want)
        outs = {"o": y}
        if probs is not None:
            outs["attn"] = probs
        return outs

    for i in range(cfg.depth):
        layers.append((f"blocks.{i}", ["attn"], block_fn))

    layers.append(("embedding", [], lambda p, ins: {
        "o": pool_project(p, ins["o"], ins["eot"], cfg)}))
    return layers


def layer_params(params: Params, layer_name: str) -> Any:
    if layer_name.startswith("blocks."):
        return params["blocks"][int(layer_name.split(".", 1)[1])]
    if layer_name == "embed":
        # the plugin puts the token captures beside these, as "weights"
        return {"token_emb": params["token_emb"],
                "pos_emb": params["pos_emb"]}
    if layer_name == "embedding":
        return {"ln_final": params["ln_final"], "proj": params["proj"]}
    return {}


def from_openai(sd: Dict[str, Any], cfg: CLIPTextConfig,
                dtype=torch.float32, device="cpu") -> Params:
    """OpenAI CLIP state dict (the unprefixed text keys beside
    ``visual.*``: ``token_embedding.weight``, ``transformer.resblocks.*``,
    ...) -> our tree, tensors of ``dtype`` on ``device``."""
    get = state_dict_reader(sd, dtype, device)
    return {
        "token_emb": get("token_embedding.weight"),
        "pos_emb": get("positional_embedding"),
        "blocks": [openai_block(get, f"transformer.resblocks.{i}.")
                   for i in range(cfg.depth)],
        "ln_final": {"s": get("ln_final.weight"),
                     "b": get("ln_final.bias")},
        "proj": get("text_projection"),
    }
