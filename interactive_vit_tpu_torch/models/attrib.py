"""Chefer-style attention attribution as a servable graph node.

Counterpart of ``interactive_vit_tpu/models/attrib.py``: "Generic
Attention-model Explainability for Interpreting Bi-Modal and
Encoder-Decoder Transformers" (Chefer, Gur & Wolf, 2021) for the plain-ViT
family (vit / deit / dino / dinov2). Per block the relevance update is
``R += E_h[(∇A ⊙ A)⁺] · R`` from the identity, where ``A`` is the block's
post-softmax attention and ``∇A`` the gradient of the target logit with
respect to it; the CLS row of the final ``R`` is the class-specific patch
heatmap.

Every block's attention gradient comes from ONE backward pass: the trunk
runs again with a zero ``delta`` added to each block's post-softmax
probabilities, and ``torch.autograd.grad`` with respect to the deltas is
``(∂ logit / ∂ A_l)_l`` (each delta stands in for its block's attention at
the evaluation point). The trunk is plain PyTorch (the block kernels have
no backward): its attention mirrors ``ops.attention.attention_reference``
line for line, so it serves the logits of the unfused block chain. On a
card the forward, the backward and the relevance chain are recorded into
the executor's captured program like any other node.
"""

from __future__ import annotations

import html
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from interactive_vit_tpu_torch.graph.registry import NodeKind
from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.models.model_plugin import dequant_grad_twin
from interactive_vit_tpu_torch.ops.node_ops import take_class

Params = Dict[str, Any]


def _make_inject_impl(delta: torch.Tensor, store: List[torch.Tensor]):
    """An ``attn_impl`` (the ``ops.attention.mhsa`` contract) that adds
    ``delta`` to the post-softmax probabilities and records them. Plain-ViT
    only: it has no ToMe key bias (``AttribNodeKind`` refuses other
    configs)."""

    def impl(q, k, v, want_attn=False, n_real=None):
        del want_attn  # probs are recorded in ``store`` either way
        scale = 1.0 / math.sqrt(q.shape[-1])
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if n_real is not None and n_real < q.shape[2]:
            neg = -0.7 * torch.finfo(torch.float32).max
            col = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(col < n_real, logits,
                                 torch.full_like(logits, neg))
        probs = torch.softmax(logits, dim=-1) + delta
        store.append(probs)
        out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)
        return out, None

    return impl


def trunk_with_attn_grads(
    caps: Params, tokens: torch.Tensor, cfg: vit.ViTConfig, scalar_fn,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...],
           torch.Tensor]:
    """Run the block trunk from post-embed tokens; return per-block
    ``(probs, grads, logits)``, grads = ∂ scalar_fn(logits) / ∂ probs.

    ``caps``: ``{"blocks": [...], "norm": ..., "head": ...}``, the subtrees
    the chained nodes close over. One forward and one backward whatever the
    depth. Where ``tokens`` carries a graph (the node sits in an outer
    differentiated replay) the gradients keep theirs."""
    blocks = caps["blocks"]
    b, n, _ = tokens.shape
    nested = tokens.requires_grad
    with torch.enable_grad():
        deltas = [torch.zeros((b, cfg.heads, n, n), dtype=torch.float32,
                              device=tokens.device, requires_grad=True)
                  for _ in blocks]
        store: List[torch.Tensor] = []
        x = tokens
        for p, dl in zip(blocks, deltas):
            x, _, _ = vit.block(p, x, cfg,
                                attn_impl=_make_inject_impl(dl, store))
        feats = vit.final_norm({"norm": caps["norm"]},
                               x[:, : cfg.prefix_tokens], cfg)
        logits = vit.head(caps, feats)
        grads = torch.autograd.grad(scalar_fn(logits), deltas,
                                    create_graph=nested)
    if not nested:
        store = [t.detach() for t in store]
        logits = logits.detach()
    return tuple(store), grads, logits


def chefer_relevance(probs, grads) -> torch.Tensor:
    """Fold per-block (probs, grads) into the relevance matrix [B,N,N]:
    ``R = I; for each block: R += E_h[(∇A ⊙ A)⁺] · R``, in f32."""
    b, _, n, _ = probs[0].shape
    r = torch.eye(n, dtype=torch.float32,
                  device=probs[0].device).expand(b, n, n)
    for a, g in zip(probs, grads):
        abar = torch.relu(g * a).mean(dim=1)  # [B, N, N] f32
        r = r + torch.matmul(abar, r)
    return r


def _render_grid(rel_row: torch.Tensor) -> torch.Tensor:
    """[B, P] per-patch relevance -> [B, 3, g, g] heatmap, per-sample
    max-normalized (relevance is nonnegative by construction)."""
    b, p = rel_row.shape
    g = math.isqrt(p)
    if g * g != p:
        raise ValueError(
            f"{p} patch tokens do not tile a square grid — wire the "
            f"attrib node from the model's embed output")
    h = rel_row / rel_row.amax(dim=-1, keepdim=True).clamp_min(1e-12)
    return h.reshape(b, 1, g, g).expand(b, 3, g, g)


class AttribNodeKind(NodeKind):
    """``<variant>:attrib``, class-specific attention attribution.

    Wiring: input "o" = the model's ``:embed`` output (the token stream
    [B,N,D]; the trunk runs again from there inside this node). Outputs:
    "o" = [B,3,g,g] heatmap of the CLS row's relevance; "rel" = the raw
    [B,N,N] relevance (extra); "logits" = the trunk's own logits (extra; a
    parity probe against the chain's head).

    Params: ``target`` max | class; ``class`` (dynamic: a 0-d capture
    beside the trunk's weights, which ride unstacked in a group).
    ``quantized``: dequantize the trunk's int8 leaf-dicts inline, as the
    saliency twins do (``model_plugin.dequant_grad_twin``)."""

    TARGETS = ("max", "class")
    autograd = True

    def __init__(self, model, cfg: vit.ViTConfig, quantized: bool = False):
        # the injected attention has no ToMe key bias: a subclassed config
        # would attribute against the wrong forward with matching shapes
        if type(cfg) is not vit.ViTConfig:
            raise TypeError(
                f"AttribNodeKind supports plain ViT trunks only; got "
                f"{type(cfg).__name__} for {model.name} (the injection "
                f"attn_impl omits ToMe key-bias and causal paths)")
        super().__init__(model.prefix() + "attrib")
        self.model = model
        self.cfg = cfg
        self._quantized = quantized

    def io(self, params):
        return {"ins": ["o"], "outs": ["o", "rel", "logits"]}

    def extra_outs(self, params):
        return ["rel", "logits"]

    def dynamic_params(self):
        return frozenset({"class"})

    def dynamic_capture_keys(self):
        return frozenset({"class"})

    def contents(self, params):
        target = params.get("target", "max")
        opts = "".join(
            f"<option value=\"{o}\"{' selected' if o == target else ''}>"
            f"{o}</option>" for o in self.TARGETS)
        cls = html.escape(str(int(float(params.get("class", 0)))))
        return ("<p>attention attribution (Chefer 2021)</p>"
                "<p>wire from the embed node; CLS-row relevance "
                "heatmap</p>"
                f"<label>target <select data-param=\"target\">{opts}"
                "</select></label> "
                f"<label>class <input data-param=\"class\" type=\"number\""
                f" step=\"1\" value=\"{cls}\" size=\"6\"></label>")

    def captures(self, params):
        p = self.model.params
        trunk = {"blocks": p["blocks"], "norm": p["norm"],
                 "head": p["head"]}
        if "head_dist" in p:  # DeiT distilled: averaged dual heads
            trunk["head_dist"] = p["head_dist"]
        return {"trunk": trunk, "class": torch.tensor(
            np.int32(int(float(params.get("class", 0)))))}

    def _decode(self, params) -> str:
        target = params.get("target", "max")
        if target not in self.TARGETS:
            raise ValueError(
                f"target must be one of {self.TARGETS}, got {target!r}")
        return target

    def fn(self, params):
        target = self._decode(params)
        cfg = self.cfg
        dequant = (dequant_grad_twin(lambda p, _ins: p) if self._quantized
                   else None)

        def run(ins, caps):
            trunk = caps["trunk"]
            if dequant is not None:
                trunk = dequant(trunk, None)
            x = ins["o"]
            if x.ndim == 2:  # unbatched token stream
                x = x[None]
            if x.ndim != 3:
                raise ValueError(
                    f"attrib expects the embed node's [B,N,D] token "
                    f"stream, got shape {tuple(x.shape)}")

            def scalar(logits):
                y = logits.to(torch.float32)
                y = (take_class(y, caps["class"]) if target == "class"
                     else y.amax(dim=-1))
                return y.sum()

            probs, grads, logits = trunk_with_attn_grads(trunk, x, cfg,
                                                         scalar)
            rel = chefer_relevance(probs, grads)
            # the CLS row, the prefix columns dropped (DeiT: CLS + DIST)
            row = rel[:, 0, cfg.prefix_tokens:]
            return {"o": _render_grid(row).to(x.dtype), "rel": rel,
                    "logits": logits}

        return run

    def stacked_fn(self, params, caps_axes=None):
        """``fn`` once for each row of a group (``torch.func.vmap`` cannot
        run ``torch.autograd.grad``), stacked; each row's class its own
        where ``caps_axes`` stacks it."""
        f = self.fn(params)
        per_row = (caps_axes or {}).get("class") == 0

        def run(ins, caps):
            c = caps["class"]
            rows = [f({ch: v[j] for ch, v in ins.items()},
                      {"trunk": caps["trunk"], "class": c[j] if per_row
                       else c})
                    for j in range(ins["o"].shape[0])]
            return {ch: torch.stack([r[ch] for r in rows])
                    for ch in rows[0]}

        return run
