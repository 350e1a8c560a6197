"""CLIP text-tower plugin and the zero-shot graph.

Counterpart of ``interactive_vit_tpu/models/clip_text_plugin.py``. The
tower's entry node, ``clip_text_b32:embed``, has no tensor input: it
carries a ``prompts`` param (a JSON list of strings), tokenizes on the
host (``models/clip_bpe``) and hands the token ids to the pass as
captures. Each prompt's end-of-text index leaves on an ``eot`` channel
wired straight to the pooling node, so the block chain stays a plain
activation chain with a causal attention tap on each block.

``prompts`` is dynamic in its wording and static in its count: the
tokens' shape [P, 77] depends only on how many prompts there are. So the
node declares ``dynamic_params = {"prompts"}`` and ``dynamic_sig`` = the
prompt count: rewording a prompt replays the cached program (on a card
its CUDA graph; ``tokens`` and ``eot`` are copied into its buffers), and
adding or removing one stages and captures a new one. In a stacked group
the token table is passed once (``dynamic_capture_keys``).
"""

from __future__ import annotations

import html
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from interactive_vit_tpu_torch.graph.ir import GraphError
from interactive_vit_tpu_torch.models import clip, clip_text
from interactive_vit_tpu_torch.models.clip_bpe import default_tokenizer
from interactive_vit_tpu_torch.models.model_plugin import (
    LayerNodeKind, TorchModel,
)
from interactive_vit_tpu_torch.runtime.device import require_device

DEFAULT_PROMPTS = ["a photo of a cat", "a photo of a dog",
                   "a diagram", "a photo of a person"]


def _parse_prompts(params: Dict[str, str]) -> List[str]:
    raw = params.get("prompts", "")
    try:
        v = json.loads(raw) if isinstance(raw, str) and raw else raw
    except json.JSONDecodeError:
        # a bare unquoted string typed into the UI: one prompt
        v = raw
    if isinstance(v, str):
        v = [v] if v else []
    if not isinstance(v, list) or not all(isinstance(s, str) for s in v):
        raise GraphError("prompts must be a JSON list of strings")
    return [str(s) for s in v] or list(DEFAULT_PROMPTS)


class _PromptNode(LayerNodeKind):
    """Text entry node: prompts param -> embedded token sequence + eot."""

    def io(self, params):
        return {"ins": [], "outs": ["o"] + self._extra}

    def contents(self, params):
        prompts = params.get("prompts", "") or json.dumps(DEFAULT_PROMPTS)
        return (f"<p>{self.get_name()}</p>"
                f"<p>{self.model.describe(self.layer_name)}</p>"
                f"<label>prompts <textarea data-param=\"prompts\" rows=\"3\" "
                f"cols=\"24\">{html.escape(prompts)}</textarea></label>")

    def dynamic_params(self):
        return frozenset({"prompts"})

    def dynamic_sig(self, params):
        return str(len(_parse_prompts(params)))

    def dynamic_capture_keys(self):
        # the embed weights do not depend on the prompts: a stacked group
        # passes the [vocab, width] table once
        return frozenset({"tokens", "eot"})

    def captures(self, params):
        cfg: clip_text.CLIPTextConfig = self.model.text_cfg
        tokens = default_tokenizer().batch(_parse_prompts(params),
                                           cfg.context)
        return {
            "weights": self.model.layer_params(self.layer_name),
            "tokens": tokens,
            # eot is the vocabulary's largest id and padding is 0
            "eot": np.argmax(tokens, axis=-1).astype(np.int32),
        }

    def stacked_fn(self, params, caps_axes=None):
        """The node over a group of K requests: their tokens [K, P, 77]
        and eot [K, P] are folded into one batch of K*P prompts, and the
        outputs unfolded to [K, P, ...]. The group's size comes from the
        stacked captures, as the node has no input."""
        if not caps_axes or caps_axes.get("tokens") != 0:
            raise ValueError(f"{self.get_name()} runs stacked only with "
                             f"its tokens stacked per request")
        f = self.fn(params)

        def run(ins, caps):
            k, n_p = caps["tokens"].shape[:2]
            outs = f(ins, {**caps, "tokens": caps["tokens"].flatten(0, 1),
                           "eot": caps["eot"].flatten(0, 1)})
            return {ch: v.unflatten(0, (k, n_p)) for ch, v in outs.items()}

        return run


class _PoolNode(LayerNodeKind):
    """Pooling / projection node: the chain's "o" and the "eot" channel."""

    def io(self, params):
        return {"ins": ["o", "eot"], "outs": ["o"]}


class TextTorchModel(TorchModel):
    """A ``TorchModel`` whose entry and pooling layers take the text
    node kinds and whose generated graph wires ``embed:eot ->
    embedding:eot``."""

    def __init__(self, *args, text_cfg: clip_text.CLIPTextConfig, **kw):
        super().__init__(*args, **kw)
        self.text_cfg = text_cfg

    def _kind_cls(self, layer_name: str) -> type:
        if layer_name == "embed":
            return _PromptNode
        if layer_name == "embedding":
            return _PoolNode
        return LayerNodeKind

    def generate_graph_json(self) -> Dict:
        obj = super().generate_graph_json()
        names = self.list_node_names()
        obj["edges"].append({
            "in_port": {"node": 0, "channel": "eot"},
            "out_port": {"node": len(names) - 1, "channel": "eot"},
        })
        return obj


def make_clip_text_model(params: Optional[Any] = None, seed: int = 0,
                         dtype=torch.float32, device="cuda",
                         cfg: Optional[clip_text.CLIPTextConfig] = None
                         ) -> TextTorchModel:
    """Build the registerable CLIP text tower on ``device`` (the card
    unless the caller asks for the CPU; raises without a card).
    ``params=None`` draws a random init from ``torch.Generator`` seeded
    with ``seed``; given params must already be on ``device``. No layer
    launches a kernel, so no layer needs a gradient twin."""
    device = require_device(device)
    cfg = cfg or clip_text.CLIPTextConfig()
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = clip_text.init_params(cfg, gen, dtype=dtype, device=device)
    descriptions = {
        "embed": f"BPE tokenize + token/pos embed (ctx {cfg.context})",
        "embedding": (f"ln_final + eot pool + proj -> L2-normed "
                      f"[{cfg.embed_dim}]"),
        **{f"blocks.{i}": (f"CLIPTextBlock d={cfg.width} h={cfg.heads} "
                           f"(causal, QuickGELU)")
           for i in range(cfg.depth)},
    }
    return TextTorchModel(
        name=cfg.name,
        layers=clip_text.layer_fns(cfg),
        params=params,
        layer_params_fn=clip_text.layer_params,
        descriptions=descriptions,
        category_names=None,
        text_cfg=cfg,
    )


def generate_zeroshot_graph_json(prompts: Optional[List[str]] = None
                                 ) -> Dict:
    """The zero-shot graph: the image tower and the text tower joined at a
    ``similarity`` node, then a category sink labelled with the prompts
    (the JAX function's JSON, node for node)."""
    prompts = prompts or list(DEFAULT_PROMPTS)
    vcfg = clip.CLIPVisionConfig()
    tcfg = clip_text.CLIPTextConfig()

    nodes: List[Dict] = []
    edges: List[Dict] = []

    def add(inst: Dict, x: int, y: int) -> int:
        nodes.append({"instance": inst, "pos": {"x": x, "y": y}})
        return len(nodes) - 1

    def net(endpoint: str, x: int, y: int, **params) -> int:
        return add({"kind": "net_node", "endpoint": endpoint,
                    "params": params}, x, y)

    # the schema's "in_port" is an edge's source, "out_port" its target
    def chain(src: int, dst: int, ch_out="o", ch_in="o") -> None:
        edges.append({"in_port": {"node": src, "channel": ch_out},
                      "out_port": {"node": dst, "channel": ch_in}})

    vnames = [lname for lname, _, _ in clip.layer_fns(vcfg)]
    tnames = [lname for lname, _, _ in clip_text.layer_fns(tcfg)]

    img = add({"kind": "img_src"}, 0, 0)
    prev = img
    for i, lname in enumerate(vnames):
        n = net(f"{vcfg.name}:{lname}", 200 + (i % 6) * 200, (i // 6) * 160)
        chain(prev, n)
        prev = n
    img_emb = prev

    t_embed = None
    prev = None
    for i, lname in enumerate(tnames):
        params = ({"prompts": json.dumps(prompts)} if lname == "embed"
                  else {})
        n = net(f"{tcfg.name}:{lname}", (i % 6) * 200,
                700 + (i // 6) * 160, **params)
        if prev is not None:
            chain(prev, n)
        if lname == "embed":
            t_embed = n
        prev = n
    txt_emb = prev
    chain(t_embed, txt_emb, ch_out="eot", ch_in="eot")

    sim = net("similarity", 1500, 450)
    chain(img_emb, sim, ch_in="a")
    chain(txt_emb, sim, ch_in="b")
    cat = add({"kind": "category", "cats": prompts}, 1700, 450)
    chain(sim, cat)
    return {"nodes": nodes, "edges": edges}
