"""ToMe-ViT plugin: a ToMe variant as tappable graph node kinds.

Counterpart of ``interactive_vit_tpu/models/tome_plugin.py``. Registers
``vit_b16_tome:<layer>`` node kinds. Block nodes extend the ViT chain with
the ToMe channels: the sizes ``s`` and the original-token assignment ``a``
flow between blocks (the generated graph JSON wires them beside ``o``),
and every block can tap ``merge``, a colour map of which original patches
have merged into each surviving token.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from interactive_vit_tpu_torch.models import tome
from interactive_vit_tpu_torch.models.labels import class_names
from interactive_vit_tpu_torch.models.model_plugin import (
    LayerNodeKind, TorchModel,
)
from interactive_vit_tpu_torch.ops.dispatch import default_block_impl
from interactive_vit_tpu_torch.runtime.device import require_device


class ToMeBlockKind(LayerNodeKind):
    """A block node that takes the flowing ToMe channels, all optional."""

    OPTIONAL_INS = ("s", "a", "r")

    def io(self, params):
        return {"ins": ["o", "s", "a", "r"], "outs": ["o"] + self._extra}

    @property
    def optional_inputs(self):
        return frozenset(self.OPTIONAL_INS)


class ToMeModel(TorchModel):
    """A ``TorchModel`` whose generated graph wires ``s`` and ``a`` along
    the chain."""

    def _kind_cls(self, layer_name: str) -> type:
        return (ToMeBlockKind if layer_name.startswith("blocks.")
                else LayerNodeKind)

    def generate_graph_json(self) -> Dict:
        obj = super().generate_graph_json()
        blocks = [i for i, n in enumerate(obj["nodes"])
                  if ":blocks." in n["instance"].get("endpoint", "")]
        for a, b in zip(blocks, blocks[1:]):
            for ch in ("s", "a"):
                obj["edges"].append(
                    {"in_port": {"node": a, "channel": ch},
                     "out_port": {"node": b, "channel": ch}})
        return obj


def make_tome_model(
    variant: str = "vit_b16_tome",
    params: Optional[Any] = None,
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
    kernels: bool = True,
) -> TorchModel:
    """Build a registerable ToMe-ViT on ``device`` (the card unless the
    caller asks for the CPU; raises without a card).

    ``params`` takes any plain-ViT tree of the same geometry (merging is
    post-hoc), already on ``device`` in ``dtype``; ``None`` draws a random
    init from ``torch.Generator`` seeded with ``seed``. The block kernel
    is resolved through ``default_block_impl("auto")``, sized at the entry
    length (the ladder's largest N, so every later block fits too): on a
    CUDA device ``fused_attn_block`` with ``key_bias`` and ``want_metric``
    in every block, on the CPU (or with ``kernels=False``) the unfused
    path. With the kernel, every layer has its plain twin for gradient
    replays (``grad_layers``)."""
    device = require_device(device)
    cfg = tome.VARIANTS[variant]
    if params is None:
        params = tome.init_params(cfg, torch.Generator().manual_seed(seed),
                                  dtype=dtype, device=device)
    block_impl = (default_block_impl("auto", dtype=dtype, n=cfg.tokens,
                                     d=cfg.width, heads=cfg.heads,
                                     device=device) if kernels else None)
    # the block kernel has no backward: gradient replays run the plain
    # path's layers
    grad_layers = ({ln: f for ln, _e, f in tome.layer_fns(cfg)}
                   if block_impl is not None else None)
    n_last = cfg.n_tokens(cfg.depth)
    descriptions = {
        "transform": f"Resize+CenterCrop({cfg.img_size})+Normalize",
        "embed": f"PatchEmbed p={cfg.patch} d={cfg.width} + CLS + pos "
                 f"[B,{cfg.tokens},{cfg.width}]",
        "norm": "final LayerNorm",
        "head": f"Linear({cfg.width} -> {cfg.num_classes}) "
                f"on {n_last} surviving tokens",
        **{f"blocks.{i}": (f"ToMe block d={cfg.width} h={cfg.heads}: "
                           f"{cfg.n_tokens(i)} -> {cfg.n_tokens(i + 1)} "
                           f"tokens (tap 'merge' for the patch-merge map)")
           for i in range(cfg.depth)},
    }
    return ToMeModel(
        name=cfg.name,
        layers=tome.layer_fns(cfg, block_impl=block_impl),
        params=params,
        layer_params_fn=tome.layer_params,
        descriptions=descriptions,
        category_names=(class_names(1000) if cfg.num_classes == 1000
                        else None),
        grad_layers=grad_layers,
    )
