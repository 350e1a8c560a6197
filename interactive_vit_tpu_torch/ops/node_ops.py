"""Built-in graph node kinds.

Counterpart of ``interactive_vit_tpu/ops/node_ops.py``, limited for now to
the identity sources and viewer sinks that the saved ViT graphs contain:
``img_src``, ``img_view``, ``multi_view``, ``category``, ``attn_view`` and
``overlay``. The sinks pass their inputs through so that taps can read what
the client-side viewer renders. The compute kinds (cos, binop, slice,
noise, conv2d, resize, saliency, ...) are not ported yet.
"""

from __future__ import annotations

from typing import List

from interactive_vit_tpu_torch.graph.registry import NodeKind, Registry


class IdentityNode(NodeKind):
    """Pass-through for sources and sinks rendered client-side.

    ``optional=True``: viewer semantics, any subset of the declared inputs
    may be wired (the executor skips the missing-input check)."""

    def __init__(self, name: str, ins: List[str], outs: List[str],
                 optional: bool = False):
        super().__init__(name)
        self._ins = ins
        self._outs = outs
        if optional:
            self.optional_inputs = True

    def io(self, params):
        return {"ins": self._ins, "outs": self._outs}

    def fn(self, params):
        ins_names, outs_names = self._ins, self._outs

        def run(ins):
            if not outs_names:
                return {}
            if len(ins_names) == 1 and len(outs_names) == 1:
                return {outs_names[0]: ins[ins_names[0]]}
            return {ch: ins[ch] for ch in outs_names if ch in ins}

        return run


class ImgViewNode(NodeKind):
    """Viewer sink for R, G, B 2-D planes or an 'o' CHW image."""

    # viewers accept any subset of their inputs
    optional_inputs = True

    def __init__(self) -> None:
        super().__init__("img_view")

    def io(self, params):
        return {"ins": ["R", "G", "B", "o"], "outs": []}

    def fn(self, params):
        return lambda ins: {}


def instances():
    """The built-in kinds; ``register_builtin`` registers exactly these."""
    return [
        IdentityNode("img_src", ["o"], ["o"]),
        ImgViewNode(),
        IdentityNode("multi_view", ["o"], []),
        IdentityNode("category", ["o"], []),
        IdentityNode("attn_view", ["attn", "r"], [], optional=True),
        IdentityNode("overlay", ["o", "r"], [], optional=True),
    ]


def register_builtin(reg: Registry) -> None:
    """Register all built-in node kinds."""
    for kind in instances():
        kind.register(reg)
