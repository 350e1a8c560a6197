"""Built-in graph node kinds.

Counterpart of ``interactive_vit_tpu/ops/node_ops.py``, limited for now to
the identity sources and viewer sinks that the saved ViT graphs contain
(``img_src``, ``img_view``, ``multi_view``, ``category``, ``attn_view`` and
``overlay``) and ``cos``, the first kind with dynamic params. The sinks
pass their inputs through so that taps can read what the client-side
viewer renders. The other compute kinds (binop, slice, noise, conv2d,
resize, saliency, ...) are not ported yet.

  cos       params A, b           -> cos(A*x + b); A and b are dynamic
"""

from __future__ import annotations

import html
from typing import Dict, List

import torch

from interactive_vit_tpu_torch.graph.registry import NodeKind, Registry


def _num_input(name: str, value, step="any", title=None) -> str:
    """A labeled numeric input bound to a node param (the ``data-param``
    convention the frontend binds to the node's params dict)."""
    label = html.escape(title or name)
    return (
        f"<label>{label} <input data-param=\"{html.escape(name)}\" "
        f"type=\"number\" step=\"{step}\" value=\"{value}\"></label>"
    )


class CosNode(NodeKind):
    """Elementwise cos(A*x + b), the reference's demo server node. A and b
    are dynamic params: they ride as 0-d f32 captures, so an edit reuses
    the executor's cached program."""

    def __init__(self) -> None:
        super().__init__("cos")

    def decode_params(self, params: Dict[str, str]):
        return float(params.get("A", 1.0)), float(params.get("b", 0.0))

    def contents(self, params):
        a, b = self.decode_params(params)
        return (f"<p>cos(A&middot;x + b)</p>"
                f"{_num_input('A', a)} {_num_input('b', b)}")

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def dynamic_params(self):
        return frozenset({"A", "b"})

    def captures(self, params):
        a, b = self.decode_params(params)
        return {"A": torch.tensor(a, dtype=torch.float32),
                "b": torch.tensor(b, dtype=torch.float32)}

    def fn(self, params):
        def run(ins, caps):
            x = ins["o"]
            # the captures cast to the stream's dtype, as the JAX kind
            # casts them: a bf16 stream stays bf16
            a = caps["A"].to(x.dtype)
            b = caps["b"].to(x.dtype)
            return {"o": torch.cos(a * x + b)}

        return run


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
        CosNode(),
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
