"""Node-kind registry.

Counterpart of ``interactive_vit_tpu/graph/registry.py``: a registry of
named ``NodeKind``s, each answering ``io(params)`` / ``contents(params)`` /
``compute(params, pinin)``. A kind's computation is a function from a dict
of input tensors to a dict of output tensors (``NodeKind.fn``), with the
kind's weights passed as a second argument when it has ``captures``.
Plugin-directory scanning is not ported yet.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List
from urllib.parse import urlencode

from interactive_vit_tpu_torch.graph.ir import Pinout

logger = logging.getLogger(__name__)

# A node computation: dict[channel -> tensor] -> dict[channel -> tensor].
NodeFn = Callable[[Dict[str, Any]], Dict[str, Any]]


class NodeKind:
    """Base class for a registered node kind."""

    def __init__(self, name: str):
        self.name = name

    def get_name(self) -> str:
        return self.name

    def contents(self, params: Dict[str, str]) -> str:
        """HTML body shown inside the node's box in the UI."""
        return self.name + "?" + urlencode(params)

    def io(self, params: Dict[str, str]) -> Dict[str, List[str]]:
        """Declare input/output channel names: ``{"ins": [...], "outs": [...]}``."""
        raise NotImplementedError(f"io() not implemented for {self.name}")

    def extra_outs(self, params: Dict[str, str]) -> List[str]:
        """Expensive optional output channels (e.g. attention maps), computed
        only when wired or explicitly tapped."""
        return []

    def fn(self, params: Dict[str, str]) -> NodeFn:
        """The node's computation; ``fn(ins, caps)`` when ``captures``
        returns non-None."""
        raise NotImplementedError(f"fn() not implemented for {self.name}")

    def captures(self, params: Dict[str, str]):
        """The node's weights (a tensor tree), or None for stateless ops."""
        return None

    def compute(self, params: Dict[str, str], inputs: Pinout) -> Pinout:
        """Eager evaluation through ``fn``."""
        caps = self.captures(params)
        if caps is None:
            out = self.fn(params)(inputs.as_dict())
        else:
            out = self.fn(params)(inputs.as_dict(), caps)
        return Pinout(out)

    def register(self, reg: "Registry") -> None:
        reg.register(self)


class Registry:
    """Registry of node kinds; callers create one and pass it around."""

    def __init__(self) -> None:
        self.nodes: Dict[str, NodeKind] = {}

    def register(self, node: NodeKind) -> None:
        name = node.get_name()
        if name in self.nodes and self.nodes[name] is not node:
            logger.warning("node kind %r replaced (was %r)", name,
                           type(self.nodes[name]).__name__)
        logger.info("registered node kind: %s", name)
        self.nodes[name] = node

    def get_node(self, name: str) -> NodeKind:
        if name not in self.nodes:
            raise KeyError(f"unknown node kind: {name!r}")
        return self.nodes[name]

    def __contains__(self, name: str) -> bool:
        return name in self.nodes

    def names(self) -> List[str]:
        return sorted(self.nodes)


_instance = Registry()


def registry() -> Registry:
    """The process-wide default registry."""
    return _instance
