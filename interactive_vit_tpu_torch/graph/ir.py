"""In-memory dataflow-graph IR.

A copy of ``interactive_vit_tpu/graph/ir.py``, which is framework-neutral
(numpy only): a ``Graph`` of ``Node``s with string-keyed input/output
channels, ``Edge``s that carry tensors, graph-level input edges, a
linear-time topological order with cycle detection, and a canonical
``Graph.signature()`` that the executor and the micro-batcher key on. It is
copied, not imported, so that this package never loads the JAX package.
Edges carry numpy arrays (wire inputs) or torch tensors.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

TensorLike = Any  # np.ndarray | torch.Tensor


class GraphError(Exception):
    """Structural graph problem (cycle, dangling port, missing input)."""


class Port:
    """One endpoint of an edge: (node, channel-name, direction).

    Mirrors ``main/graph.py:39-43``.
    """

    __slots__ = ("node", "channel", "direction")

    def __init__(self, node: "Node", channel: str, direction: str) -> None:
        assert direction in ("in", "out"), direction
        self.node = node
        self.channel = channel
        self.direction = direction

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Port({self.node.index}:{self.channel}:{self.direction})"


class Edge:
    """A directed edge carrying an optional tensor value.

    ``src is None`` marks a graph-level input edge (the reference's
    ``Graph.add_input``, ``main/graph.py:72-77``).
    """

    __slots__ = ("src", "dst", "tensor")

    def __init__(self, src: Optional[Port], dst: Optional[Port]) -> None:
        if src is not None:
            assert src.direction == "out"
        if dst is not None:
            assert dst.direction == "in"
        self.src = src
        self.dst = dst
        self.tensor: Optional[TensorLike] = None


class Pinout:
    """String-keyed bundle of tensors moving in or out of a node.

    Contract of ``main/graph.py:123-132``; extended with dict conveniences
    because the staged executor passes these as plain dicts internally.
    """

    def __init__(self, init: Optional[Dict[str, TensorLike]] = None) -> None:
        self.pinout: Dict[str, TensorLike] = dict(init) if init else {}

    def set(self, ch: str, t: TensorLike) -> None:
        self.pinout[ch] = t

    def get(self, ch: str) -> Optional[TensorLike]:
        return self.pinout.get(ch)

    def channels(self) -> List[str]:
        return list(self.pinout.keys())

    def as_dict(self) -> Dict[str, TensorLike]:
        return dict(self.pinout)


def effective_params(node: "Node", tap_set=None) -> Dict[str, str]:
    """``node.params`` plus ``__taps__``: the sorted output channels that
    are tapped or consumed downstream. Node kinds with expensive optional
    outputs (attention maps, rollout) read it to decide what to emit —
    EVERY evaluation path (staged executor, eager debug, registry compute,
    per-node timings) must inject it or wired extra channels silently
    never get computed."""
    live = {ch for (i, ch) in (tap_set or ()) if i == node.index}
    for ch, edges in node.outputs.items():
        if any(e.dst is not None for e in edges):
            live.add(ch)
    return dict(node.params, __taps__=",".join(sorted(live)))


class Node:
    """Graph node: a node-kind name plus stringly-typed params.

    Params are ``Dict[str, str]`` on purpose — they travel as URL-style query
    strings in the wire contract (reference ``main/graph.py:7-10`` and
    ``views.py:19``).

    Unlike the reference (which stored ONE edge per output channel,
    ``main/graph.py:64-70`` — silently breaking fan-out because a second
    ``connect`` from the same channel overwrote the first edge), ``outputs``
    maps each channel to a *list* of edges. The client graph always supported
    fan-out; this makes the server IR match.
    """

    __slots__ = ("name", "params", "index", "inputs", "outputs")

    def __init__(self, name: str, params: Dict[str, str], index: int) -> None:
        self.name = name
        self.params = dict(params)
        self.index = index
        self.inputs: Dict[str, Edge] = {}
        self.outputs: Dict[str, List[Edge]] = {}

    # -- reference-parity accessors (main/graph.py:15-36) --------------------
    def get_pinin(self) -> Pinout:
        res = Pinout()
        for ch, e in self.inputs.items():
            if e.tensor is None:
                raise GraphError(
                    f"node {self.index} ({self.name}): input '{ch}' has no value"
                )
            res.set(ch, e.tensor)
        return res

    def set_pinout(self, pinout: Pinout) -> None:
        for ch, t in pinout.pinout.items():
            if ch in self.outputs:
                for e in self.outputs[ch]:
                    e.tensor = t
            else:
                edge = Edge(Port(self, ch, "out"), None)
                edge.tensor = t
                self.outputs[ch] = [edge]

    def get_pinout(self) -> Pinout:
        res = Pinout()
        for ch, edges in self.outputs.items():
            for e in edges:
                if e.tensor is not None:
                    res.set(ch, e.tensor)
                    break
        return res

    def out_edges(self) -> List["Edge"]:
        return [e for edges in self.outputs.values() for e in edges]

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Node({self.index}, {self.name!r})"


class Graph:
    """A DAG of nodes. API parity with ``main/graph.py:55-99``."""

    def __init__(self) -> None:
        self.nodes: List[Node] = []

    def add_node(self, name: str, params: Optional[Dict[str, str]] = None) -> Node:
        node = Node(name, params or {}, len(self.nodes))
        self.nodes.append(node)
        return node

    def connect(self, a: Node, a_ch: str, b: Node, b_ch: str) -> Edge:
        self._drop_input(b, b_ch)
        edge = Edge(Port(a, a_ch, "out"), Port(b, b_ch, "in"))
        a.outputs.setdefault(a_ch, []).append(edge)
        b.inputs[b_ch] = edge
        return edge

    def add_input(self, value: TensorLike, node: Node, channel: str) -> Edge:
        self._drop_input(node, channel)
        edge = Edge(None, Port(node, channel, "in"))
        edge.tensor = value
        node.inputs[channel] = edge
        return edge

    @staticmethod
    def _drop_input(node: Node, channel: str) -> None:
        """Detach any existing edge into (node, channel): re-connecting an
        input must not leave the stale edge in the old source's outputs —
        it would double-count the destination's indegree in ``order()``
        (a malformed wire request could then topo-sort a consumer before
        its real producer)."""
        old = node.inputs.pop(channel, None)
        if old is not None and old.src is not None:
            edges = old.src.node.outputs.get(old.src.channel, [])
            if old in edges:
                edges.remove(old)

    # -- analysis -------------------------------------------------------------
    def input_edges(self) -> List[Tuple[Node, str, Edge]]:
        """Graph-level inputs in deterministic (node index, channel) order."""
        res = []
        for node in self.nodes:
            for ch in sorted(node.inputs):
                e = node.inputs[ch]
                if e.src is None:
                    res.append((node, ch, e))
        return res

    def order(self) -> List[Node]:
        """Topological order (Kahn), raising ``GraphError`` on cycles.

        The reference's version (``main/graph.py:79-99``) is O(V^2) and loops
        forever on a cycle; this one is O(V+E).
        """
        indeg: Dict[int, int] = {n.index: 0 for n in self.nodes}
        for n in self.nodes:
            for e in n.inputs.values():
                if e.src is not None:
                    indeg[n.index] += 1

        ready = [n for n in self.nodes if indeg[n.index] == 0]
        res: List[Node] = []
        while ready:
            x = ready.pop()
            res.append(x)
            for e in x.out_edges():
                if e.dst is not None:
                    d = e.dst.node
                    indeg[d.index] -= 1
                    if indeg[d.index] == 0:
                        ready.append(d)
        if len(res) != len(self.nodes):
            raise GraphError("graph contains a cycle")
        return res

    def signature(self, extra: Iterable[Any] = (),
                  param_filter=None) -> str:
        """Canonical key for compile caching.

        Captures topology + node kinds + params + input shapes/dtypes; two
        graphs with equal signatures run the same computation.
        ``param_filter(node) -> dict`` selects which params participate —
        the executor drops each kind's ``dynamic_params`` (their values
        ride as runtime captures, so they don't change the program).
        """
        pf = param_filter or (lambda n: n.params)
        desc = {
            "nodes": [
                {"name": n.name, "params": sorted(pf(n).items())}
                for n in self.nodes
            ],
            "edges": sorted(
                (
                    e.src.node.index,
                    e.src.channel,
                    n.index,
                    ch,
                )
                for n in self.nodes
                for ch, e in n.inputs.items()
                if e.src is not None
            ),
            "inputs": [
                (
                    node.index,
                    ch,
                    list(np.shape(e.tensor)),
                    str(np.asarray(e.tensor).dtype)
                    if e.tensor is not None and not hasattr(e.tensor, "dtype")
                    else (str(e.tensor.dtype) if e.tensor is not None else None),
                )
                for node, ch, e in self.input_edges()
            ],
            "extra": list(extra),
        }
        blob = json.dumps(desc, sort_keys=True, default=str).encode()
        return hashlib.sha256(blob).hexdigest()

    def __str__(self) -> str:
        """Debug printer (parity with ``main/graph.py:101-121``)."""
        lines = ["graph:"]
        for node in self.nodes:
            tag = f"{node.index}:{node.name}"
            for ch, edges in node.outputs.items():
                for e in edges:
                    dst = (
                        f"{e.dst.node.index}:{e.dst.node.name}"
                        if e.dst is not None
                        else "*"
                    )
                    shape = (
                        f" {tuple(np.shape(e.tensor))}" if e.tensor is not None else ""
                    )
                    lines.append(f"\t{tag} --[{ch}]--> {dst}{shape}")
            for ch, e in node.inputs.items():
                if e.src is None:
                    shape = (
                        f" {tuple(np.shape(e.tensor))}" if e.tensor is not None else ""
                    )
                    lines.append(f"\t* --[{ch}]--> {tag}{shape}")
        return "\n".join(lines)
