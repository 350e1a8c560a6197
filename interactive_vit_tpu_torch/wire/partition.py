"""Server-side mirror of the client's local/server partition rule.

The frontend evaluates cheap viewer-local ops client-side (zero round
trip — the reference's WebGPU capability, its
``main/static/main/gpu.js:144-283``) and ships everything else to the
server in ONE batched request (the reference's subgraph batching, its
``main/static/main/nodes/net_node.js:346-369``).
The DECISION — which nodes evaluate where, and the exact request the
server receives — lives in ``frontend/js/partition.js`` (pure, DOM-free)
and is re-derived here line-for-line so CI can pin it without a JS
runtime (VERDICT r3 #2): ``tests/fixtures/partition_fixtures.json``
commits {scenario graph, expected local set, expected exact request
bytes}, ``tests/test_torch_partition_render.py`` replays them through THIS
module (the port's copy of ``interactive_vit_tpu/wire/partition.py``), and
``frontend/js/wire.test.mjs`` replays the same file through the real JS
rule whenever a runtime exists. A behavior change in either
implementation breaks the committed fixtures.

Graph description (plain data, index-addressed — the same shape
``graph.js Context.describe()`` produces)::

    nodes: [{"kind", "source", "viewer", "has_tensor", "ins": ["o", ...]}]
    edges: [{"src": {"node", "channel"}, "dst": {"node", "channel"}}]
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

# client-side role tables (frontend/js/localops.js LOCAL_KINDS,
# frontend/js/nodes.js isSource/isViewer)
LOCAL_KINDS = frozenset(
    {"cos", "binop", "slice", "shuffle", "const", "conv2d", "resize"})
SOURCE_KINDS = frozenset({"img_src"})
VIEWER_KINDS = frozenset(
    {"img_view", "multi_view", "category", "attn_view", "overlay"})

Node = Dict
Edge = Dict


def _first_edge_to(edges: List[Edge], node: int, channel: str):
    for e in edges:
        if e["dst"]["node"] == node and e["dst"]["channel"] == channel:
            return e
    return None


def ready_set(nodes: List[Node], edges: List[Edge]) -> List[bool]:
    """``partition.js readySet``: sources ready iff they hold a tensor;
    others iff every wired input's producer is transitively ready. An
    unwired input gates readiness unless its channel is the optional
    rollout carry ``"r"``."""
    ready: List = [None] * len(nodes)

    def is_ready(i: int) -> bool:
        if ready[i] is not None:
            return ready[i]
        ready[i] = False  # cycle guard
        n = nodes[i]
        if n["source"]:
            ok = bool(n["has_tensor"])
        else:
            ok = True
            for ch in n["ins"]:
                e = _first_edge_to(edges, i, ch)
                if e is None:
                    if ch != "r":
                        ok = False
                        break
                elif not is_ready(e["src"]["node"]):
                    ok = False
                    break
        ready[i] = ok
        return ok

    for i in range(len(nodes)):
        is_ready(i)
    return ready


def local_set(nodes: List[Node], edges: List[Edge],
              ready: List[bool]) -> Set[int]:
    """``partition.js localSet``: client-evaluable nodes — kind has a
    local impl, whole input ancestry client-held, and NO non-viewer
    descendant needs the server."""
    capable: List = [None] * len(nodes)

    def is_capable(i: int) -> bool:
        if capable[i] is not None:
            return capable[i]
        capable[i] = False  # cycle guard
        n = nodes[i]
        if n["source"]:
            ok = bool(n["has_tensor"])
        elif n["viewer"] or n["kind"] not in LOCAL_KINDS or not ready[i]:
            ok = False
        else:
            ok = all(
                (e := _first_edge_to(edges, i, ch)) is None
                or is_capable(e["src"]["node"])
                for ch in n["ins"])
        capable[i] = ok
        return ok

    for i in range(len(nodes)):
        is_capable(i)

    feeds_server: List = [None] * len(nodes)

    def check(i: int) -> bool:
        if feeds_server[i] is not None:
            return feeds_server[i]
        feeds_server[i] = False  # cycle guard
        hit = False
        for e in edges:
            if e["src"]["node"] != i:
                continue
            m = e["dst"]["node"]
            if nodes[m]["viewer"]:
                continue
            m_local = capable[m] and not nodes[m]["source"]
            if not m_local or check(m):
                hit = True
                break
        feeds_server[i] = hit
        return hit

    return {
        i for i, n in enumerate(nodes)
        if not n["source"] and not n["viewer"] and capable[i]
        and not check(i)
    }


def plan_request(nodes: List[Node], edges: List[Edge], ready: List[bool],
                 local: Set[int]) -> Dict:
    """``partition.js planRequest``: the server request plan in ORIGINAL
    node indices — ``req`` members in node order, ``taps``/``edges`` in
    edge order, ``tensors`` = source node index per shipped tensor in
    first-use order (deduped per source)."""
    req = [i for i, n in enumerate(nodes)
           if not n["source"] and not n["viewer"] and ready[i]
           and i not in local]
    index = {n: k for k, n in enumerate(req)}

    taps = []
    for e in edges:
        if nodes[e["dst"]["node"]]["viewer"] and e["src"]["node"] in index:
            taps.append({"node": index[e["src"]["node"]],
                         "channel": e["src"]["channel"]})

    out_edges: List[Dict] = []
    tensors: List[int] = []
    tensor_index: Dict[int, int] = {}
    for e in edges:
        if e["dst"]["node"] not in index:
            continue  # viewer inputs come from taps
        s = e["src"]["node"]
        dst_port = {"node": index[e["dst"]["node"]],
                    "channel": e["dst"]["channel"]}
        if s in index:
            out_edges.append({
                "out_port": dst_port,
                "in_port": {"node": index[s],
                            "channel": e["src"]["channel"]},
            })
        elif nodes[s]["source"]:
            if not nodes[s]["has_tensor"]:
                continue  # omit, server errors per-node
            ti = tensor_index.get(s)
            if ti is None:
                ti = len(tensors)
                tensors.append(s)
                tensor_index[s] = ti
            out_edges.append({"out_port": dst_port, "tensor": ti})
    return {"req": req, "taps": taps, "edges": out_edges,
            "tensors": tensors}


def partition(nodes: List[Node],
              edges: List[Edge]) -> Tuple[List[bool], Set[int], Dict]:
    """Convenience: (ready, local, request plan) in one call."""
    r = ready_set(nodes, edges)
    lo = local_set(nodes, edges, r)
    return r, lo, plan_request(nodes, edges, r, lo)
