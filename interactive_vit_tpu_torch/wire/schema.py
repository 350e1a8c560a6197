"""Graph JSON schema: the save/load format and the graph library.

A copy of ``interactive_vit_tpu/wire/schema.py`` (framework-neutral).

    {
      "nodes": [ {"instance": {"kind": ..., ...kind-specific...},
                  "pos": {"x": N, "y": N}}, ... ],
      "edges": [ {"in_port":  {"node": i, "channel": ch},   # producer
                  "out_port": {"node": j, "channel": ch}},  # consumer
                 ... ]
    }

Note the naming quirk kept for compatibility: in this schema ``in_port`` is
the edge's SOURCE and ``out_port`` its DESTINATION, the opposite of the wire
protocol's usage. ``net_node`` instances become graph nodes named by their
endpoint; other kinds (``category``, ``img_view``, ...) become nodes named
by their kind, with their instance fields folded into params.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

from interactive_vit_tpu_torch.graph.ir import Graph, GraphError


def generate_model_graph_json(
    node_names: List[str],
    extra_nodes: Optional[List[Dict]] = None,
    extra_edges: Optional[List[Dict]] = None,
) -> Dict:
    """Auto-layout a linear model chain in a sqrt(n) grid.

    Parity with ``main/context.py:55-73``: one ``net_node`` per layer, chained
    o->o, positions on a 200px grid.
    """
    obj: Dict = {"nodes": [], "edges": []}
    cnt = len(node_names)
    w = max(1, int(math.sqrt(cnt)))
    for i, name in enumerate(node_names):
        obj["nodes"].append(
            {
                "instance": {"kind": "net_node", "endpoint": name, "params": {}},
                "pos": {"x": (i % w) * 200, "y": (i // w) * 200},
            }
        )
        if i != 0:
            obj["edges"].append(
                {
                    "in_port": {"node": i - 1, "channel": "o"},
                    "out_port": {"node": i, "channel": "o"},
                }
            )
    if extra_nodes:
        obj["nodes"].extend(extra_nodes)
    if extra_edges:
        obj["edges"].extend(extra_edges)
    return obj


def graph_from_json(obj: Dict) -> Graph:
    """Build an executable ``Graph`` from a saved graph JSON.

    ``net_node`` instances become graph nodes named by their endpoint; other
    instance kinds become nodes named by their kind (so a server that
    registers e.g. a ``binop`` NodeKind can evaluate reference-saved graphs
    fully server-side). Kind-specific instance fields are folded into params
    as JSON strings so NodeKinds can recover them.
    """
    g = Graph()
    for node_json in obj["nodes"]:
        inst = node_json["instance"]
        kind = inst["kind"]
        if kind == "net_node":
            g.add_node(inst["endpoint"], inst.get("params", {}))
        else:
            params = {
                k: v if isinstance(v, str) else json.dumps(v)
                for k, v in inst.items()
                if k != "kind"
            }
            g.add_node(kind, params)
    for edge_json in obj["edges"]:
        si = int(edge_json["in_port"]["node"])
        di = int(edge_json["out_port"]["node"])
        # explicit range check: a negative index would WRAP via Python
        # list indexing and silently mis-wire the graph (wrong results
        # with HTTP 200 instead of a structured error)
        for idx in (si, di):
            if not 0 <= idx < len(g.nodes):
                raise GraphError(f"edge references nonexistent node {idx}")
        src = g.nodes[si]
        dst = g.nodes[di]
        g.connect(
            src,
            edge_json["in_port"]["channel"],
            dst,
            edge_json["out_port"]["channel"],
        )
    return g


class GraphLibrary:
    """Directory of saved graph JSONs (``static/graphs`` contract).

    Backs the ``list_graphs`` / ``load_graph`` endpoints
    (``main/views.py:44-59``) with path-traversal protection.
    """

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def list(self) -> List[str]:
        return sorted(
            f for f in os.listdir(self.root) if f.endswith(".json")
        )

    def _path(self, name: str) -> str:
        # realpath, not abspath: a symlink under root would let a
        # lexically-contained name resolve outside the library
        root = os.path.realpath(self.root)
        path = os.path.realpath(os.path.join(root, name))
        if not path.startswith(root + os.sep):
            raise ValueError(f"illegal graph name: {name!r}")
        return path

    def load(self, name: str) -> Dict:
        with open(self._path(name), "r", encoding="utf-8") as f:
            return json.load(f)

    def load_bytes(self, name: str) -> bytes:
        with open(self._path(name), "rb") as f:
            return f.read()

    def save(self, name: str, obj: Dict) -> None:
        # atomic: concurrent /load_graph readers (threaded HTTP server)
        # must never see torn JSON, and a failed dump must not destroy
        # the previously-valid saved graph
        path = self._path(name)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(obj, f)
        os.replace(tmp, path)

    def exists(self, name: str) -> bool:
        try:
            return os.path.exists(self._path(name))
        except ValueError:
            return False
