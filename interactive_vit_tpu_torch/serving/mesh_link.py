"""Serving on a mesh of several ranks: rank 0 owns HTTP, the others follow.

The JAX server is one controller whose jitted programs GSPMD partitions
over the mesh. The port runs one process a device (``torchrun``), each
with its own ``Executor(mesh=)``: a pass's collectives (a DTensor's
redistributions, the pipeline's hops, a group's data gather) meet only if
every rank makes the same executor calls in the same order. So rank 0,
which serves HTTP, sends each executor call to the other ranks before it
makes it (``LeadExecutor``), and every other rank runs ``follow``: it
receives the call (the entry, the graphs with their input tensors, the
taps; the dynamic values ride in the graphs' params) and makes the same
one on its own executor.

The calls travel over a gloo group of the whole world (``MeshLink``,
``broadcast_object_list``), made beside the mesh's own group, whatever
the mesh's backend. One lock on rank 0 makes each send and its call one
step, so the order of sends is the order of calls whichever thread makes
them (the batcher's dispatches, deferred ones included, ``/profile``'s
runs, ``/debug_eval``'s ``run_timed_eager``). A graph that fails raises
the same ``NodeError`` on every rank: rank 0 answers with it, the
followers log it and take the next call. ``App.close`` on rank 0 sends a
stop, and each follower's ``follow`` returns. Where the link fails (a
follower has died), rank 0 fails that call and every later one with a
``RuntimeError`` that names the lost link, and makes no further
collective.
"""

from __future__ import annotations

import datetime
import logging
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch.distributed as dist

from interactive_vit_tpu_torch.graph.ir import Graph

logger = logging.getLogger(__name__)

# the executor calls the app and the batcher make, which a follower makes
# too (the eager debug path holds no collective; it is sent all the same,
# so that a follower's calls are rank 0's, one for one)
ENTRIES = ("run", "run_stacked", "run_timed_eager")
STOP = "stop"
# a follower waits for rank 0's next call as long as the server is idle
IDLE_TIMEOUT = datetime.timedelta(days=365)


def graph_message(graph: Graph) -> Tuple[dict, List[np.ndarray]]:
    """A graph as (nodes and edges in the wire's JSON form, its input
    tensors as numpy arrays of their own dtype)."""
    nodes = [{"endpoint": n.name, "params": dict(n.params)}
             for n in graph.nodes]
    edges, tensors = [], []
    for n in graph.nodes:
        for ch, e in n.inputs.items():
            if e.src is None:
                edges.append({"out_port": {"node": n.index, "channel": ch},
                              "tensor": len(tensors)})
                t = e.tensor
                tensors.append(t.detach().cpu().numpy()
                               if hasattr(t, "detach") else np.asarray(t))
            else:
                edges.append({"out_port": {"node": n.index, "channel": ch},
                              "in_port": {"node": e.src.node.index,
                                          "channel": e.src.channel}})
    return {"nodes": nodes, "edges": edges}, tensors


def graph_of_message(msg: Tuple[dict, List[np.ndarray]]) -> Graph:
    """``graph_message``'s inverse: the same nodes, params, edges and
    input tensors."""
    obj, tensors = msg
    g = Graph()
    for node in obj["nodes"]:
        g.add_node(node["endpoint"], node["params"])
    for e in obj["edges"]:
        dst = g.nodes[e["out_port"]["node"]]
        if "tensor" in e:
            g.add_input(tensors[e["tensor"]], dst, e["out_port"]["channel"])
        else:
            g.connect(g.nodes[e["in_port"]["node"]], e["in_port"]["channel"],
                      dst, e["out_port"]["channel"])
    return g


class MeshLink:
    """Rank 0's executor calls to the other ranks, over a gloo group of
    the whole world. Every rank constructs it, in the same order as its
    other groups (a collective)."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)
        self.lost: Optional[str] = None

    def send(self, entry: str, graphs: List[Graph], taps) -> None:
        """On rank 0: one call to every follower. Raises ``RuntimeError``
        once the link has failed."""
        if self.lost is not None:
            raise RuntimeError(f"mesh follower lost ({self.lost}); this "
                               f"rank makes no further collective")
        msg = (entry, [graph_message(g) for g in graphs], taps)
        try:
            dist.broadcast_object_list([msg], src=0, group=self.group)
        except Exception as err:  # noqa: BLE001 -- a dead peer
            self.lost = str(err) or type(err).__name__
            raise RuntimeError(f"mesh follower lost ({self.lost})") from err

    def recv(self):
        """On a follower: rank 0's next call, (entry, graphs, taps)."""
        box: List[Any] = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        entry, msgs, taps = box[0]
        return entry, [graph_of_message(m) for m in msgs], taps

    def stop(self) -> None:
        """On rank 0: end every follower's loop (once; not after a
        failure)."""
        if self.lost is None:
            self.send(STOP, [], None)
            self.lost = "stopped"


class LeadExecutor:
    """Rank 0's executor on a mesh of several ranks: each entry call
    (``ENTRIES``) is sent to the followers, then made, under one lock.
    Every other attribute is the executor's own (``is_compiled``,
    ``group_sig``, ``device``, ``mesh``, ...: nothing a follower needs)."""

    def __init__(self, executor, link: MeshLink):
        self._ex = executor
        self._link = link
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._ex, name)

    def _call(self, entry: str, graphs: List[Graph], taps, call):
        with self._lock:
            self._link.send(entry, graphs, taps)
            return call()

    def run(self, graph: Graph, taps="all", defer: bool = False):
        return self._call("run", [graph], taps,
                          lambda: self._ex.run(graph, taps, defer=defer))

    def run_stacked(self, graphs: List[Graph], taps="all",
                    defer: bool = False):
        return self._call("run_stacked", list(graphs), taps,
                          lambda: self._ex.run_stacked(graphs, taps,
                                                       defer=defer))

    def run_timed_eager(self, graph: Graph):
        return self._call("run_timed_eager", [graph], None,
                          lambda: self._ex.run_timed_eager(graph))


def follow(executor, link: MeshLink) -> int:
    """A follower's loop: make each of rank 0's calls on ``executor`` (its
    results dropped; a failure logged, rank 0 answers with the same one)
    until the stop. Returns the number of calls made."""
    calls = 0
    while True:
        entry, graphs, taps = link.recv()
        if entry == STOP:
            return calls
        if entry not in ENTRIES:
            raise RuntimeError(f"mesh link: unknown entry {entry!r}")
        calls += 1
        try:
            if entry == "run":
                executor.run(graphs[0], taps)
            elif entry == "run_stacked":
                executor.run_stacked(graphs, taps)
            else:
                executor.run_timed_eager(graphs[0])
        except Exception as err:  # noqa: BLE001 -- rank 0 answers with it
            logger.info("mesh call %d (%s) failed on this rank as on rank "
                        "0: %s", calls, entry, err)
