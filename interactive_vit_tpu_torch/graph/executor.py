"""Eager graph executor with the JAX executor's contract.

Counterpart of ``interactive_vit_tpu/graph/executor.py``: validates a graph
with per-node error attribution, resolves a tap spec, runs the nodes in
topological order on one device, and returns the tapped outputs as
``{node_index: {channel: array}}``. PyTorch runs eagerly, so there is no
staging, program cache or jit; untapped outputs are still computed, except
the expensive optional channels (attention maps, rollout), which node kinds
skip unless they are tapped or wired (``ir.effective_params``).

Tap sets
--------
``taps="all"``      every output channel of every node (wire-protocol parity).
``taps="primary"``  every output EXCEPT unconsumed expensive extras
                    (attention maps) -- the serving default.
``taps="sinks"``    only output channels with no consumer inside the graph.
``taps={(i,ch)}``   an explicit set -- the interactive fast path.

Not ported yet: compiled execution (CUDA graphs), layouts, pipeline
folding, meshes and gradient nodes. ``run_stacked`` runs a group's graphs
one after another; concatenating them into one batch comes later.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from interactive_vit_tpu_torch.graph.ir import Graph, GraphError, effective_params
from interactive_vit_tpu_torch.graph.registry import Registry, registry
from interactive_vit_tpu_torch.runtime.device import require_device

logger = logging.getLogger(__name__)

TapSpec = Union[str, Iterable[Tuple[int, str]]]


class NodeError(Exception):
    """An error attributed to one graph node (TargettedError contract)."""

    def __init__(self, node_index: int, node_name: str, message: str):
        super().__init__(f"node {node_index} ({node_name}): {message}")
        self.node_index = node_index
        self.node_name = node_name
        self.message = message


def _consumed(graph: Graph) -> Set[Tuple[int, str]]:
    return {(e.src.node.index, e.src.channel)
            for n in graph.nodes for e in n.inputs.values()
            if e.src is not None}


def resolve_taps(
    graph: Graph, taps: TapSpec, reg: Optional[Registry] = None
) -> Set[Tuple[int, str]]:
    """Expand a tap spec into a concrete set of (node_index, channel)."""
    reg = reg or registry()
    if taps == "all":
        return {(n.index, ch) for n in graph.nodes
                for ch in reg.get_node(n.name).io(n.params)["outs"]}
    if taps == "primary":
        # all outputs minus UNCONSUMED extras: attention maps ship only
        # when wired or explicitly requested
        consumed = _consumed(graph)
        out = set()
        for n in graph.nodes:
            kind = reg.get_node(n.name)
            extras = set(kind.extra_outs(n.params))
            for ch in kind.io(n.params)["outs"]:
                if ch not in extras or (n.index, ch) in consumed:
                    out.add((n.index, ch))
        return out
    if taps == "sinks":
        return resolve_taps(graph, "all", reg) - _consumed(graph)
    # explicit tap set: validate every (node, channel) now, so an unknown
    # key is a structured error and not a silently partial response
    out = set(taps)  # type: ignore[arg-type]
    for i, ch in out:
        if not isinstance(i, int) or i < 0 or i >= len(graph.nodes):
            raise GraphError(f"tap references nonexistent node {i}")
        n = graph.nodes[i]
        outs = reg.get_node(n.name).io(n.params)["outs"]
        if ch not in outs:
            raise NodeError(i, n.name, f"tap channel {ch!r} is not an "
                                       f"output of this node (outs: {outs})")
    return out


class ExecStats:
    """Per-run timing of the last ``run``/``run_stacked``."""

    def __init__(self) -> None:
        self.stage_s: float = 0.0
        self.execute_s: float = 0.0


def host_array(t: torch.Tensor) -> np.ndarray:
    """A node output as f32 numpy (the wire's tensor type)."""
    return t.detach().float().cpu().numpy()


class Executor:
    """Runs graphs eagerly on ``device`` (the card unless the caller asks
    for the CPU; raises without a card)."""

    def __init__(self, reg: Optional[Registry] = None, device="cuda"):
        self.reg = reg or registry()
        self.device = require_device(device)
        self.last_stats = ExecStats()

    # -- validation -----------------------------------------------------------
    def validate(self, graph: Graph) -> None:
        """Structural validation with per-node error attribution."""
        graph.order()  # raises GraphError on cycles
        for n in graph.nodes:
            try:
                kind = self.reg.get_node(n.name)
            except KeyError as e:
                raise NodeError(n.index, n.name, str(e)) from e
            io = kind.io(n.params)
            for ch in n.inputs:
                if ch not in io["ins"]:
                    raise NodeError(n.index, n.name,
                                    f"unknown input channel {ch!r}")
            for ch, edges in n.outputs.items():
                if any(e.dst is not None for e in edges) and ch not in io["outs"]:
                    raise NodeError(n.index, n.name,
                                    f"unknown output channel {ch!r}")
            # optional_inputs: True = all optional, or a set of channel
            # names (only those may be unwired)
            optional = getattr(kind, "optional_inputs", False)
            if optional is not True:
                skip = optional if isinstance(optional, (set, frozenset)) \
                    else frozenset()
                for ch in io["ins"]:
                    if ch not in n.inputs and ch not in skip:
                        raise NodeError(n.index, n.name,
                                        f"missing input {ch!r}")

    def group_sig(self, graph: Graph, extra=()) -> str:
        """Batching signature: graphs with equal signatures have the same
        topology, params, input shapes and (through ``extra``) taps."""
        return graph.signature(extra=list(extra))

    def _input(self, t) -> torch.Tensor:
        # a copy: wire tensors are read-only views of the request bytes
        return torch.from_numpy(np.array(t)).to(self.device)

    def _eval_node(self, n, env, tap_set) -> None:
        """Evaluate one node into ``env``, attributing failures to it."""
        kind = self.reg.get_node(n.name)
        ins = {ch: (env[("in", n.index, ch)] if e.src is None
                    else env[(e.src.node.index, e.src.channel)])
               for ch, e in n.inputs.items()}
        params = effective_params(n, tap_set)
        try:
            caps = kind.captures(params)
            f = kind.fn(params)
            outs = f(ins) if caps is None else f(ins, caps)
        except NodeError:
            raise
        except Exception as err:  # noqa: BLE001 -- attribution contract
            raise NodeError(n.index, n.name, str(err)) from err
        for ch, v in outs.items():
            env[(n.index, ch)] = v

    # -- the production path ----------------------------------------------------
    @torch.inference_mode()
    def run(self, graph: Graph, taps: TapSpec = "all"
            ) -> Dict[int, Dict[str, np.ndarray]]:
        """Validate, run and return ``{node_index: {channel: f32 numpy}}``."""
        stats = ExecStats()
        t0 = time.perf_counter()
        self.validate(graph)
        tap_set = resolve_taps(graph, taps, self.reg)
        env: Dict[Any, Any] = {("in", n.index, ch): self._input(e.tensor)
                               for n, ch, e in graph.input_edges()}
        stats.stage_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for n in graph.order():
            self._eval_node(n, env, tap_set)
        result: Dict[int, Dict[str, np.ndarray]] = {}
        # "i/ch" string order: the route order of the JAX executor's
        # responses (its outputs are a dict pytree keyed "i/ch")
        for i, ch in sorted(tap_set, key=lambda k: f"{k[0]}/{k[1]}"):
            if (i, ch) in env:
                result.setdefault(i, {})[ch] = host_array(env[(i, ch)])
        stats.execute_s = time.perf_counter() - t0
        self.last_stats = stats
        return result

    def run_stacked(self, graphs: List[Graph], taps: TapSpec = "all"
                    ) -> List[Dict[int, Dict[str, np.ndarray]]]:
        """Run K graphs that share a group signature; returns K result
        dicts, equal to K separate ``run``s (they run one after another)."""
        if not graphs:
            raise ValueError("run_stacked: empty batch")
        sig0 = self.group_sig(graphs[0])
        for g in graphs[1:]:
            if self.group_sig(g) != sig0:
                raise ValueError("run_stacked: mixed graph signatures")
        t0 = time.perf_counter()
        results = [self.run(g, taps) for g in graphs]
        self.last_stats = ExecStats()
        self.last_stats.execute_s = time.perf_counter() - t0
        return results

    # -- the debug path -----------------------------------------------------------
    @torch.inference_mode()
    def run_eager(
        self, graph: Graph
    ) -> Tuple[Dict[int, Dict[str, np.ndarray]], Dict[int, str]]:
        """Per-node evaluation with fault isolation.

        Returns (outputs, errors). A failing node's descendants are skipped
        with an "eval error upstream" marker, the client graph engine's
        semantics; the other nodes still run."""
        outputs: Dict[int, Dict[str, np.ndarray]] = {}
        errors: Dict[int, str] = {}
        failed: Set[int] = set()
        env: Dict[Any, Any] = {}
        for n, ch, e in graph.input_edges():
            env[("in", n.index, ch)] = self._input(e.tensor)
        for n in graph.order():
            if any(e.src is not None and e.src.node.index in failed
                   for e in n.inputs.values()):
                failed.add(n.index)
                errors[n.index] = "eval error upstream"
                continue
            try:
                self._eval_node(n, env, None)
                outputs[n.index] = {k[1]: host_array(v) for k, v in env.items()
                                    if k[0] == n.index}
            except Exception as err:  # noqa: BLE001 -- per-node isolation
                failed.add(n.index)
                errors[n.index] = str(err)
        return outputs, errors
