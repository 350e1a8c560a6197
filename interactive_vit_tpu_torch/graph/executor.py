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

Micro-batches
-------------
``run_stacked`` runs K graphs that share a group signature as ONE pass:
each input edge's tensors stack on a new axis 0, every node runs once
through its kind's ``stacked_fn`` (a model layer folds K into its batch
axis, so each block kernel launches once with a batch of K), and the
tapped outputs split into K result dicts equal to K separate ``run``s.
``defer=True`` (both paths) returns an ``InFlight`` handle: the tapped
outputs are already on their way to page-locked host buffers behind the
group's own launches, and ``materialize()`` waits for them -- the
micro-batcher's pipelining hook.

Not ported yet: compiled execution (CUDA graphs), layouts, pipeline
folding, meshes and gradient nodes. The JAX executor's content-addressed
device input cache is not ported (it hides a slow remote transfer that a
local card does not have).
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
    """Per-run timing of the last ``run``/``run_stacked`` (``execute_s``
    ends at the dispatch when the run is deferred)."""

    def __init__(self) -> None:
        self.stage_s: float = 0.0
        self.execute_s: float = 0.0


def host_array(t: torch.Tensor) -> np.ndarray:
    """A node output as f32 numpy (the wire's tensor type)."""
    return t.detach().float().cpu().numpy()


def _tap_order(tap_set) -> List[Tuple[int, str]]:
    # "i/ch" string order: the route order of the JAX executor's responses
    # (its outputs are a dict pytree keyed "i/ch")
    return sorted(tap_set, key=lambda k: f"{k[0]}/{k[1]}")


class InFlight:
    """A dispatched run whose tapped outputs are on their way to the host.

    On a CUDA device each output was cast to f32 on the card and its copy
    into a page-locked buffer enqueued right behind the run's own launches,
    with an event recorded after the copies; ``materialize`` waits on that
    event alone, so a later group's kernels, queued meanwhile, never delay
    this one's results. ``k``: the group's size (None: one ``run``)."""

    def __init__(self, flat: Dict[str, torch.Tensor], k: Optional[int],
                 event=None):
        self._flat = flat
        self.k = k
        self._event = event

    def ready(self) -> bool:
        """Whether the copies have landed (``materialize`` will not wait)."""
        return self._event is None or self._event.query()

    def materialize(self):
        """Wait for the copies; ``{node: {channel: f32 numpy}}``, or a list
        of K of them for a group."""
        if self._event is not None:
            self._event.synchronize()
        flat = {key: t.numpy() for key, t in self._flat.items()}
        self._flat = {}
        if self.k is None:
            return Executor.split_single(flat)
        return Executor.split_stacked(flat, self.k)


class Executor:
    """Runs graphs eagerly on ``device`` (the card unless the caller asks
    for the CPU; raises without a card)."""

    def __init__(self, reg: Optional[Registry] = None, device="cuda"):
        self.reg = reg or registry()
        self.device = require_device(device)
        self.last_stats = ExecStats()
        # run signatures (graph, taps, batch) dispatched once: the first
        # run of one may build kernel sources and grow the allocator
        self._seen: Set[str] = set()

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

    def _stacked_input(self, ts) -> torch.Tensor:
        # one host stack (a copy) and one transfer for the group
        return torch.from_numpy(np.stack([np.asarray(t) for t in ts])).to(
            self.device)

    def _eval_node(self, n, env, tap_set, k: Optional[int] = None) -> None:
        """Evaluate one node into ``env``, attributing failures to it.
        ``k``: the group size of a stacked run (every value in ``env``
        carries a leading axis K): the kind's ``stacked_fn`` runs, or, for
        a node with no input, ``fn`` once with its outputs broadcast."""
        kind = self.reg.get_node(n.name)
        ins = {ch: (env[("in", n.index, ch)] if e.src is None
                    else env[(e.src.node.index, e.src.channel)])
               for ch, e in n.inputs.items()}
        params = effective_params(n, tap_set)
        try:
            caps = kind.captures(params)
            args = (ins,) if caps is None else (ins, caps)
            if k is None or not ins:
                outs = kind.fn(params)(*args)
                if k is not None:
                    outs = {ch: v.unsqueeze(0).expand(k, *v.shape)
                            for ch, v in outs.items()}
            else:
                outs = kind.stacked_fn(params)(*args)
        except NodeError:
            raise
        except Exception as err:  # noqa: BLE001 -- attribution contract
            raise NodeError(n.index, n.name, str(err)) from err
        for ch, v in outs.items():
            env[(n.index, ch)] = v

    def _run_sig(self, graph: Graph, tap_set, batch: Optional[int]) -> str:
        return self.group_sig(graph, extra=[sorted(tap_set), batch])

    def is_compiled(self, graph: Graph, taps: TapSpec,
                    batch: Optional[int] = None) -> bool:
        """Whether (graph, taps, batch) has run once on this executor
        (``batch``: a group's size, None for one ``run``). Its first run
        may build kernel sources with nvcc for tens of seconds, the
        counterpart of the JAX executor's cold compile: the batcher does
        not pipeline finished groups behind such a run."""
        tap_set = resolve_taps(graph, taps, self.reg)
        return self._run_sig(graph, tap_set, batch) in self._seen

    def _to_host(self, env, tap_set, k: Optional[int]) -> InFlight:
        """Enqueue the tapped outputs' copies to the host (see InFlight)."""
        keys = [(i, ch) for i, ch in _tap_order(tap_set) if (i, ch) in env]
        if self.device.type != "cuda":
            return InFlight({f"{i}/{ch}": env[(i, ch)].detach().float().cpu()
                             for i, ch in keys}, k)
        flat = {}
        for i, ch in keys:
            src = env[(i, ch)].detach().float().contiguous()
            host = torch.empty(src.shape, dtype=torch.float32,
                               pin_memory=True)
            host.copy_(src, non_blocking=True)
            flat[f"{i}/{ch}"] = host
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return InFlight(flat, k, event)

    # -- the production path ----------------------------------------------------
    @torch.inference_mode()
    def run(self, graph: Graph, taps: TapSpec = "all", defer: bool = False):
        """Validate, run and return ``{node_index: {channel: f32 numpy}}``;
        with ``defer``, the ``InFlight`` handle instead."""
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
        handle = self._to_host(env, tap_set, None)
        self._seen.add(self._run_sig(graph, tap_set, None))
        return self._finish(handle, stats, t0, defer)

    def _finish(self, handle: InFlight, stats: ExecStats, t0: float,
                defer: bool):
        if not defer:
            handle = handle.materialize()
        stats.execute_s = time.perf_counter() - t0
        self.last_stats = stats
        return handle

    @staticmethod
    def split_single(flat) -> Dict[int, Dict[str, np.ndarray]]:
        """{"i/ch": arr} -> {i: {ch: arr}}."""
        result: Dict[int, Dict[str, np.ndarray]] = {}
        for key, val in flat.items():
            idx_s, ch = key.split("/", 1)
            result.setdefault(int(idx_s), {})[ch] = val
        return result

    @staticmethod
    def split_stacked(flat, k: int) -> List[Dict[int, Dict[str, np.ndarray]]]:
        """Stacked {"i/ch": [K, ...]} -> K per-request result dicts."""
        return [Executor.split_single({key: val[j]
                                       for key, val in flat.items()})
                for j in range(k)]

    @torch.inference_mode()
    def run_stacked(self, graphs: List[Graph], taps: TapSpec = "all",
                    defer: bool = False):
        """Run K graphs that share a group signature as ONE pass; returns
        K result dicts, equal to K separate ``run``s (keys, order, shapes
        and values), or with ``defer`` the ``InFlight`` handle.

        Inputs stack on axis 0; each node runs once through its kind's
        ``stacked_fn`` (see the module docstring). A failing node raises
        ``NodeError`` for the whole group, never a quiet per-request rerun.
        The group is not padded: the JAX executor pads to a power of two
        to bound its compile count, while this eager executor compiles
        nothing per shape, and padding would spend device time for
        nothing."""
        if not graphs:
            raise ValueError("run_stacked: empty batch")
        g0 = graphs[0]
        sig0 = self.group_sig(g0)
        for g in graphs[1:]:
            if self.group_sig(g) != sig0:
                raise ValueError("run_stacked: mixed graph signatures")
        stats = ExecStats()
        t0 = time.perf_counter()
        self.validate(g0)
        tap_set = resolve_taps(g0, taps, self.reg)
        k = len(graphs)
        per_graph = [{(n.index, ch): e.tensor for n, ch, e in g.input_edges()}
                     for g in graphs]
        env: Dict[Any, Any] = {
            ("in", i, ch): self._stacked_input([pg[(i, ch)]
                                                for pg in per_graph])
            for i, ch in per_graph[0]}
        stats.stage_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for n in g0.order():
            self._eval_node(n, env, tap_set, k)
        handle = self._to_host(env, tap_set, k)
        self._seen.add(self._run_sig(g0, tap_set, k))
        return self._finish(handle, stats, t0, defer)

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

    @torch.inference_mode()
    def run_timed_eager(
        self, graph: Graph
    ) -> Tuple[Dict[int, float], Dict[int, Dict[str, List[int]]],
               Dict[int, str]]:
        """Per-node evaluation with fault isolation (``run_eager``'s
        semantics) and each node's steady-state time: the node runs once,
        then once more timed, the device synchronized before and after.
        The ``/debug_eval`` engine. Returns (timings_ms, output_shapes,
        errors)."""
        timings: Dict[int, float] = {}
        shapes: Dict[int, Dict[str, List[int]]] = {}
        errors: Dict[int, str] = {}
        failed: Set[int] = set()
        env: Dict[Any, Any] = {("in", n.index, ch): self._input(e.tensor)
                               for n, ch, e in graph.input_edges()}
        for n in graph.order():
            if any(e.src is not None and e.src.node.index in failed
                   for e in n.inputs.values()):
                failed.add(n.index)
                errors[n.index] = "eval error upstream"
                continue
            try:
                self._eval_node(n, env, None)
                self._sync()
                t0 = time.perf_counter()
                self._eval_node(n, env, None)
                self._sync()
                timings[n.index] = (time.perf_counter() - t0) * 1e3
                shapes[n.index] = {k[1]: list(v.shape)
                                   for k, v in env.items() if k[0] == n.index}
            except Exception as err:  # noqa: BLE001 -- per-node isolation
                failed.add(n.index)
                errors[n.index] = str(err)
        return timings, shapes, errors

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
