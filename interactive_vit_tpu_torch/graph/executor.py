"""Graph executor with the JAX executor's contract.

Counterpart of ``interactive_vit_tpu/graph/executor.py``: validates a graph
with per-node error attribution, resolves a tap spec, stages the graph once
for each program signature, runs it on one device, and returns the tapped
outputs as ``{node_index: {channel: array}}``. Untapped outputs are still
computed, except the expensive optional channels (attention maps,
rollout), which node kinds skip unless they are tapped or wired
(``ir.effective_params``).

Compiled path
-------------
``_program_sig`` (topology, node params without each kind's dynamic
params, input shapes and dtypes, the tap set, ``use_jit`` and, for a
stacked run, the marker and its bucket) keys an LRU of at most
``max_cache_entries`` staged programs behind a lock (``cache_info``,
``clear_cache``; ``is_compiled`` is membership). Staging validates the
graph and fixes the node order, each node's effective params, its kind's
``fn`` (``stacked_fn`` in a stacked program) and its static captures,
placed on the device once. A cache hit skips all of that and refreshes
only the dynamic captures (``NodeKind.dynamic_params``, such as cos's A
and b), so an edit of them reuses the program.

On a CUDA device with ``use_jit`` (the default) the first request of a
signature runs one eager pass on the executor's side stream, from static
input buffers (the pass builds any kernel source, loads the modules and
sets the kernels' attributes; its outputs are that request's results),
and then captures the same pass into a ``torch.cuda.CUDAGraph``, through
the tapped outputs made f32 and contiguous. Each later request copies its
inputs and dynamic values into the static buffers, replays the graph, and
enqueues its outputs' copies into fresh page-locked host buffers behind
the replay. The copies stay outside the graph, so that a second replay of
the same program, queued while the first one's results are still being
read (the batcher's pipelining), cannot overwrite them. All programs
capture into one shared memory pool. That is safe because every replay
and every copy runs in order on the one side stream, each replay's
outputs are copied out before the next replay, and the static inputs lie
outside the pool. The programs' static outputs stay allocated, so the
cache also evicts by their bytes (``MAX_CAPTURE_BYTES``). A program also
holds the cached device constants that its pass read
(``runtime/constants.py``): the graph keeps only their addresses, and
their caches are bounded.

A capture that fails raises: ``NodeError`` attributed to the node whose
work could not be captured where that work raised as it was issued,
``GraphError`` where only the end of the capture found it void. The
request fails, the program is not cached, and nothing falls back to an
eager pass. A replay runs the captured kernels without calling their
wrappers, so their launch counters (``<wrapper>.launches``) count the
warm pass's launches and those that the capture recorded, and no replay.

On the CPU, and with ``use_jit=False``, the same staging, cache, refresh
and stats run and each request runs the staged pass eagerly (on a card,
on the caller's stream). ``run_eager`` and ``run_timed_eager`` (the
``/debug_eval`` engine) are always eager.

Tracing
-------
While a profiler runs, every node of a pass (a staged step, a gradient
cone's replay, an eager debug node) runs inside
``torch.profiler.record_function("n<i>_<kind>")``, the JAX executor's
``jax.named_scope`` name; with none running nothing is recorded. A capture
records the kernels, not the ranges: a replay has no host step to range.
Under ``utils/tracing.debug_nans`` an eager pass checks each node's
outputs, a replay its tapped outputs (and on a NaN reruns its eager pass
to name the node), and both raise ``FloatingPointError``; the eager debug
paths record it as the node's error.

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
axis, so each block kernel launches once with a batch of K), dynamic
captures stack as per-request rows, and the tapped outputs split into K
result dicts equal to K separate ``run``s. K is rounded up to a power of
two (``_stacked_bucket``), padded with copies of request 0, as in the JAX
executor: the buckets bound the programs, and so the captures and their
memory, of each signature. ``defer=True`` (both paths) returns an
``InFlight`` handle: the tapped outputs are already on their way to
page-locked host buffers behind the group's own launches, and
``materialize()`` waits for them -- the micro-batcher's pipelining hook.

Gradient nodes
--------------
A ``grad_node`` kind (saliency, dream, occlusion) gets its ancestor cone
as a closed ``forward(x)`` of one leaf: a graph input or an upstream
node's output (``GradSpec``, ``_grad_specs``). Its step puts the leaf
value into a copy of the pass's env and re-runs only the cone's nodes that
depend on it (``GradSpec.replay``), in topo order; every other value is
the one the pass computed. Where the replay differentiates, each replayed
node runs ``grad_safe_fn`` (a model layer's plain twin: a kernel has no
backward); occlusion (``differentiates = False``) keeps ``fn``, and runs
its masked leaves through the nodes' ``stacked_fn`` (``forward.stacked``).
A gradient node inside another one's replay composes by recursion. A
graph with a kind that runs autograd (a gradient node, ``<model>:attrib``)
runs under ``torch.no_grad`` (the kinds enable autograd for their own
``torch.autograd.grad`` calls, which a capture records: the backward
kernels run on the pass's stream, their memory from the program's pool),
every other graph under ``torch.inference_mode`` (``_grad_mode``).
A stacked program runs a gradient step once for each row of the group, so
that every row is what its own ``run`` gives. ``run_eager`` and
``run_timed_eager`` stage a gradient node's step alone and run it on the
values computed before it (``_eager_grad``), and refuse one nested in
another's cone.

Not ported yet: layouts, and of the mesh (``parallel/mesh.py``, which the
trainers use) only the executor's mesh mode and its pipeline folding are
still to come. The JAX executor's content-addressed device input cache is
not ported (it hides a slow remote transfer that a local card does not
have).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from interactive_vit_tpu_torch.graph.ir import Graph, GraphError, effective_params
from interactive_vit_tpu_torch.graph.registry import Registry, registry
from interactive_vit_tpu_torch.runtime.constants import retained
from interactive_vit_tpu_torch.runtime.device import require_device
from interactive_vit_tpu_torch.utils import tracing

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


def _tap_key(taps: TapSpec) -> str:
    if isinstance(taps, str):
        return taps
    return "|".join(f"{i}:{ch}" for i, ch in sorted(taps))


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


class GradSpec:
    """One gradient node's resolved differentiation plan.

    ``wrt_key``  env key of the leaf: ``("in", node, ch)`` for a graph
                 input, ``(node, ch)`` for an upstream node's output.
    ``src_key``  env key of the tensor the scalar target reduces.
    ``anc``      the src's whole ancestor cone, in topo order.
    ``replay``   the nodes of ``anc`` that depend on the leaf, in topo
                 order: the nodes a ``forward`` re-runs."""

    __slots__ = ("wrt_key", "src_key", "anc", "replay")

    def __init__(self, wrt_key, src_key, anc, replay):
        self.wrt_key = wrt_key
        self.src_key = src_key
        self.anc = anc
        self.replay = replay


def _grad_specs(graph: Graph, order, input_edges, node_kinds,
                only: Optional[int] = None) -> Dict[int, GradSpec]:
    """Every gradient node's ``GradSpec`` (``only``: that node's alone, so
    that the eager paths attribute one bad node's error to it). The wiring
    errors are ``NodeError``s with the JAX executor's texts: a wrt input
    out of range, a wrt node or channel that does not exist, a wired
    tensor that does not depend on the leaf."""
    specs: Dict[int, GradSpec] = {}
    for n in graph.nodes:
        kind = node_kinds[n.index]
        if not kind.grad_node or (only is not None and n.index != only):
            continue
        try:
            wspec = kind.grad_wrt(n.params)
        except Exception as err:  # noqa: BLE001 -- attribution contract
            raise NodeError(n.index, n.name, str(err)) from err
        if wspec[0] == "input":
            k = wspec[1]
            if k < 0 or k >= len(input_edges):
                raise NodeError(
                    n.index, n.name,
                    f"wrt={k} but the graph has {len(input_edges)} "
                    f"input(s)")
            wnode, wch, _e = input_edges[k]
            wrt_key: Tuple[Any, ...] = ("in", wnode.index, wch)
            wrt_label = f"graph input {k}"
        else:
            _, widx, wch = wspec
            if widx < 0 or widx >= len(graph.nodes):
                raise NodeError(
                    n.index, n.name, f"wrt node {widx} does not exist")
            wnode = graph.nodes[widx]
            if wch not in node_kinds[wnode.index].io(wnode.params)["outs"]:
                raise NodeError(
                    n.index, n.name,
                    f"wrt node {widx} has no output channel {wch!r}")
            wrt_key = (widx, wch)
            wrt_label = f"node {widx} channel {wch!r}"
        e = n.inputs["o"]  # validate() enforced presence
        if e.src is None:
            src_key: Tuple[Any, ...] = ("in", n.index, "o")
            anc: List[Any] = []
        else:
            src_key = (e.src.node.index, e.src.channel)
            seen: Set[int] = set()
            stack = [e.src.node]
            while stack:
                m = stack.pop()
                if m.index in seen:
                    continue
                seen.add(m.index)
                stack += [e2.src.node for e2 in m.inputs.values()
                          if e2.src is not None]
            anc = [m for m in order if m.index in seen]
        # a node depends on the leaf if an input reads the leaf or any
        # output of a node that depends on it (recomputing a node
        # refreshes all its channels)
        dep: Set[int] = set()

        def reads_leaf(m) -> bool:
            for ch, e2 in m.inputs.items():
                key = (("in", m.index, ch) if e2.src is None
                       else (e2.src.node.index, e2.src.channel))
                if key == wrt_key or (e2.src is not None
                                      and e2.src.node.index in dep):
                    return True
            return False

        replay = []
        for m in anc:
            if m.index == wrt_key[0]:
                continue  # the leaf's producer is never recomputed
            if reads_leaf(m):
                dep.add(m.index)
                replay.append(m)
        if not (src_key == wrt_key or src_key[0] in dep):
            raise NodeError(
                n.index, n.name,
                f"the wired tensor does not depend on {wrt_label} — "
                f"its gradient would be identically zero")
        specs[n.index] = GradSpec(wrt_key, src_key, anc, replay)
    return specs


class ExecStats:
    """Per-run timing of the last ``run``/``run_stacked``: ``stage_s`` the
    signature, cache lookup and (on a miss) validation and staging,
    ``compile_s`` the CUDA graph capture (0 on a hit and off the card),
    ``execute_s`` the pass up to the results on the host (up to the
    dispatch when the run is deferred), ``cache_hit`` whether the program
    was in the cache."""

    def __init__(self) -> None:
        self.stage_s: float = 0.0
        self.compile_s: float = 0.0
        self.execute_s: float = 0.0
        self.cache_hit: bool = False

    def as_dict(self) -> Dict[str, float]:
        return {
            "stage_s": self.stage_s,
            "compile_s": self.compile_s,
            "execute_s": self.execute_s,
            "cache_hit": self.cache_hit,
        }


def host_array(t: torch.Tensor) -> np.ndarray:
    """A node output as f32 numpy (the wire's tensor type)."""
    return t.detach().float().cpu().numpy()


def _host_tensor(t) -> torch.Tensor:
    """A graph input as a host tensor (a copy: wire tensors are read-only
    views of the request bytes)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu()
    return torch.from_numpy(np.array(t))


def _host_stack(ts) -> torch.Tensor:
    """One input edge's tensors of a group, stacked on a new axis 0."""
    if any(isinstance(t, torch.Tensor) for t in ts):
        return torch.stack([_host_tensor(t) for t in ts])
    return torch.from_numpy(np.stack([np.asarray(t) for t in ts]))


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
    this one's results. ``k``: the group's size (None: one ``run``); a
    padded group's outputs carry the bucket's rows, of which the first
    ``k`` are returned."""

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


class _Step:
    """One node of a staged pass: its kind's fn (``stacked_fn`` in a
    stacked program or a chunked replay, ``grad_safe_fn`` in a replay that
    differentiates, ``grad_fn`` for a gradient node), its static captures
    on the device, its input keys in the pass's env, whether its captures
    are dynamic, and whether its outputs broadcast over the bucket (a node
    with no input in a stacked program runs once). A gradient node's step
    also holds ``grad``: its ``GradSpec``, its replay's steps and, for a
    forward-only kind outside any differentiated replay, the same steps
    stacked (``forward.stacked``'s; None: that runs the rows one by one)."""

    __slots__ = ("index", "name", "fn", "caps", "ins", "dyn", "broadcast",
                 "grad", "scope")

    def __init__(self, index, name, fn, caps, ins, dyn, broadcast,
                 grad=None):
        self.index, self.name, self.fn, self.caps = index, name, fn, caps
        self.ins, self.dyn, self.broadcast = ins, dyn, broadcast
        self.grad = grad
        self.scope = node_scope(index, name)


def node_scope(index: int, name: str) -> str:
    """The profiler range of node ``index`` of kind ``name``: the JAX
    executor's ``jax.named_scope`` name."""
    return f"n{index}_{name.replace(':', '.')}"


class _Dyn:
    """A node with dynamic captures: its position in ``graph.nodes`` (the
    rows of a group are the nodes at that position: an edge-less node's
    index is not part of the signature), its index in the staging graph,
    the (shape, dtype) of each dynamic key of its captures, and the static
    rest, placed."""

    __slots__ = ("pos", "index", "spec", "static")

    def __init__(self, pos, index, spec, static):
        self.pos, self.index, self.spec, self.static = pos, index, spec, static


class _Program:
    """One signature's staged pass; on a card also its captured graph,
    static input, dynamic-value and output buffers, the cached device
    constants that the graph reads (``keep``), and the bytes its static
    buffers hold."""

    def __init__(self, steps, dyn, input_keys, out_keys, k):
        self.steps: List[_Step] = steps
        self.dyn: List[_Dyn] = dyn
        self.input_keys = input_keys
        self.out_keys = out_keys
        self.k: Optional[int] = k  # the bucket of a stacked program
        self.graph = None
        self.static_in: List[torch.Tensor] = []
        self.static_dyn: Dict[int, Dict[str, torch.Tensor]] = {}
        self.static_out: Dict[str, torch.Tensor] = {}
        self.keep: list = []
        self.nbytes = 0


class Executor:
    """Stages, caches and runs graphs on ``device`` (the card unless the
    caller asks for the CPU; raises without a card). On a card with
    ``use_jit`` each program signature is captured once into a CUDA graph
    and replayed; ``use_jit=False`` runs every request eagerly."""

    # LRU bound on staged programs: long-running interactive serving sees
    # unbounded distinct (graph, shapes, taps) signatures
    MAX_CACHE_ENTRIES = 64
    # bound on the bytes that the captured programs' static outputs and
    # inputs hold on the card; the least recently used programs go first,
    # the newest always stays. The served paths' caches hold 9.5-214 MB
    # for their 2-5 programs of buckets 1 and 2 (the most: dinov2_s14_reg
    # @518 with the maps of block 0; vit_h14@742 149 MB; cache_info in
    # chip_smoke.py's phase 4 on an H100 80GB), so 64 such programs fit
    # under it and the count bounds them. It bites on wide taps at large
    # buckets: dinov2@518 with every map at bucket 8 holds 12 x 6 x 1374^2
    # f32 maps x 8, ~4.3 GB. The intermediates are not counted:
    # every capture allocates them from the one shared pool, where they
    # are reused, so they come to about the largest program's, once.
    MAX_CAPTURE_BYTES = 8 << 30

    def __init__(self, reg: Optional[Registry] = None, use_jit: bool = True,
                 max_cache_entries: Optional[int] = None, device="cuda"):
        self.reg = reg or registry()
        self.use_jit = use_jit
        self.max_cache_entries = max_cache_entries or self.MAX_CACHE_ENTRIES
        self.device = require_device(device)
        self.last_stats = ExecStats()
        # signature -> _Program, LRU-ordered; _cache_lock guards the dict
        # (precompile may fill it from another thread)
        self._cache: "OrderedDict[str, _Program]" = OrderedDict()
        self._cache_lock = threading.Lock()
        # one run's device work at a time: staging, the warm pass and the
        # capture, a replay with its copies, and the eager debug passes
        # (an HTTP thread's /debug_eval never overlaps a capture)
        self._device_lock = threading.RLock()
        self._stream = None  # the compiled path's side stream
        self._pool = None  # the captures' shared memory pool

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

    # -- signatures -------------------------------------------------------------
    @staticmethod
    def _stacked_bucket(k: int) -> int:
        """Power-of-two batch bucket of a group of ``k``."""
        return 1 << (k - 1).bit_length()

    def _sig_param_filter(self, n):
        """Drop each kind's dynamic params from the signature: their
        values ride as runtime captures (NodeKind.dynamic_params), so an
        interactive edit reuses the cached program. A kind whose dynamic
        params also decide capture shapes contributes its shape class
        (NodeKind.dynamic_sig)."""
        try:
            kind = self.reg.get_node(n.name)
        except KeyError:
            return n.params
        dyn = kind.dynamic_params()
        if not dyn:
            return n.params
        filtered = {k: v for k, v in n.params.items() if k not in dyn}
        try:
            dsig = kind.dynamic_sig(n.params)
        except Exception as err:  # noqa: BLE001 -- attribution contract
            raise NodeError(n.index, n.name, str(err)) from err
        if dsig is not None:
            filtered["__dyn_sig__"] = dsig
        return filtered

    def _program_sig(self, graph: Graph, tap_set,
                     batch: Optional[int] = None) -> str:
        """THE cache signature, the one that ``run``, ``run_stacked``,
        ``is_compiled`` and ``precompile`` use (a drift between them would
        break the batcher's pipelining: always-False wastes the overlap,
        wrongly-True stalls finished results behind a capture)."""
        extra = [_tap_key(tap_set), self.use_jit]
        # ANY stacked program (k=1 included) gets the marker: run() and
        # run_stacked([g]) stage different passes (fn vs stacked_fn)
        if batch is not None:
            extra += ["stacked", self._stacked_bucket(batch)]
        return graph.signature(extra=extra,
                               param_filter=self._sig_param_filter)

    def group_sig(self, graph: Graph, extra=()) -> str:
        """Batching signature: topology, params, input shapes and (through
        ``extra``) taps, dynamic params EXCLUDED: requests that differ only
        in a dynamic value (cos A / b) share one group, their values
        stacked per request in ``run_stacked``."""
        return graph.signature(extra=list(extra),
                               param_filter=self._sig_param_filter)

    def _sig_of(self, graph: Graph, taps: TapSpec, batch: Optional[int]):
        """(tap set, program signature); a graph whose taps cannot resolve
        (an unknown kind) raises validation's attributed error."""
        try:
            tap_set = resolve_taps(graph, taps, self.reg)
            return tap_set, self._program_sig(graph, tap_set, batch)
        except (NodeError, GraphError):
            raise
        except Exception:
            self.validate(graph)
            raise

    # -- the program cache --------------------------------------------------------
    def _cache_get(self, sig: str) -> Optional[_Program]:
        with self._cache_lock:
            hit = self._cache.get(sig)
            if hit is not None:
                self._cache.move_to_end(sig)
            return hit

    def _cache_put(self, sig: str, prog: _Program) -> None:
        with self._cache_lock:
            self._cache[sig] = prog
            self._cache.move_to_end(sig)
            held = sum(p.nbytes for p in self._cache.values())
            while len(self._cache) > 1 and (
                    len(self._cache) > self.max_cache_entries
                    or held > self.MAX_CAPTURE_BYTES):
                _, old = self._cache.popitem(last=False)
                held -= old.nbytes

    def is_compiled(self, graph: Graph, taps: TapSpec,
                    batch: Optional[int] = None) -> bool:
        """True if (graph, taps, batch bucket) has a cached program: on a
        card, a captured graph. The batcher asks before pipelining a
        dispatch behind finished results (a first run builds kernel
        sources and captures, for up to tens of seconds)."""
        tap_set = resolve_taps(graph, taps, self.reg)
        sig = self._program_sig(graph, tap_set, batch)
        with self._cache_lock:
            return sig in self._cache

    def cache_info(self) -> Dict[str, int]:
        """``entries``: the cached programs; ``captured_bytes``: the bytes
        their static buffers hold on the card."""
        with self._cache_lock:
            return {"entries": len(self._cache),
                    "captured_bytes": sum(p.nbytes
                                          for p in self._cache.values())}

    def clear_cache(self) -> None:
        with self._cache_lock:
            self._cache.clear()

    # -- staging ------------------------------------------------------------------
    def _place(self, tree):
        """A capture tree with every tensor (and numpy array) on the
        device."""
        if isinstance(tree, torch.Tensor):
            return tree if tree.device == self.device else tree.to(self.device)
        if isinstance(tree, np.ndarray):
            return torch.from_numpy(np.array(tree)).to(self.device)
        if isinstance(tree, dict):
            return {k: self._place(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._place(v) for v in tree)
        return tree

    def _stage(self, graph: Graph, tap_set, bucket: Optional[int] = None,
               grad_of=None) -> _Program:
        """The validated graph's pass, once a signature: the node order,
        each node's effective params, its kind's fn (``stacked_fn`` for a
        stacked program of ``bucket`` rows) and its static captures placed
        on the device; for each gradient node its replay's steps. The
        program keeps no reference to the graph (or its request tensors).
        ``grad_of``: (a gradient node, whether to stage its cone): the
        eager paths' program of that node alone, after its cone's steps
        where they must compute its leaf again (``_eager_grad``)."""
        order = graph.order()
        kinds = {n.index: self.reg.get_node(n.name) for n in graph.nodes}
        specs = _grad_specs(graph, order, graph.input_edges(), kinds,
                            only=None if grad_of is None
                            else grad_of[0].index)
        staged = order
        if grad_of is not None:
            anc = specs[grad_of[0].index].anc
            order = anc + [grad_of[0]]
            staged = order if grad_of[1] else order[-1:]
        # a node-wrt leaf's producer must emit the wrt channel
        live = set(tap_set) | {s.wrt_key for s in specs.values()
                               if s.wrt_key[0] != "in"}
        pos = {id(n): i for i, n in enumerate(graph.nodes)}
        caps_of, dyn = {}, []
        for n in order:
            kind = kinds[n.index]
            try:
                caps = kind.captures(n.params)
                keys = None
                if caps is not None and kind.dynamic_params():
                    dck = kind.dynamic_capture_keys()
                    keys = [k for k in caps if dck is None or k in dck]
                    spec = {k: (tuple(t.shape), t.dtype) for k, t in
                            ((k, torch.as_tensor(caps[k])) for k in keys)}
                    dyn.append(_Dyn(pos[id(n)], n.index, spec,
                                    self._place({k: v for k, v in caps.items()
                                                 if k not in keys})))
                    caps_of[n.index] = (None, {k: 0 if k in keys else None
                                               for k in caps})
                else:
                    caps_of[n.index] = (self._place(caps), None)
            except NodeError:
                raise
            except Exception as err:  # noqa: BLE001 -- attribution contract
                raise NodeError(n.index, n.name, str(err)) from err

        def step(n, rows, diff) -> _Step:
            """``n``'s step: ``rows`` None (one request), a stacked
            program's bucket, or "chunk" (a forward-only replay's batched
            masked leaves); ``diff``: inside a differentiated replay."""
            kind = kinds[n.index]
            params = effective_params(n, live)
            caps, axes = caps_of[n.index]
            dynamic = axes is not None
            try:
                if n.index in specs:
                    fn = kind.grad_fn(params)
                elif diff:
                    fn = kind.grad_safe_fn(params)
                elif rows is None or (not n.inputs and not dynamic):
                    fn = kind.fn(params)
                elif dynamic:
                    fn = kind.stacked_fn(params, axes if rows != "chunk"
                                         else dict.fromkeys(axes))
                else:
                    fn = kind.stacked_fn(params)
            except NodeError:
                raise
            except Exception as err:  # noqa: BLE001 -- attribution contract
                raise NodeError(n.index, n.name, str(err)) from err
            ins = [(ch, ("in", n.index, ch) if e.src is None
                    else (e.src.node.index, e.src.channel))
                   for ch, e in n.inputs.items()]
            grad = None
            if n.index in specs:
                sp = specs[n.index]
                d = kind.differentiates or diff
                grad = (sp, [step(m, None, d) for m in sp.replay],
                        None if d else [step(m, "chunk", False)
                                        for m in sp.replay])
            return _Step(n.index, n.name, fn, caps, ins, dynamic,
                         isinstance(rows, int) and not n.inputs
                         and not dynamic, grad)

        steps = [step(n, bucket, False) for n in staged]
        input_keys = [("in", n.index, ch) for n, ch, _ in graph.input_edges()]
        return _Program(steps, dyn, input_keys, _tap_order(tap_set), bucket)

    def _dyn_values(self, prog: _Program, graphs: List[Graph]):
        """{node index: {key: host tensor}}: the dynamic captures of this
        request (one graph) or of a group's rows (stacked on axis 0),
        each node's errors attributed to it. A value whose shape or dtype
        is not the staged one is refused: the program (on a card, its
        buffers) was built for that one (``NodeKind.dynamic_sig``)."""
        out = {}
        for d in prog.dyn:
            rows = []
            for g in graphs:
                n = g.nodes[d.pos]
                try:
                    caps = self.reg.get_node(n.name).captures(n.params)
                    row = {k: torch.as_tensor(caps[k]) for k in d.spec}
                except Exception as err:  # noqa: BLE001 -- attribution
                    raise NodeError(n.index, n.name, str(err)) from err
                for k, t in row.items():
                    if (tuple(t.shape), t.dtype) != d.spec[k]:
                        raise NodeError(
                            n.index, n.name, f"dynamic capture {k!r} is "
                            f"{tuple(t.shape)} {t.dtype}, the staged program "
                            f"{d.spec[k][0]} {d.spec[k][1]}: a kind whose "
                            f"dynamic params decide shapes declares them "
                            f"in dynamic_sig")
                rows.append(row)
            out[d.index] = (rows[0] if prog.k is None else
                            {k: torch.stack([r[k] for r in rows])
                             for k in d.spec})
        return out

    def _pass(self, prog: _Program, env, dyn_caps):
        """Run the staged steps over ``env`` (the inputs' keys filled);
        returns the tapped outputs as {"i/ch": tensor}. A node's failure
        (in a capture: work that cannot be captured, which raises where it
        is issued) is attributed to it."""
        self._steps(prog, prog.steps, env, dyn_caps, prog.k)
        return {f"{i}/{ch}": env[(i, ch)] for i, ch in prog.out_keys
                if (i, ch) in env}

    def _steps(self, prog: _Program, steps, env, dyn_caps, k,
               chunk=None) -> None:
        """Run ``steps`` into ``env``; ``k``: a stacked program's bucket
        (None: one request). ``chunk``: (size, keys) of a forward-only
        replay of ``size`` masked leaves at once, ``keys`` the env keys
        that carry them (the leaf's); an input the replay did not compute
        (the pass's value) broadcasts over them. Under ``debug_nans``,
        outside a capture, each node's outputs are checked after it runs."""
        nans = tracing.nans_enabled() and not (
            self.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())
        for st in steps:
            try:
                ins = {}
                for ch, key in st.ins:
                    v = env[key]
                    if chunk is not None and key not in chunk[1]:
                        v = v.unsqueeze(0).expand(chunk[0], *v.shape)
                    ins[ch] = v
                caps = dyn_caps[st.index] if st.dyn else st.caps
                with tracing.node_range(st.scope):
                    if st.grad is not None:
                        outs = self._grad_step(prog, st, env, caps,
                                               dyn_caps, k)
                    else:
                        outs = (st.fn(ins) if caps is None
                                else st.fn(ins, caps))
                if st.broadcast:
                    outs = {ch: v.unsqueeze(0).expand(k, *v.shape)
                            for ch, v in outs.items()}
            except (NodeError, FloatingPointError):
                raise
            except Exception as err:  # noqa: BLE001 -- attribution contract
                raise NodeError(st.index, st.name, str(err)) from err
            if nans:
                tracing.check_nans(st.index, st.name, outs)
            for ch, v in outs.items():
                env[(st.index, ch)] = v
                if chunk is not None:
                    chunk[1].add((st.index, ch))

    def _grad_step(self, prog: _Program, st: _Step, env, caps, dyn_caps,
                   k) -> Dict[str, torch.Tensor]:
        """A gradient node's outputs: its kind's ``grad_fn`` given
        ``forward`` (the replay of its cone from the leaf) and the leaf's
        value. In a stacked program, once for each row, stacked."""
        if k is not None:
            per_row = {d.index: set(d.spec) for d in prog.dyn}

            def row(tree, j, i):
                return None if tree is None else {
                    kk: v[j] if kk in per_row.get(i, ()) else v
                    for kk, v in tree.items()}

            outs = [self._grad_step(
                prog, st, {key: v[j] for key, v in env.items()},
                row(caps, j, st.index),
                {i: row(c, j, i) for i, c in dyn_caps.items()},
                None) for j in range(k)]
            return {ch: torch.stack([o[ch] for o in outs])
                    for ch in outs[0]}
        spec, replay, chunked = st.grad

        def forward(xv):
            if spec.src_key == spec.wrt_key:
                return xv
            env2 = dict(env)
            env2[spec.wrt_key] = xv
            self._steps(prog, replay, env2, dyn_caps, None)
            return env2[spec.src_key]

        def stacked(xs):
            if chunked is None:
                return torch.stack([forward(x) for x in xs.unbind(0)])
            if spec.src_key == spec.wrt_key:
                return xs
            env2 = dict(env)
            env2[spec.wrt_key] = xs
            self._steps(prog, chunked, env2, dyn_caps, None,
                        chunk=(xs.shape[0], {spec.wrt_key}))
            return env2[spec.src_key]

        forward.stacked = stacked
        return st.fn(forward, env[spec.wrt_key], caps)

    def _dyn_caps(self, prog: _Program, values) -> Dict[int, Dict]:
        """Each dynamic node's captures: its static part and ``values``."""
        return {d.index: {**d.static, **values[d.index]} for d in prog.dyn}

    # -- the passes ---------------------------------------------------------------
    def _compiled(self) -> bool:
        return self.use_jit and self.device.type == "cuda"

    def _side(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _eager(self, prog: _Program, inputs, values) -> InFlight:
        """The staged pass run eagerly on the current stream."""
        env = {key: t.to(self.device)
               for key, t in zip(prog.input_keys, inputs)}
        dyn = self._dyn_caps(prog, {i: self._place(v)
                                    for i, v in values.items()})
        return self._to_host(self._pass(prog, env, dyn), prog.k)

    def _warm_and_capture(self, prog: _Program, inputs, values,
                          stats: ExecStats) -> InFlight:
        """A signature's first request on a card: static buffers, one
        eager pass on the side stream (its outputs are this request's
        results), then the capture of that pass."""
        side = self._side()
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            prog.static_in = [torch.empty(t.shape, dtype=t.dtype,
                                          device=self.device)
                              for t in inputs]
            prog.static_dyn = {i: {k: torch.empty(v.shape, dtype=v.dtype,
                                                  device=self.device)
                                   for k, v in vals.items()}
                               for i, vals in values.items()}
            self._fill(prog, inputs, values)
            env = dict(zip(prog.input_keys, prog.static_in))
            dyn = self._dyn_caps(prog, prog.static_dyn)
            with retained() as keep:
                handle = self._to_host(self._pass(prog, env, dyn), prog.k)
                side.synchronize()
                t0 = time.perf_counter()
                self._capture(prog, dyn)
                stats.compile_s = time.perf_counter() - t0
            prog.keep = keep
        prog.nbytes = sum(t.numel() * t.element_size() for t in
                          [*prog.static_in, *prog.static_out.values()])
        return handle

    def _capture(self, prog: _Program, dyn) -> None:
        """Capture the pass from the static buffers into ``prog.graph``
        (on the side stream, the current one)."""
        graph = torch.cuda.CUDAGraph()
        env = dict(zip(prog.input_keys, prog.static_in))
        void, passed = None, False
        try:
            # thread_local: another thread's unrelated CUDA calls (a
            # health probe, a page-locked allocation) cannot invalidate it
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                # debug_nans's anomaly mode checks a backward's outputs on
                # the host: a sync, which a capture cannot hold (a replay
                # checks its taps instead)
                with (torch.autograd.set_detect_anomaly(False)
                      if torch.is_anomaly_enabled()
                      else contextlib.nullcontext()):
                    outs = self._pass(prog, env, dyn)
                prog.static_out = {key: t.detach().float().contiguous()
                                   for key, t in outs.items()}
                passed = True
            finally:
                try:
                    graph.capture_end()
                except Exception as err:  # noqa: BLE001 -- a void capture
                    void = err
                if void is not None or not passed:
                    self._stop_pool_recording()
            if void is not None:
                raise GraphError(f"CUDA graph capture failed: {void}") \
                    from void
        except BaseException:
            prog.static_out = {}
            raise
        prog.graph = graph

    def _stop_pool_recording(self) -> None:
        """After a void capture: ``capture_end`` raises before it stops
        the allocator's recording into the shared pool, and the pool then
        refuses every later capture ("already recording"). Seen on an H100
        with torch 2.11.0+cu128, even after one ``endAllocateToPool``;
        ``tests/test_torch_cuda_graphs.py``'s uncapturable-kind case
        captures again after such a failure. End every recording into it
        that is left, and give later captures a fresh pool (the cached
        programs keep theirs)."""
        dev = (self.device.index if self.device.index is not None
               else torch.cuda.current_device())
        for _ in range(8):
            try:
                torch._C._cuda_endAllocateToPool(dev, self._pool)
            except RuntimeError:  # no recording into it is left
                break
        self._pool = torch.cuda.graph_pool_handle()

    def _fill(self, prog: _Program, inputs, values) -> None:
        """Copy a request's inputs and dynamic values into the static
        buffers (on the current stream, the side one)."""
        for buf, t in zip(prog.static_in, inputs):
            buf.copy_(t, non_blocking=True)
        for i, vals in values.items():
            for k, v in vals.items():
                prog.static_dyn[i][k].copy_(v, non_blocking=True)

    def _replay(self, prog: _Program, inputs, values) -> InFlight:
        side = self._side()
        with torch.cuda.stream(side):
            self._fill(prog, inputs, values)
            prog.graph.replay()
            if tracing.nans_enabled():
                self._replay_nans(prog)
            return self._to_host(prog.static_out, prog.k)

    def _replay_nans(self, prog: _Program) -> None:
        """``debug_nans`` after a replay: where a tapped output holds a NaN,
        the program's eager pass on the same static buffers, with the
        per-node checks, raises at the node that made it."""
        bad = [key for key, t in prog.static_out.items()
               if bool(torch.isnan(t).any())]
        if not bad:
            return
        env = dict(zip(prog.input_keys, prog.static_in))
        self._pass(prog, env, self._dyn_caps(prog, prog.static_dyn))
        raise FloatingPointError(
            f"invalid value (nan) in the replay's tapped outputs {bad}; the "
            f"eager pass on the same inputs holds none")

    def _execute(self, sig: str, prog: _Program, hit: bool, inputs,
                 values, stats: ExecStats) -> InFlight:
        """Run a looked-up (hit) or freshly staged program; a new program
        enters the cache only once its first run (and capture) worked."""
        if not self._compiled():
            handle = self._eager(prog, inputs, values)
        elif hit:
            handle = self._replay(prog, inputs, values)
        else:
            handle = self._warm_and_capture(prog, inputs, values, stats)
        if not hit:
            self._cache_put(sig, prog)
        return handle

    def _to_host(self, outs: Dict[str, torch.Tensor],
                 k: Optional[int]) -> InFlight:
        """Enqueue the tapped outputs' copies to the host (see InFlight)."""
        if self.device.type != "cuda":
            return InFlight({key: t.detach().float().cpu()
                             for key, t in outs.items()}, k)
        flat = {}
        for key, t in outs.items():
            src = t.detach().float().contiguous()
            host = torch.empty(src.shape, dtype=torch.float32,
                               pin_memory=True)
            host.copy_(src, non_blocking=True)
            flat[key] = host
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return InFlight(flat, k, event)

    # -- the production path ----------------------------------------------------
    def _grad_mode(self, graph: Graph):
        """The autograd mode of ``graph``'s staging and passes:
        ``inference_mode`` (the cheapest on the host), or ``no_grad`` where
        a kind runs autograd (``NodeKind.autograd``): autograd cannot save
        an inference tensor for backward, so the static buffers and
        captures of its graph must be ordinary tensors."""
        try:
            grad = any(self.reg.get_node(n.name).autograd
                       for n in graph.nodes)
        except KeyError:  # validation attributes the unknown kind
            grad = False
        return torch.no_grad() if grad else torch.inference_mode()

    def run(self, graph: Graph, taps: TapSpec = "all", defer: bool = False):
        """Run one graph and return ``{node_index: {channel: f32 numpy}}``;
        with ``defer``, the ``InFlight`` handle instead. A cache hit skips
        validation and staging (the signature guarantees them) and, on a
        card, replays the captured graph."""
        stats = ExecStats()
        t0 = time.perf_counter()
        tap_set, sig = self._sig_of(graph, taps, None)
        inputs = [_host_tensor(e.tensor) for _, _, e in graph.input_edges()]
        with self._device_lock, self._grad_mode(graph):
            prog = self._cache_get(sig)
            stats.cache_hit = prog is not None
            if prog is None:
                self.validate(graph)
                prog = self._stage(graph, tap_set)
            values = self._dyn_values(prog, [graph])
            stats.stage_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            handle = self._execute(sig, prog, stats.cache_hit, inputs,
                                   values, stats)
        return self._finish(handle, stats, t0, defer)

    def run_stacked(self, graphs: List[Graph], taps: TapSpec = "all",
                    defer: bool = False):
        """Run K graphs that share a group signature as ONE pass; returns
        K result dicts, equal to K separate ``run``s (keys, order, shapes
        and values), or with ``defer`` the ``InFlight`` handle.

        Inputs stack on axis 0 and dynamic captures stack as per-request
        rows; each node runs once through its kind's ``stacked_fn`` (see
        the module docstring). K is padded to its power-of-two bucket with
        copies of request 0: a bucket is one program (on a card one
        capture) for every K in it, so the buckets bound the captures of a
        signature and the memory they hold. A failing node raises
        ``NodeError`` for the whole group, never a quiet per-request
        rerun."""
        if not graphs:
            raise ValueError("run_stacked: empty batch")
        g0 = graphs[0]
        sig0 = self.group_sig(g0)
        for g in graphs[1:]:
            if self.group_sig(g) != sig0:
                raise ValueError("run_stacked: mixed graph signatures")
        stats = ExecStats()
        t0 = time.perf_counter()
        k = len(graphs)
        bucket = self._stacked_bucket(k)
        tap_set, sig = self._sig_of(g0, taps, k)
        padded = list(graphs) + [g0] * (bucket - k)
        per_graph = [[e.tensor for _, _, e in g.input_edges()]
                     for g in padded]
        inputs = [_host_stack([pg[i] for pg in per_graph])
                  for i in range(len(per_graph[0]))]
        with self._device_lock, self._grad_mode(g0):
            prog = self._cache_get(sig)
            stats.cache_hit = prog is not None
            if prog is None:
                self.validate(g0)
                prog = self._stage(g0, tap_set, bucket)
            values = self._dyn_values(prog, padded)
            stats.stage_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            handle = self._execute(sig, prog, stats.cache_hit, inputs,
                                   values, stats)
        handle.k = k
        return self._finish(handle, stats, t0, defer)

    def _finish(self, handle: InFlight, stats: ExecStats, t0: float,
                defer: bool):
        if not defer:
            handle = handle.materialize()
        stats.execute_s = time.perf_counter() - t0
        self.last_stats = stats
        return handle

    def precompile(self, graph: Graph, taps: TapSpec = "primary",
                   batch: Optional[int] = None) -> bool:
        """Stage ``(graph, taps)`` into the program cache, and on a card
        capture it, without returning results: the server's warmup. Off
        the card nothing runs; on a card the capture needs one warm pass,
        which runs on the graph's own inputs (``batch``: the stacked program of that group size's
        bucket, its rows copies of the graph). Returns True if a new
        program was cached, False if it was already cached or
        ``use_jit`` is off."""
        if not self.use_jit:
            return False
        tap_set, sig = self._sig_of(graph, taps, batch)
        with self._device_lock, self._grad_mode(graph):
            if self._cache_get(sig) is not None:
                return False
            self.validate(graph)
            bucket = None if batch is None else self._stacked_bucket(batch)
            prog = self._stage(graph, tap_set, bucket)
            edges = [e.tensor for _, _, e in graph.input_edges()]
            inputs = ([_host_tensor(t) for t in edges] if bucket is None
                      else [_host_stack([t] * bucket) for t in edges])
            if self._compiled():
                values = self._dyn_values(prog, [graph] * (bucket or 1))
                self._execute(sig, prog, False, inputs, values, ExecStats())
            else:
                self._cache_put(sig, prog)
        return True

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
        """Stacked {"i/ch": [bucket, ...]} -> k per-request result dicts."""
        return [Executor.split_single({key: val[j]
                                       for key, val in flat.items()})
                for j in range(k)]

    # -- the debug path -----------------------------------------------------------
    def _eval_node(self, n, env) -> Dict[str, torch.Tensor]:
        """Evaluate one node eagerly, attributing failures to it; returns
        its outputs."""
        kind = self.reg.get_node(n.name)
        try:
            ins = {ch: (env[("in", n.index, ch)] if e.src is None
                        else env[(e.src.node.index, e.src.channel)])
                   for ch, e in n.inputs.items()}
            params = effective_params(n, None)
            caps = self._place(kind.captures(n.params))
            args = (ins,) if caps is None else (ins, caps)
            with tracing.node_range(node_scope(n.index, n.name)):
                return kind.fn(params)(*args)
        except NodeError:
            raise
        except Exception as err:  # noqa: BLE001 -- attribution contract
            raise NodeError(n.index, n.name, str(err)) from err

    def _eager_grad(self, graph: Graph, n, env) -> Dict[str, torch.Tensor]:
        """One gradient node on the eager paths, from the values ``env``
        holds (the eager loop runs in topo order, so its whole cone is
        there): its step staged alone and run as the staged pass runs it.
        Where the leaf is a node's channel that was not computed (an
        unwired extra), the cone's steps run first from the graph's inputs
        with that channel on. A gradient node that this would evaluate is
        refused (the staged path composes them)."""
        order = graph.order()
        kinds = {m.index: self.reg.get_node(m.name) for m in graph.nodes}
        spec = _grad_specs(graph, order, graph.input_edges(), kinds,
                           only=n.index)[n.index]
        cone = spec.wrt_key not in env
        for m in spec.anc if cone else spec.replay:
            if kinds[m.index].grad_node:
                raise NodeError(
                    n.index, n.name,
                    f"node {m.index} ({m.name}) is a gradient node "
                    f"inside this node's differentiation cone — "
                    f"nested gradients evaluate on the staged path "
                    f"(/compute), not the eager debug path")
        prog = self._stage(graph, (), grad_of=(n, cone))
        dyn = self._dyn_caps(prog, {
            i: self._place(v)
            for i, v in self._dyn_values(prog, [graph]).items()})
        base = ({k: v for k, v in env.items() if k[0] == "in"} if cone
                else dict(env))
        self._steps(prog, prog.steps, base, dyn, None)
        return {k[1]: v for k, v in base.items() if k[0] == n.index}

    def _eval_any(self, graph: Graph, n, env) -> None:
        """``_eval_node``, or ``_eager_grad`` for a gradient node, into
        ``env``; under ``debug_nans`` a NaN in its outputs raises."""
        outs = (self._eager_grad(graph, n, env)
                if self.reg.get_node(n.name).grad_node
                else self._eval_node(n, env))
        for ch, v in outs.items():
            env[(n.index, ch)] = v
        if tracing.nans_enabled():
            tracing.check_nans(n.index, n.name, outs)

    def _inputs_env(self, graph: Graph) -> Dict[Any, Any]:
        return {("in", n.index, ch): _host_tensor(e.tensor).to(self.device)
                for n, ch, e in graph.input_edges()}

    def run_eager(
        self, graph: Graph
    ) -> Tuple[Dict[int, Dict[str, np.ndarray]], Dict[int, str]]:
        """Per-node evaluation with fault isolation.

        Returns (outputs, errors). A failing node's descendants are skipped
        with an "eval error upstream" marker, the client graph engine's
        semantics; the other nodes still run, a gradient node beside a
        failing one too."""
        outputs: Dict[int, Dict[str, np.ndarray]] = {}
        errors: Dict[int, str] = {}
        failed: Set[int] = set()
        with self._device_lock, self._grad_mode(graph):
            env = self._inputs_env(graph)
            for n in graph.order():
                if any(e.src is not None and e.src.node.index in failed
                       for e in n.inputs.values()):
                    failed.add(n.index)
                    errors[n.index] = "eval error upstream"
                    continue
                try:
                    self._eval_any(graph, n, env)
                    outputs[n.index] = {k[1]: host_array(v)
                                        for k, v in env.items()
                                        if k[0] == n.index}
                except Exception as err:  # noqa: BLE001 -- isolation
                    failed.add(n.index)
                    errors[n.index] = str(err)
        return outputs, errors

    def run_timed_eager(
        self, graph: Graph
    ) -> Tuple[Dict[int, float], Dict[int, Dict[str, List[int]]],
               Dict[int, str]]:
        """Per-node evaluation with fault isolation (``run_eager``'s
        semantics) and each node's steady-state time: the node runs once,
        then once more timed, the device synchronized before and after (a
        gradient node's time is its replay, backward and render). The
        ``/debug_eval`` engine. Returns (timings_ms, output_shapes,
        errors)."""
        timings: Dict[int, float] = {}
        shapes: Dict[int, Dict[str, List[int]]] = {}
        errors: Dict[int, str] = {}
        failed: Set[int] = set()
        with self._device_lock, self._grad_mode(graph):
            env = self._inputs_env(graph)
            for n in graph.order():
                if any(e.src is not None and e.src.node.index in failed
                       for e in n.inputs.values()):
                    failed.add(n.index)
                    errors[n.index] = "eval error upstream"
                    continue
                try:
                    self._eval_any(graph, n, env)
                    self._sync()
                    t0 = time.perf_counter()
                    self._eval_any(graph, n, env)
                    self._sync()
                    timings[n.index] = (time.perf_counter() - t0) * 1e3
                    shapes[n.index] = {k[1]: list(v.shape)
                                       for k, v in env.items()
                                       if k[0] == n.index}
                except Exception as err:  # noqa: BLE001 -- isolation
                    failed.add(n.index)
                    errors[n.index] = str(err)
        return timings, shapes, errors

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
