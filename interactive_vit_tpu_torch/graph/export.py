"""Graph export: a tapped graph's staged pass as one deployable artifact.

Counterpart of ``interactive_vit_tpu/graph/export.py``. The JAX package
serializes its staged XLA program with ``jax.export``; here the executor's
staged pass (``Executor._stage`` and ``_pass``, the node loop that ``run``
runs) is traced by ``torch.export`` into one ``ExportedProgram``, saved
with ``torch.export.save``. The captures tree (model weights and dynamic
node params) rides beside it in the package's own safetensors writer, and
a JSON manifest pins the calling convention. Every capture is an argument
of the program, so no weight is baked into it.

Loading needs no node registry, no model code and no plugin: the program
holds every node's math. The kernels of rows 1-7 stay in it as the custom
ops of ``ops/custom_ops.py`` (``ivt::*``), which ``ExportedGraph`` imports
to register them; their CUDA bodies launch the same hand-written kernels
as the live executor. Dynamic node params stay runtime arguments:
``ExportedGraph.set_cap`` edits one between calls, and a call may take a
per-call overlay of them, without a new export.

A program is traced with fake tensors on the executor's device, so an
artifact is for one platform: ``platforms`` is ``["cuda"]`` for a program
traced on a card (its kernels are the ``ivt`` ops) and ``["cpu"]`` for one
traced on the CPU (the plain versions, with no ``ivt`` op). A graph whose
kinds run autograd (the gradient kinds, ``<model>:attrib``) is traced
first by ``make_fx``, which records the backward as ATen ops, and that
graph is then exported: ``torch.export`` of a function that calls
``torch.autograd.grad`` itself does not give a program.

Artifact layout (a directory):
    program.pt2           torch.export.save of the staged pass
    captures.safetensors  the flattened captures tree
    manifest.json         format, torch version, platforms, input specs,
                          out keys, captures skeleton, serving metadata,
                          the selftest record, provenance

On a card, ``ExportedGraph`` captures the loaded program into a CUDA graph
at its first call (static input, capture and output buffers) and replays
it after, the counterpart of the JAX loader's ``jax.jit`` of the exported
call. Not ported: mesh-sharded programs (``ROADMAP.md`` queue 1 item 7b)
and the JAX loader's content-addressed input cache. An artifact of the JAX
package (``program.stablehlo``) is refused by name.
"""

from __future__ import annotations

import base64
import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from interactive_vit_tpu_torch.utils import safetensors_io

FORMAT = 1
PROGRAM_FILE = "program.pt2"
CAPS_FILE = "captures.safetensors"
MANIFEST_FILE = "manifest.json"
JAX_PROGRAM_FILE = "program.stablehlo"
MESH_NOT_PORTED = ("mesh-sharded export is not ported yet (ROADMAP.md "
                   "queue 1 item 7b)")


class ExportError(Exception):
    """Artifact construction / loading failure (one error type, like
    SafetensorsError / WireError: callers branch on the class)."""


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype in the JAX package's spelling: "float32", "bfloat16",
    "int8"."""
    return str(dtype).rsplit(".", 1)[-1]


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ExportError(f"unknown dtype {name!r} in the manifest")
    return dt


# -- captures tree <-> (skeleton json, flat tensor dict) -----------------------

def _flatten_caps(caps: Any, prefix: str, flat: Dict[str, torch.Tensor]):
    """Describe ``caps`` as a JSON skeleton (the JAX package's format);
    tensor leaves move into ``flat`` as host tensors under path keys. Only
    dicts, lists, tuples and tensors (or numpy arrays) may appear: anything
    else, and two leaves whose "."-joined paths collide, raise
    ``ExportError``."""
    if isinstance(caps, dict):
        return {"t": "d",
                "v": {k: _flatten_caps(v, f"{prefix}.{k}", flat)
                      for k, v in caps.items()}}
    if isinstance(caps, (list, tuple)):
        return {"t": "l" if isinstance(caps, list) else "u",
                "v": [_flatten_caps(v, f"{prefix}.{i}", flat)
                      for i, v in enumerate(caps)]}
    if isinstance(caps, np.ndarray):
        caps = torch.from_numpy(np.array(caps))
    if not isinstance(caps, torch.Tensor):
        raise ExportError(f"capture leaf {prefix!r} is not a tensor: "
                          f"{type(caps).__name__}")
    if prefix in flat:
        # dict keys may hold dots ("blocks.0"): overwriting would deploy
        # the wrong weights with no error anywhere
        raise ExportError(
            f"capture path key collision at {prefix!r} — two distinct "
            f"leaves flatten to the same name")
    flat[prefix] = caps.detach().cpu().contiguous()
    # the dtype rides in the skeleton: the reader upcasts BF16 to f32
    return {"t": "a", "v": prefix, "dt": _dtype_name(caps.dtype)}


def _unflatten_caps(skel: Any, flat: Dict[str, np.ndarray]):
    """The captures tree of a skeleton, as host tensors of the recorded
    dtypes."""
    t = skel["t"]
    if t == "d":
        return {k: _unflatten_caps(v, flat) for k, v in skel["v"].items()}
    if t in ("l", "u"):
        seq = [_unflatten_caps(v, flat) for v in skel["v"]]
        return seq if t == "l" else tuple(seq)
    if t == "a":
        try:
            arr = flat[skel["v"]]
        except KeyError as err:
            raise ExportError(
                f"captures file is missing tensor {skel['v']!r}") from err
        out = torch.from_numpy(np.array(arr))
        want = skel.get("dt")
        return out.to(_torch_dtype(want)) if want else out
    raise ExportError(f"bad captures skeleton tag {t!r}")


def _leaves(tree, path=()):
    """(path, leaf) of every non-container leaf of a captures tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


# -- editable params --------------------------------------------------------------

def _host(like) -> np.ndarray:
    """A capture leaf as numpy on the host (bf16 as f32)."""
    if isinstance(like, torch.Tensor):
        t = like.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(like)


def _generic_parse(s: str, like):
    """(mode, value) rebuilding a dynamic capture leaf from its wire param
    string WITHOUT the node kind's code, or (None, None).

    Covers the interactive-edit surface: scalar ints / floats (cos A / b,
    the noise seed, the saliency class, patch_sim's row / col) and base64
    f32 arrays (the conv2d matrix). Verified against the kind's real
    ``captures()`` at export: only verified params become editable."""
    ref = _host(like)
    try:
        if ref.ndim == 0:
            if np.issubdtype(ref.dtype, np.integer):
                return "int", np.asarray(int(float(s)), ref.dtype)
            if np.issubdtype(ref.dtype, np.floating):
                return "float", np.asarray(float(s), ref.dtype)
            return None, None
        raw = np.frombuffer(base64.b64decode(s), "<f4")
        if raw.size == ref.size:
            return "b64f32", raw.reshape(ref.shape).astype(ref.dtype,
                                                           copy=False)
    except Exception:  # noqa: BLE001 -- unparseable = not editable
        pass
    return None, None


def parse_editable(mode: str, s: str, like) -> torch.Tensor:
    """Apply a recorded edit mode (the serve-from-artifact hot path): a
    host tensor of ``like``'s shape and dtype. Only ``like.shape`` and
    ``like.dtype`` are read, so a device leaf costs no copy to the host."""
    shape, dtype = tuple(like.shape), like.dtype
    if mode == "int":
        return torch.tensor(int(float(s)), dtype=dtype)
    if mode == "float":
        return torch.tensor(float(s), dtype=dtype)
    if mode == "b64f32":
        raw = np.frombuffer(base64.b64decode(s), "<f4").reshape(shape)
        return torch.from_numpy(raw.copy()).to(dtype)
    raise ExportError(f"unknown edit mode {mode!r}")


def _serving_metadata(graph, reg, caps_arg) -> Dict[str, Any]:
    """Everything ``serving/export_app.py`` needs to serve the reference's
    HTTP surface with NO registry or model code: the exported request
    shape (nodes and wired edges), which params are dynamic (left out of
    the match), which of those are editable (verified per leaf), and each
    node's IO and contents for ``/description`` and ``/contents``."""
    nodes_meta = [{"name": n.name, "params": dict(n.params)}
                  for n in graph.nodes]
    edges_meta = []
    for n in graph.nodes:
        for ch, e in n.inputs.items():
            if e.src is not None:
                edges_meta.append(
                    [e.src.node.index, e.src.channel, n.index, ch])
    dynamic: Dict[str, list] = {}
    editable: Dict[str, Dict[str, str]] = {}
    node_io: Dict[str, Dict[str, Any]] = {}
    node_meta: List[Dict[str, Any]] = []
    for n in graph.nodes:
        try:
            kind = reg.get_node(n.name)
        except KeyError:
            continue
        # per-NODE metadata: contents / io depend on the params (a slice
        # node renders its own spec)
        try:
            node_meta.append({"name": n.name, "params": dict(n.params),
                              "io": kind.io(n.params),
                              "contents": kind.contents(n.params)})
        except Exception:  # noqa: BLE001 -- metadata is best-effort
            pass
        if n.name not in node_io:
            try:
                node_io[n.name] = {"io": kind.io(n.params),
                                   "contents": kind.contents(n.params)}
            except Exception:  # noqa: BLE001 -- metadata is best-effort
                pass
        dyn = kind.dynamic_params()
        if not dyn:
            continue
        dynamic[str(n.index)] = sorted(dyn)
        caps = caps_arg.get(str(n.index))
        if not isinstance(caps, dict):
            continue
        dck = kind.dynamic_capture_keys()
        keys = set(caps) if dck is None else (set(caps) & set(dck))
        modes: Dict[str, str] = {}
        for k in keys:
            if k not in n.params or not hasattr(caps[k], "dtype"):
                continue
            mode, val = _generic_parse(n.params[k], caps[k])
            if mode is not None and np.array_equal(val, _host(caps[k])):
                modes[k] = mode
        if modes:
            editable[str(n.index)] = modes
    return {"graph_nodes": nodes_meta, "graph_edges": edges_meta,
            "dynamic_params": dynamic, "editable": editable,
            "node_io": node_io, "node_meta": node_meta}


# -- export -------------------------------------------------------------------------

def shape_struct(shape, dtype=torch.float32) -> torch.Tensor:
    """A graph input given by its shape and dtype alone (a tensor on the
    meta device): ``export_graph`` traces and records it without pixels,
    and the program then runs on real inputs of that shape."""
    return torch.empty(tuple(int(d) for d in shape), dtype=dtype,
                       device="meta")


def _example(t, device: torch.device) -> torch.Tensor:
    """A graph input's tensor on ``device`` (zeros for a ``shape_struct``)."""
    if isinstance(t, torch.Tensor):
        if t.device.type == "meta":
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        return t.detach().to(device)
    return torch.from_numpy(np.array(t)).to(device)


def _rebind(steps, caps: Dict[str, Any]):
    """Copies of staged steps whose static captures are the program's
    capture arguments (``caps``, keyed by node index), a gradient node's
    replay steps included. Dynamic steps read theirs from the pass's
    dynamic captures."""
    from interactive_vit_tpu_torch.graph.executor import _Step

    out = []
    for st in steps:
        grad = st.grad
        if grad is not None:
            spec, replay, chunked = grad
            grad = (spec, _rebind(replay, caps),
                    None if chunked is None else _rebind(chunked, caps))
        out.append(_Step(st.index, st.name, st.fn,
                         caps.get(str(st.index)) if st.caps is not None
                         else None, st.ins, st.dyn, st.broadcast, grad))
    return out


class _Staged(torch.nn.Module):
    """The exported function ``(inputs, caps) -> {"i/ch": tensor}`` as a
    module (``torch.export`` traces modules)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, inputs, caps):
        return self.fn(inputs, caps)


def _stats(flat: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
    stats = {}
    for key, v in flat.items():  # keys are "i/ch" strings
        a = v.detach().float().cpu().numpy()
        stats[key] = {"shape": list(a.shape), "mean": float(a.mean()),
                      "std": float(a.std()),
                      "absmax": float(np.abs(a).max())}
    return stats


def _trace(staged, inputs, caps, grad: bool):
    """The ExportedProgram of ``staged(inputs, caps)``: ``torch.export``
    under ``no_grad``, or for a graph that runs autograd ``make_fx``'s
    graph of it (the backward as ATen ops) exported after."""
    args = (tuple(inputs), caps)
    with torch.no_grad():
        if not grad:
            return torch.export.export(_Staged(staged), args, strict=False)
        from torch.fx.experimental.proxy_tensor import make_fx

        # the cached device constants (resize matrices, masks) are real
        # tensors: the graph keeps them as constants
        gm = make_fx(staged, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*args)
        return torch.export.export(gm, args, strict=False)


def export_graph(graph, out_dir: str, taps="primary", executor=None,
                 provenance: Optional[Dict[str, Any]] = None,
                 client_graph: Optional[Dict[str, Any]] = None,
                 mesh=None) -> Dict[str, Any]:
    """Stage ``graph`` as ``Executor.run`` would (``_stage``), trace its
    pass on the executor's device and write program, captures and manifest
    into ``out_dir``. Returns the manifest.

    The exported function takes ``(inputs, caps)``: the graph's input
    tensors in ``graph.input_edges()`` order and every node's captures
    keyed ``str(node index)`` (weights and dynamic params alike), and
    returns the tapped outputs as ``{"i/ch": tensor}``. The selftest record
    is the pass's output statistics on seeded numpy inputs (the JAX
    record's feeds). ``mesh`` raises: mesh-sharded export is not ported."""
    if mesh is not None:
        raise ExportError(MESH_NOT_PORTED)
    from interactive_vit_tpu_torch.graph.executor import (
        Executor, _Program, resolve_taps,
    )
    from interactive_vit_tpu_torch.runtime import constants

    ex = executor or Executor()
    ex.validate(graph)
    tap_set = resolve_taps(graph, taps, ex.reg)
    grad = any(ex.reg.get_node(n.name).autograd for n in graph.nodes)
    input_edges = graph.input_edges()
    inputs = [_example(e.tensor, ex.device) for _, _, e in input_edges]
    with ex._device_lock, torch.no_grad():
        prog = ex._stage(graph, tap_set)
        values = ex._dyn_values(prog, [graph])
        caps_arg: Dict[str, Any] = {}
        dyn = {d.index: d for d in prog.dyn}
        for st in prog.steps:
            if st.dyn:
                caps_arg[str(st.index)] = {**dyn[st.index].static,
                                           **ex._place(values[st.index])}
            elif st.caps is not None:
                caps_arg[str(st.index)] = st.caps

        def staged(ins, caps):
            view = _Program(_rebind(prog.steps, caps), prog.dyn,
                            prog.input_keys, prog.out_keys, None)
            return ex._pass(view, dict(zip(prog.input_keys, ins)),
                            {d.index: caps[str(d.index)] for d in prog.dyn})

        try:
            # the seeded record first: its eager pass also fills the
            # device-constant caches with real tensors, which the trace
            # then reads as constants of the program
            rng = np.random.default_rng(0)
            feeds = [torch.from_numpy(rng.random([int(d) for d in t.shape])
                                      .astype(np.float32))
                     .to(device=ex.device, dtype=t.dtype) for t in inputs]
            with ex._grad_mode(graph):
                stats = _stats(staged(feeds, caps_arg))
            ep = _trace(staged, inputs, caps_arg, grad)
        except ExportError:
            raise
        except Exception as err:  # noqa: BLE001 -- one error type out
            raise ExportError(f"program export failed: {err}") from err
        finally:
            # a constant first built inside the trace is a fake tensor:
            # none may stay cached (programs keep what they retained)
            constants.clear_all()
    # the example inputs would carry every weight a second time
    ep._example_inputs = None

    flat: Dict[str, torch.Tensor] = {}
    skel = _flatten_caps(caps_arg, "c", flat)
    manifest = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "platforms": [ex.device.type],
        "inputs": [
            {"node": n.index, "name": n.name, "channel": ch,
             "shape": list(t.shape), "dtype": _dtype_name(t.dtype)}
            for (n, ch, _), t in zip(input_edges, inputs)
        ],
        "out_keys": [[i, ch] for i, ch in prog.out_keys],
        "captures_skeleton": skel,
        "mesh": None,
        "capture_specs": None,
        "provenance": provenance or {},
    }
    manifest.update(_serving_metadata(graph, ex.reg, caps_arg))
    manifest["selftest"] = {"input_seed": 0, "stats": stats}
    if client_graph is not None:
        # the saved graph JSON (viewers included) rides along so that the
        # export server's /list_graphs and /load_graph boot the frontend
        manifest["client_graph"] = client_graph

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(ep, os.path.join(out_dir, PROGRAM_FILE))
    safetensors_io.save_file(flat, os.path.join(out_dir, CAPS_FILE),
                             metadata={"format": str(FORMAT)})
    with open(os.path.join(out_dir, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


# -- load / run ---------------------------------------------------------------------

def split_single(flat) -> Dict[int, Dict[str, np.ndarray]]:
    """{"i/ch": arr} -> {i: {ch: arr}} (``Executor.split_single``'s, kept
    here: the executor imports the node registry, which a load must not)."""
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for key, val in flat.items():
        i, ch = key.split("/", 1)
        out.setdefault(int(i), {})[ch] = val
    return out


class ExportedGraph:
    """A loaded artifact: ``__call__(*inputs)`` runs the program.

    Needs only torch, ``ops/custom_ops.py`` and the artifact's bytes. The
    captures live on the artifact's device from load. ``set_cap(node,
    name, value)`` edits one dynamic param for every later call; a call's
    ``caps`` overlay edits them for that call alone. On a card the first
    call captures the program into a CUDA graph (the inputs, captures and
    tapped outputs in static buffers) and every later call copies its
    inputs and overlay in and replays; the lock serializes them, so
    concurrent calls with different overlays do not race. A ``cuda``
    artifact on a host without a card raises: it never runs on the CPU."""

    def __init__(self, path: str):
        # the program's ivt:: nodes need their ops registered before load
        from interactive_vit_tpu_torch.ops import custom_ops  # noqa: F401
        from interactive_vit_tpu_torch.runtime.device import require_device

        self.path = path
        try:
            with open(os.path.join(path, MANIFEST_FILE)) as f:
                self.manifest = json.load(f)
        except OSError as err:
            raise ExportError(f"{path}: no readable manifest: {err}") from err
        prog_path = os.path.join(path, PROGRAM_FILE)
        if (not os.path.exists(prog_path)
                and os.path.exists(os.path.join(path, JAX_PROGRAM_FILE))):
            raise ExportError(
                f"{path}: {JAX_PROGRAM_FILE} is a JAX package artifact "
                f"(jax.export); this package loads {PROGRAM_FILE} artifacts "
                f"of its own graph/export.py")
        if self.manifest.get("format") != FORMAT:
            raise ExportError(
                f"{path}: unsupported artifact format "
                f"{self.manifest.get('format')!r} (this build reads "
                f"{FORMAT})")
        if self.manifest.get("mesh"):
            raise ExportError(f"{path}: {MESH_NOT_PORTED}")
        platforms = self.manifest.get("platforms") or ["cpu"]
        try:
            self.device = require_device(platforms[0])
        except RuntimeError as err:
            raise ExportError(
                f"{path}: the program was exported for {platforms}: "
                f"{err}") from err
        try:
            ep = torch.export.load(prog_path)
        except Exception as err:  # noqa: BLE001 -- one error type out
            raise ExportError(
                f"{path}: program deserialization failed: {err}") from err
        self._module = ep.module()
        flat = safetensors_io.load_file(os.path.join(path, CAPS_FILE))
        self.caps = _map_leaves(lambda t: t.to(self.device),
                                _unflatten_caps(
                                    self.manifest["captures_skeleton"],
                                    flat))
        self.out_keys: List[Tuple[int, str]] = [
            (int(i), ch) for i, ch in self.manifest["out_keys"]]
        self._lock = threading.RLock()
        self._graph = None  # the CUDA graph, captured at the first call
        self._stream = None
        self._static_in: List[torch.Tensor] = []
        self._static_out: Dict[str, torch.Tensor] = {}

    @property
    def input_specs(self) -> List[Dict[str, Any]]:
        return self.manifest["inputs"]

    def _leaf(self, node_index: int, name: str) -> torch.Tensor:
        node = self.caps.get(str(node_index))
        if node is None or not isinstance(node, dict) or name not in node:
            have = sorted(
                f"{i}:{k}" for i, c in self.caps.items()
                if isinstance(c, dict) for k in c)
            raise ExportError(
                f"no capture {node_index}:{name}; artifact has {have}")
        old = node[name]
        if not isinstance(old, torch.Tensor):
            raise ExportError(
                f"capture {node_index}:{name} is a weights subtree, not a "
                f"scalar/array dynamic param — only leaf params are "
                f"editable")
        return old

    def set_cap(self, node_index: int, name: str, value) -> None:
        """Edit one dynamic node param for every later call (its shape and
        dtype must be the exported one's: the program's calling convention
        is static). The leaf is written in place: a captured CUDA graph
        reads it where it is."""
        old = self._leaf(node_index, name)
        new = torch.as_tensor(np.asarray(value)).to(old.dtype)
        if tuple(new.shape) != tuple(old.shape):
            raise ExportError(
                f"capture {node_index}:{name} has shape {tuple(old.shape)}, "
                f"got {tuple(new.shape)} (shapes are baked into the "
                f"program)")
        with self._lock:
            old.copy_(new)

    def _inputs(self, inputs) -> List[torch.Tensor]:
        specs = self.manifest["inputs"]
        if len(inputs) != len(specs):
            raise ExportError(
                f"program takes {len(specs)} inputs "
                f"({[s['name'] for s in specs]}), got {len(inputs)}")
        out = []
        for x, spec in zip(inputs, specs):
            t = (x.detach().cpu() if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.array(x)))
            if list(t.shape) != spec["shape"]:
                raise ExportError(
                    f"input for {spec['name']}:{spec['channel']} has "
                    f"shape {list(t.shape)}, program was exported for "
                    f"{spec['shape']}")
            out.append(t.to(_torch_dtype(spec["dtype"])))
        return out

    def _overlay(self, caps) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(capture leaf, this call's value) for each leaf of ``caps`` that
        is not the loaded leaf itself."""
        if caps is None:
            return []
        mine = dict(_leaves(self.caps))
        edits = []
        for path, v in _leaves(caps):
            old = mine.get(path)
            if old is None:
                raise ExportError(f"capture overlay has no leaf {path}")
            if v is not old:
                t = torch.as_tensor(v).to(old.dtype)
                if tuple(t.shape) != tuple(old.shape):
                    raise ExportError(
                        f"capture overlay leaf {path} has shape "
                        f"{tuple(t.shape)}, the program "
                        f"{tuple(old.shape)}")
                edits.append((old, t))
        return edits

    def __call__(self, *inputs, caps: Optional[Any] = None,
                 want: Optional[set] = None
                 ) -> Dict[int, Dict[str, np.ndarray]]:
        """Run the program; ``{node: {channel: f32 numpy}}``. ``caps``: a
        captures tree whose leaves override the loaded ones for THIS call
        only (the export server's per-request edits). ``want``: the
        ``(node, channel)`` keys to copy to the host (the program computes
        every exported output)."""
        args = self._inputs(inputs)
        edits = self._overlay(caps)
        keys = None if want is None else {f"{i}/{ch}" for i, ch in want}
        try:
            with self._lock, torch.no_grad():
                if self.device.type == "cuda":
                    flat = self._run_cuda(args, edits, keys)
                else:
                    flat = self._run_cpu(args, edits, keys)
        except ExportError:
            raise
        except Exception as err:  # noqa: BLE001 -- one error type out
            raise ExportError(f"exported program failed: {err}") from err
        return split_single(flat)

    def _run_cpu(self, args, edits, keys):
        saved = [(leaf, leaf.clone()) for leaf, _ in edits]
        try:
            for leaf, v in edits:
                leaf.copy_(v)
            outs = self._module(tuple(args), self.caps)
        finally:
            for leaf, v in saved:
                leaf.copy_(v)
        return {k: v.detach().float().numpy() for k, v in outs.items()
                if keys is None or k in keys}

    def _run_cuda(self, args, edits, keys):
        """One call on the card, on the artifact's side stream: the
        overlay's values copied into the capture leaves (the old ones kept
        and copied back after), the inputs into the static buffers, the
        first call's eager pass and capture or a replay, and the wanted
        outputs' copies into page-locked host buffers."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            saved = [(leaf, leaf.clone()) for leaf, _ in edits]
            for leaf, v in edits:
                leaf.copy_(v, non_blocking=True)
            if self._graph is None:
                self._static_in = [torch.empty(t.shape, dtype=t.dtype,
                                               device=self.device)
                                   for t in args]
            for buf, t in zip(self._static_in, args):
                buf.copy_(t, non_blocking=True)
            if self._graph is None:
                outs = self._module(tuple(self._static_in), self.caps)
                outs = {k: v.float() for k, v in outs.items()}
                side.synchronize()
                self._capture()
            else:
                self._replay()
                outs = self._static_out
            host = {}
            for k, v in outs.items():
                if keys is None or k in keys:
                    h = torch.empty(v.shape, dtype=torch.float32,
                                    pin_memory=True)
                    h.copy_(v, non_blocking=True)
                    host[k] = h
            for leaf, v in saved:
                leaf.copy_(v, non_blocking=True)
            side.synchronize()
        return {k: h.numpy() for k, h in host.items()}

    def _capture(self) -> None:
        """Capture the program from the static buffers (on the side
        stream, the current one) into ``self._graph``."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream,
                              capture_error_mode="thread_local"):
            outs = self._module(tuple(self._static_in), self.caps)
            self._static_out = {k: v.detach().float().contiguous()
                                for k, v in outs.items()}
        self._graph = graph

    def _replay(self) -> None:
        self._graph.replay()

    def selftest(self, rel_tol: float = 5e-2) -> Dict[str, Any]:
        """Replay the manifest's seeded inputs and compare each output's
        mean / std / absmax with the values recorded at export, relative to
        the recorded absmax: corrupt capture bytes, a truncated program or
        a broken calling convention move them far, rounding does not.
        Needs no model code and no live executor. Returns {"ok", "checked",
        "worst"}; raises ``ExportError`` without a record."""
        rec = self.manifest.get("selftest")
        if not rec:
            raise ExportError(f"{self.path}: no selftest record in the "
                              f"manifest")
        rng = np.random.default_rng(int(rec["input_seed"]))
        feeds = [rng.random(s["shape"]).astype(np.float32)
                 for s in self.manifest["inputs"]]
        outs = self(*feeds)
        worst = {"key": None, "metric": None, "rel": 0.0}
        checked = 0
        for key, exp in rec["stats"].items():
            i, ch = key.split("/", 1)
            a = np.asarray(outs[int(i)][ch], np.float32)
            if list(a.shape) != exp["shape"]:
                return {"ok": False, "checked": checked,
                        "worst": {"key": key, "metric": "shape",
                                  "got": list(a.shape),
                                  "want": exp["shape"]}}
            scale = max(abs(exp["absmax"]), 1e-6)
            for metric, got in (("mean", float(a.mean())),
                                ("std", float(a.std())),
                                ("absmax", float(np.abs(a).max()))):
                rel = abs(got - exp[metric]) / scale
                if rel > worst["rel"]:
                    worst = {"key": key, "metric": metric, "rel": rel,
                             "got": got, "want": exp[metric]}
            checked += 1
        return {"ok": worst["rel"] <= rel_tol, "checked": checked,
                "worst": worst}


def load_artifact(path: str) -> ExportedGraph:
    return ExportedGraph(path)
