"""Node-kind registry.

Counterpart of ``interactive_vit_tpu/graph/registry.py``: a registry of
named ``NodeKind``s, each answering ``io(params)`` / ``contents(params)`` /
``compute(params, pinin)``. A kind's computation is a function from a dict
of input tensors to a dict of output tensors (``NodeKind.fn``), with the
kind's weights passed as a second argument when it has ``captures``.
``NodeKind.stacked_fn`` is the same computation over K requests at once
(``Executor.run_stacked``), and ``scan_plugins`` registers the kinds of a
plugin directory. ``dynamic_params`` / ``dynamic_sig`` /
``dynamic_capture_keys`` name the params whose values ride as runtime
captures, so that an edit of them reuses the executor's staged (on a card:
captured) program. A ``grad_node`` kind (saliency, dream, occlusion, a
model's ``:attrib``) is handed its ancestor cone as a closed function by
the executor (``NodeKind.grad_fn``); inside a replay that differentiates,
each node of the cone runs ``grad_safe_fn``.
"""

from __future__ import annotations

import ast
import importlib.util
import logging
import os
import sys
from typing import Any, Callable, Dict, List, Optional
from urllib.parse import urlencode

import torch

from interactive_vit_tpu_torch.graph.ir import Pinout

logger = logging.getLogger(__name__)

# A node computation: dict[channel -> tensor] -> dict[channel -> tensor].
NodeFn = Callable[[Dict[str, Any]], Dict[str, Any]]


class NodeKind:
    """Base class for a registered node kind.

    ``grad_node``: the executor evaluates the kind through
    ``grad_fn(params)(forward, x, caps)``, where ``forward`` re-runs the
    node's ancestor cone as a function of one leaf tensor ``x`` (its
    ``grad_wrt(params)``: a graph input or an upstream node's output).
    ``differentiates``: whether those replays run under autograd (False:
    forwards only, so they keep the kernel-backed ``fn``). ``autograd``:
    the kind runs ``torch.autograd`` itself (every ``grad_node`` does), so
    a graph that holds one runs under ``no_grad``, not ``inference_mode``."""

    grad_node = False
    differentiates = True
    autograd = False

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

    def grad_safe_fn(self, params: Dict[str, str]) -> NodeFn:
        """``fn`` for a replay that autograd differentiates (a downstream
        saliency, dream or attrib node). A kind whose ``fn`` launches a
        hand-written kernel (which has no backward) or rounds activations
        (zero gradient almost everywhere) overrides it with a plain
        PyTorch twin (``models/model_plugin.TorchModel(grad_layers=)``)."""
        return self.fn(params)

    def captures(self, params: Dict[str, str]):
        """The node's weights (a tensor tree), or None for stateless ops."""
        return None

    def dynamic_params(self) -> frozenset:
        """Param names whose VALUES ride as runtime captures, not as part
        of the staged program: the executor leaves them out of its cache
        signature and refreshes them from the graph on every run, so an
        interactive edit (cos A / b) reuses the cached program, on a card
        its captured CUDA graph, instead of staging and capturing anew. A
        kind declaring these MUST deliver the values through
        ``captures()`` as a flat dict of tensors whose keys, shapes and
        dtypes do not depend on the values."""
        return frozenset()

    def dynamic_sig(self, params: Dict[str, str]) -> Optional[str]:
        """Shape-class key for the dynamic params, or None. Where a dynamic
        param also decides capture shapes in a coarser way (a list whose
        wording is dynamic but whose length is not), return a string of
        exactly the shape-deciding part, so that programs of different
        shapes are never shared."""
        return None

    def dynamic_capture_keys(self) -> Optional[frozenset]:
        """The keys of ``captures()`` whose values depend on the dynamic
        params; None: all of them. A stacked run stacks these per request
        and passes the others (large static weights) once, unstacked."""
        return None

    def stacked_fn(self, params: Dict[str, str],
                   caps_axes=None) -> NodeFn:
        """``fn`` over K requests at once: every input carries a leading
        stacked axis K, and so does every output, each slice equal to what
        ``fn`` gives that request alone (called as ``fn`` is, with the
        weights unstacked). ``caps_axes``: for a kind with dynamic params,
        the executor's per-key axes of its captures ({key: 0} for a value
        stacked per request, {key: None} for one passed once); None:
        every capture passed once. The default runs ``fn`` under
        ``torch.func.vmap``, the counterpart of the JAX executor's
        ``jax.vmap``: exact for kinds written in plain torch ops. A kind
        whose ``fn`` reaches a kernel through ``data_ptr`` overrides it
        (``LayerNodeKind``): a vmapped tensor has no storage to point at."""
        f = self.fn(params)
        if self.captures(params) is None:
            return torch.func.vmap(f)
        return torch.func.vmap(f, in_dims=(0, caps_axes))

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


# Top-level modules a plugin file of the JAX package imports; the port
# never loads such a file (it would import JAX).
_JAX_MODULES = frozenset({"jax", "jaxlib", "flax", "optax", "orbax",
                          "interactive_vit_tpu"})


def _imports_jax(path: str) -> bool:
    """Whether the Python file at ``path`` imports JAX or the JAX package
    (read from its syntax tree, without running it)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        if any(n.split(".")[0] in _JAX_MODULES for n in names):
            return True
    return False


def scan_plugins(dirs: List[str], reg: Optional[Registry] = None) -> None:
    """Import every ``.py`` in ``dirs``, call its ``instances()`` and
    register what it returns.

    A file that imports JAX or the JAX package (a plugin written for it)
    is skipped unread; a file that fails to import or register is logged
    and skipped, never fatal, as in the JAX package."""
    reg = reg or registry()
    for full_dir in dirs:
        if not os.path.isdir(full_dir):
            logger.warning("plugin dir missing: %s", full_dir)
            continue
        for file in sorted(os.listdir(full_dir)):
            path = os.path.join(full_dir, file)
            if not os.path.isfile(path) or not path.endswith(".py"):
                continue
            # namespaced: a plugin file named queue.py or json.py must not
            # take over sys.modules["queue"] for the whole process
            name = "ivt_torch_plugins." + os.path.splitext(file)[0]
            try:
                if _imports_jax(path):
                    logger.info("skipped plugin %s: it imports JAX", path)
                    continue
                spec = importlib.util.spec_from_file_location(name, path)
                assert spec is not None and spec.loader is not None
                module = importlib.util.module_from_spec(spec)
                sys.modules[name] = module
                try:
                    spec.loader.exec_module(module)
                except Exception:
                    sys.modules.pop(name, None)
                    raise
                for inst in module.instances():
                    inst.register(reg)
            except Exception as err:  # noqa: BLE001 -- plugin isolation
                logger.info("could not register plugin %s: %s", path, err)
