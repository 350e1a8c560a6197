"""Model plugin tier: expose a model's layers as tappable graph node kinds.

Counterpart of ``interactive_vit_tpu/models/model_plugin.py``. A model is
an ordered list of named functions over parameter subtrees
(``models/vit.py::layer_fns``); each becomes a ``LayerNodeKind`` named
``"<model>:<layer>"`` whose weights are its captures. A layer may declare
extra tap channels beyond the flowing "o" (transformer blocks add "attn",
"r" and "cls"); they are computed only when wired or tapped.

A group of K requests runs each layer once: ``LayerNodeKind.stacked_fn``
folds the stacked axis into the model's own batch axis, so a block kernel
sees a batch of K in one launch.

A layer whose ``fn`` launches a hand-written kernel (no backward) or runs
int8 weights has a differentiable twin (``TorchModel(grad_layers=)``): the
same layer math in plain PyTorch, which a gradient replay runs
(``LayerNodeKind.grad_safe_fn``), as the JAX package's replays run plain
XLA twins of its Pallas layers. ``extra_kinds`` are node kinds registered
with the model outside its chain (the ViT family's ``:attrib``).
"""

from __future__ import annotations

import functools
import html
import inspect
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from interactive_vit_tpu_torch.graph.registry import NodeKind, Registry
from interactive_vit_tpu_torch.ops.quant import (
    dequantize_weight, is_quantized, is_w8a8,
)
from interactive_vit_tpu_torch.wire.schema import (
    GraphLibrary, generate_model_graph_json,
)

logger = logging.getLogger(__name__)

# (layer_name, extra_out_channels, fn(params_subtree, ins_dict) -> outs_dict)
LayerSpec = Tuple[str, List[str], Callable]

# Per-request rank of an image sent without its batch axis ([C, H, W]).
IMAGE_RANK = 3


def dequant_grad_twin(fn: Callable) -> Callable:
    """Wrap a layer fn for gradient replays over a quantized param tree:
    each int8 leaf-dict (weight-only or W8A8) is dequantized inline to the
    tree's activation dtype (its first floating tensor's; f32 where it has
    none), so that the replayed math is dense and its gradient flows where
    the serving path's activation rounding would zero it almost
    everywhere."""

    def dq(obj, dtype):
        if is_quantized(obj) or is_w8a8(obj):
            return dequantize_weight(obj, dtype=dtype)
        if isinstance(obj, dict):
            return {k: dq(v, dtype) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(dq(v, dtype) for v in obj)
        return obj

    def act_dtype(obj):
        if isinstance(obj, torch.Tensor):
            return obj.dtype if obj.is_floating_point() else None
        items = (obj.values() if isinstance(obj, dict) else
                 obj if isinstance(obj, (list, tuple)) else ())
        for v in items:
            dt = act_dtype(v)
            if dt is not None:
                return dt
        return None

    @functools.wraps(fn)
    def run(p, ins, **kw):
        return fn(dq(p, act_dtype(p) or torch.float32), ins, **kw)

    return run


def image_entry(fn: Callable, keeps_rank: bool,
                rank: int = IMAGE_RANK) -> Callable:
    """Mark a layer fn whose "o" input is an image that a request may send
    without its batch axis ([C, H, W] instead of [B, C, H, W]). With
    ``keeps_rank`` such an input gives an output without the batch axis too
    (the transform); without it, an output with a batch of 1 (the patch
    embedding). ``rank``: the rank of such an input without its batch axis
    (3 for an image; 1 for the features of a classifier that the reference
    ran unbatched, VGG's). Every other layer's inputs and outputs carry the
    batch axis. ``LayerNodeKind.stacked_fn`` reads the mark."""
    fn.image_entry = "keeps_rank" if keeps_rank else "adds_batch"
    fn.image_rank = rank
    return fn


class LayerNodeKind(NodeKind):
    """One model layer as a graph node kind. ``grad_fn_impl``: the layer's
    differentiable twin (the ``fn`` contract), which ``grad_safe_fn`` runs;
    None: ``fn`` is differentiable as it is."""

    def __init__(self, model: "TorchModel", layer_name: str,
                 extra_outs: List[str], fn: Callable,
                 grad_fn_impl: Optional[Callable] = None):
        super().__init__(model.prefix() + layer_name)
        self.model = model
        self.layer_name = layer_name
        self._extra = list(extra_outs)
        self._fn = fn
        self._grad_fn_impl = grad_fn_impl

    def io(self, params):
        # layers with an "r" (rollout) extra also accept an optional "r"
        # input: the rollout flows along the chain like the activation
        ins = ["o"] + (["r"] if "r" in self._extra else [])
        return {"ins": ins, "outs": ["o"] + self._extra}

    def extra_outs(self, params):
        return list(self._extra)

    @property
    def optional_inputs(self):
        """The rollout-carry input may be unwired; "o" stays required."""
        return {"r"} if "r" in self._extra else frozenset()

    def contents(self, params):
        body = (f"<p>{self.get_name()}</p> "
                f"<p>{self.model.describe(self.layer_name)}</p>")
        if "attn" in self._extra:
            # a JSON head list limits the emitted maps to those heads
            cur = params.get("attn_heads", "")
            body += (f"<label>tap heads <input data-param=\"attn_heads\" "
                     f"type=\"text\" size=\"8\" "
                     f"value=\"{html.escape(cur)}\" "
                     f"placeholder=\"all, e.g. [0,5]\"></label>")
        return body

    def captures(self, params):
        caps = self.model.layer_params(self.layer_name)
        return caps if caps else None

    def fn(self, params):
        return self._bind(self._fn, params)

    def grad_safe_fn(self, params):
        """``fn`` for gradient replays: the model's twin where it has one
        (a kernel has no backward; int8 activations round)."""
        return self._bind(self._grad_fn_impl or self._fn, params)

    def _bind(self, f, params):
        taps = set((params.get("__taps__") or "").split(","))
        want = frozenset(taps & set(self._extra))
        kw: Dict[str, Any] = {"want": want} if self._extra else {}
        if self._takes_node_params:
            kw["node_params"] = params

        def keep(outs):
            return {ch: v for ch, v in outs.items() if ch == "o" or ch in want}

        if self.captures(params) is None:
            return lambda ins: keep(f({}, ins, **kw))
        return lambda ins, caps: keep(f(caps, ins, **kw))

    def stacked_fn(self, params):
        """The layer over K requests in one call: the stacked axis K is
        folded into the model's batch axis (per-request batch b: [K, b,
        ...] -> [K*b, ...]), the layer fn runs once, and its outputs are
        unfolded to [K, b, ...]. An unbatched image ([K, C, H, W] stacked;
        of ``image_entry``'s rank) is a batch of K as it stands; its
        outputs keep or gain the batch axis as ``image_entry`` says. Exact where the layer's ops treat
        the batch's rows apart, as the plain versions and the kernels do;
        no ``BatchedTensor`` ever reaches a kernel."""
        f = self.fn(params)
        entry = getattr(self._fn, "image_entry", None)
        rank = getattr(self._fn, "image_rank", IMAGE_RANK)

        def run(ins, *caps):
            x = ins["o"]
            k = x.shape[0]
            if entry is not None and x.ndim == rank + 1:
                outs = f(ins, *caps)
                if entry == "keeps_rank":
                    return outs
                return {ch: v.unsqueeze(1) for ch, v in outs.items()}
            b = x.shape[1]
            for ch, v in ins.items():
                if v.shape[:2] != (k, b):
                    raise ValueError(
                        f"stacked input {ch!r} has leading dims "
                        f"{tuple(v.shape[:2])}; expected ({k}, {b})")
            outs = f({ch: v.flatten(0, 1) for ch, v in ins.items()}, *caps)
            return {ch: v.unflatten(0, (k, b)) for ch, v in outs.items()}

        return run

    @functools.cached_property
    def _takes_node_params(self) -> bool:
        """Layer fns opting into node params (e.g. attn_heads) declare a
        ``node_params`` keyword."""
        return "node_params" in inspect.signature(self._fn).parameters


class TorchModel:
    """A named model: ordered layers + params, registerable as node kinds.

    ``register`` also writes the chained graph JSON into the graph library
    when the library has none for this model (the reference app's
    behaviour). ``grad_layers``: layer name -> its differentiable twin
    (the layer fn contract), run in gradient replays; ``extra_kinds``:
    node kinds registered with the model outside the chain."""

    def __init__(
        self,
        name: str,
        layers: Sequence[LayerSpec],
        params: Any,
        layer_params_fn: Callable[[Any, str], Any],
        descriptions: Optional[Dict[str, str]] = None,
        category_names: Optional[List[str]] = None,
        grad_layers: Optional[Dict[str, Callable]] = None,
        extra_kinds: Optional[List[NodeKind]] = None,
    ):
        self.name = name
        self.layers = list(layers)
        self.params = params
        self._layer_params_fn = layer_params_fn
        self.descriptions = descriptions or {}
        self.category_names = category_names
        self.grad_layers = grad_layers or {}
        self.extra_kinds = list(extra_kinds or [])

    def prefix(self) -> str:
        return self.name + ":"

    def list_node_names(self) -> List[str]:
        return [self.prefix() + lname for lname, _, _ in self.layers]

    def layer_params(self, layer_name: str) -> Any:
        return self._layer_params_fn(self.params, layer_name)

    def describe(self, layer_name: str) -> str:
        return self.descriptions.get(layer_name, layer_name)

    def generate_graph_json(self) -> Dict:
        """Chained layer nodes in a sqrt-grid, plus a category sink when the
        model has class names."""
        obj = generate_model_graph_json(self.list_node_names())
        if self.category_names is not None:
            i = len(obj["nodes"])
            w = max(1, int(i ** 0.5))
            obj["nodes"].append({
                "instance": {"kind": "category", "cats": self.category_names},
                "pos": {"x": (i % w) * 200, "y": (i // w) * 200},
            })
            obj["edges"].append({
                "in_port": {"node": i - 1, "channel": "o"},
                "out_port": {"node": i, "channel": "o"},
            })
        return obj

    def generate_saliency_graph_json(self) -> Dict:
        """The model chain plus the gradient-tap workflow, each node
        feeding an ``img_view``: ``saliency`` (grad x input of the winning
        class wrt the image), ``dream`` (gradient ascent on class 0),
        ``occlusion`` (patch 32, stride 16) wired from the ``:head`` node,
        and, where the model has an ``:attrib`` kind and an ``:embed``
        node, the attribution node wired from the embed output. Raises for
        a chain without a ``:head`` layer."""
        obj = self.generate_graph_json()
        head = next((i for i, n in enumerate(obj["nodes"])
                     if n["instance"].get("endpoint", "").endswith(":head")),
                    None)
        if head is None:
            raise ValueError(f"{self.name} has no :head node — saliency "
                             f"demo needs a classifier chain")
        hx = obj["nodes"][head]["pos"]["x"]
        hy = obj["nodes"][head]["pos"]["y"]

        def add(inst, dx, dy):
            obj["nodes"].append(
                {"instance": inst, "pos": {"x": hx + dx, "y": hy + dy}})
            return len(obj["nodes"]) - 1

        def wire(a, ach, b, bch):
            obj["edges"].append({"in_port": {"node": a, "channel": ach},
                                 "out_port": {"node": b, "channel": bch}})

        def with_view(src, src_ch, inst, dy):
            node = add(inst, 220, dy)
            wire(src, src_ch, node, "o")
            wire(node, "o", add({"kind": "img_view"}, 440, dy), "o")

        with_view(head, "o", {"kind": "net_node", "endpoint": "saliency",
                              "params": {"target": "max",
                                         "mode": "gradxinput"}}, 120)
        with_view(head, "o", {"kind": "net_node", "endpoint": "dream",
                              "params": {"target": "class", "class": "0",
                                         "steps": "32", "lr": "0.05"}}, 280)
        with_view(head, "o", {"kind": "net_node", "endpoint": "occlusion",
                              "params": {"target": "max", "patch": "32",
                                         "stride": "16"}}, 440)
        if any(k.get_name().endswith(":attrib") for k in self.extra_kinds):
            emb = next((i for i, n in enumerate(obj["nodes"])
                        if n["instance"].get("endpoint",
                                             "").endswith(":embed")), None)
            if emb is not None:
                with_view(emb, "o", {"kind": "net_node",
                                     "endpoint": self.name + ":attrib",
                                     "params": {"target": "max"}}, 600)
        return obj

    def _kind_cls(self, layer_name: str) -> type:
        """Node-kind class for ``layer_name``; a subclass hook (the Swin
        model swaps in a kind with a window selector)."""
        return LayerNodeKind

    def register(self, reg: Registry,
                 graph_lib: Optional[GraphLibrary] = None) -> None:
        if graph_lib is not None and not graph_lib.exists(self.name + ".json"):
            graph_lib.save(self.name + ".json", self.generate_graph_json())
            logger.info("generated graph %s.json", self.name)
        for lname, extra, fn in self.layers:
            self._kind_cls(lname)(
                self, lname, extra, fn,
                grad_fn_impl=self.grad_layers.get(lname)).register(reg)
        for kind in self.extra_kinds:
            kind.register(reg)
