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
"""

from __future__ import annotations

import functools
import html
import inspect
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from interactive_vit_tpu_torch.graph.registry import NodeKind, Registry
from interactive_vit_tpu_torch.wire.schema import (
    GraphLibrary, generate_model_graph_json,
)

logger = logging.getLogger(__name__)

# (layer_name, extra_out_channels, fn(params_subtree, ins_dict) -> outs_dict)
LayerSpec = Tuple[str, List[str], Callable]

# Per-request rank of an image sent without its batch axis ([C, H, W]).
IMAGE_RANK = 3


def image_entry(fn: Callable, keeps_rank: bool) -> Callable:
    """Mark a layer fn whose "o" input is an image that a request may send
    without its batch axis ([C, H, W] instead of [B, C, H, W]). With
    ``keeps_rank`` such an input gives an output without the batch axis too
    (the transform); without it, an output with a batch of 1 (the patch
    embedding). Every other layer's inputs and outputs carry the batch
    axis. ``LayerNodeKind.stacked_fn`` reads the mark."""
    fn.image_entry = "keeps_rank" if keeps_rank else "adds_batch"
    return fn


class LayerNodeKind(NodeKind):
    """One model layer as a graph node kind."""

    def __init__(self, model: "TorchModel", layer_name: str,
                 extra_outs: List[str], fn: Callable):
        super().__init__(model.prefix() + layer_name)
        self.model = model
        self.layer_name = layer_name
        self._extra = list(extra_outs)
        self._fn = fn

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
        taps = set((params.get("__taps__") or "").split(","))
        want = frozenset(taps & set(self._extra))
        kw: Dict[str, Any] = {"want": want} if self._extra else {}
        if self._takes_node_params:
            kw["node_params"] = params
        f = self._fn

        def keep(outs):
            return {ch: v for ch, v in outs.items() if ch == "o" or ch in want}

        if self.captures(params) is None:
            return lambda ins: keep(f({}, ins, **kw))
        return lambda ins, caps: keep(f(caps, ins, **kw))

    def stacked_fn(self, params):
        """The layer over K requests in one call: the stacked axis K is
        folded into the model's batch axis (per-request batch b: [K, b,
        ...] -> [K*b, ...]), the layer fn runs once, and its outputs are
        unfolded to [K, b, ...]. An unbatched image ([K, C, H, W] stacked)
        is a batch of K as it stands; its outputs keep or gain the batch
        axis as ``image_entry`` says. Exact where the layer's ops treat
        the batch's rows apart, as the plain versions and the kernels do;
        no ``BatchedTensor`` ever reaches a kernel."""
        f = self.fn(params)
        entry = getattr(self._fn, "image_entry", None)

        def run(ins, *caps):
            x = ins["o"]
            k = x.shape[0]
            if entry is not None and x.ndim == IMAGE_RANK + 1:
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
    behaviour)."""

    def __init__(
        self,
        name: str,
        layers: Sequence[LayerSpec],
        params: Any,
        layer_params_fn: Callable[[Any, str], Any],
        descriptions: Optional[Dict[str, str]] = None,
        category_names: Optional[List[str]] = None,
    ):
        self.name = name
        self.layers = list(layers)
        self.params = params
        self._layer_params_fn = layer_params_fn
        self.descriptions = descriptions or {}
        self.category_names = category_names

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
            self._kind_cls(lname)(self, lname, extra, fn).register(reg)
