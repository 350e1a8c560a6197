"""MAE plugin: masked reconstruction as interactive graph nodes.

Counterpart of ``interactive_vit_tpu/models/mae_plugin.py``. The chain is
short:

    <name>:transform     eval preprocessing (resize to the encoder's size)
    <name>:reconstruct   mask -> encode -> decode -> compose the views

``reconstruct``'s "o" is the paper's figure (visible patches from the
input, masked ones from the prediction), "masked" what the encoder saw,
"err" and "mask" per-patch [gh, gw] heatmaps. Its ``seed`` is a dynamic
param: a 0-d int64 capture that the mask is drawn from on the device, so a
seed edit replays the cached (on a card: captured) program with a new
mask. ``mask_ratio`` is static: it sets the visible-token count, a shape,
so it belongs to the program's signature. A stacked group draws each
request's mask from its own seed, as the JAX executor's per-entry vmap.
"""

from __future__ import annotations

import html
from typing import Any, Optional

import torch

from interactive_vit_tpu_torch.graph.ir import GraphError
from interactive_vit_tpu_torch.models import mae
from interactive_vit_tpu_torch.models.model_plugin import (
    LayerNodeKind, TorchModel, image_entry,
)
from interactive_vit_tpu_torch.ops.node_ops import uniform_bits_stacked
from interactive_vit_tpu_torch.runtime.device import require_device

_U32 = 0xFFFFFFFF


def _parse_ratio(params) -> Optional[float]:
    raw = (params or {}).get("mask_ratio", "")
    if not raw:
        return None
    try:
        r = float(raw)
    except ValueError:
        raise GraphError(f"mask_ratio {raw!r} is not a number")
    if not 0.0 <= r < 1.0:
        raise GraphError(f"mask_ratio {r} must be in [0, 1)")
    return r


class _ReconstructKind(LayerNodeKind):
    """The reconstruction node: a dynamic ``seed`` (an edit replays the
    cached program), a static ``mask_ratio`` (in the signature)."""

    def contents(self, params):
        seed = params.get("seed", "0") or "0"
        ratio = params.get("mask_ratio", "") or ""
        return (
            f"<p>{self.get_name()}</p>"
            f"<p>{self.model.describe(self.layer_name)}</p>"
            f"<label>seed <input data-param=\"seed\" type=\"number\" "
            f"value=\"{html.escape(seed)}\"></label> "
            f"<label>mask ratio <input data-param=\"mask_ratio\" "
            f"type=\"text\" size=\"5\" value=\"{html.escape(ratio)}\" "
            f"placeholder=\"0.75\"></label>")

    def dynamic_params(self):
        return frozenset({"seed"})

    def dynamic_capture_keys(self):
        # the weights do not depend on the seed: a stacked group passes
        # them once and stacks only the seeds
        return frozenset({"seed"})

    def captures(self, params):
        try:
            seed = int(params.get("seed", "0") or "0")
        except ValueError:
            raise GraphError(
                f"seed {params.get('seed')!r} is not an integer")
        # jax.random.key(seed) of an int32 seed is the key (0, seed as u32)
        return {"w": self.model.layer_params(self.layer_name),
                "seed": torch.tensor(seed & _U32, dtype=torch.int64)}

    def stacked_fn(self, params, caps_axes=None):
        """The node over K requests: each request's mask from its own seed
        (``uniform_bits_stacked``: row k is the draw of seed k at that
        request's [b, L]), the K requests folded into one batch of K*b
        images through the encoder and decoder, the views unfolded to [K,
        b, ...]. An unbatched image ([K, C, H, W] stacked) is a batch of 1
        a request, as ``fn`` makes it."""
        if not caps_axes or caps_axes.get("seed") != 0:
            raise ValueError(f"{self.get_name()} runs stacked only with "
                             f"its seeds stacked per request")
        f = self.fn(params)
        length = self.model.cfg.num_patches

        def run(ins, caps):
            x = ins["o"]
            if x.ndim == 4:
                x = x.unsqueeze(1)
            k, b = x.shape[:2]
            noise = uniform_bits_stacked(caps["seed"], [b, length])
            outs = f({"o": x.flatten(0, 1)},
                     {"w": caps["w"], "noise": noise.flatten(0, 1)})
            return {ch: v.unflatten(0, (k, b)) for ch, v in outs.items()}

        return run


class MAETorchModel(TorchModel):
    """A ``TorchModel`` whose reconstruct layer takes ``_ReconstructKind``;
    ``cfg``: its ``MAEConfig``."""

    def __init__(self, *args, cfg: mae.MAEConfig, **kw):
        super().__init__(*args, **kw)
        self.cfg = cfg

    def _kind_cls(self, layer_name: str) -> type:
        return _ReconstructKind if layer_name == "reconstruct" \
            else LayerNodeKind


def make_mae_model(variant: str = "mae_t16", params: Optional[Any] = None,
                   seed: int = 0, dtype=torch.float32, device="cuda"
                   ) -> MAETorchModel:
    """Build the registerable MAE demo on ``device`` (the card unless the
    caller asks for the CPU; raises without a card). ``variant`` may carry
    an ``@`` suffix (``mae.resolve_variant``). ``params=None`` draws a
    random init from ``torch.Generator`` seeded with ``seed`` (its
    reconstruction is noise); given params must already be on ``device``
    in ``dtype``; a native-flat tree's dropped empty encoder head is put
    back."""
    device = require_device(device)
    cfg = mae.resolve_variant(variant)
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = mae.init_params(cfg, gen, dtype=dtype, device=device)
    else:
        params.setdefault("enc", {}).setdefault("head", {})
    e = cfg.enc_cfg

    def transform_fn(p, ins):
        from interactive_vit_tpu_torch.ops.preprocess_mm import preprocess_mm

        return {"o": preprocess_mm(ins["o"], e.img_size)}

    def reconstruct_fn(caps, ins, want=frozenset(), node_params=None):
        x = ins["o"]
        if x.ndim == 3:
            x = x[None]
        return mae.reconstruct(caps["w"], x, cfg, seed=caps.get("seed"),
                               mask_ratio=_parse_ratio(node_params),
                               noise=caps.get("noise"))

    layers = [
        ("transform", [], image_entry(transform_fn, True)),
        ("reconstruct", ["masked", "err", "mask"], reconstruct_fn),
    ]

    def layer_params_fn(p, layer_name):
        return p if layer_name == "reconstruct" else {}

    return MAETorchModel(
        cfg.name, layers, params, layer_params_fn,
        descriptions={
            "transform": f"resize to {e.img_size} + normalize "
                         f"(matmul-form bilinear)",
            "reconstruct": (
                f"mask {cfg.mask_ratio:.0%} of patches, reconstruct with "
                f"the MAE decoder; o = pasted reconstruction, masked = "
                f"encoder input, err/mask = per-patch heatmaps"),
        },
        cfg=cfg,
    )
