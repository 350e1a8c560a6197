"""Quantization agreement: how far the int8 serving modes move the logits.

    python -m interactive_vit_tpu_torch.tools.quant_agreement --variant swin_t
    python -m interactive_vit_tpu_torch.tools.quant_agreement \
        --variant vit_b16 --rounds 8 --batch 64

The port's counterpart of the root ``tools/experiments/quant_agreement.py``
(which measures the JAX package), for ``--variant`` vit_b16 or swin_t. One
seeded random bf16 init (``--seed``) serves three modes, each as the server
runs it on a card:

* ``bf16`` -- dense weights; the block kernel (ViT) or the window kernel
  (Swin) in every block;
* ``int8_w8`` -- every block linear (qkv, proj, fc1, fc2) weight-only int8,
  on the unfused path (no kernel takes int8 qkv);
* ``int8w8a8_mlp`` -- fc1 and fc2 W8A8 through ``default_mlp_impl("auto",
  quant="w8a8")`` (the W8A8 MLP kernel where the shape fits it), the
  attention as in ``bf16``.

``--rounds`` batches of ``--batch`` seeded random images (8 x 64 by default)
go through each mode. For each mode, one JSON line gives its top-1
agreement with ``bf16``, the mean absolute logit difference from it, and
that over the logit spread (the ``bf16`` logits' standard deviation,
averaged over the rounds). The ``bf16`` line is the check of the harness
itself: agreement 1 and difference 0. Random weights give smooth logits,
so this bounds the perturbation's class and is no real-weights accuracy.

Runs on the card (``--device cuda``, the default; it raises without one);
``--device cpu`` runs the plain versions, the unfused W8A8 path included.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

VARIANTS = ("vit_b16", "swin_t")


def _leaf_dtype(tree):
    """The dtype of the first floating tensor of a param tree."""
    if isinstance(tree, torch.Tensor):
        return tree.dtype if tree.is_floating_point() else None
    items = (tree.values() if isinstance(tree, dict) else
             tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        dt = _leaf_dtype(v)
        if dt is not None:
            return dt
    return None


def build_modes(family: str, cfg, params,
                device) -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    """{mode: images [B, 3, H, W] -> logits} for ``family`` ("vit" or
    "swin") at ``cfg`` from the dense ``params`` (on ``device``, in the
    activation dtype), the kernels chosen as the model makers choose them
    on ``device``."""
    from interactive_vit_tpu_torch.ops.dispatch import (
        default_block_impl, default_mlp_impl, default_window_impl,
    )
    from interactive_vit_tpu_torch.ops.quant import quantize_tree

    dtype = _leaf_dtype(params)
    w8 = quantize_tree(params, mode="w8")
    w8a8 = quantize_tree(params, names=frozenset({"fc1_w", "fc2_w"}),
                         mode="w8a8")
    if family == "vit":
        from interactive_vit_tpu_torch.models import vit

        block = default_block_impl("auto", dtype=dtype, n=cfg.tokens,
                                   d=cfg.width, heads=cfg.heads,
                                   device=device)
        mlp = default_mlp_impl("auto", dtype=dtype, d=cfg.width,
                               mlp_dim=cfg.mlp_dim, quant="w8a8",
                               device=device)

        def run(p, **kw):
            return lambda x: vit.forward(p, x, cfg, **kw)["logits"]

        return {"bf16": run(params, block_impl=block),
                "int8_w8": run(w8),
                "int8w8a8_mlp": run(w8a8, block_impl=block, mlp_impl=mlp)}
    from interactive_vit_tpu_torch.models import swin

    window = default_window_impl("auto", dtype=dtype, cfg=cfg, device=device)
    mlps = [default_mlp_impl("auto", dtype=dtype, d=cfg.stage_dim(s),
                             mlp_dim=cfg.stage_dim(s) * cfg.mlp_ratio,
                             quant="w8a8", device=device)
            for s in range(len(cfg.depths))]

    def run_swin(p, **kw):
        return lambda x: swin.forward(p, x, cfg, **kw)["logits"]

    return {"bf16": run_swin(params, window_impl=window),
            "int8_w8": run_swin(w8),
            "int8w8a8_mlp": run_swin(w8a8, window_impl=window,
                                     mlp_impls=mlps if any(mlps) else None)}


def agreement(modes: Dict[str, Callable], batches: Iterable[torch.Tensor]
              ) -> List[dict]:
    """One row a mode: top-1 agreement with ``modes["bf16"]``, the mean
    absolute logit difference from it, and that over the bf16 logits'
    spread, over every batch of ``batches``."""
    agree = {k: 0 for k in modes}
    mae = {k: 0.0 for k in modes}
    spread, n, rounds = 0.0, 0, 0
    with torch.inference_mode():
        for images in batches:
            ref = modes["bf16"](images).float()
            spread += float(ref.std())
            top = ref.argmax(-1)
            for k, fn in modes.items():
                lg = fn(images).float()
                agree[k] += int((lg.argmax(-1) == top).sum())
                mae[k] += float((lg - ref).abs().mean())
            n += images.shape[0]
            rounds += 1
    return [{"mode": k, "top1_agreement": agree[k] / n,
             "logit_mae": mae[k] / rounds,
             "logit_mae_over_spread": mae[k] / spread}
            for k in modes]


def seeded_images(rounds: int, batch: int, size: int, dtype, device):
    """``rounds`` batches of [batch, 3, size, size] uniform images, round r
    from ``np.random.default_rng(r)`` (as the JAX experiment draws them)."""
    for r in range(rounds):
        x = np.random.default_rng(r).random((batch, 3, size, size),
                                            dtype=np.float32)
        yield torch.from_numpy(x).to(device=device, dtype=dtype)


def main(argv=None) -> List[dict]:
    """Prints one JSON line a mode and returns the rows."""
    from interactive_vit_tpu_torch.runtime.device import (
        exact_f32_matmuls, require_device,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="vit_b16", choices=VARIANTS)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    exact_f32_matmuls()
    gen = torch.Generator().manual_seed(args.seed)
    dtype = torch.bfloat16
    if args.variant.startswith("swin_"):
        from interactive_vit_tpu_torch.models import swin as family_mod

        family, cfg = "swin", family_mod.VARIANTS[args.variant]
    else:
        from interactive_vit_tpu_torch.models import vit as family_mod

        family, cfg = "vit", family_mod.resolve_variant(args.variant)
    params = family_mod.init_params(cfg, gen, dtype=dtype, device=device)
    rows = agreement(build_modes(family, cfg, params, device),
                     seeded_images(args.rounds, args.batch, cfg.img_size,
                                   dtype, device))
    for row in rows:
        row = {"variant": args.variant, "device": str(device), **row}
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
