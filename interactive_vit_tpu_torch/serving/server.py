"""Server entry point: ``python -m interactive_vit_tpu_torch.serving.server``.

Counterpart of ``interactive_vit_tpu/serving/server.py``: register the
built-in node kinds and the requested model variants (plain ViTs and Swin,
through ``models/autoregister``), then serve. With
``--graphs-dir``, a variant's chained graph JSON is written into that
library when it lacks one; the repository's own ``static/graphs`` (the
default) is only read. Example, on one CUDA card:

    python -m interactive_vit_tpu_torch.serving.server --models vit_b16 \\
        --dtype bfloat16 --port 8965

``--models vit_l16`` (384 px, 577 tokens) serves through the headwise
block kernel, ``--models dinov2_s14_reg`` (518 px, 1374 tokens) through the
flash attention kernel (``--attn``), ``--models swin_t`` through the fused
window attention kernel in all 12 blocks (``--models swin_t,vit_b16``
serves both).

A plain-ViT name takes an ``@[<pixels>][p<patch>]`` suffix:
``--models dinov2_s14_reg@742`` (a 53 x 53 grid, 2814 tokens) serves
through the online-softmax flash kernel, ``--models vit_t16@256`` through
the fused block kernel (the repository has its saved graph).

``--dtype int8`` serves weight-only int8 (qkv, proj, fc1, fc2) over bf16
activations on the unfused path; ``--dtype int8w8a8`` quantizes fc1 and
fc2 as W8A8 and runs the W8A8 MLP kernel beside the block kernel, which
``--attn int8-scores`` switches to its s8 mode (plain-ViT models only;
refused with ``--dtype int8``):

    python -m interactive_vit_tpu_torch.serving.server --models vit_b16 \
        --dtype int8w8a8 --attn int8-scores --port 8965

Weights are a seeded random init; checkpoint loading, plugin scanning,
multi-device serving, quantized Swin and the other families are not
ported yet.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models.autoregister import make_model
from interactive_vit_tpu_torch.ops.dispatch import default_attn_impl
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.runtime.device import require_device
from interactive_vit_tpu_torch.serving.app import App

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# --dtype -> (activation and weight dtype, quantize mode): the int8 modes
# serve bf16 activations, as in the JAX package
DTYPES = {"float32": (torch.float32, False),
          "bfloat16": (torch.bfloat16, False),
          "int8": (torch.bfloat16, "w8"),
          "int8w8a8": (torch.bfloat16, "w8a8")}
ATTN_CHOICES = ("auto", "flash", "reference", "int8-scores")


def build_app(
    models=("vit_t16",),
    graphs_dir: str = None,
    dtype_name: str = "float32",
    device="cuda",
    seed: int = 0,
    max_batch: int = 8,
    max_wait_ms: float = 3.0,
    attn_impl_name: str = "auto",
) -> App:
    """An ``App`` with its own registry serving ``models`` on ``device``
    (the card unless the caller asks for the CPU; raises without a card).
    ``dtype_name``: a ``DTYPES`` key. ``attn_impl_name``: the attention
    policy of blocks on the unfused path (``ops/dispatch.
    default_attn_impl``), or "int8-scores": the s8 mode of the fused block
    for plain-ViT models (the others keep "auto"), refused with the
    weight-only "int8" dtype, as in the JAX server."""
    dtype, quantize = DTYPES[dtype_name]
    block_kernel = "auto"
    if attn_impl_name == "int8-scores":
        if quantize and quantize != "w8a8":
            raise ValueError(
                "--attn int8-scores needs dense attention weights "
                "(float32/bfloat16/int8w8a8 --dtype; weight-only int8 "
                "runs the unfused path)")
        block_kernel = "int8-scores"
        attn_impl_name = "auto"
    device = require_device(device)
    attn_impl = default_attn_impl(attn_impl_name)
    reg = Registry()
    register_builtin(reg)
    repo_lib = graphs_dir is None
    graphs_dir = graphs_dir or os.path.join(_REPO_ROOT, "static", "graphs")
    frontend_dir = os.path.join(_REPO_ROOT, "frontend")
    app = App(
        reg=reg,
        graphs_dir=graphs_dir,
        frontend_dir=frontend_dir if os.path.isdir(frontend_dir) else None,
        device=device,
        max_batch=max_batch,
        max_wait_ms=max_wait_ms,
    )
    for variant in models:
        # the s8 mode exists for the plain-ViT block only
        bk = "auto" if variant.startswith("swin_") else block_kernel
        model = make_model(variant, seed=seed, dtype=dtype, device=device,
                           attn_impl=attn_impl, quantize=quantize,
                           block_kernel=bk)
        # the repository's library is never written: a variant without a
        # saved graph there gets none
        model.register(reg, None if repo_lib else app.graphs)
        logger.info("registered model %s (%d nodes) on %s in %s", variant,
                    len(model.layers), device, dtype_name)
    return app


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="interactive_vit_tpu_torch server (PyTorch + CUDA)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--models", default="vit_t16",
                        help="comma-separated model variants to register "
                             "(plain ViTs and swin_t/s/b)")
    parser.add_argument("--dtype", default="float32", choices=sorted(DTYPES),
                        help="weight and activation dtype; int8 = weight-"
                             "only int8 weights, int8w8a8 = W8A8 fc1/fc2 "
                             "(both over bfloat16 activations)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on, e.g. cuda, cuda:1 "
                             "or cpu")
    parser.add_argument("--attn", default="auto", choices=ATTN_CHOICES,
                        help="attention of blocks on the unfused path "
                             "(LayerScale models such as DINOv2): auto = "
                             "the flash kernel on CUDA for N >= 256; "
                             "int8-scores = the s8 mode of the fused block "
                             "(plain-ViT models)")
    parser.add_argument("--graphs-dir", default=None,
                        help="saved-graph library; a variant's chain graph "
                             "is generated into it when missing (default: "
                             "static/graphs, read only)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weight init")
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--max-wait-ms", type=float, default=3.0)
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    app = build_app(
        models=[m for m in args.models.split(",") if m],
        graphs_dir=args.graphs_dir,
        dtype_name=args.dtype,
        device=args.device,
        seed=args.seed,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        attn_impl_name=args.attn,
    )
    app.serve(args.host, args.port)


if __name__ == "__main__":
    main()
