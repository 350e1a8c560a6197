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

Weights are a seeded random init; checkpoint loading, plugin scanning,
multi-device serving and the other families are not ported yet.
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

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    ``attn_impl_name``: the attention policy of blocks on the unfused path
    (``ops/dispatch.default_attn_impl``)."""
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
    dtype = DTYPES[dtype_name]
    for variant in models:
        model = make_model(variant, seed=seed, dtype=dtype, device=device,
                           attn_impl=attn_impl)
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
                        help="weight and activation dtype")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on, e.g. cuda, cuda:1 "
                             "or cpu")
    parser.add_argument("--attn", default="auto",
                        choices=["auto", "flash", "reference"],
                        help="attention of blocks on the unfused path "
                             "(LayerScale models such as DINOv2): auto = "
                             "the flash kernel on CUDA for N >= 256")
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
