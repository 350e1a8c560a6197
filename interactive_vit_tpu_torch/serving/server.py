"""Server entry point: ``python -m interactive_vit_tpu_torch.serving.server``.

Counterpart of ``interactive_vit_tpu/serving/server.py``: register the
built-in node kinds and the requested model variants (plain ViTs, Swin,
ToMe, CLIP, VGG16, ResNet-50, ConvNeXt, the MoE ViT and MAE, through
``models/autoregister``), then serve. With
``--graphs-dir``, a variant's chained graph JSON is written into that
library when it lacks one; the repository's own ``static/graphs`` (the
default) is only read. Example, on one CUDA card:

    python -m interactive_vit_tpu_torch.serving.server --models vit_b16 \\
        --dtype bfloat16 --port 8965

``--models vit_l16`` (384 px, 577 tokens) serves through the headwise
block kernel, ``--models dinov2_s14_reg`` (518 px, 1374 tokens) through the
flash attention kernel (``--attn``), ``--models swin_t`` through the fused
window attention kernel in all 12 blocks (``--models swin_t,vit_b16``
serves both). ``--models vit_b16_tome`` (token merging, r=8: 197 tokens
entering the first block, 109 the last) serves the repository's saved graph
through the fused block kernel with ToMe's key bias and key metric in all
12 blocks (``vit_b16_tome16`` and ``vit_s16_tome`` too; under ``--attn
int8-scores`` they keep that kernel while the plain ViTs beside them take
the s8 block, as in the JAX server):

    python -m interactive_vit_tpu_torch.serving.server \\
        --models vit_b16_tome --dtype bfloat16 --port 8965

A plain-ViT name takes an ``@[<pixels>][p<patch>]`` suffix:
``--models dinov2_s14_reg@742`` (a 53 x 53 grid, 2814 tokens) serves
through the online-softmax flash kernel, ``--models vit_t16@256`` through
the fused block kernel (the repository has its saved graph).

``--models clip_b32,clip_text_b32,vgg16`` serves CLIP ViT-B/32's image
tower (the fused block kernel in all 12 blocks at N=50, ending in an
L2-normalised embedding node), its text tower (the prompts of the embed
node tokenized on the host; causal attention on the plain path) and the
reference's VGG16 (cuDNN convolutions, no kernel of this package); with
both CLIP towers and ``--graphs-dir`` the server writes
``clip_zeroshot.json`` (the towers joined at a ``similarity`` node) where
the library lacks it:

    python -m interactive_vit_tpu_torch.serving.server \
        --models clip_b32,clip_text_b32,vgg16 --dtype bfloat16 --port 8965

``--models resnet50,convnext_t,vit_moe_s16,mae_t16`` serves the
repository's saved graphs of the last four families: ResNet-50 and
ConvNeXt-T on cuDNN convolutions (no kernel of this package), the MoE ViT
(8 experts in every odd block, routed per image; under ``--attn flash``
every block's attention runs the row-resident flash kernel, under
``auto`` the plain path at its 197 tokens) and MAE (a seed edit of
``reconstruct`` redraws the mask on the device and replays the captured
program; a ``mask_ratio`` edit captures anew):

    python -m interactive_vit_tpu_torch.serving.server \
        --models resnet50,convnext_t,vit_moe_s16,mae_t16 --attn flash

``--dtype int8`` serves weight-only int8 (qkv, proj, fc1, fc2) over bf16
activations on the unfused path; ``--dtype int8w8a8`` quantizes fc1 and
fc2 as W8A8 and runs the W8A8 MLP kernel beside the block kernel, which
``--attn int8-scores`` switches to its s8 mode (plain-ViT models only;
refused with ``--dtype int8``):

    python -m interactive_vit_tpu_torch.serving.server --models vit_b16 \
        --dtype int8w8a8 --attn int8-scores --port 8965

Swin takes both modes: ``--dtype int8w8a8`` keeps the window kernel in
every block and runs the W8A8 MLP kernel in each stage (swin_t: 12 of
each a request), ``--dtype int8`` the unfused path with int8 block
weights and no kernel:

    python -m interactive_vit_tpu_torch.serving.server --models swin_t \
        --dtype int8w8a8

Concurrent requests that share a graph signature run as one batched pass
through the kernels (``--max-batch``, default 8; ``--max-wait-ms``, the
window a group collects in), with ``--pipeline-depth`` groups in flight
(default 1; 0 runs each group to its end before the next). Each program
signature (graph, input shape, taps, and a group's power-of-two bucket) is
captured once into a CUDA graph and replayed after (``Executor``'s
compiled path). ``--warmup`` runs each model's saved graph once at batch 1
and once at ``--max-batch`` before serving, so that the kernels' nvcc
builds and the captures of those two buckets happen before the first
request:

    python -m interactive_vit_tpu_torch.serving.server --models vit_b16 \\
        --dtype bfloat16 --max-batch 8 --pipeline-depth 1 --warmup

A classifier's saved ``<variant>_saliency.json`` (the chain with
``saliency``, ``dream`` and ``occlusion`` off its head and, for a plain
ViT, ``<variant>:attrib`` off its embed node) serves the gradient kinds;
with ``--graphs-dir`` the server writes that graph where the library lacks
it, as the JAX server does. The server turns TF32 off first: the f32 paths
and the gradient twins hold the 1e-4 contract only on exact f32 matmuls.

``--plugin-dirs`` registers the node kinds of port plugin files (files
that import JAX are skipped), ``--frontend-dir`` serves another frontend,
``--compute-timeout-s`` bounds a /compute (503 past it).

Weights are a seeded random init (``--seed``) unless ``--ckpt MODEL=PATH``
(repeatable) names a checkpoint: a ``.safetensors`` file, a torch ``.pth``
(``tools/convert.py``'s converters; ``--ckpt-layout`` names the state
dict's naming, "auto" sniffs it) or a checkpoint directory of this package
(``tools/convert.py --output``, the trainer's ``--output``). The weights
load as f32, are cast to the serving dtype and then quantized (``--dtype
int8`` / ``int8w8a8``). An orbax directory of the JAX package is refused;
the JAX trainer's ``--export-safetensors`` file serves:

    python -m interactive_vit_tpu_torch.serving.server --models vit_b16 \
        --ckpt vit_b16=vit_b_16.safetensors --ckpt-layout torchvision

``--from-export DIR[,DIR]`` serves exported artifacts
(``tools/export_graph.py``) instead of live models, through
``serving/export_app.py``: no registry, no model code, no plugin, and the
same endpoints; ``--export-selftest`` replays each artifact's seeded
inputs against its recorded statistics first and refuses to boot on a
failure. TF32 is off on this route too:

    python -m interactive_vit_tpu_torch.serving.server \
        --from-export /tmp/vit_b16_art --export-selftest --port 8965

``--mesh`` serves on a device mesh, one process a device under
``torchrun`` (``parallel/mesh.py``; the spec's product must be the number
of ranks launched). Rank 0 serves HTTP; every other rank follows its
executor calls (``serving/mesh_link.py``). The kernel rule is the train
steps' (``ops/dispatch.mesh_serving_options``): where the model axis is 1
every rank holds whole weights and serves as one device does, kernels
included (a stacked group's rows spread over "data"; "stage" folds the
block chain into a pipeline); where it is above 1 the weights are
DTensors, so the models are made with ``kernels=False``, the plain ViTs
with their qkv head-major, and the attention is "reference", as the JAX
server forces. One card runs a one-rank mesh (NCCL takes no two ranks on
one card); four ranks of gloo run the multi-rank mesh on the CPU:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m interactive_vit_tpu_torch.serving.server --models vit_b16 \
        --mesh data=2,model=2 --device cpu --port 8965

Not ported yet: tap speculation and the warm inventory
(``--speculate-buckets``, ``--no-speculate``, ``--warm-inventory``,
``--warm-budget-s``; ``ROADMAP.md`` queue 1 item 9); the TPU-host flags
(``--platform``, ``--jit-cache``, ``--recycle-*``) have no counterpart.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from interactive_vit_tpu_torch.graph.registry import Registry, scan_plugins
from interactive_vit_tpu_torch.models.autoregister import (
    make_model, plain_vit_family,
)
from interactive_vit_tpu_torch.models.clip_text_plugin import (
    generate_zeroshot_graph_json,
)
from interactive_vit_tpu_torch.ops.dispatch import (
    default_attn_impl, mesh_serving_options,
)
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.parallel import mesh as mesh_lib
from interactive_vit_tpu_torch.parallel.train import cast_params
from interactive_vit_tpu_torch.runtime.device import (
    exact_f32_matmuls, require_device,
)
from interactive_vit_tpu_torch.serving.app import App
from interactive_vit_tpu_torch.wire.schema import graph_from_json

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


def load_model_params(variant: str, path: str, layout: str = "auto",
                      device="cuda"):
    """Real weights for ``variant`` from a checkpoint directory of this
    package (``utils/checkpoint.py``), a ``.safetensors`` file or a torch
    ``.pth`` (the files through ``tools/convert.convert`` in ``layout``),
    as f32 tensors on ``device`` (a directory's leaves keep their saved
    dtypes). An orbax directory raises ``ValueError``."""
    if os.path.isdir(path):
        from interactive_vit_tpu_torch.utils.checkpoint import load_params

        return load_params(path, device=device)
    from interactive_vit_tpu_torch.tools.convert import (
        convert, load_state_dict,
    )

    return convert(variant, layout, load_state_dict(path), device=device)


def build_app(
    models=("vit_t16",),
    graphs_dir: str = None,
    dtype_name: str = "float32",
    device="cuda",
    seed: int = 0,
    max_batch: int = 8,
    max_wait_ms: float = 3.0,
    attn_impl_name: str = "auto",
    frontend_dir: str = None,
    plugin_dirs=(),
    compute_timeout_s: float = 120.0,
    pipeline_depth: int = 1,
    ckpts=None,
    ckpt_layout: str = "auto",
    mesh_spec: str = "",
) -> App:
    """An ``App`` with its own registry serving ``models`` on ``device``
    (the card unless the caller asks for the CPU; raises without a card).
    ``dtype_name``: a ``DTYPES`` key. ``attn_impl_name``: the attention
    policy of blocks on the unfused path (``ops/dispatch.
    default_attn_impl``), or "int8-scores": the s8 mode of the fused block
    for plain-ViT models (the others keep "auto"), refused with the
    weight-only "int8" dtype, as in the JAX server. ``plugin_dirs``: each
    scanned for node-kind plugins (``graph/registry.scan_plugins``).
    ``frontend_dir``: default the repository's ``frontend``. ``ckpts``:
    {variant: checkpoint path} (``load_model_params``, ``ckpt_layout`` for
    files); the others take the seeded random init. A key of ``ckpts``
    that is not served raises, as in the JAX server. ``mesh_spec``
    (``--mesh``, ``parallel/mesh.parse_mesh``'s grammar): serve on the mesh
    of this ``torchrun`` launch (``make_serving_mesh``), each rank on its
    own device, the models made by the mesh's kernel rule (the module
    docstring); on every rank but 0 the app is a follower (``App.follow``
    instead of ``serve``)."""
    exact_f32_matmuls()
    ckpts = dict(ckpts or {})
    unused = set(ckpts) - set(models)
    if unused:
        # a mistyped --ckpt key would otherwise serve random weights with
        # no hint
        raise ValueError(
            f"--ckpt given for models not being served: {sorted(unused)} "
            f"(serving {sorted(models)})")
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
    mesh, mesh_opts = None, {}
    if mesh_spec:
        mesh, device = make_serving_mesh(mesh_spec, device)
        mesh_opts = mesh_serving_options(mesh_lib.axis_size(mesh, "model"))
        attn_impl_name = mesh_opts.get("attn", attn_impl_name)
        logger.info("serving on mesh %s, this rank %d on %s (kernel rule: "
                    "%s)", mesh_lib.mesh_shape(mesh), dist.get_rank(),
                    device, mesh_opts or "the one-device models")
    attn_impl = default_attn_impl(attn_impl_name)
    reg = Registry()
    register_builtin(reg)
    for d in plugin_dirs:
        scan_plugins([d], reg)
    repo_lib = graphs_dir is None
    graphs_dir = graphs_dir or os.path.join(_REPO_ROOT, "static", "graphs")
    frontend_dir = frontend_dir or os.path.join(_REPO_ROOT, "frontend")
    app = App(
        reg=reg,
        graphs_dir=graphs_dir,
        frontend_dir=frontend_dir if os.path.isdir(frontend_dir) else None,
        device=device,
        max_batch=max_batch,
        max_wait_ms=max_wait_ms,
        compute_timeout_s=compute_timeout_s,
        pipeline_depth=pipeline_depth,
        mesh=mesh,
    )
    writes = not repo_lib and not app.follower
    for variant in models:
        # the s8 mode exists for the plain-ViT block only; the other
        # families take their own auto dispatch, as in the JAX server
        bk = block_kernel if plain_vit_family(variant) else "auto"
        params = None
        if variant in ckpts:
            t0 = time.perf_counter()
            # f32 from the file, the serving dtype here, quantization in
            # make_model
            params = cast_params(load_model_params(
                variant, ckpts[variant], ckpt_layout, device), dtype)
            logger.info("loaded %s weights from %s in %.2f s", variant,
                        ckpts[variant], time.perf_counter() - t0)
        model = make_model(variant, params=params, seed=seed, dtype=dtype,
                           device=device, attn_impl=attn_impl,
                           quantize=quantize, block_kernel=bk,
                           kernels=mesh_opts.get("kernels", True),
                           tp_layout=mesh_opts.get("tp_layout", False))
        # the repository's library is never written (a variant without a
        # saved graph there gets none), and on a mesh only rank 0 writes
        model.register(reg, app.graphs if writes else None)
        logger.info("registered model %s (%d nodes) on %s in %s", variant,
                    len(model.layers), device, dtype_name)
        # classifier chains also get the gradient-tap demo graph
        # (saliency, dream and occlusion off the head; attrib off embed)
        sal_name = f"{variant}_saliency.json"
        if (writes
                and any(n.endswith(":head") for n in model.list_node_names())
                and not app.graphs.exists(sal_name)):
            app.graphs.save(sal_name, model.generate_saliency_graph_json())
            logger.info("generated graph %s", sal_name)
    if (writes and {"clip_b32", "clip_text_b32"} <= set(models)
            and not app.graphs.exists("clip_zeroshot.json")):
        # both CLIP towers served: the zero-shot graph (the image chain and
        # the prompt chain joined at a similarity node)
        app.graphs.save("clip_zeroshot.json", generate_zeroshot_graph_json())
        logger.info("generated graph clip_zeroshot.json")
    return app


def make_serving_mesh(spec: str, device):
    """``--mesh``: (the mesh, this rank's device). Joins the process group
    of this ``torchrun`` launch (``mesh.init_distributed``) and builds the
    mesh of ``mesh.parse_mesh(spec)``; raises where there is no launch or
    the spec's product is not the number of ranks launched."""
    sizes = mesh_lib.parse_mesh(spec)
    device = mesh_lib.init_distributed(device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"--mesh {spec!r} serves one process a device: launch the "
            f"server under torchrun (python -m torch.distributed.run "
            f"--nproc-per-node N -m interactive_vit_tpu_torch.serving."
            f"server ...)")
    world = dist.get_world_size()
    need = math.prod(sizes.values()) if sizes else world
    if need != world:
        raise ValueError(
            f"--mesh {spec!r} needs {need} ranks, but {world} were launched "
            f"(torchrun --nproc-per-node {need})")
    return mesh_lib.make_mesh(sizes), device


def warmup(app: App, models, batch_sizes=(1,)) -> None:
    """Run each model's saved graph once per batch size (1: ``run``; K: a
    group of K through ``run_stacked``, its bucket's program) on a 224 x
    224 input with the primary taps, so that the kernels' builds and, on a
    card, the captures of those programs happen before the first request
    (requests of that signature then replay). A model without a saved
    graph is skipped."""
    for variant in models:
        try:
            obj = app.graphs.load(variant + ".json")
        except FileNotFoundError:
            logger.info("no saved graph for %s: not warmed", variant)
            continue
        for bs in batch_sizes:
            graphs = []
            for _ in range(bs):
                g = graph_from_json(obj)
                g.add_input(np.zeros((3, 224, 224), np.float32),
                            g.nodes[0], "o")
                graphs.append(g)
            t0 = time.perf_counter()
            if bs == 1:
                app.executor.run(graphs[0], taps="primary")
            else:
                app.executor.run_stacked(graphs, taps="primary")
            logger.info("warmed %s batch=%d in %.1fs", variant, bs,
                        time.perf_counter() - t0)


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="interactive_vit_tpu_torch server (PyTorch + CUDA)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--models", default="vit_t16",
                        help="comma-separated model variants to register "
                             "(plain ViTs, swin_t/s/b, the *_tome variants, "
                             "clip_b32, clip_text_b32 and vgg16)")
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
    parser.add_argument("--frontend-dir", default=None,
                        help="frontend assets to serve (default: the "
                             "repository's frontend/)")
    parser.add_argument("--plugin-dirs", default="",
                        help="comma-separated directories of node-kind "
                             "plugins to register (files that import JAX "
                             "are skipped)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weight init (models "
                             "without --ckpt)")
    parser.add_argument("--ckpt", action="append", default=[],
                        metavar="MODEL=PATH",
                        help="serve MODEL with real weights from PATH (a "
                             "checkpoint directory of this package, a "
                             ".safetensors file, or a torch .pth); "
                             "repeatable")
    parser.add_argument("--ckpt-layout", default="auto",
                        choices=["auto", "torchvision", "timm", "openai"],
                        help="state-dict naming of file checkpoints "
                             "('auto' sniffs key prefixes)")
    parser.add_argument("--max-batch", type=int, default=8,
                        help="most requests of one graph signature run as "
                             "one batched pass")
    parser.add_argument("--max-wait-ms", type=float, default=3.0,
                        help="how long a group waits for more requests")
    parser.add_argument("--pipeline-depth", type=int, default=1,
                        help="dispatched groups in flight before the "
                             "oldest is materialized (1 overlaps a group's "
                             "copies to the host with the next group's "
                             "host pass and kernels; 0 = none)")
    parser.add_argument("--compute-timeout-s", type=float, default=120.0,
                        help="per-request /compute deadline; past it the "
                             "request gets 503")
    parser.add_argument("--warmup", action="store_true",
                        help="run each model's saved graph at batch 1 and "
                             "at --max-batch before serving (kernel builds "
                             "and allocator growth off the first request)")
    parser.add_argument("--from-export", default="", metavar="DIR",
                        help="serve exported artifact(s) (tools/"
                             "export_graph.py output; comma-separated) "
                             "instead of live models: no registry, no "
                             "model code, no plugin code "
                             "(serving/export_app.py)")
    parser.add_argument("--mesh", default="",
                        help="multi-device serving mesh, e.g. "
                             "'data=4,model=2' (add 'stage=N' for "
                             "pipeline-parallel serving of untapped block "
                             "chains), one process a device under torchrun "
                             "(the product must be the ranks launched; "
                             "'data=all' spreads every rank on data); "
                             "empty = single device")
    parser.add_argument("--export-selftest", action="store_true",
                        help="with --from-export: verify each artifact "
                             "(seeded replay against its recorded output "
                             "statistics) before serving; refuse to boot "
                             "on a failure")
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser


def build_export_app(dirs, frontend_dir=None, selftest: bool = False):
    """The ``--from-export`` app over the artifact directories ``dirs``
    (one: ``ExportApp``, more: ``MultiExportApp``), TF32 off. With
    ``selftest`` each artifact's selftest runs first and a failure raises
    ``SystemExit``: the server does not boot on a corrupt artifact."""
    from interactive_vit_tpu_torch.serving.export_app import (
        ExportApp, MultiExportApp,
    )

    exact_f32_matmuls()
    dirs = [d for d in dirs if d]
    if len(dirs) == 1:
        xapp = ExportApp(dirs[0], frontend_dir=frontend_dir)
    else:
        xapp = MultiExportApp(dirs, frontend_dir=frontend_dir)
    logger.info("artifact(s) %s loaded in %.2fs; serving with no model "
                "code", xapp.artifact_dir, xapp.boot_load_s)
    if selftest:
        for u in getattr(xapp, "units", [xapp]):
            res = u.art.selftest()
            logger.info("selftest %s: ok=%s (%d outputs, worst rel=%.2e)",
                        u.artifact_dir, res["ok"], res["checked"],
                        res["worst"]["rel"])
            if not res["ok"]:
                raise SystemExit(f"artifact {u.artifact_dir} failed "
                                 f"selftest: {res['worst']}")
    return xapp


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.from_export:
        build_export_app(args.from_export.split(","), args.frontend_dir,
                         args.export_selftest).serve(args.host, args.port)
        return
    models = [m for m in args.models.split(",") if m]
    app = build_app(
        models=models,
        graphs_dir=args.graphs_dir,
        dtype_name=args.dtype,
        device=args.device,
        seed=args.seed,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        attn_impl_name=args.attn,
        frontend_dir=args.frontend_dir,
        plugin_dirs=[d for d in args.plugin_dirs.split(",") if d],
        compute_timeout_s=args.compute_timeout_s,
        pipeline_depth=args.pipeline_depth,
        ckpts=dict(kv.split("=", 1) for kv in args.ckpt),
        ckpt_layout=args.ckpt_layout,
        mesh_spec=args.mesh,
    )
    if app.follower:
        logger.info("rank %d follows rank 0's executor calls",
                    dist.get_rank())
        app.follow()
        logger.info("rank %d stopped", dist.get_rank())
        dist.destroy_process_group()
        return
    try:
        if args.warmup:
            warmup(app, models,
                   batch_sizes=sorted({1, max(1, args.max_batch)}))
        app.serve(args.host, args.port)
    finally:
        app.close()
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
