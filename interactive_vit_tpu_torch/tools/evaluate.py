"""Evaluation: batched top-1 / top-k accuracy over a dataset, on the card.

    python -m interactive_vit_tpu_torch.tools.evaluate --variant vit_t16 \
        --ckpt ckpts/oracle.safetensors --memorize 64 --batch 32
    python -m interactive_vit_tpu_torch.tools.evaluate --variant vit_b16 \
        --ckpt b16.safetensors --data shards/val --batch 64

Counterpart of ``interactive_vit_tpu/tools/evaluate.py`` (``ivt-eval``) on
one card (or the CPU with ``--device cpu``). Data comes from the sources
the trainer reads: ``--data PREFIX`` (``{PREFIX}_images.npy`` /
``_labels.npy``, read mmapped in file order, so every sample counts once,
the tail included; the trainer's shuffling loader yields full batches
only), or ``--memorize N`` (the patterned oracle set). Images go to the
trunk at model resolution; a short last chunk is padded by repetition to
the batch size. Prints one JSON line:

    {"variant": ..., "n": N, "top1": ..., "top5": ..., "wall_s": ...,
     "imgs_per_s": ...}

Not ported: ``--mesh`` (one device) and ``--platform`` (``--device``).
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)


def run_eval(infer, params, batches, batch: int, top_k: int = 5):
    """Stream (images, labels) chunks through ``infer(params, images) ->
    logits``. A short final chunk is padded to ``batch`` rows by repeating
    its first image, so every call sees the training batch size. Returns
    (n, top1_hits, topk_hits)."""
    n = hits1 = hitsk = 0
    for images, labels in batches:
        k = len(labels)
        images = np.asarray(images)
        if k < batch:
            pad = np.repeat(images[:1], batch - k, axis=0)
            images = np.concatenate([images, pad])
        logits = infer(params, images)
        if isinstance(logits, torch.Tensor):
            logits = logits.float().cpu().numpy()
        logits = np.asarray(logits)[:k]
        labels = np.asarray(labels)[:k]
        order = np.argsort(-logits, axis=-1)
        hits1 += int((order[:, 0] == labels).sum())
        hitsk += int((order[:, :top_k] == labels[:, None]).any(-1).sum())
        n += k
    return n, hits1, hitsk


class _Cfg:
    """The geometry of the convolutional families (no config object)."""

    img_size, num_classes = 224, 1000


def make_logits_fn(variant: str):
    """``(forward(params, images) -> logits, cfg, init_fn(generator,
    device))`` for every classification family the port has: the plain ViT
    (``@`` geometries too), swin_*, vit_moe_*, *_tome, convnext_*, resnet50
    and vgg16 (whose forward includes its transform). Feature extractors
    (``num_classes=0``) raise: top-k needs a classifier head."""
    from interactive_vit_tpu_torch.models import vit

    base = variant.partition("@")[0]
    if base in vit.VARIANTS:
        cfg = vit.resolve_variant(variant)
        if cfg.num_classes == 0:
            raise ValueError(
                f"{variant} is a feature extractor (num_classes=0); "
                f"top-k accuracy needs a classifier head")
        return (lambda p, x: vit.forward(p, x, cfg)["logits"], cfg,
                lambda g, dev: vit.init_params(cfg, g, device=dev))
    if "@" in variant:
        raise ValueError(
            f"{variant!r}: the @[<pixels>][p<patch>] suffix is supported "
            f"only for the plain-ViT family (vit_*/dino_*/deit_*)")
    if base.startswith("swin_"):
        from interactive_vit_tpu_torch.models import swin as fam
    elif base.startswith("vit_moe"):
        from interactive_vit_tpu_torch.models import moe as fam
    elif "_tome" in base or base.startswith("tome"):
        from interactive_vit_tpu_torch.models import tome as fam
    elif base.startswith("convnext_"):
        from interactive_vit_tpu_torch.models import convnext

        cfg = convnext.VARIANTS[variant]
        return (lambda p, x: convnext.forward(p, x, cfg), cfg,
                lambda g, dev: convnext.init_params(cfg, g, device=dev))
    elif base in ("resnet50", "vgg16"):
        from interactive_vit_tpu_torch.models import resnet, vgg

        mod = resnet if base == "resnet50" else vgg
        return (mod.forward, _Cfg,
                lambda g, dev: mod.init_params(g, device=dev))
    else:
        raise ValueError(
            f"no evaluation path for {variant!r} (classification families: "
            f"vit/deit (@res ok), swin_*, vit_moe_*, *_tome, convnext_*, "
            f"resnet50, vgg16)")
    cfg = fam.VARIANTS[variant]
    return (lambda p, x: fam.forward(p, x, cfg)["logits"], cfg,
            lambda g, dev: fam.init_params(cfg, g, device=dev))


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--variant", default="vit_t16")
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint directory / .safetensors / .pth "
                             "(layout auto-detected; random init when "
                             "absent — a smoke run, not a measurement)")
    parser.add_argument("--ckpt-layout", default="auto")
    parser.add_argument("--data", default=None, metavar="PREFIX",
                        help="evaluate {PREFIX}_images.npy/_labels.npy "
                             "(the trainer's format; mmapped, file order, "
                             "every sample once)")
    parser.add_argument("--memorize", type=int, default=0,
                        help="evaluate on the N-image patterned oracle "
                             "set (the trainer's --memorize set)")
    parser.add_argument("--distinct-classes", type=int, default=64)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--limit", type=int, default=0,
                        help="stop after N samples (0 = the whole set)")
    parser.add_argument("--top-k", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    args = parser.parse_args(argv)
    if bool(args.data) == bool(args.memorize):
        parser.error("exactly one of --data / --memorize is required")
    return args


def main(argv=None) -> dict:
    """Evaluate; prints the JSON line and returns it as a dict."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from interactive_vit_tpu_torch.models import vit
    from interactive_vit_tpu_torch.parallel.train import (
        tree_leaves, tree_unflatten,
    )
    from interactive_vit_tpu_torch.runtime.device import (
        exact_f32_matmuls, require_device,
    )

    device = require_device(args.device)
    exact_f32_matmuls()
    infer_raw, cfg, init_fn = make_logits_fn(args.variant)
    if args.ckpt:
        from interactive_vit_tpu_torch.serving.server import (
            load_model_params,
        )

        params = load_model_params(args.variant, args.ckpt,
                                   args.ckpt_layout, device=device)
        if args.variant.partition("@")[0] in vit.VARIANTS:
            # @ geometries: directories and native files skip the
            # converter, so adapt here (identity at the native geometry)
            params = vit.adapt_checkpoint(params, cfg)
        logger.info("loaded %s weights from %s", args.variant, args.ckpt)
    else:
        params = init_fn(torch.Generator().manual_seed(args.seed), device)
        logger.warning("no --ckpt: evaluating RANDOM-INIT weights")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    params = tree_unflatten(params, [
        t.to(device=device, dtype=dtype) if t.is_floating_point()
        else t.to(device) for t in tree_leaves(params)])

    def infer(p, images):
        with torch.inference_mode():
            # a copy: an mmapped chunk is read-only
            x = torch.from_numpy(np.array(images)).to(device)
            return infer_raw(p, x.to(dtype))

    if args.memorize:
        from interactive_vit_tpu_torch.tools.train import pattern_set

        images, labels = pattern_set(
            args.seed, args.memorize, cfg.img_size, cfg.num_classes,
            args.distinct_classes)
    else:
        # mmapped, in file order: every sample exactly once (the trainer's
        # loader shuffles and drops the n % batch tail)
        images = np.load(args.data + "_images.npy", mmap_mode="r")
        labels = np.load(args.data + "_labels.npy", mmap_mode="r")
        if len(labels) != len(images):
            raise SystemExit(
                f"--data: {len(images)} images vs {len(labels)} labels")
    if args.limit:
        images, labels = images[:args.limit], labels[:args.limit]

    def chunked():
        for lo in range(0, len(labels), args.batch):
            yield images[lo:lo + args.batch], labels[lo:lo + args.batch]

    t0 = time.perf_counter()
    n, h1, hk = run_eval(infer, params, chunked(), args.batch, args.top_k)
    wall = time.perf_counter() - t0
    out = {"variant": args.variant, "n": n,
           "top1": round(h1 / max(1, n), 4),
           f"top{args.top_k}": round(hk / max(1, n), 4),
           "wall_s": round(wall, 2),
           "imgs_per_s": round(n / wall, 1)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
