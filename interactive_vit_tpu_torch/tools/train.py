"""The trainer: ViT training on one device.

    python -m interactive_vit_tpu_torch.tools.train \
        --variant vit_b16 --dtype mixed --attn auto --batch 64 --steps 100

Counterpart of ``interactive_vit_tpu/tools/train.py`` on one card (or the
CPU with ``--device cpu``). Data is synthetic: class-conditional Gaussian
blobs, or with ``--memorize N`` a fixed set of N patterned images (the
end-to-end accuracy oracle), kept on the device and gathered by index each
step. The step is ``parallel/train.py``'s: AdamW as optax's chain
(warmup + cosine, global-norm clipping, layer-wise LR decay), per-block
rematerialisation, mixed precision, gradient accumulation, and on a card
the hand-written attention kernels (``--attn auto``): the packed kernel
for an even head count of width 64 (vit_b16), the [B, H, N, dh] one
otherwise (vit_t16). Not ported: the device mesh, checkpoints and resume,
``--init``, the data loader and augmentation, distillation and the
safetensors export; the parser refuses their flags.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)


def synthetic_batch(rng, batch: int, img: int, classes: int):
    """Class-conditional Gaussian images (numpy, [B, 3, img, img]) and
    their int labels."""
    labels = rng.integers(0, classes, size=(batch,))
    means = (labels[:, None, None, None] / classes).astype(np.float32)
    images = (rng.normal(size=(batch, 3, img, img)).astype(np.float32) * 0.3
              + means)
    return images, labels


def pattern_set(seed: int, n: int, img: int, classes: int,
                distinct: int = 64):
    """A fixed labelled set of class-conditional sinusoid gratings with a
    little noise (the memorisation oracle's data): labels span
    ``min(classes, distinct)`` classes. The JAX package's, from the same
    numpy generator."""
    rng = np.random.default_rng(seed)
    distinct = min(classes, distinct)
    labels = np.concatenate([np.arange(distinct),
                             rng.integers(0, distinct,
                                          size=(max(0, n - distinct),))])[:n]
    yy, xx = np.meshgrid(np.arange(img), np.arange(img), indexing="ij")
    images = np.empty((n, 3, img, img), np.float32)
    for i, lab in enumerate(labels):
        lab = int(lab)
        fx = 1 + (lab * 7) % 13
        fy = 1 + (lab * 11) % 13
        base = (np.sin(2 * np.pi * fx * xx / img + lab)
                * np.cos(2 * np.pi * fy * yy / img))
        chan = 0.5 + 0.5 * np.eye(3, dtype=np.float32)[lab % 3]
        images[i] = base[None] * chan[:, None, None]
        images[i] += rng.normal(size=(3, img, img)).astype(np.float32) * 0.05
    return images, labels.astype(np.int64)


def evaluate(infer_fn, params, images, labels, batch: int) -> float:
    """Top-1 over a set, in chunks of the training batch size."""
    from interactive_vit_tpu_torch.tools.evaluate import run_eval

    def chunks():
        for lo in range(0, len(labels), batch):
            yield images[lo:lo + batch], labels[lo:lo + batch]

    n, hits1, _ = run_eval(infer_fn, params, chunks(), batch, top_k=1)
    return hits1 / n


def make_ema_update(decay: float):
    """``ema = decay * ema + (1 - decay) * params`` on f32 EMA leaves (a
    bf16 average cannot hold the increment: bf16(0.9999) == 1)."""
    from interactive_vit_tpu_torch.parallel.train import (
        tree_leaves, tree_unflatten,
    )

    def update(ema, params):
        e = tree_leaves(ema)
        p = [x.to(y.dtype) for x, y in zip(tree_leaves(params), e)]
        return tree_unflatten(ema, torch._foreach_add(
            torch._foreach_mul(e, decay), torch._foreach_mul(p, 1.0 - decay)))

    return update


def _seed_ema(params):
    """A fresh f32 EMA tree from params (always a copy)."""
    from interactive_vit_tpu_torch.parallel.train import tree_map_with_path

    return tree_map_with_path(
        lambda _, p: p.to(torch.float32, copy=True)
        if p.is_floating_point() else p.clone(), params)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--variant", default="vit_t16",
                        help="a plain ViT variant, with an optional "
                             "@<pixels>p<patch> geometry (vit_b16@384)")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--warmup", type=int, default=0,
                        help="warmup steps (with cosine decay to --steps)")
    parser.add_argument("--clip-norm", type=float, default=0.0,
                        help="global-norm gradient clipping (0 = off)")
    parser.add_argument("--llrd", type=float, default=0.0,
                        help="layer-wise LR decay: block j of L at "
                             "lr*llrd^(L-j), the embedding tier at "
                             "lr*llrd^(L+1), head and final norm at lr "
                             "(0 = uniform)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--remat", default="auto",
                        choices=["auto", "on", "off", "dots"],
                        help="per-block rematerialisation; auto keeps it "
                             "off while the backward's activations fit "
                             "the device's memory; dots keeps the matmul "
                             "outputs and recomputes the elementwise ops")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16", "mixed"],
                        help="float32; bfloat16 = bf16 params and compute; "
                             "mixed = f32 master params, bf16 forward and "
                             "backward")
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation over k microbatches "
                             "(one optimizer update, f32 sums)")
    parser.add_argument("--attn", default="auto",
                        choices=["auto", "reference", "flash_vjp"],
                        help="train-step attention "
                             "(ops.dispatch.default_train_attn_impl)")
    parser.add_argument("--eval-every", type=int, default=0,
                        help="top-1 on a held-out synthetic batch (the "
                             "memorize set with --memorize) every N steps")
    parser.add_argument("--memorize", type=int, default=0,
                        help="train on a fixed set of N patterned images "
                             "instead of streaming synthetic batches")
    parser.add_argument("--distinct-classes", type=int, default=64,
                        help="distinct labels in the --memorize set")
    parser.add_argument("--label-smoothing", type=float, default=0.0)
    parser.add_argument("--ema-decay", type=float, default=0.0,
                        help="keep an f32 exponential moving average of the "
                             "params; evals use it (0 = off)")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    args = parser.parse_args(argv)
    if args.accum_steps > 1 and args.batch % args.accum_steps:
        parser.error("--batch must be divisible by --accum-steps")
    return args


def resolve_cfg(variant: str):
    """The plain ViT family only (``@`` geometries included)."""
    from interactive_vit_tpu_torch.models import vit

    if variant.partition("@")[0] not in vit.VARIANTS:
        raise ValueError(
            f"--variant {variant!r}: the port trains the plain ViT family "
            f"only (one of {sorted(vit.VARIANTS)}, optionally @<geometry>)")
    return vit.resolve_variant(variant)


def main(argv=None) -> dict:
    """Train; returns what the run saw: ``history`` [(step, loss, seconds
    since the first step began)] at the logged steps (the clock is read
    after the loss reached the host), ``evals`` [(step, top-1)],
    ``remat``, ``head_major``, ``attn`` and the final ``params`` in the
    canonical qkv layout."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from interactive_vit_tpu_torch.ops.dispatch import default_train_attn_impl
    from interactive_vit_tpu_torch.parallel import mesh as mesh_lib
    from interactive_vit_tpu_torch.parallel import train as train_lib
    from interactive_vit_tpu_torch.runtime.device import require_device

    device = require_device(args.device)
    cfg = resolve_cfg(args.variant)
    optimizer = train_lib.make_optimizer(
        args.lr, warmup_steps=args.warmup,
        total_steps=args.steps if args.warmup else 0,
        clip_norm=args.clip_norm, llrd=args.llrd)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    compute_dtype = torch.bfloat16 if args.dtype == "mixed" else None
    run_dtype = compute_dtype or dtype or torch.float32
    attn_impl = default_train_attn_impl(args.attn, dtype=run_dtype, cfg=cfg,
                                        device=device)
    logger.info("train attention: %s", "kernels (attention_vjp)"
                if attn_impl is not None else "plain (autograd)")
    if args.remat == "auto":
        remat = train_lib.auto_remat(
            cfg, max(1, args.batch // args.accum_steps), dtype=run_dtype,
            flash_attn=attn_impl is not None, device=device)
        logger.info("remat auto -> %s", "on" if remat else "off")
    else:
        remat = {"on": True, "off": False, "dots": "dots"}[args.remat]

    params, opt_state, step_fn, infer_fn = train_lib.setup(
        cfg, device=device, seed=args.seed, lr=args.lr, remat=remat,
        optimizer=optimizer, dtype=dtype, attn_impl=attn_impl,
        accum_steps=args.accum_steps, label_smoothing=args.label_smoothing,
        compute_dtype=compute_dtype)
    head_major = train_lib.wants_head_major(cfg, attn_impl)
    ema_update = make_ema_update(args.ema_decay) if args.ema_decay else None
    ema = _seed_ema(params) if args.ema_decay else None

    rng = np.random.default_rng(args.seed)
    if args.memorize:
        eval_images, eval_labels = pattern_set(
            args.seed, args.memorize, cfg.img_size, cfg.num_classes,
            args.distinct_classes)
        # the set lives on the device; a step gathers its batch by index
        mem_images = torch.from_numpy(eval_images).to(device)
        mem_labels = torch.from_numpy(eval_labels).to(device)
    else:
        eval_images, eval_labels = synthetic_batch(
            np.random.default_rng(10_007), args.batch, cfg.img_size,
            cfg.num_classes)

    history, evals = [], []
    t0 = time.perf_counter()
    for step in range(args.steps):
        if args.memorize:
            idx = torch.from_numpy(
                rng.integers(0, args.memorize, size=(args.batch,))).to(device)
            images, labels = mem_images[idx], mem_labels[idx]
        else:
            images, labels = synthetic_batch(rng, args.batch, cfg.img_size,
                                             cfg.num_classes)
            images = torch.from_numpy(images).to(device)
            labels = torch.from_numpy(labels).to(device)
        params, opt_state, loss = step_fn(params, opt_state, images, labels)
        if ema_update is not None:
            ema = ema_update(ema, params)
        if step % args.log_every == 0 or step == args.steps - 1:
            value = float(loss)
            dt = time.perf_counter() - t0
            history.append((step, value, dt))
            logger.info("step %4d  loss %.4f  (%.1f imgs/s)", step, value,
                        (step + 1) * args.batch / dt)
        if args.eval_every and (step + 1) % args.eval_every == 0:
            acc = evaluate(infer_fn, ema if ema is not None else params,
                           eval_images, eval_labels, args.batch)
            evals.append((step, acc))
            logger.info("step %4d  %seval top-1 %.3f", step,
                        "EMA " if ema is not None else "", acc)

    final = ema if ema is not None else params
    if head_major:
        final = mesh_lib.unpermute_qkv_head_major(final, cfg.heads)
    return {"history": history, "evals": evals, "remat": remat,
            "head_major": head_major,
            "attn": None if attn_impl is None else attn_impl.__name__,
            "params": final}


if __name__ == "__main__":
    main()
