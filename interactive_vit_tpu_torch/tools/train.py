"""The trainer: the ViT, MoE, Swin and ConvNeXt families and DeiT
distillation on one device, with train-state checkpoints and resume.

    python -m interactive_vit_tpu_torch.tools.train \
        --variant vit_b16 --dtype mixed --attn auto --batch 64 --steps 100 \
        --output ckpts/vit_b16 --save-every 50
    python -m interactive_vit_tpu_torch.tools.train --variant deit_b16 \
        --dtype mixed --distill-teacher vit_b16.safetensors \
        --teacher-variant vit_b16 --distill-tau 1

Counterpart of ``interactive_vit_tpu/tools/train.py`` on one card (or the
CPU with ``--device cpu``). ``--variant`` is a plain ViT (with an optional
``@`` geometry), ``vit_moe_s16``, ``swin_*`` or ``convnext_*``. Data is
synthetic (class-conditional Gaussian blobs), or with ``--memorize N`` a
fixed set of N patterned images (the end-to-end accuracy oracle), kept on
the device and gathered by index each step, or with ``--data PREFIX`` the
``{PREFIX}_images.npy`` / ``_labels.npy`` files of
``data/loader.save_dataset`` through the native prefetching loader
(``data/loader.py``: a seeded shuffle each epoch and a deterministic flip
per sample; the first batch is the train-stream eval sample, and
``--resume`` skips the batches the interrupted run had consumed, so the
resumed stream is the uninterrupted one). ``--hflip``, ``--crop-pad``,
``--color-jitter``, ``--cutout``, ``--mixup`` and ``--cutmix`` augment
each batch on the device (``data/augment.py``, deterministic per (seed,
step)). The step is ``parallel/train.py``'s: AdamW as optax's chain
(warmup + cosine, global-norm clipping, layer-wise LR decay), per-block
rematerialisation (``--no-remat`` is the deprecated ``--remat off``),
mixed precision, gradient accumulation, and on a card the hand-written
attention kernels (``--attn auto``): the packed kernel for an even head
count of width 64 (vit_b16, deit_b16, vit_moe_s16), the [B, H, N, dh] one
otherwise (vit_t16); Swin and ConvNeXt train through no kernel of the
port, as in the JAX package. The f32 matmuls and convolutions run with TF32
off (``runtime/device.exact_f32_matmuls``).

``--distill-teacher FILE --teacher-variant V`` trains a distilled student
(deit_*) against a frozen teacher of any trainable family, loaded through
``tools/convert.convert`` (``--distill-alpha``, ``--distill-tau``: 0 hard,
above 0 soft). The teacher runs the canonical qkv layout under
``no_grad`` and is in neither the optimizer state nor a checkpoint.

Checkpoints are directories of ``utils/checkpoint.py`` (the JAX trainer
writes orbax ones): ``--output D`` writes the export params to ``D/params``
(qkv columns in the canonical layout, the EMA cast to the param dtype with
``--ema-decay``) and the train state (params in the training layout,
optimizer state, step, the qkv-layout marker, the EMA) to ``D/state``;
``--save-every N`` also saves the state every N steps in the background;
``--resume`` continues from ``D/state``; ``--init FILE`` starts a fresh run
of a plain ViT from a checkpoint's trunk; ``--export-safetensors FILE``
writes the export params in the native "/" naming, which the server's
``--ckpt`` serves. Not ported: the device mesh (``--mesh``) and
``--platform``; the parser refuses their flags.
"""

from __future__ import annotations

import argparse
import logging
import os
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


def _same_structure(a, b) -> bool:
    """Equal tree structure (dict keys, list lengths) and leaf shapes:
    ``jax.tree.structure`` equality plus the shapes."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and sorted(a) == sorted(b)
                and all(_same_structure(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
                and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    return getattr(a, "shape", None) == getattr(b, "shape", None)


def merge_pretrained(params, tree, cfg, head_major: bool = False):
    """Merge a converted pretrained ViT tree into freshly initialized
    params (the fine-tune init).

    The tree is geometry-adapted first (``vit.adapt_checkpoint``) and its
    qkv columns repacked head-major when this run's layout wants it. Each
    top-level key whose structure and shapes match loads onto its target's
    device and dtype; everything else (typically a classifier head of
    another label space) keeps the fresh init. Returns ``(merged_params,
    loaded_keys, skipped_keys)``; raises if the block trunk did not load
    (a checkpoint of another model)."""
    from interactive_vit_tpu_torch.models import vit
    from interactive_vit_tpu_torch.parallel import mesh as mesh_lib
    from interactive_vit_tpu_torch.parallel.train import (
        tree_leaves, tree_unflatten,
    )

    tree = vit.adapt_checkpoint(tree, cfg)
    if head_major:
        tree = mesh_lib.permute_qkv_head_major(tree, cfg.heads)
    merged = dict(params)
    loaded, skipped = [], []
    for key, new in tree.items():
        old = merged.get(key)
        if old is None:
            skipped.append(key)
            continue
        compatible = _same_structure(new, old)
        if not compatible or not tree_leaves(new):
            # empty subtrees ({} heads) carry no weights: nothing to load
            (skipped if not compatible else loaded).append(key)
            continue
        merged[key] = tree_unflatten(new, [
            n.to(device=o.device, dtype=o.dtype)
            for n, o in zip(tree_leaves(new), tree_leaves(old))])
        loaded.append(key)
    if "blocks" not in loaded:
        raise ValueError(
            f"--init checkpoint does not match {cfg.name}: the block "
            f"trunk failed to load (loaded={loaded}, skipped={skipped}) "
            f"— wrong variant or depth?")
    return merged, loaded, skipped


def init_from_checkpoint(path: str, params, cfg, variant: str,
                         head_major: bool):
    """``--init``: load ``path`` (safetensors or torch .pth, the layout
    sniffed) and merge its trunk into ``params`` (``merge_pretrained``)."""
    from interactive_vit_tpu_torch.tools.convert import (
        convert, load_state_dict,
    )

    tree = convert(variant, "auto", load_state_dict(path))
    return merge_pretrained(params, tree, cfg, head_major)


def save_state(path: str, params, opt_state, step: int, saver=None,
               head_major: bool = False, ema=None) -> None:
    """Train-state checkpoint: params, optimizer state and step in one
    directory (``utils/checkpoint.py``); through ``saver`` (an
    ``AsyncSaver``) the write overlaps the next steps. ``head_major``
    records the qkv column layout of the params, which ``load_state``
    checks: the layout follows --attn and --dtype, and a same-shape load of
    permuted columns would otherwise pass unseen."""
    from interactive_vit_tpu_torch.utils.checkpoint import save_params

    tree = {"params": params, "opt_state": opt_state,
            "step": torch.tensor(step),
            "qkv_head_major": torch.tensor(int(head_major))}
    if ema is not None:
        tree["ema"] = ema
    if saver is not None:
        saver.save(path, tree)
    else:
        save_params(path, tree)


def load_state(path: str, like_params, like_opt_state,
               expect_head_major=None, want_ema: bool = False):
    """Restore ``save_state``'s tree onto the devices and dtypes of
    ``like_params`` / ``like_opt_state``. The layout marker and the EMA are
    optional (they follow the saving run's flags): the ``like`` tree is
    built from what the checkpoint holds (``state_keys``). A layout that
    differs from ``expect_head_major`` raises. Returns ``(params,
    opt_state, step)``, and the EMA (None when the checkpoint has none)
    with ``want_ema``."""
    from interactive_vit_tpu_torch.parallel.train import (
        tree_leaves, tree_map_with_path,
    )
    from interactive_vit_tpu_torch.utils.checkpoint import (
        LeafSpec, load_params, state_keys,
    )

    saved = state_keys(path)
    dev = tree_leaves(like_params)[0].device
    scalar = LeafSpec((), torch.int64, dev)
    like = {"params": like_params, "opt_state": like_opt_state,
            "step": scalar}
    if "qkv_head_major" in saved:
        like["qkv_head_major"] = scalar
    if "ema" in saved:
        # the EMA accumulates in f32 whatever the param dtype
        like["ema"] = tree_map_with_path(
            lambda _, p: LeafSpec(
                tuple(p.shape),
                torch.float32 if p.is_floating_point() else p.dtype,
                p.device), like_params)
    st = load_params(path, like=like)
    saved_hm = (bool(int(st.pop("qkv_head_major")))
                if "qkv_head_major" in saved else None)
    if (expect_head_major is not None and saved_hm is not None
            and saved_hm != bool(expect_head_major)):
        raise ValueError(
            f"--resume layout mismatch: checkpoint at {path} stores qkv "
            f"{'head-major' if saved_hm else 'torch-layout'} columns but "
            f"this run resolves to "
            f"{'head-major' if expect_head_major else 'torch-layout'} "
            f"(the layout follows --attn/--dtype/device via "
            f"wants_head_major). Resume with the original flags, or "
            f"export via --export-safetensors and restart from --ckpt.")
    if want_ema:
        return (st["params"], st["opt_state"], int(st["step"]),
                st.get("ema"))
    return st["params"], st["opt_state"], int(st["step"])


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--variant", default="vit_t16",
                        help="a plain ViT variant, with an optional "
                             "@<pixels>p<patch> geometry (vit_b16@384), "
                             "vit_moe_s16, swin_* or convnext_*")
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
    parser.add_argument("--no-remat", action="store_true",
                        help="(deprecated) same as --remat off")
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
    parser.add_argument("--data", default=None, metavar="PREFIX",
                        help="train on {PREFIX}_images.npy/_labels.npy via "
                             "the native prefetching loader (data/loader.py)"
                             " instead of synthetic batches; augments with "
                             "deterministic horizontal flips")
    parser.add_argument("--hflip", action="store_true",
                        help="random horizontal flips (on the device — "
                             "data/augment.py; the --data loader's own "
                             "deterministic flip is independent)")
    parser.add_argument("--crop-pad", type=int, default=0,
                        help="zero-pad N px per side + random same-size "
                             "crop (shift augmentation)")
    parser.add_argument("--color-jitter", type=float, default=0.0,
                        help="brightness/contrast/saturation jitter "
                             "strength s (factors from U[1-s, 1+s])")
    parser.add_argument("--cutout", type=int, default=0,
                        help="zero-fill a random NxN square per image")
    parser.add_argument("--mixup", type=float, default=0.0,
                        help="mixup Beta(a,a) alpha (0 = off); emits soft "
                             "labels")
    parser.add_argument("--cutmix", type=float, default=0.0,
                        help="cutmix Beta(a,a) alpha (0 = off); with "
                             "--mixup, one of the two is chosen per step")
    parser.add_argument("--label-smoothing", type=float, default=0.0)
    parser.add_argument("--distill-teacher", default=None, metavar="FILE",
                        help="DeiT distillation: a frozen teacher "
                             "checkpoint whose predictions supervise the "
                             "student's distillation head (token 1); the "
                             "student must be a distilled variant (deit_*). "
                             "Requires --teacher-variant")
    parser.add_argument("--teacher-variant", default=None,
                        help="the teacher checkpoint's variant (any "
                             "trainable family; the student's resolution "
                             "and label space)")
    parser.add_argument("--distill-alpha", type=float, default=0.5,
                        help="distillation weight: loss = (1-a) CE(cls, "
                             "labels) + a distill")
    parser.add_argument("--distill-tau", type=float, default=0.0,
                        help="0 = hard distillation (CE against the "
                             "teacher's argmax); >0 = soft (the teacher's "
                             "softmax at tau, scaled tau^2)")
    parser.add_argument("--ema-decay", type=float, default=0.0,
                        help="keep an f32 exponential moving average of the "
                             "params; evals use it (0 = off)")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--output", default=None,
                        help="checkpoint directory (params/: the export "
                             "weights; state/: the train state)")
    parser.add_argument("--save-every", type=int, default=0,
                        help="also save the train state every N steps (in "
                             "the background)")
    parser.add_argument("--resume", action="store_true",
                        help="restore the train state from --output/state "
                             "and continue at the saved step (pass the same "
                             "--warmup/--clip-norm/--llrd as the original "
                             "run)")
    parser.add_argument("--init", default=None, metavar="FILE",
                        help="initialize the trunk from a checkpoint "
                             "(safetensors or .pth, layout sniffed); the "
                             "classifier head stays fresh where it does "
                             "not match. Mutually exclusive with --resume")
    parser.add_argument("--export-safetensors", default=None,
                        help="also write the final export params as a "
                             ".safetensors file in the native '/' naming "
                             "(servable via --ckpt)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    args = parser.parse_args(argv)
    if args.accum_steps > 1 and args.batch % args.accum_steps:
        parser.error("--batch must be divisible by --accum-steps")
    if args.data and args.memorize:
        parser.error("--data and --memorize are mutually exclusive "
                     "(the loader stream would silently win)")
    if args.init and args.resume:
        parser.error("--init and --resume are mutually exclusive: "
                     "--resume restores the full train state, --init "
                     "seeds a fresh run from pretrained weights")
    if bool(args.distill_teacher) != bool(args.teacher_variant):
        parser.error("--distill-teacher and --teacher-variant go together")
    from interactive_vit_tpu_torch.models import vit

    if args.init and args.variant.partition("@")[0] not in vit.VARIANTS:
        parser.error("--init supports the plain-ViT family only "
                     "(vit_*/deit_*/dino* variants)")
    state_dir = os.path.join(args.output, "state") if args.output else None
    if args.resume and not (state_dir and os.path.exists(state_dir)):
        parser.error(f"--resume: no state at {state_dir}")
    return args


def resolve_remat(args, cfg, run_dtype, attn_impl, device):
    """``--remat`` (``--no-remat`` is ``off``) as ``remat_wrapper``'s
    argument; ``auto``: ``parallel/train.auto_remat`` at the microbatch."""
    from interactive_vit_tpu_torch.parallel import train as train_lib

    if args.no_remat:
        return False
    if args.remat != "auto":
        return {"on": True, "off": False, "dots": "dots"}[args.remat]
    remat = train_lib.auto_remat(
        cfg, max(1, args.batch // args.accum_steps), dtype=run_dtype,
        flash_attn=attn_impl is not None, device=device)
    logger.info("remat auto -> %s", "on" if remat else "off")
    return remat


def resolve_cfg(variant: str):
    """A trainable family's config (JAX's ``resolve_cfg``): a plain ViT
    (``@`` geometries included), ``swin_*``, ``convnext_*`` or an MoE
    variant."""
    from interactive_vit_tpu_torch.models import convnext, moe, swin, vit

    if variant.partition("@")[0] in vit.VARIANTS:
        return vit.resolve_variant(variant)
    for fam in (swin, convnext, moe):
        if variant in fam.VARIANTS:
            return fam.VARIANTS[variant]
    raise ValueError(
        f"--variant {variant!r} is not a trainable model: a plain ViT (one "
        f"of {sorted(vit.VARIANTS)}, optionally @<geometry>) or one of "
        f"{sorted([*swin.VARIANTS, *convnext.VARIANTS, *moe.VARIANTS])}")


def load_teacher(args, dtype, device):
    """``--distill-teacher``: the teacher's config and params through
    ``tools/convert.convert`` (the layout sniffed), in ``dtype`` (None:
    f32) on ``device``."""
    from interactive_vit_tpu_torch.tools.convert import (
        convert, load_state_dict,
    )

    teacher_cfg = resolve_cfg(args.teacher_variant)
    params = convert(args.teacher_variant, "auto",
                     load_state_dict(args.distill_teacher),
                     dtype=dtype or torch.float32, device=device)
    logger.info("distillation: frozen %s teacher from %s (alpha=%g, %s)",
                args.teacher_variant, args.distill_teacher,
                args.distill_alpha, f"soft tau={args.distill_tau}"
                if args.distill_tau > 0 else "hard")
    return teacher_cfg, params


def main(argv=None) -> dict:
    """Train; returns what the run saw: ``history`` [(step, loss, seconds
    since the run's first step began)] at the logged steps (the clock is
    read after the loss reached the host), ``evals`` [(step, top-1)],
    ``remat``, ``head_major``, ``attn``, the final export ``params`` (the
    canonical qkv layout; the EMA in the param dtype with --ema-decay),
    ``start_step`` (the resumed step, else 0), ``saves`` [(step, seconds
    the --save-every save held the loop)], the final train ``state``
    (params in the training layout, optimizer state, step), the loader's
    ``backend`` ("native" / "python"; None without --data) and the
    ``eval_sample`` (images, labels) the evals read."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from interactive_vit_tpu_torch.ops.dispatch import default_train_attn_impl
    from interactive_vit_tpu_torch.parallel import mesh as mesh_lib
    from interactive_vit_tpu_torch.parallel import train as train_lib
    from interactive_vit_tpu_torch.runtime.device import (
        exact_f32_matmuls, require_device,
    )

    device = require_device(args.device)
    exact_f32_matmuls()
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
    remat = resolve_remat(args, cfg, run_dtype, attn_impl, device)

    common = dict(device=device, seed=args.seed, lr=args.lr, remat=remat,
                  optimizer=optimizer, dtype=dtype, attn_impl=attn_impl,
                  accum_steps=args.accum_steps,
                  label_smoothing=args.label_smoothing,
                  compute_dtype=compute_dtype)
    if args.distill_teacher:
        teacher_cfg, teacher_params = load_teacher(args, dtype, device)
        params, opt_state, step_fn, infer_fn = train_lib.setup_distill(
            cfg, teacher_cfg, teacher_params, alpha=args.distill_alpha,
            tau=args.distill_tau, **common)
        del teacher_params  # the step's closure holds the teacher
    else:
        params, opt_state, step_fn, infer_fn = train_lib.setup(cfg, **common)
    head_major = train_lib.wants_head_major(cfg, attn_impl)
    if args.init:
        params, loaded, skipped = init_from_checkpoint(
            args.init, params, cfg, args.variant, head_major)
        # the optimizer state is zeros shaped like the params: unchanged
        logger.info("initialized from %s: loaded %s%s", args.init, loaded,
                    f", fresh {skipped}" if skipped else "")
    state_dir = os.path.join(args.output, "state") if args.output else None
    start_step = 0
    ema = None
    ema_update = make_ema_update(args.ema_decay) if args.ema_decay else None
    if args.resume:
        params, opt_state, start_step, *rest = load_state(
            state_dir, params, opt_state, expect_head_major=head_major,
            want_ema=bool(args.ema_decay))
        if args.ema_decay:
            ema = rest[0]
            if ema is None:
                logger.info("checkpoint has no EMA state; seeding the "
                            "average from the restored params")
        logger.info("resumed from %s at step %d", state_dir, start_step)
    if args.ema_decay and ema is None:
        ema = _seed_ema(params)
    from interactive_vit_tpu_torch.data.augment import (
        AugmentConfig, make_augment_fn,
    )

    aug_cfg = AugmentConfig(
        hflip=args.hflip, crop_pad=args.crop_pad,
        color_jitter=args.color_jitter, cutout=args.cutout,
        mixup_alpha=args.mixup, cutmix_alpha=args.cutmix)
    aug_fn = make_augment_fn(aug_cfg, cfg.num_classes, seed=args.seed)
    if aug_fn is not None:
        logger.info("augment: %s", aug_cfg)

    # as in the JAX trainer, a resumed synthetic or --memorize stream is
    # drawn from a generator seeded at --seed + the resumed step: it is not
    # the stream the uninterrupted run would have gone on with (the --data
    # stream is: the loader skips the consumed batches below)
    rng = np.random.default_rng(args.seed + start_step)
    loader = backend = None
    if args.data:
        from interactive_vit_tpu_torch.data.loader import Loader

        # borrow=True: a batch views a prefetch slot (no host copy); each
        # step copies it to the device before the next next() reuses it
        loader = Loader(args.data + "_images.npy", args.data + "_labels.npy",
                        args.batch, seed=args.seed, flip=True, borrow=True)
        backend = "native" if loader.native else "python"
        logger.info("data loader: %d samples, %s backend", loader.n, backend)
        # a smoke metric over the training stream (these samples re-enter
        # training after epoch 0); np.array: the borrowed views die at the
        # next batch
        ev = next(loader)
        eval_images, eval_labels = np.array(ev[0]), np.array(ev[1])
        # the batches the interrupted run consumed: the resumed stream
        # goes on where the uninterrupted run would be
        for _ in range(start_step):
            next(loader)
    elif args.memorize:
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

    history, evals, saves = [], [], []
    saver = None  # an AsyncSaver, made at the first --save-every save
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        if loader is not None:
            images, labels, _epoch = next(loader)
            # a blocking copy out of the pageable slot (copy=True: on the
            # CPU too), done before the next next() lets a worker refill it
            images = torch.from_numpy(images).to(device, copy=True)
            labels = torch.from_numpy(labels).to(device, copy=True)
        elif args.memorize:
            idx = torch.from_numpy(
                rng.integers(0, args.memorize, size=(args.batch,))).to(device)
            images, labels = mem_images[idx], mem_labels[idx]
        else:
            images, labels = synthetic_batch(rng, args.batch, cfg.img_size,
                                             cfg.num_classes)
            images = torch.from_numpy(images).to(device)
            labels = torch.from_numpy(labels).to(device)
        if aug_fn is not None:
            # deterministic per (seed, step): a resumed run replays it
            images, labels = aug_fn(step, images, labels)
        params, opt_state, loss = step_fn(params, opt_state, images, labels)
        if ema_update is not None:
            ema = ema_update(ema, params)
        if step % args.log_every == 0 or step == args.steps - 1:
            value = float(loss)
            dt = time.perf_counter() - t0
            history.append((step, value, dt))
            logger.info("step %4d  loss %.4f  (%.1f imgs/s)", step, value,
                        (step - start_step + 1) * args.batch / dt)
        if args.eval_every and (step + 1) % args.eval_every == 0:
            acc = evaluate(infer_fn, ema if ema is not None else params,
                           eval_images, eval_labels, args.batch)
            evals.append((step, acc))
            logger.info("step %4d  %s%s top-1 %.3f", step,
                        "EMA " if ema is not None else "",
                        "train-stream" if loader is not None else "eval",
                        acc)
        if (args.save_every and state_dir
                and (step + 1) % args.save_every == 0):
            if saver is None:
                from interactive_vit_tpu_torch.utils.checkpoint import (
                    AsyncSaver,
                )

                saver = AsyncSaver()
            ts = time.perf_counter()
            save_state(state_dir, params, opt_state, step + 1, saver=saver,
                       head_major=head_major, ema=ema)
            saves.append((step + 1, time.perf_counter() - ts))
            logger.info("async-saving train state at step %d", step + 1)
    if loader is not None:
        loader.close()
    if saver is not None:
        saver.close()  # drain the write in flight before the final save

    # the export layout: canonical qkv columns (the train state keeps the
    # training layout, which --resume re-enters); with --ema-decay the
    # average, cast back to the param dtype, is the artifact
    export_params = params
    if ema is not None:
        export_params = train_lib.tree_unflatten(params, [
            e.to(p.dtype) if e.is_floating_point() else e
            for e, p in zip(train_lib.tree_leaves(ema),
                            train_lib.tree_leaves(params))])
    if head_major:
        export_params = mesh_lib.unpermute_qkv_head_major(export_params,
                                                          cfg.heads)
    if args.output:
        from interactive_vit_tpu_torch.utils.checkpoint import save_params

        save_params(os.path.join(args.output, "params"), export_params)
        save_state(state_dir, params, opt_state, args.steps,
                   head_major=head_major, ema=ema)
        logger.info("saved checkpoint to %s", args.output)
    if args.export_safetensors:
        from interactive_vit_tpu_torch.models.weights import to_native_flat
        from interactive_vit_tpu_torch.utils.safetensors_io import save_file

        # bf16 leaves keep their bits under BF16 tags, as JAX's writer's
        save_file(to_native_flat(export_params, keep_bf16=True),
                  args.export_safetensors)
        logger.info("exported %s", args.export_safetensors)
    return {"history": history, "evals": evals, "remat": remat,
            "head_major": head_major,
            "attn": None if attn_impl is None else attn_impl.__name__,
            "params": export_params, "start_step": start_step,
            "saves": saves,
            "backend": backend,
            "eval_sample": (eval_images, eval_labels),
            "state": {"params": params, "opt_state": opt_state,
                      "step": args.steps}}


if __name__ == "__main__":
    main()
