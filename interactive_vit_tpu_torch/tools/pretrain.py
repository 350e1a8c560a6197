"""MAE self-supervised pretraining on one device or a device mesh.

    python -m interactive_vit_tpu_torch.tools.pretrain \\
        --variant mae_b16 --dtype mixed --steps 400 --batch 64 \\
        --memorize 256 --export-encoder enc.safetensors --probe

Counterpart of ``interactive_vit_tpu/tools/pretrain.py`` on one card (or
the CPU with ``--device cpu``; the card is the default and a run without
one raises). The objective is masked reconstruction (``models/mae.py``,
``parallel/train.make_mae_train_step``), so no label is read; step
``s``'s masks come from ``fold_in(key(seed + 0xAE), s)`` (and
``fold_in(., i)`` for microbatch i under ``--accum-steps``), JAX's keys
bit for bit. ``--resume`` under ``--data`` skips the consumed batches,
so it replays the uninterrupted run; under ``--memorize`` the batch
indices are drawn anew from ``--seed`` + the resumed step, as in the JAX
package. The encoder trains through the plain attention, as in the JAX
package (the visible-token count varies with the mask ratio).
``--probe`` fits a ridge linear probe on the frozen CLS features of the
pretrained encoder and of a random-init one, held-out top-1 both (host
numpy).

Outputs:
  --output DIR              ``utils/checkpoint.py`` directories: DIR/params
                            (the full MAE tree) and DIR/state (params,
                            optimizer state, step; ``--resume`` continues)
  --export-encoder FILE     the encoder as a plain-ViT safetensors file
                            (native "/" naming), served by
                            ``serving.server --models <encoder> --ckpt
                            <encoder>=FILE`` and the ``tools/train.py
                            --init`` of a fine-tune
  --export-safetensors FILE the full MAE tree (the reconstruction demo:
                            ``--models mae_* --ckpt``)

``--mesh`` pretrains on a device mesh under ``torchrun`` (as
``tools/train.py``: "data=all" by default, one device outside
``torchrun``; ``parallel/train.setup_sharded_mae``): every rank draws the
global batch and the masks of the global batch and trains its rows; rank 0
logs and writes whole tensors. Not ported: ``--platform``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)


def linear_probe(features, labels, classes: int, l2: float = 1e-3,
                 train_frac: float = 0.8, seed: int = 0) -> float:
    """Closed-form ridge regression on one-hot labels; the held-out top-1
    (a fit-set accuracy says nothing: with few samples and wide features
    any encoder, random ones too, fits it). Host numpy in float64, the JAX
    package's function."""
    x = np.asarray(features, np.float64)
    y = np.asarray(labels)
    perm = np.random.default_rng(seed).permutation(len(x))
    n_tr = max(classes, int(round(len(x) * train_frac)))
    tr, te = perm[:n_tr], perm[n_tr:]
    if len(te) == 0:
        tr = te = perm  # degenerate tiny sets: the fit accuracy
    onehot = np.eye(classes)[y[tr]]
    d = x.shape[1]
    w = np.linalg.solve(x[tr].T @ x[tr] + l2 * np.eye(d), x[tr].T @ onehot)
    pred = (x[te] @ w).argmax(axis=1)
    return float((pred == y[te]).mean())


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--variant", default="mae_t16",
                        help="mae_t16 / mae_s16 / mae_b16, optionally with "
                             "the @<pixels> encoder geometry")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1.5e-4)
    parser.add_argument("--warmup", type=int, default=0,
                        help="warmup steps (with cosine decay to --steps)")
    parser.add_argument("--weight-decay", type=float, default=0.05)
    parser.add_argument("--mask-ratio", type=float, default=None,
                        help="override the config's mask ratio (0.75)")
    parser.add_argument("--no-norm-pix", action="store_true",
                        help="raw-pixel targets instead of per-patch "
                             "normalised ones")
    parser.add_argument("--mesh", default="data=all",
                        help="the device mesh under torchrun (e.g. "
                             "data=2,model=2; 'data=all' = pure DP)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16", "mixed"],
                        help="mixed = f32 master params, bf16 forward and "
                             "backward")
    parser.add_argument("--remat", default="off",
                        choices=["on", "off", "dots"],
                        help="per-block rematerialisation of both trunks")
    parser.add_argument("--accum-steps", type=int, default=1)
    parser.add_argument("--memorize", type=int, default=256,
                        help="pretrain on a fixed set of N patterned "
                             "images; --data overrides")
    parser.add_argument("--distinct-classes", type=int, default=64,
                        help="pattern classes of the --memorize set (read "
                             "by --probe only)")
    parser.add_argument("--data", default=None, metavar="PREFIX",
                        help="pretrain on {PREFIX}_images.npy through the "
                             "native prefetching loader (the labels only "
                             "for --probe)")
    parser.add_argument("--probe", action="store_true",
                        help="after pretraining, a ridge linear probe's "
                             "held-out top-1 on frozen CLS features, beside "
                             "the same probe on a random-init encoder")
    parser.add_argument("--output", default=None)
    parser.add_argument("--save-every", type=int, default=0)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--export-encoder", default=None)
    parser.add_argument("--export-safetensors", default=None)
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    args = parser.parse_args(argv)
    if args.accum_steps > 1 and args.batch % args.accum_steps:
        parser.error("--batch must be divisible by --accum-steps")
    state_dir = os.path.join(args.output, "state") if args.output else None
    if args.resume and not (state_dir and os.path.exists(state_dir)):
        parser.error(f"--resume: no state at {state_dir}")
    from interactive_vit_tpu_torch.parallel.mesh import parse_mesh

    try:
        parse_mesh(args.mesh)
    except ValueError as err:
        parser.error(str(err))
    return args


def cls_features(params, images, cfg, batch: int, device) -> np.ndarray:
    """The encoder's final-norm CLS features of every image (all tokens
    kept), [N, D] f32 on the host, ``batch`` images a pass."""
    from interactive_vit_tpu_torch.models import mae

    feats = []
    with torch.no_grad():
        for i in range(0, len(images), batch):
            x = torch.from_numpy(np.ascontiguousarray(
                images[i:i + batch])).to(device)
            feats.append(mae.encode(params, x, cfg)[:, 0].float().cpu()
                         .numpy())
    return np.concatenate(feats)


def main(argv=None) -> dict:
    """Pretrain; returns what the run saw: ``history`` [(step, loss,
    seconds since the run's first step began)] at the logged steps,
    ``probe`` (pretrained top-1, random-init top-1) with ``--probe`` else
    None, ``start_step`` (the resumed step, else 0), the final ``params``
    and the train ``state`` (params, optimizer state, step). On a mesh
    the params are whole on every rank, the probe is rank 0's (None
    elsewhere), and a rank outside the mesh returns ``{}``."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from interactive_vit_tpu_torch.models import mae
    from interactive_vit_tpu_torch.ops.node_ops import fold_in, prng_key
    from interactive_vit_tpu_torch.parallel import mesh as mesh_lib
    from interactive_vit_tpu_torch.parallel import train as train_lib
    from interactive_vit_tpu_torch.runtime.device import exact_f32_matmuls
    from interactive_vit_tpu_torch.tools.train import (
        load_state, pattern_set, save_state,
    )

    device = mesh_lib.init_distributed(args.device)
    exact_f32_matmuls()
    mesh = mesh_lib.make_run_mesh(args.mesh)
    if not mesh_lib.is_chief():
        logging.getLogger().setLevel(logging.WARNING)
    if not mesh_lib.in_mesh(mesh):
        return {}
    rows = mesh_lib.replicated(mesh)
    if mesh is not None:
        rows = mesh_lib.batch_sharding(mesh, args.accum_steps)
        logger.info("mesh: %s over %d devices", mesh_lib.mesh_shape(mesh),
                    mesh.size())
    cfg = mae.resolve_variant(args.variant)
    if args.no_norm_pix:
        cfg = dataclasses.replace(cfg, norm_pix=False)
    enc_cfg = cfg.enc_cfg
    logger.info("encoder %s (%d patches, keep %d)", enc_cfg.name,
                cfg.num_patches, cfg.len_keep(args.mask_ratio))
    optimizer = train_lib.make_optimizer(
        args.lr, wd=args.weight_decay, warmup_steps=args.warmup,
        total_steps=args.steps if args.warmup else 0)
    state_dir = os.path.join(args.output, "state") if args.output else None
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    compute_dtype = torch.bfloat16 if args.dtype == "mixed" else None
    remat = {"on": True, "off": False, "dots": "dots"}[args.remat]

    common = dict(seed=args.seed, lr=args.lr, remat=remat,
                  optimizer=optimizer, dtype=dtype,
                  accum_steps=args.accum_steps, mask_ratio=args.mask_ratio,
                  compute_dtype=compute_dtype)
    if mesh is None:
        params, opt_state, step_fn = train_lib.setup_mae(
            cfg, device=device, **common)
    else:
        params, opt_state, step_fn = train_lib.setup_sharded_mae(
            cfg, mesh, **common)
    start_step = 0
    if args.resume:
        params, opt_state, start_step = load_state(state_dir, params,
                                                   opt_state)
        logger.info("resumed from %s at step %d", state_dir, start_step)

    rng = np.random.default_rng(args.seed + start_step)
    loader = None
    probe_labels = None
    if args.data:
        from interactive_vit_tpu_torch.data.loader import Loader

        loader = Loader(args.data + "_images.npy", args.data + "_labels.npy",
                        args.batch, seed=args.seed, flip=True, borrow=True)
        logger.info("data loader: %d samples", loader.n)
        for _ in range(start_step):
            next(loader)
    else:
        mem_images, probe_labels = pattern_set(
            args.seed, args.memorize, enc_cfg.img_size,
            max(enc_cfg.num_classes, args.distinct_classes),
            args.distinct_classes)
        # the set lives on the device; a step gathers its batch by index
        mem_images_d = torch.from_numpy(mem_images).to(device)

    base_key = prng_key(args.seed + 0xAE)
    history = []
    saver = None  # an AsyncSaver, made at the first --save-every save
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        if loader is not None:
            images, _labels, _epoch = next(loader)
            # a blocking copy out of the borrowed slot before the next next()
            images = torch.from_numpy(images).to(device, copy=True)
        else:
            idx = torch.from_numpy(
                rng.integers(0, args.memorize, size=(args.batch,))).to(device)
            images = mem_images_d[idx]
        # deterministic per (seed, step): --resume replays the stream
        params, opt_state, loss = step_fn(params, opt_state, rows(images),
                                          fold_in(base_key, step))
        if step % args.log_every == 0 or step == args.steps - 1:
            value = float(loss)
            dt = time.perf_counter() - t0
            history.append((step, value, dt))
            logger.info("step %4d  recon loss %.6f  (%.1f imgs/s)", step,
                        value, (step - start_step + 1) * args.batch / dt)
        if (args.save_every and state_dir
                and (step + 1) % args.save_every == 0):
            if saver is None:
                from interactive_vit_tpu_torch.utils.checkpoint import (
                    AsyncSaver,
                )

                saver = AsyncSaver()
            save_state(state_dir, params, opt_state, step + 1, saver=saver)
            logger.info("async-saving state at step %d", step + 1)
    if loader is not None:
        loader.close()
    if saver is not None:
        saver.close()  # drain the write in flight before the final save

    # whole tensors (DTensor leaves gathered on a mesh)
    state_params, params = params, mesh_lib.unshard(params)
    probe = None
    if args.probe and mesh_lib.is_chief():
        if args.data:
            # copies: a read-only memmap cannot back a torch tensor
            probe_images = np.array(np.load(args.data + "_images.npy",
                                            mmap_mode="r")[:2048])
            probe_labels = np.array(np.load(args.data + "_labels.npy",
                                            mmap_mode="r")[:2048])
        else:
            probe_images = mem_images
        classes = int(np.max(probe_labels)) + 1
        acc = linear_probe(cls_features(params, probe_images, cfg,
                                        args.batch, device),
                           probe_labels, classes)
        rand = mae.init_params(cfg, torch.Generator().manual_seed(
            args.seed + 1), dtype=dtype or torch.float32, device=device)
        acc0 = linear_probe(cls_features(rand, probe_images, cfg,
                                         args.batch, device),
                            probe_labels, classes)
        probe = (acc, acc0)
        logger.info("linear probe top-1: pretrained %.3f vs random-init "
                    "%.3f (%d samples, %d classes)", acc, acc0,
                    len(probe_images), classes)

    if args.output:
        from interactive_vit_tpu_torch.utils.checkpoint import save_params

        if mesh_lib.is_chief():
            save_params(os.path.join(args.output, "params"), params)
        save_state(state_dir, state_params, opt_state, args.steps)
        logger.info("saved checkpoint to %s", args.output)
    if (args.export_encoder or args.export_safetensors) \
            and mesh_lib.is_chief():
        from interactive_vit_tpu_torch.models.weights import to_native_flat
        from interactive_vit_tpu_torch.utils.safetensors_io import save_file

        # bf16 leaves keep their bits under BF16 tags, as JAX's writer's
        if args.export_encoder:
            save_file(to_native_flat(mae.encoder_params(params),
                                     keep_bf16=True), args.export_encoder)
            logger.info("exported the encoder (a plain-ViT %s checkpoint) "
                        "to %s", enc_cfg.name, args.export_encoder)
        if args.export_safetensors:
            save_file(to_native_flat(params, keep_bf16=True),
                      args.export_safetensors)
            logger.info("exported the full MAE tree to %s",
                        args.export_safetensors)
    return {"history": history, "probe": probe, "start_step": start_step,
            "params": params,
            "state": {"params": state_params, "opt_state": opt_state,
                      "step": args.steps}}


if __name__ == "__main__":
    main()
