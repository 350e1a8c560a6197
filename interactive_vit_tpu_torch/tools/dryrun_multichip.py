"""The multi-rank dry run: every mesh path of the port on toy shapes, each
held against the same computation on one device.

    torchrun --standalone --nproc-per-node 4 -m \\
        interactive_vit_tpu_torch.tools.dryrun_multichip --device cpu

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py`` for the training half of the mesh: on four ranks
(gloo on the CPU, NCCL on four cards) it runs

* ``train3``: three ``setup_sharded`` steps (plain SGD) at
  ``data=2,model=2`` with accumulation 2 and remat (DTensor weights, the
  local shard shapes recorded);
* ``train_aug``: the augmentation stage drawn for the global batch (soft
  labels from mixup / cutmix) and one AdamW step on the mesh;
* ``distill`` / ``mae``: one ``setup_sharded_distill`` and one
  ``setup_sharded_mae`` step;
* ``moe``: the expert-parallel forward and one step with the load-balance
  term (experts over "model");
* ``swin`` (logits and the shifted block's maps under DP x TP), ``tome``
  and ``convnext`` (pure DP) forwards;
* ``ring`` / ``ulysses`` on ``data=4`` and on the model axis of
  ``data=2,model=2``, with padded tokens (``n_real``);
* ``pipeline``: ``pipelined_vit_forward`` and a tapped
  ``pipeline_apply_stacked`` on ``data=2,stage=2``;
* the refusals (heads or tokens not divisible, a ring asked for maps);
* checkpoints: a state saved on the mesh reads back whole on one rank,
  and one saved on one rank reads back onto the mesh.

``run_cases`` returns every result whole on every rank (the tests hold
rank 0's against the JAX functions on a mesh of the same shape);
``main`` holds them against ``reference`` (one device, the same inputs)
and prints one line a case on rank 0. The mesh executor, gradient taps,
mesh export and pipeline-folded serving are not part of it yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import sys
import tempfile
from typing import Any, Callable, Dict

import numpy as np
import torch

WORLD = 4
CFG = dict(img_size=32, patch=16, width=64, depth=2, heads=4,
           num_classes=16)
BATCH = 8
N_REAL = 13  # of 16 tokens: the ring and Ulysses mask 3 padded keys


def configs() -> Dict[str, Any]:
    """The toy configs of every case (the JAX dry run's)."""
    from interactive_vit_tpu_torch.models import (
        convnext, mae, moe, swin, tome, vit,
    )

    cfg = vit.ViTConfig("vit_dryrun", **CFG)
    return {
        "vit": cfg,
        "deit": dataclasses.replace(cfg, name="deit_dryrun", distilled=True),
        "mae": mae.MAEConfig("mae_dryrun", "vit_t16", dec_width=32,
                             dec_depth=1, dec_heads=2, enc_override=cfg),
        "moe": moe.MoEViTConfig(
            "moe_dryrun", img_size=32, patch=16, width=64, depth=2, heads=4,
            num_classes=16, n_experts=4, capacity_factor=2.0),
        "tome": tome.ToMeViTConfig(
            "tome_dryrun", img_size=32, patch=8, width=64, depth=2, heads=4,
            num_classes=16, r=3),
        "swin": swin.SwinConfig(
            "swin_dryrun", img_size=32, patch=4, embed_dim=16, depths=(2, 2),
            heads=(2, 4), window=4, mlp_ratio=2, num_classes=16),
        "convnext": convnext.ConvNeXtConfig(
            "cnx_dryrun", depths=(1, 1), dims=(8, 16), num_classes=16,
            img_size=32, resize_to=34),
    }


def make_inputs(seed: int = 0) -> Dict[str, Any]:
    """Whole params (the port's inits, from ``seed``) and numpy inputs of
    every case."""
    from interactive_vit_tpu_torch.models import (
        convnext, mae, moe, swin, tome, vit,
    )

    cfgs = configs()

    def gen(i):
        return torch.Generator().manual_seed(seed * 100 + i)

    rng = np.random.default_rng(seed)
    batches = [(rng.random((BATCH, 3, 32, 32), dtype=np.float32),
                rng.integers(0, 16, size=(BATCH,))) for _ in range(3)]
    return {
        "vit": vit.init_params(cfgs["vit"], gen(0)),
        "deit": vit.init_params(cfgs["deit"], gen(1)),
        "teacher": vit.init_params(cfgs["vit"], gen(6)),
        "mae": mae.init_params(cfgs["mae"], gen(7)),
        "moe": moe.init_params(cfgs["moe"], gen(2)),
        "tome": tome.init_params(cfgs["tome"], gen(3)),
        "swin": swin.init_params(cfgs["swin"], gen(4)),
        "convnext": convnext.init_params(cfgs["convnext"], gen(5)),
        "batches": batches,
        "qkv": [rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
                for _ in range(3)],
    }


class SGD:
    """Plain SGD in the optimizer protocol (the update is -lr g): the
    params then compare the gradients themselves."""

    def __init__(self, lr: float = 1e-2):
        self.lr = lr

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        from interactive_vit_tpu_torch.parallel.train import (
            tree_map_with_path,
        )

        return tree_map_with_path(lambda _, g: -self.lr * g, grads), state


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _flat(prefix: str, tree) -> Dict[str, np.ndarray]:
    from interactive_vit_tpu_torch.parallel import mesh as mesh_lib
    from interactive_vit_tpu_torch.parallel.train import (
        tree_leaves_with_path,
    )

    return {f"{prefix}{p}": _np(x) for p, x in
            tree_leaves_with_path(mesh_lib.unshard(tree))}


def _refusal(fn: Callable) -> str:
    try:
        fn()
    except ValueError as err:
        return str(err)
    return ""


def run_cases(inputs: Dict[str, Any], device="cpu",
              ckpt_dir: str = "") -> Dict[str, Any]:
    """Every case on the mesh (all ``WORLD`` ranks call it); returns
    ``{name: numpy array or str}``, whole on every rank. ``ckpt_dir``: a
    directory every rank sees (the checkpoint case writes there)."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from interactive_vit_tpu_torch.data.augment import (
        AugmentConfig, make_augment_fn,
    )
    from interactive_vit_tpu_torch.models import convnext, moe, swin, tome
    from interactive_vit_tpu_torch.ops.node_ops import prng_key
    from interactive_vit_tpu_torch.parallel import mesh as mesh_lib
    from interactive_vit_tpu_torch.parallel import pipeline as pp_lib
    from interactive_vit_tpu_torch.parallel import sequence as seq_lib
    from interactive_vit_tpu_torch.parallel import train as train_lib
    from interactive_vit_tpu_torch.parallel.sp_attention import (
        make_sp_attn_impl,
    )

    if dist.get_world_size() != WORLD:
        raise RuntimeError(f"the dry run takes {WORLD} ranks, got "
                           f"{dist.get_world_size()}")
    cfgs = configs()
    out: Dict[str, Any] = {}
    mesh22 = mesh_lib.make_mesh({"data": 2, "model": 2})
    dp4 = mesh_lib.make_mesh({"data": 4})

    def dev(x):
        return torch.as_tensor(np.asarray(x)).to(device)

    # three DP x TP steps, accumulation 2, remat
    params, opt, step, _ = train_lib.setup_sharded(
        cfgs["vit"], mesh22, optimizer=SGD(), remat=True, accum_steps=2,
        params=inputs["vit"])
    blk = params["blocks"][0]
    out["train3_qkv_local"] = np.asarray(mesh_lib.local(blk["qkv_w"]).shape)
    out["train3_proj_local"] = np.asarray(
        mesh_lib.local(blk["proj_w"]).shape)
    rows2 = mesh_lib.batch_sharding(mesh22, 2)
    losses = []
    for images, labels in inputs["batches"]:
        params, opt, loss = step(params, opt, rows2(dev(images)),
                                 rows2(dev(labels)))
        losses.append(float(loss))
    out["train3_loss"] = np.asarray(losses)
    out.update(_flat("train3_params", mesh_lib.unpermute_qkv_head_major(
        mesh_lib.unshard(params), cfgs["vit"].heads)))

    # the augmentation stage ahead of one AdamW step (soft labels)
    rows = mesh_lib.batch_sharding(mesh22)
    aug = make_augment_fn(
        AugmentConfig(hflip=True, crop_pad=2, cutout=4, mixup_alpha=0.5,
                      cutmix_alpha=1.0), 16, seed=3, batch_sharding=rows)
    images, labels = inputs["batches"][0]
    a_im, a_lb = aug(0, dev(images), dev(labels))
    out["train_aug_labels"] = _np(mesh_lib.all_gather_rows(a_lb, mesh22))
    params, opt, step, infer = train_lib.setup_sharded(
        cfgs["vit"], mesh22, remat=False, params=inputs["vit"])
    out["train_aug_logits"] = _np(mesh_lib.all_gather_rows(
        infer(params, rows(dev(images))), mesh22))
    params, opt, loss = step(params, opt, a_im, a_lb)
    out["train_aug_loss"] = np.asarray(float(loss))
    if ckpt_dir:
        out.update(_checkpoint_case(params, opt, ckpt_dir))

    # distillation and MAE: one SGD step each
    params, opt, step, _ = train_lib.setup_sharded_distill(
        cfgs["deit"], cfgs["vit"], inputs["teacher"], mesh22,
        optimizer=SGD(), params=inputs["deit"])
    params, opt, loss = step(params, opt, rows(dev(images)),
                             rows(dev(labels)))
    out["distill_loss"] = np.asarray(float(loss))
    out.update(_flat("distill_params", mesh_lib.unpermute_qkv_head_major(
        mesh_lib.unshard(params), cfgs["deit"].heads)))
    params, opt, step = train_lib.setup_sharded_mae(
        cfgs["mae"], mesh22, optimizer=SGD(), params=inputs["mae"])
    params, opt, loss = step(params, opt, rows(dev(images)), prng_key(0))
    out["mae_loss"] = np.asarray(float(loss))
    out.update(_flat("mae_params", params))

    # expert parallelism: the forward, and one step with the aux term
    moe_cfg = cfgs["moe"]
    sp = mesh_lib.shard_params(
        train_lib.tree_map_with_path(lambda _, x: x.to(device),
                                     inputs["moe"]), mesh22)
    out["moe_exp_local"] = np.asarray(
        mesh_lib.local(sp["blocks"][1]["exp_fc1_w"]).shape)
    with implicit_replication():
        logits = moe.forward(sp, rows(dev(images)), moe_cfg)["logits"]
    out["moe_logits"] = _np(mesh_lib.all_gather_rows(
        mesh_lib.full_tensor(logits), mesh22))
    params, opt, step, _ = train_lib.setup_sharded(
        moe_cfg, mesh22, optimizer=SGD(), remat=False, params=inputs["moe"])
    params, opt, loss = step(params, opt, rows(dev(images)),
                             rows(dev(labels)))
    out["moe_loss"] = np.asarray(float(loss))

    # Swin under DP x TP (flat qkv columns), ToMe and ConvNeXt under DP
    ss = mesh_lib.shard_params(
        train_lib.tree_map_with_path(lambda _, x: x.to(device),
                                     inputs["swin"]), mesh22)
    with implicit_replication():
        so = swin.forward(ss, rows(dev(images)), cfgs["swin"],
                          want_attn=True)
    out["swin_logits"] = _np(mesh_lib.all_gather_rows(
        mesh_lib.full_tensor(so["logits"]), mesh22))
    out["swin_maps"] = _np(mesh_lib.all_gather_rows(
        mesh_lib.full_tensor(so["attn"][1]), mesh22))
    rows4 = mesh_lib.batch_sharding(dp4)
    tp = train_lib.tree_map_with_path(lambda _, x: x.to(device),
                                      inputs["tome"])
    out["tome_logits"] = _np(mesh_lib.all_gather_rows(tome.forward(
        tp, rows4(dev(images)), cfgs["tome"])["logits"], dp4))
    cp = train_lib.tree_map_with_path(lambda _, x: x.to(device),
                                      inputs["convnext"])
    out["convnext_logits"] = _np(mesh_lib.all_gather_rows(convnext.forward(
        cp, rows4(dev(images)), cfgs["convnext"]), dp4))

    # sequence parallelism, whole results gathered over the axis
    q, k, v = (dev(x) for x in inputs["qkv"])
    for name, m, axis in (("data", dp4, "data"), ("model", mesh22, "model")):
        ring = make_sp_attn_impl(m, axis, "ring")
        uly = make_sp_attn_impl(m, axis, "ulysses")
        out[f"ring_{name}"] = _np(ring(q, k, v, n_real=N_REAL)[0])
        uo, up = uly(q, k, v, want_attn=True, n_real=N_REAL)
        out[f"ulysses_{name}"] = _np(uo)
        out[f"ulysses_{name}_probs"] = _np(up)
    out["err_ulysses_heads"] = _refusal(lambda: seq_lib.ulysses_attention(
        q[:, :3], k[:, :3], v[:, :3], dp4))
    out["err_ring_tokens"] = _refusal(lambda: seq_lib.ring_attention(
        q[:, :, :15], k[:, :, :15], v[:, :, :15], dp4))
    out["err_ulysses_tokens"] = _refusal(lambda: seq_lib.ulysses_attention(
        q[:, :, :15], k[:, :, :15], v[:, :, :15], dp4))
    out["err_ring_maps"] = _refusal(lambda: make_sp_attn_impl(
        dp4, "data", "ring")(q, k, v, True))

    # the GPipe schedule over stage=2, composed with data=2
    pp = mesh_lib.make_mesh({"data": 2, "stage": 2})
    vp = train_lib.tree_map_with_path(lambda _, x: x.to(device),
                                      inputs["vit"])
    x = dev(images)
    out["pipeline_logits"] = _np(pp_lib.pipelined_vit_forward(
        vp, x, cfgs["vit"], pp))
    from interactive_vit_tpu_torch.models import vit

    emb = vit.embed(vp, x, cfgs["vit"])
    stage = mesh_lib.axis_index(pp, "stage")
    y, taps = pp_lib.pipeline_apply_stacked(
        pp_lib._stack_blocks(vp["blocks"][stage:stage + 1]), emb,
        lambda p, h: vit.block(p, h, cfgs["vit"])[0], pp, tap_layers=(0,))
    out["pipeline_trunk"] = _np(y)
    out["pipeline_tap0"] = _np(taps[0])
    out["err_pipeline_layers"] = _refusal(lambda: pp_lib.pipeline_apply(
        vp["blocks"] * 3 + vp["blocks"][:1], emb, None, pp))
    return out


def _checkpoint_case(params, opt, ckpt_dir: str) -> Dict[str, Any]:
    """A state saved on the mesh (DTensor params and AdamW moments) reads
    back whole without a mesh, and a whole state saved by one rank reads
    back onto the mesh as the same shards: the largest difference of
    each, 0 when they round-trip."""
    import os

    import torch.distributed as dist

    from interactive_vit_tpu_torch.parallel import mesh as mesh_lib
    from interactive_vit_tpu_torch.parallel.train import tree_leaves
    from interactive_vit_tpu_torch.tools.train import load_state, save_state

    def diff(a, b):
        return max(float((mesh_lib.local(x).float()
                          - mesh_lib.local(y).float()).abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    whole_p, whole_o = mesh_lib.unshard((params, opt))
    mesh_path = os.path.join(ckpt_dir, "mesh_state")
    save_state(mesh_path, params, opt, 1, head_major=True)
    dist.barrier()
    p1, o1, step = load_state(mesh_path, whole_p, whole_o,
                              expect_head_major=True)
    out = {"ckpt_mesh_to_one": np.asarray(max(diff(p1, whole_p),
                                              diff(o1["mu"], whole_o["mu"]),
                                              float(step != 1)))}
    one_path = os.path.join(ckpt_dir, "one_state")
    save_state(one_path, whole_p, whole_o, 1, head_major=True)  # rank 0
    dist.barrier()
    pm, om, _ = load_state(one_path, params, opt, expect_head_major=True)
    out["ckpt_one_to_mesh"] = np.asarray(max(diff(pm, params),
                                             diff(om["nu"], opt["nu"])))
    out["ckpt_qkv_local"] = np.asarray(
        mesh_lib.local(pm["blocks"][0]["qkv_w"]).shape)
    return out


def reference(inputs: Dict[str, Any]) -> Dict[str, Any]:
    """The cases on one device (the CPU): what ``run_cases`` must give."""
    from interactive_vit_tpu_torch.models import (
        convnext, mae, moe, swin, tome, vit,
    )
    from interactive_vit_tpu_torch.ops.attention import attention_reference
    from interactive_vit_tpu_torch.ops.node_ops import prng_key
    from interactive_vit_tpu_torch.parallel import mesh as mesh_lib
    from interactive_vit_tpu_torch.parallel import train as train_lib

    cfgs = configs()
    t = torch.as_tensor
    out: Dict[str, Any] = {}
    heads = cfgs["vit"].heads
    hm = mesh_lib.permute_qkv_head_major(inputs["vit"], heads)
    step = train_lib.make_train_step(cfgs["vit"], SGD(), remat=True,
                                     qkv_head_major=True, accum_steps=2)
    params, opt, losses = hm, {}, []
    for images, labels in inputs["batches"]:
        # the mesh's microbatches: each half of the batch, rows of both
        # data ranks (mesh.batch_rows)
        params, opt, loss = step(params, opt, t(images), t(labels))
        losses.append(float(loss))
    out["train3_loss"] = np.asarray(losses)
    out.update(_flat("train3_params",
                     mesh_lib.unpermute_qkv_head_major(params, heads)))
    images, labels = inputs["batches"][0]
    x = t(images)
    logits = vit.forward(inputs["vit"], x, cfgs["vit"])["logits"]
    out["train_aug_logits"] = _np(logits)
    dstep = train_lib.make_distill_train_step(
        cfgs["deit"], cfgs["vit"], inputs["teacher"], SGD(),
        qkv_head_major=True)
    dp, _, loss = dstep(mesh_lib.permute_qkv_head_major(inputs["deit"],
                                                        heads),
                        {}, x, t(labels))
    out["distill_loss"] = np.asarray(float(loss))
    out.update(_flat("distill_params",
                     mesh_lib.unpermute_qkv_head_major(dp, heads)))
    mp, _, loss = train_lib.make_mae_train_step(cfgs["mae"], SGD())(
        inputs["mae"], {}, x, prng_key(0))
    out["mae_loss"] = np.asarray(float(loss))
    out.update(_flat("mae_params", mp))
    out["moe_logits"] = _np(moe.forward(inputs["moe"], x,
                                        cfgs["moe"])["logits"])
    out["moe_loss"] = np.asarray(float(train_lib.loss_fn(
        inputs["moe"], x, t(labels), cfgs["moe"])))
    so = swin.forward(inputs["swin"], x, cfgs["swin"], want_attn=True)
    out["swin_logits"], out["swin_maps"] = _np(so["logits"]), _np(
        so["attn"][1])
    out["tome_logits"] = _np(tome.forward(inputs["tome"], x,
                                          cfgs["tome"])["logits"])
    out["convnext_logits"] = _np(convnext.forward(inputs["convnext"], x,
                                                  cfgs["convnext"]))
    q, k, v = (t(a) for a in inputs["qkv"])
    ro, rp = attention_reference(q, k, v, True, n_real=N_REAL)
    for name in ("data", "model"):
        out[f"ring_{name}"] = out[f"ulysses_{name}"] = _np(ro)
        out[f"ulysses_{name}_probs"] = _np(rp)
    out["pipeline_logits"] = _np(logits)
    emb = vit.embed(inputs["vit"], x, cfgs["vit"])
    y0 = vit.block(inputs["vit"]["blocks"][0], emb, cfgs["vit"])[0]
    out["pipeline_tap0"] = _np(y0)
    out["pipeline_trunk"] = _np(vit.block(inputs["vit"]["blocks"][1], y0,
                                          cfgs["vit"])[0])
    return out


# the tolerance of each case (f32 on both sides; the mesh sums in other
# orders: the row-parallel matmuls' partial sums, the data-axis mean)
TOLERANCE = {"train3": 1e-5, "train_aug_logits": 1e-4, "distill": 1e-5,
             "mae": 1e-5, "moe_logits": 1e-4, "moe_loss": 1e-5,
             "swin": 1e-4, "tome": 1e-4, "convnext": 1e-4, "ring": 1e-5,
             "ulysses": 1e-5, "pipeline": 1e-5}

REFUSALS = {
    "err_ulysses_heads": "heads 3 must be divisible by mesh axis 'data'",
    "err_ring_tokens": "token count 15 must be divisible by mesh axis",
    "err_ulysses_tokens": "token count 15 must be divisible by mesh axis",
    "err_ring_maps": "ring attention cannot tap full attention maps",
    "err_pipeline_layers": "7 layers not divisible by 2 stages",
}


def check(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
    """The largest error of each case group against ``want`` (raises
    AssertionError past its ``TOLERANCE``), and the refusals' texts."""
    errs: Dict[str, float] = {}
    for key, ref in want.items():
        group = next(g for g in sorted(TOLERANCE, key=len, reverse=True)
                     if key.startswith(g))
        err = float(np.max(np.abs(np.asarray(got[key]) - ref)))
        errs[group] = max(errs.get(group, 0.0), err)
        assert err <= TOLERANCE[group], (key, err, TOLERANCE[group])
    for key, text in REFUSALS.items():
        assert text in got[key], (key, got[key])
    assert tuple(got["train3_qkv_local"]) == (64, 96)
    assert tuple(got["ckpt_qkv_local"]) == (64, 96)
    assert got["ckpt_mesh_to_one"] == 0 and got["ckpt_one_to_mesh"] == 0
    assert tuple(got["train3_proj_local"]) == (32, 64)
    assert tuple(got["moe_exp_local"]) == (2, 64, 256)
    assert got["train_aug_labels"].shape == (BATCH, 16)
    assert np.isfinite(got["train_aug_loss"])
    return errs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--device", default="cuda",
                        help="cuda (NCCL, one card a rank; raises without "
                             "one) or cpu (gloo)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from interactive_vit_tpu_torch.parallel import mesh as mesh_lib
    from interactive_vit_tpu_torch.runtime.device import exact_f32_matmuls

    device = mesh_lib.init_distributed(args.device)
    exact_f32_matmuls()
    if not dist.is_initialized():
        raise SystemExit(f"launch with torchrun --nproc-per-node {WORLD}")
    inputs = make_inputs(args.seed)
    tmp = [tempfile.mkdtemp(prefix="ivt-dryrun-") if dist.get_rank() == 0
           else ""]
    dist.broadcast_object_list(tmp, src=0)
    try:
        got = run_cases(inputs, device, ckpt_dir=tmp[0])
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(tmp[0], ignore_errors=True)
    errs = check(got, reference(inputs))
    if dist.get_rank() == 0:
        for group in sorted(errs):
            print(f"dryrun {group}: ok, max_abs_err {errs[group]:.3g} "
                  f"(tolerance {TOLERANCE[group]:g})")
        print(f"dryrun refusals: ok ({len(REFUSALS)} texts)")
        print("dryrun checkpoints: ok (mesh -> one rank and one rank -> "
              "mesh round-trip bit for bit)")
        print(f"dryrun_multichip ok: {WORLD} ranks on {device.type} "
              f"(data=2,model=2; data=4; data=2,stage=2), train loss "
              f"{got['train3_loss'][-1]:.4f}")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
