"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``interactive_vit_tpu_torch`` through its main paths and fails
(non-zero exit, no result line) on the first phase that goes wrong:

1. device  -- a CUDA card must be present; TF32 is turned off; prints the
   card's name and power limit as ``nvidia-smi`` reports them.
2. build   -- builds the eight hand-written kernel sources from ``csrc/``
   with nvcc, one compiler process each, all at once (the s8 mode of the
   block is a mode of ``fused_attn_block.cu``, and the two trainable
   attentions share ``flash_attention.cu`` forward and
   ``attention_bwd.cu`` backward: ten kernels).
3. kernel  -- each kernel against its plain PyTorch version on the card,
   with max abs errors against the stated bounds (which must refuse the
   kernel's maps or mean zeroed or halved) and CUDA-event times (turns
   plain, kernel, kernel, plain):
   * the fused attention block at the vit_b16 (B=1 and 8), vit_t16 and
     vit_t16@256 (N=257) block shapes, bf16 and f32, maps off / maps +
     head-mean / a subset;
   * the headwise attention block at the vit_l16@384 block shape (B=1 and
     4), bf16 and f32, maps off / maps + mean / heads (0, 7, 15) + mean;
   * the flash attention at the dinov2_s14_reg@518 shape (6 heads, N=1374,
     dh=64) and at N=577, maps on and off, plus keys masked beyond
     n_real=1374 of N=1408; ``scaled_dot_product_attention`` is timed
     beside it with maps off (a yardstick; the port never calls it);
   * the window attention at swin_t's four stage shapes (maps 56/28/14/7,
     widths 96/192/384/768, 3/6/12/24 heads, window 7; each at B=1 and
     B=8) and one swin_b stage (14x14, 512, 16 heads), unshifted and, where
     the stage has more than one window, shifted by 3 with the seam mask
     (masked pairs must get probs of exactly 0 in bf16), maps off and on,
     fast and exact softmax, bf16 and f32; ``scaled_dot_product_attention``
     with the additive bias + mask is timed beside the attention part;
   * the fused MLP at vit_b16 (197 x 768) and at swin_t's four stages
     (3136 x 96, 784 x 192, 196 x 384, 49 x 768), each at B=1 and 8, bf16
     and f32; the bound must refuse a kernel that returned the residual
     alone;
   * the online flash attention at the dinov2_s14_reg@742 shape (6 heads,
     N=2814, dh=64; B=1 and 8, and keys masked beyond n_real=2800), bf16
     and f32, against its plain version at the kernel's key tile (128);
     ``scaled_dot_product_attention`` timed beside it;
   * the W8A8 MLP at vit_b16 (197 x 768, B=1 and 8), bf16 and f32: its
     s32 accumulators equal to the exact products of its own int8
     activations, those activations the plain version's but in at most 1%
     of places (by 1), y within its bound; ``torch._int_mm`` timed on the
     fc1 product;
   * the s8 mode of the fused block at vit_b16 (B=1 and 8), bf16 and f32,
     maps off / maps + mean / a subset with s8 scores and PV, and maps +
     mean with s8 scores only;
   * the trainable attention, forward and backward (o, dq, dk, dv), in
     both layouts: ``attention_train`` on [B, H, N, dh] at vit_b16's and
     vit_t16's train shapes (B=64, 12 or 3 heads, N=197, dh=64) and with
     keys masked beyond n_real=197 of N=208; ``attention_train_packed`` on
     the head-major [B, N, 3D] at vit_b16's and at the masked shape; bf16
     and f32, each bound refusing a gradient zeroed or halved;
     ``scaled_dot_product_attention`` forward + backward timed beside.
4. slice   -- eight paths through the HTTP server in-process, seeded random
   weights, the saved graphs copied to a temp dir (a missing chain graph
   is generated there). Each path's launch counts are set to 0 just
   before it and read just after:
   * vit_b16 (+ one vit_t16 request), bf16: ``attn`` + ``r`` on blocks
     0, 5, 11 and the logits, 5 requests in sequence and 4 at once; the
     fused block kernel in every block;
   * vit_l16 @384, bf16: ``attn`` + ``r`` on block 0, ``attn`` of heads
     (0, 7, 15) + ``r`` on block 12, ``r`` on block 23, the logits; 3 in
     sequence and 2 at once; the headwise kernel in all 24 blocks;
   * dinov2_s14_reg @518, bf16: ``attn`` + ``r`` on block 0, ``r`` on
     blocks 6 and 11, the CLS features; 3 in sequence; the flash kernel
     in all 12 blocks;
   * swin_t, bf16, a 240 x 300 image through the bicubic transform:
     ``attn`` on stages.0.0, stages.0.1 (shifted), stages.2.5 (window 2
     only) and stages.3.1 (heads 0, 11, 23), the logits; 5 in sequence and
     4 at once; the window kernel in all 12 blocks, 12 launches a request;
   * dinov2_s14_reg@742, bf16: the block outputs ``o`` of blocks 0, 6 and
     11 and the CLS features, 2 in sequence; the online flash kernel in
     all 12 blocks;
   * vit_t16@256 from the repository's saved graph: ``attn`` + ``r`` on
     blocks 0 and 6, ``r`` on block 11, the logits; the fused block kernel;
   * vit_b16 ``--dtype int8w8a8 --attn int8-scores``: the vit_b16 taps, 3
     in sequence; the W8A8 MLP kernel and the s8 block in every block
     (12 + 12 launches a request), against the plain path with the two
     kernels' plain versions (whose quantizers round half up, as the
     kernels');
   * vit_b16 ``--dtype int8`` (weight-only): no kernel launches;
   each checked for shapes, finiteness, probs rows summing to 1 and
   agreement with the port's plain path on the card (the kernels' plain
   versions in every block) and for the launches of every kernel, then
   one f32 request per path of a float dtype whose output must match the
   plain path at 1e-4. Each path also prints its
   ``/metrics`` p50s and one ``executor.run`` under ``torch.profiler``
   (device busy share, the kernels that take the most time).
   Then the monolithic forwards ``vit.forward`` (vit_b16) and
   ``swin.forward`` (swin_t) at B=1 and B=8, bf16, with the block or window
   kernel and the fused MLP kernel from ``default_mlp_impl("fused")``,
   against the same forwards with the plain versions: 12 MLP launches a
   call.
5. train   -- ``tools.train.main`` in-process, launch counts zeroed
   before each run and read after it:
   (a) vit_b16 @224, ``--dtype mixed --attn auto --batch 64 --steps 10
       --memorize 64``: ``--remat auto`` must resolve to off; exactly 12
       packed forward and 12 backward launches a step; a finite loss at
       every step, the last below the first; ms a step and images/s, and
       one profiled step (device busy / idle, the top kernels) beside one
       of the plain attention;
   (b) vit_t16, ``--dtype bfloat16 --batch 64 --steps 5``: 12 + 12
       launches a step of ``attention_train`` ([B, H, N, dh], 3 heads), no
       packed launch; timed and profiled as (a);
   (c) vit_b16 with ``--remat on``, 2 steps: 24 forward launches a step
       (the checkpointed blocks run again in the backward);
   (d) the first step's gradients in f32, vit_b16 at B=8: the kernels
       (head-major params, unpermuted) against the plain attention on the
       same params and batch, every parameter within its bound.
6. result  -- a JSON line describing the kernels, then the final line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX. Weights are random (seeded), so the logits are
meaningless as classifications; what is checked is that the served path
and the plain path agree.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = "interactive_vit_tpu_torch/csrc/"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "fused_attn_block": (CSRC + "fused_attn_block.cu",
                         "interactive_vit_tpu/ops/fused_block.py:205"),
    "headwise_attn_block": (CSRC + "headwise_attn_block.cu",
                            "interactive_vit_tpu/ops/fused_block.py:501"),
    "flash_attention": (CSRC + "flash_attention.cu",
                        "interactive_vit_tpu/ops/flash_attention.py:87"),
    "fused_window_attn": (CSRC + "fused_window_attn.cu",
                          "interactive_vit_tpu/ops/fused_window.py:128"),
    "fused_mlp_block": (CSRC + "fused_mlp_block.cu",
                        "interactive_vit_tpu/ops/fused_mlp.py:60"),
    "flash_attention_online": (CSRC + "flash_attention_online.cu",
                               "interactive_vit_tpu/ops/flash_attention.py:188"),
    "fused_mlp_w8a8_block": (CSRC + "fused_mlp_w8a8_block.cu",
                             "interactive_vit_tpu/ops/fused_mlp.py:154"),
    # the s8 mode (int8_scores) of the block kernel: the same source
    "fused_attn_block_s8": (CSRC + "fused_attn_block.cu",
                            "interactive_vit_tpu/ops/fused_block.py:205"),
    # forward: flash_attention.cu on strided views; backward: the new source
    "attention_train": (CSRC + "attention_bwd.cu",
                        "interactive_vit_tpu/ops/attention_vjp.py:141"),
    "attention_train_packed": (CSRC + "attention_bwd.cu",
                               "interactive_vit_tpu/ops/attention_vjp.py:293"),
}

# Bounds of a kernel against its plain version (same inputs, same cast
# points; only the order of f32 sums differs). f32: 1e-4 absolute. bf16
# keeps 8 significant bits: a sum that lands within its f32 rounding error
# of a bf16 rounding boundary rounds to the neighbour, one ulp (2^-8 to
# 2^-7 of the element) in a qkv, head-output or y element. y (and the flash
# output) may move by a few ulps at the top of its range: 2^-6 of its
# scale. A probs or mean element moves in proportion to itself: a one-ulp
# flip in a q or k element (the fused kernel computes its own qkv) shifts
# a score by up to 2^-7 |q_i k_i| dh^-0.5 and the probs by that share,
# before their own rounding. So the bound is per element: 2^-5 of the
# plain value (four ulps), plus 1e-6 for values at or near 0, and never
# above 2^-7. (A bound on the whole tensor would not do: at N=1374 a
# typical probability is 7e-4.)
F32_BOUND = 1e-4
BF16_Y_REL = 2.0 ** -6
BF16_P_REL = 2.0 ** -5
BF16_P_ABS = 1e-6
BF16_P_CAP = 2.0 ** -7
# A served bf16 path against the plain path through all its blocks: the
# rare one-ulp flips above enter the residual stream and propagate through
# later blocks, so each output is bound by its own scale: within 2^-4 of
# its largest value (the head output: of max(1, its largest value)).
SLICE_REL = 2.0 ** -4
# bf16 probs rows: each of N probs rounds by <= 2^-9 relative, so a row
# sums to 1 within 2^-9; bound 2^-7.
ROW_SUM_BOUND = 2.0 ** -7
# The int8 kernels (the W8A8 MLP, the s8 block), in both dtypes. Their s32
# products are exact, but each int8 is the rounding of an f32 (or bf16)
# value that the kernel and the plain version compute in another order, so
# a value within that difference of a .5 boundary rounds to the other int8.
# One flipped int8 of q or k moves a score by at most scale * max|q| *
# max|k| / 127 (~0.02 at the shapes below) and its probability by about
# that share of itself; one flipped int8 of p moves o by at most ps *
# max|v|, one of the MLP's activations y by one quantization step through
# a product. So y is held to 2^-6 of its scale (as bf16's y) in f32 too,
# and probs and mean, per element, to 2^-4 of the plain value plus 1e-6,
# never above 2^-5; a tap zeroed or halved still fails. The W8A8 MLP's
# integer stages are checked exactly instead: acc1 = q1 @ fc1_q and acc2 =
# q2 @ fc2_q on the kernel's own int8 activations, which differ from the
# plain version's in at most 1% of places (``check_w8a8_parts``).
S8_P_REL = 2.0 ** -4
S8_P_CAP = 2.0 ** -5
W8A8_Q_SHARE = 0.01
# The trainable attention's o, dq, dk, dv against the plain versions. f32:
# only the order of f32 sums differs (scores over dh, delta and dq over N
# keys, dk and dv over N queries), ~1e-6 of a tensor's largest value; bound
# 1e-5 of it. bf16: both round P (for dv), ds and the outputs at the same
# points; a value within its f32 error of a bf16 boundary rounds to the
# neighbour, one ulp of the element, or one ulp of one term inside a sum of
# N; so each element within 2^-6 of its plain value (two ulps) plus 2^-8 of
# the tensor's largest value. A gradient zeroed or halved fails either way.
TRAIN_F32_REL = 1e-5
TRAIN_BF16_REL = 2.0 ** -6
TRAIN_BF16_SCALE = 2.0 ** -8
# First-step f32 gradients of vit_b16 (12 blocks), the kernels against the
# plain attention: the per-block differences above (~1e-6 of the scale)
# pass through 12 blocks forward and back; each parameter's gradient is
# held to 1e-4 of its largest value, the loss to 1e-5.
TRAIN_GRAD_REL = 1e-4
# vit_b16's and vit_t16's train attention shapes: (B, heads, N, dh)
TRAIN_B16 = (64, 12, 197, 64)
TRAIN_T16 = (64, 3, 197, 64)

# The least time the card could take (H100 SXM published peaks): bytes over
# the memory rate, operations over the peak rate for the inputs' type (bf16
# tensor cores; f32 outside them).
HBM_BYTES_PER_S = 3.35e12

# The new kernels' main-path shapes: dinov2_s14_reg@742's attention (heads,
# tokens, head width) and vit_b16's MLP (tokens, width, hidden).
ONLINE_SHAPE = (6, 2814, 64)
W8A8_SHAPE = (197, 768, 3072)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card from CUDA events, after a warm-up
    and a synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_turns(kernel_fn, plain_fn):
    """(kernel ms, plain ms), each the mean of two turns taken in the
    order plain, kernel, kernel, plain."""
    t_p1 = time_ms(plain_fn)
    t_k1 = time_ms(kernel_fn)
    t_k2 = time_ms(kernel_fn)
    t_p2 = time_ms(plain_fn)
    return (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2


def bound(nbytes: float, flops, dtype_name: str):
    """(bound_ms, bound_by) for work that moves ``nbytes`` and does
    ``flops`` multiply-adds x 2 on inputs of ``dtype_name`` (or, as a dict,
    that many on inputs of each type: the times add)."""
    if not isinstance(flops, dict):
        flops = {dtype_name: flops}
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[t] for t, n in flops.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def block_cost(b, n, d, heads, esize, n_maps, mean):
    """Bytes and FLOPs of one attention block (LN1 + QKV + attention +
    projection + residual): x, LN, qkv and proj weights read once, y, the
    maps of ``n_maps`` heads and the mean written once."""
    nbytes = esize * (2 * b * n * d + 4 * d * d + 6 * d
                      + n_maps * b * n * n + (b * n * n if mean else 0))
    flops = (2 * b * n * d * 3 * d + 4 * b * heads * n * n * (d // heads)
             + 2 * b * n * d * d)
    return nbytes, flops


def flash_cost(b, h, n, dh, esize, maps):
    """Bytes and FLOPs of attention on q, k, v [b, h, n, dh]."""
    nbytes = esize * (4 * b * h * n * dh + (b * h * n * n if maps else 0))
    return nbytes, 4 * b * h * n * n * dh


def random_block(d: int, dtype, device, seed: int):
    """One block's attention parameters with non-trivial LN and biases."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g) * std + mean).to(
            device=device, dtype=dtype)

    return {
        "ln1_s": rnd(d, std=0.1, mean=1.0), "ln1_b": rnd(d, std=0.1),
        "qkv_w": rnd(d, 3 * d, std=d ** -0.5), "qkv_b": rnd(3 * d, std=0.1),
        "proj_w": rnd(d, d, std=d ** -0.5), "proj_b": rnd(d, std=0.1),
    }


def output_bound(i, ref, dtype, s8=False):
    """(bound of each element of output ``i`` against the plain ``ref``, a
    tensor or a number; its description). ``s8``: the int8 kernels'."""
    import torch

    if s8 and i > 0:
        return ((S8_P_REL * ref.float().abs() + BF16_P_ABS).clamp(
            max=S8_P_CAP), f"min({S8_P_CAP:g}, {S8_P_REL:g}|ref|+"
                           f"{BF16_P_ABS:g})")
    if dtype == torch.float32 and not s8:
        return F32_BOUND, f"{F32_BOUND:g}"
    if i == 0:
        bound = BF16_Y_REL * max(1.0, ref.abs().max().item())
        return bound, f"{bound:.3g}"
    return ((BF16_P_REL * ref.float().abs() + BF16_P_ABS)
            .clamp(max=BF16_P_CAP),
            f"min({BF16_P_CAP:g}, {BF16_P_REL:g}|ref|+{BF16_P_ABS:g})")


def check_outputs(tag, got, ref, dtype, labels, quiet=False, s8=False):
    """Max abs errors of ``got`` against ``ref`` (same layout, ``None``
    where absent) and their bounds; raises outside a bound. The first
    tensor is y (or the attention output), the rest probs / mean."""
    errs, parts, ok = [], [], True
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            if g is not None:
                raise AssertionError(f"{tag}: unexpected output {i}")
            continue
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{tag}: output {i} is {tuple(g.shape)} "
                                 f"{g.dtype}, plain {tuple(r.shape)} "
                                 f"{r.dtype}")
        bound, text = output_bound(i, r, dtype, s8)
        diff = (g.float() - r.float()).abs()
        use = (diff / bound).max().item()
        ok = ok and use <= 1.0
        errs.append(diff.max().item())
        parts.append(f"{labels[i]}={errs[-1]:.3g} (bound {text}, "
                     f"{use:.2f} of it)")
    line = f"  {tag}: max abs err " + ", ".join(parts)
    if not ok:
        if not quiet:
            log(line)
        raise AssertionError(f"{tag} outside its bounds")
    return errs, line


def check_bounds_refuse(tag, got, ref, dtype, labels, s8=False,
                        first=1) -> None:
    """The bounds must refuse a kernel whose outputs from ``first`` on (by
    default the maps and mean; 0 takes y too) are zero or half the plain
    values: each such corruption of ``got`` has to fail."""
    for i in range(first, len(got)):
        if got[i] is None:
            continue
        for factor in (0.0, 0.5):
            bad = list(got)
            bad[i] = got[i] * factor
            try:
                check_outputs(tag, bad, ref, dtype, labels, quiet=True,
                              s8=s8)
            except AssertionError:
                continue
            raise AssertionError(f"{tag}: {labels[i]} x {factor} passed "
                                 f"the bounds")


def phase_block_kernel(device, name, kernel, plain, shapes, modes, served,
                       s8=False):
    """A block kernel against its plain version over ``shapes`` x dtypes x
    ``modes``; returns the numbers of the ``served`` (shape name, batch,
    dtype, mode) for the result line. ``s8``: the s8 mode's bounds, and
    its attention products counted as int8 operations."""
    import torch

    out = {}
    for sname, b, n, d, heads in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            p = random_block(d, dtype, device, seed=b * 100 + d)
            x = torch.randn((b, n, d), generator=torch.Generator()
                            .manual_seed(d + b)).to(device=device, dtype=dtype)
            for mode, kw in modes(heads).items():
                got = kernel(x, p, heads, 1e-6, **kw)
                ref = plain(x, p, heads, 1e-6, **kw)
                torch.cuda.synchronize()
                tag = f"{name} {sname} B={b} {dt} {mode}"
                labels = ("y", "probs", "mean")
                errs, line = check_outputs(tag, got, ref, dtype, labels,
                                           s8=s8)
                check_bounds_refuse(tag, got, ref, dtype, labels, s8=s8,
                                    first=0)
                if mode != "subset":
                    t_k, t_p = time_turns(
                        lambda: kernel(x, p, heads, 1e-6, **kw),
                        lambda: plain(x, p, heads, 1e-6, **kw))
                    line += f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms"
                    if (sname, b, dt, mode) == served:
                        sel = kw.get("attn_heads")
                        n_maps = (0 if not kw.get("want_attn") else
                                  len(sel) if sel else heads)
                        nbytes, flops = block_cost(
                            b, n, d, heads, x.element_size(), n_maps,
                            kw.get("want_mean", False))
                        if s8:  # QK^T and PV in int8, the GEMMs in dt
                            attn = 4 * b * heads * n * n * (d // heads)
                            flops = {dt: flops - attn, "int8": attn}
                        bms, by = bound(nbytes, flops, dt)
                        out = {"max_abs_err": max(errs), "ms": t_k,
                               "plain_ms": t_p, "bound_ms": bms,
                               "bound_by": by, "library_ms": None}
                        ops = sum(flops.values()) if s8 else flops
                        line += (f"; bound {bms:.5f} ms ({by}: "
                                 f"{nbytes / 1e6:.2f} MB, "
                                 f"{ops / 1e9:.3f} G operations)")
                log(line)
    return out


def phase_flash_kernel(device) -> dict:
    """The flash kernel against its plain version; returns the served
    configuration's numbers (dinov2_s14_reg, bf16, maps off) for the result
    line, SDPA's time beside them."""
    import torch
    import torch.nn.functional as F

    from interactive_vit_tpu_torch.ops import flash_attention as fa

    out = {}
    cases = [("dinov2_s14_reg", (1, 6, 1374, 64), None),
             ("vit_l16", (1, 16, 577, 64), None),
             ("padded", (1, 6, 1408, 64), 1374)]
    for cname, shape, n_real in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            g = torch.Generator().manual_seed(shape[2])
            q, k, v = [(torch.randn(shape, generator=g) * 2).to(device, dtype)
                       for _ in range(3)]
            for maps in (False, True):
                if n_real is not None and not maps:
                    continue
                kw = {"want_attn": maps, "n_real": n_real}
                got = fa.flash_attention(q, k, v, **kw)
                ref = fa.flash_attention_reference(q, k, v, **kw)
                torch.cuda.synchronize()
                tag = (f"flash_attention {cname} {shape} {dt} "
                       f"maps {'on' if maps else 'off'}"
                       + (f" n_real={n_real}" if n_real else ""))
                errs, line = check_outputs(tag, got, ref, dtype,
                                           ("o", "probs"))
                check_bounds_refuse(tag, got, ref, dtype, ("o", "probs"))
                if n_real is not None:
                    if not torch.all(got[1][..., n_real:] == 0):
                        raise AssertionError(f"{tag}: masked keys got probs")
                    log(line)
                    continue
                t_k, t_p = time_turns(
                    lambda: fa.flash_attention(q, k, v, **kw),
                    lambda: fa.flash_attention_reference(q, k, v, **kw))
                nbytes, flops = flash_cost(*shape, q.element_size(), maps)
                bms, by = bound(nbytes, flops, dt)
                line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms; bound "
                         f"{bms:.5f} ms ({by})")
                t_lib = None
                if not maps:
                    t_lib = time_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v))
                    line += f"; scaled_dot_product_attention {t_lib:.4f} ms"
                if (cname, dt, maps) == ("dinov2_s14_reg", "bfloat16", False):
                    out = {"max_abs_err": max(errs), "ms": t_k,
                           "plain_ms": t_p, "bound_ms": bms, "bound_by": by,
                           "library_ms": t_lib}
                log(line)
    return out


def window_cost(b, res, c, heads, win, esize, maps, masked):
    """Bytes and FLOPs of one window-attention branch (QKV + W-MSA + proj)
    on a [b, res, res, c] map: the map, the weights, the f32 bias (and
    seam mask) read once; the branch output (and the maps) written once."""
    t, nw = win * win, (res // win) ** 2
    rows = b * res * res
    nbytes = (esize * (2 * rows * c + 4 * c * c + 4 * c
                       + (b * nw * heads * t * t if maps else 0))
              + 4 * (heads * t * t + (nw * t * t if masked else 0)))
    flops = (2 * rows * c * 3 * c + 2 * rows * c * c
             + 4 * b * nw * heads * t * t * (c // heads))
    return nbytes, flops


def mlp_cost(rows, d, md, esize):
    """Bytes and FLOPs of one MLP branch on ``rows`` rows of width d: x,
    LN, both weight matrices and biases read once, y written once."""
    return esize * (2 * rows * d + 2 * d * md + md + 3 * d), 4 * rows * d * md


def check_window_case(tag, fw, args, dtype, maps, fast):
    """One launch of the window kernel against its plain version, the
    bounds' refusal of a zeroed or halved tap, and the seam pairs of a
    shifted block. Returns (max abs errs, the line for the log)."""
    import torch

    mask = args[-1]
    kw = {"want_attn": maps, "fast_softmax": fast}
    got = fw.fused_window_attn(*args, **kw)
    ref = fw.fused_window_attn_reference(*args, **kw)
    torch.cuda.synchronize()
    errs, line = check_outputs(tag, got, ref, dtype, ("a", "probs"))
    check_bounds_refuse(tag, got, ref, dtype, ("a", "probs"))
    if maps and mask is not None:
        seam = got[1].float()[(mask[None, :, None] < 0).expand_as(got[1])]
        # exp(-100): exactly 0 in bf16, a denormal in f32
        clean = (seam == 0 if dtype == torch.bfloat16 else seam < 1e-37)
        if seam.numel() == 0 or not bool(clean.all()):
            raise AssertionError(f"{tag}: masked seam pairs got probs")
    return errs, line


def phase_window_kernel(device) -> dict:
    """The window-attention kernel against its plain version; returns the
    numbers of the shape most of a served swin_t request's launches have
    (stage 2: 6 of 12 blocks; bf16, unshifted, maps off)."""
    import itertools

    import torch
    import torch.nn.functional as F

    from interactive_vit_tpu_torch.models import swin
    from interactive_vit_tpu_torch.ops import fused_window as fw

    out = {}
    win = 7
    t = win * win
    # every shape a served request (B=1; concurrent requests batch) or the
    # monolithic forward (B=1 and 8) gives the kernel, and one swin_b stage
    stage_shapes = [("swin_t stage0", 56, 96, 3), ("swin_t stage1", 28, 192, 6),
                    ("swin_t stage2", 14, 384, 12),
                    ("swin_t stage3", 7, 768, 24)]
    shapes = ([(sname, b, res, c, heads)
               for sname, res, c, heads in stage_shapes for b in (1, 8)]
              + [("swin_b stage2", 1, 14, 512, 16)])
    for (sname, b, res, c, heads), dtype in itertools.product(
            shapes, (torch.bfloat16, torch.float32)):
        nw = (res // win) ** 2
        dt = str(dtype).replace("torch.", "")
        g = torch.Generator().manual_seed(res * 1000 + c + b)

        def rnd(*shape, std=1.0):
            return (torch.randn(shape, generator=g) * std).to(
                device=device, dtype=dtype)

        p = {"qkv_w": rnd(c, 3 * c, std=c ** -0.5), "qkv_b": rnd(3 * c, std=0.1),
             "proj_w": rnd(c, c, std=c ** -0.5), "proj_b": rnd(c, std=0.1)}
        y = rnd(b, res, res, c)
        bias = rnd(heads, t, t, std=0.5)
        # a stage of one window has no shifted block (the shift clamps to 0)
        for shift, maps in itertools.product((0, 3) if nw > 1 else (0,),
                                             (False, True)):
            mask = swin.shift_attn_mask(res, win, shift)
            if mask is not None:
                mask = torch.from_numpy(mask).to(device)
            args = (y, p, heads, win, bias, mask)
            tag = (f"fused_window_attn {sname} B={b} {dt} shift={shift} "
                   f"maps {'on' if maps else 'off'}")
            exact_errs, _ = check_window_case(tag + " exact", fw, args, dtype,
                                              maps, fast=False)
            errs, line = check_window_case(tag, fw, args, dtype, maps,
                                           fast=True)
            kw = {"want_attn": maps}
            t_k, t_p = time_turns(
                lambda: fw.fused_window_attn(*args, **kw),
                lambda: fw.fused_window_attn_reference(*args, **kw))
            nbytes, flops = window_cost(b, res, c, heads, win,
                                        y.element_size(), maps,
                                        mask is not None)
            bms, by = bound(nbytes, flops, dt)
            log(line + f"; exact softmax {max(exact_errs):.3g}; kernel "
                f"{t_k:.4f} ms, plain {t_p:.4f} ms; bound {bms:.5f} ms ({by}: "
                f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
            if (sname, b, dt, shift, maps) == ("swin_t stage2", 1, "bfloat16",
                                               0, False):
                out = {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p,
                       "bound_ms": bms, "bound_by": by, "library_ms": None}
        if b == 1 and dtype == torch.bfloat16:
            # yardstick for the attention part alone (no QKV, no proj): one
            # library call on ready-made q, k, v with the additive bias; the
            # port never calls it
            q, k, v = (rnd(b, nw, heads, t, c // heads) for _ in range(3))
            add = bias[None].expand(nw, heads, t, t)
            t_lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=add))
            log(f"  {sname} {dt}: scaled_dot_product_attention on the "
                f"attention part (q, k, v [{b}, {nw}, {heads}, {t}, "
                f"{c // heads}] + bias) {t_lib:.4f} ms")
    return out


def phase_mlp_kernel(device) -> dict:
    """The fused MLP kernel against its plain version; returns the numbers
    of the vit_b16 shape (197 x 768, B=1, bf16) for the result line."""
    import torch

    from interactive_vit_tpu_torch.ops import fused_mlp as fm

    out = {}
    # every shape the monolithic forwards give the kernel (B=1 and 8):
    # vit_b16's block and swin_t's four stages, each width its own
    # instantiation of the kernel
    shapes = [(sname, b, n, d, eps)
              for sname, n, d, eps in (("vit_b16", 197, 768, 1e-6),
                                       ("swin_t stage0", 3136, 96, 1e-5),
                                       ("swin_t stage1", 784, 192, 1e-5),
                                       ("swin_t stage2", 196, 384, 1e-5),
                                       ("swin_t stage3", 49, 768, 1e-5))
              for b in (1, 8)]
    for sname, b, n, d, eps in shapes:
        md = 4 * d
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            g = torch.Generator().manual_seed(n + d + b)

            def rnd(*shape, std=1.0, mean=0.0):
                return (torch.randn(shape, generator=g) * std + mean).to(
                    device=device, dtype=dtype)

            p = {"ln2_s": rnd(d, std=0.1, mean=1.0), "ln2_b": rnd(d, std=0.1),
                 "fc1_w": rnd(d, md, std=d ** -0.5),
                 "fc1_b": rnd(md, std=0.1),
                 "fc2_w": rnd(md, d, std=md ** -0.5),
                 "fc2_b": rnd(d, std=0.1)}
            x = rnd(b, n, d)
            got = fm.fused_mlp_block(x, p, eps)
            ref = fm.fused_mlp_block_reference(x, p, eps)
            torch.cuda.synchronize()
            tag = f"fused_mlp_block {sname} B={b} {n}x{d} {dt}"
            errs, line = check_outputs(tag, (got,), (ref,), dtype, ("y",))
            try:  # the bound must refuse the residual alone
                check_outputs(tag, (x,), (ref,), dtype, ("y",), quiet=True)
            except AssertionError:
                pass
            else:
                raise AssertionError(f"{tag}: x alone passed the bound")
            t_k, t_p = time_turns(
                lambda: fm.fused_mlp_block(x, p, eps),
                lambda: fm.fused_mlp_block_reference(x, p, eps))
            nbytes, flops = mlp_cost(b * n, d, md, x.element_size())
            bms, by = bound(nbytes, flops, dt)
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms; bound "
                     f"{bms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
                     f"{flops / 1e9:.3f} GFLOP)")
            if (sname, b, dt) == ("vit_b16", 1, "bfloat16"):
                out = {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p,
                       "bound_ms": bms, "bound_by": by, "library_ms": None}
            log(line)
    return out


def online_plain(q, k, v, want_attn=False, n_real=None):
    """``attn_impl`` of the served dinov2_s14_reg@742 path's plain version:
    the online kernel's plain version (no maps)."""
    from interactive_vit_tpu_torch.ops import flash_attention as fa

    return fa.flash_attention_online_reference(q, k, v, n_real), None


def phase_online_kernel(device) -> dict:
    """The online flash kernel against its plain version at its own key
    tile, at the dinov2_s14_reg@742 shape (6 heads, N=2814, dh=64; B=1 and
    8, and keys masked beyond n_real=2800); returns the B=1 bf16 numbers,
    SDPA's time beside them."""
    import torch
    import torch.nn.functional as F

    from interactive_vit_tpu_torch.ops import flash_attention as fa

    out = {}
    heads, n, dh = ONLINE_SHAPE
    for b, n_real in ((1, None), (8, None), (1, n - 14)):
        shape = (b, heads, n, dh)
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            g = torch.Generator().manual_seed(b)
            q, k, v = [(torch.randn(shape, generator=g) * 2).to(device, dtype)
                       for _ in range(3)]
            got = fa.flash_attention_online(q, k, v, n_real)
            ref = fa.flash_attention_online_reference(
                q, k, v, n_real, block_k=fa.ONLINE_BLOCK_K)
            torch.cuda.synchronize()
            tag = (f"flash_attention_online dinov2_s14_reg@742 {shape} {dt}"
                   + (f" n_real={n_real}" if n_real else ""))
            errs, line = check_outputs(tag, (got,), (ref,), dtype, ("o",))
            check_bounds_refuse(tag, (got,), (ref,), dtype, ("o",), first=0)
            if n_real is not None:
                log(line)
                continue
            t_k, t_p = time_turns(
                lambda: fa.flash_attention_online(q, k, v),
                lambda: fa.flash_attention_online_reference(q, k, v))
            nbytes, flops = flash_cost(*shape, q.element_size(), False)
            bms, by = bound(nbytes, flops, dt)
            t_lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            log(line + f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms; bound "
                f"{bms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
                f"{flops / 1e9:.3f} GFLOP); scaled_dot_product_attention "
                f"{t_lib:.4f} ms")
            if (b, dt) == (1, "bfloat16"):
                out = {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p,
                       "bound_ms": bms, "bound_by": by, "library_ms": t_lib}
    return out


def check_w8a8_parts(tag, p, parts, rparts) -> str:
    """The W8A8 kernel's integer stages: its s32 accumulators equal the
    exact products of its own int8 activations (a zeroed or halved
    accumulator fails), and those activations are the plain version's but
    for at most ``W8A8_Q_SHARE`` of them: q1 off by 1 (an LN value one ulp
    away), q2 off by at most 2 in rows whose q1 agrees (an h value and the
    row's scale each one bf16 ulp away); a row whose q1 differs moves its
    h by a whole fc1 quantization step, which only y's bound holds."""
    import torch

    from interactive_vit_tpu_torch.ops import quant

    notes = []
    q1_rows = (parts["q1"] == rparts["q1"]).all(dim=-1, keepdim=True)
    for acc, q, w, most in (("acc1", "q1", "fc1_w", 1),
                            ("acc2", "q2", "fc2_w", 2)):
        exact = quant.int_matmul(parts[q], p[w][quant.AQKEY])
        if not torch.equal(parts[acc], exact):
            raise AssertionError(f"{tag}: {acc} is not the exact product")
        if torch.equal(parts[acc] * 0, exact) or torch.equal(
                parts[acc] // 2, exact):
            raise AssertionError(f"{tag}: a zeroed or halved {acc} passed")
        diff = (parts[q].int() - rparts[q].int()).abs()
        share = (diff > 0).float().mean().item()
        held = (diff * q1_rows).max().item()
        if held > most or share > W8A8_Q_SHARE:
            raise AssertionError(f"{tag}: {q} differs from the plain "
                                 f"version's in {share:.3g} of places, by up "
                                 f"to {held} where q1 agrees")
        notes.append(f"{acc} exact, {q} differs in {share:.3g} (by up to "
                     f"{diff.max().item()})")
    return ", ".join(notes)


def phase_w8a8_kernel(device) -> dict:
    """The W8A8 MLP kernel against its plain version at vit_b16 (197 x 768,
    hidden 3072; B=1 and 8), bf16 and f32: exact integer stages, y within
    its bound; returns the B=1 bf16 numbers, ``torch._int_mm``'s time for
    the fc1 product beside them."""
    import torch

    from interactive_vit_tpu_torch.ops import fused_mlp as fm
    from interactive_vit_tpu_torch.ops import quant

    out = {}
    n, d, md = W8A8_SHAPE
    eps = 1e-6
    for b in (1, 8):
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            g = torch.Generator().manual_seed(b + 7)

            def rnd(*shape, std=1.0, mean=0.0):
                return (torch.randn(shape, generator=g) * std + mean).to(
                    device=device, dtype=dtype)

            p = {"ln2_s": rnd(d, std=0.1, mean=1.0), "ln2_b": rnd(d, std=0.1),
                 "fc1_w": quant.quantize_weight(rnd(d, md, std=d ** -0.5),
                                                "w8a8"),
                 "fc1_b": rnd(md, std=0.1),
                 "fc2_w": quant.quantize_weight(rnd(md, d, std=md ** -0.5),
                                                "w8a8"),
                 "fc2_b": rnd(d, std=0.1)}
            x = rnd(b, n, d)
            got, parts = fm.fused_mlp_w8a8_block(x, p, eps, want_parts=True)
            ref, rparts = fm.fused_mlp_w8a8_parts(x, p, eps)
            torch.cuda.synchronize()
            tag = f"fused_mlp_w8a8_block vit_b16 B={b} {n}x{d} {dt}"
            errs, line = check_outputs(tag, (got,), (ref,), dtype, ("y",),
                                       s8=True)
            check_bounds_refuse(tag, (got,), (ref,), dtype, ("y",), s8=True,
                                first=0)
            try:  # the bound must refuse the residual alone
                check_outputs(tag, (x,), (ref,), dtype, ("y",), quiet=True,
                              s8=True)
            except AssertionError:
                pass
            else:
                raise AssertionError(f"{tag}: x alone passed the bound")
            line += "; " + check_w8a8_parts(tag, p, parts, rparts)
            t_k, t_p = time_turns(lambda: fm.fused_mlp_w8a8_block(x, p, eps),
                                  lambda: fm.fused_mlp_w8a8_reference(x, p,
                                                                      eps))
            rows = b * n
            nbytes = (x.element_size() * (2 * rows * d + 3 * d + md)
                      + 2 * d * md + 4 * (md + d))
            ops = {"int8": 4 * rows * d * md}
            bms, by = bound(nbytes, ops, dt)
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms; bound "
                     f"{bms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
                     f"{ops['int8'] / 1e9:.3f} G int8 operations)")
            t_lib = None
            a = parts["q1"].reshape(rows, d)
            w1 = p["fc1_w"][quant.AQKEY]
            try:  # the fc1 product alone, one library call
                t_lib = time_ms(lambda: torch._int_mm(a, w1))
                line += f"; torch._int_mm (fc1 only) {t_lib:.4f} ms"
            except RuntimeError as e:
                line += f"; torch._int_mm refused: {str(e)[:80]}"
            if (b, dt) == (1, "bfloat16"):
                out = {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p,
                       "bound_ms": bms, "bound_by": by, "library_ms": t_lib}
            log(line)
    return out


def chain_graph(graph_obj, image, node_params=None):
    """A saved graph with per-node params and ``image`` bound to node 0."""
    from interactive_vit_tpu_torch.wire.schema import graph_from_json

    g = graph_from_json(graph_obj)
    for i, params in (node_params or {}).items():
        g.nodes[i].params.update(params)
    g.add_input(image, g.nodes[0], "o")
    return g


def chain_request(graph_obj, image, taps, node_params=None):
    """Request bytes for ``chain_graph`` with an explicit tap list."""
    from interactive_vit_tpu_torch.wire.codec import (
        REQUEST_MAGIC, Request, decode_message, encode_message,
    )

    g = chain_graph(graph_obj, image, node_params)
    obj, tensors = decode_message(Request.encode(g), expect_magic=REQUEST_MAGIC)
    obj["taps"] = [{"node": i, "channel": ch} for i, ch in taps]
    return encode_message(REQUEST_MAGIC, obj, tensors)


def profile_request(app, graph, taps, tag) -> None:
    """One ``executor.run`` of a served request under ``torch.profiler``
    (``report_profile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        app.executor.run(graph, taps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, wall_ms, f"{tag} profile of one executor.run")


def report_profile(prof, wall_ms: float, what: str) -> None:
    """Log a profile's host wall time, device busy time (the sum of kernel
    times: the port runs on one stream, so kernels do not overlap) and the
    kernels that take the most device time."""
    from torch.autograd import DeviceType

    kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(t for t, _, _ in kernels)
    if not kernels:
        log(f"  {what}: wall {wall_ms:.2f} ms; device time not measured "
            f"(the profiler saw no kernel)")
        return
    top = sorted(kernels, reverse=True)[:6]
    log(f"  {what}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}%, idle "
        f"{100 - 100 * busy / wall_ms:.1f}%); top: " + "; ".join(
            f"{name[:48]} x{n} {t:.3f} ms" for t, n, name in top))


def post(url: str, body: bytes) -> bytes:
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def serve(models, dtype_name, device, graphs_dir, attn="auto"):
    from interactive_vit_tpu_torch.serving.server import build_app

    app = build_app(models=models, graphs_dir=graphs_dir,
                    dtype_name=dtype_name, device=device, seed=0,
                    attn_impl_name=attn)
    httpd = app.serve("127.0.0.1", 0, background=True)
    return app, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop(app, httpd) -> None:
    httpd.shutdown()
    httpd.server_close()
    app.close()


class Path:
    """One served path: a model of ``family`` (the ``models`` module with
    its ``layer_fns``), its taps (graph node -> channels; a generated chain
    graph's node i is the model's layer i) and the launches of each kernel
    that one request makes (``kernels``: name -> count; every other kernel
    must launch no time). ``plain`` holds the ``layer_fns`` arguments that
    put the kernels' plain versions into every block. ``tap_shape(path,
    node, ch)`` gives a tap's expected shape and ``check_tap(path, node,
    arr, tag, bf16)`` holds what else the family asks of a tapped array.
    ``other``: a second Path served beside this one and asked once.
    ``dtype`` and ``attn``: the server's ``--dtype`` and ``--attn``;
    ``f32``: whether one float32 request follows."""

    def __init__(self, model, family, cfg, img, taps, kernels, plain,
                 tap_shape, seq, conc, check_tap=None, node_params=None,
                 other=None, dtype="bfloat16", attn="auto", f32=True):
        self.model, self.family, self.cfg = model, family, cfg
        self.img, self.tap_nodes = img, taps
        self.kernels, self.plain = kernels, plain
        self.dtype, self.attn, self.f32 = dtype, attn, f32
        self.tap_shape, self.check_tap = tap_shape, check_tap
        self.seq, self.conc = seq, conc
        self.node_params = node_params or {}
        self.other = other
        layers = family.layer_fns(cfg)
        self.names = [name for name, _, _ in layers]
        self.head_node = self.names.index("head")
        # the blocks are the layers with extra (tap) channels
        self.depth = sum(1 for _, extra, _ in layers if extra)
        self.head_shape = (1, cfg.num_classes or cfg.width)

    def taps(self):
        return ([(i, ch) for i, chs in self.tap_nodes.items() for ch in chs]
                + [(self.head_node, "o")])

    def params_of(self, node):
        return dict(self.node_params.get(node, {}))


def vit_tap_shape(path, node, ch):
    """Plain ViT: ``attn`` [1, heads or the selected ones, N, N], the
    head-mean ``r`` [1, N, N], a block's output ``o`` [1, N, D]."""
    from interactive_vit_tpu_torch.models.vit import parse_attn_heads

    sel = parse_attn_heads(path.params_of(node))
    n = path.cfg.tokens
    return {"attn": (1, len(sel) if sel else path.cfg.heads, n, n),
            "r": (1, n, n), "o": (1, n, path.cfg.width)}[ch]


def swin_stage_block(path, node):
    _, s, b = path.names[node].split(".")
    return int(s), int(b)


def swin_tap_shape(path, node, ch):
    """Swin: ``attn`` [1, nW, heads or the selected ones, T, T]; with
    ``attn_win`` the one window's [1, heads, T, T]."""
    from interactive_vit_tpu_torch.models.vit import parse_attn_heads

    cfg = path.cfg
    s, _ = swin_stage_block(path, node)
    params = path.params_of(node)
    sel = parse_attn_heads(params)
    t = cfg.window ** 2
    shape = (1, (cfg.stage_res(s) // cfg.window) ** 2,
             len(sel) if sel else cfg.heads[s], t, t)
    return shape[:1] + shape[2:] if params.get("attn_win") else shape


def swin_check_tap(path, node, arr, tag, bf16) -> None:
    """A shifted block's seam pairs get no attention: exactly 0 in bf16
    (exp(-100) rounds to 0), a denormal in f32."""
    cfg = path.cfg
    s, b = swin_stage_block(path, node)
    shift = cfg.stage_shift(s, b)
    if not shift or path.params_of(node):
        return
    mask = path.family.shift_attn_mask(cfg.stage_res(s), cfg.window, shift)
    seam = arr[np.broadcast_to(mask[None, :, None] < 0, arr.shape)]
    if seam.size == 0 or not (seam == 0 if bf16 else seam < 1e-37).all():
        raise AssertionError(f"{tag}: node {node} masked seam pairs got "
                             f"probs (max {seam.max()})")


def plain_taps(path, model, image, device):
    """The port's plain path on ``device`` with the served model's weights:
    the same layer chain with the kernels' plain versions in every block.
    Returns (head output, {node: {channel: tensor}})."""
    import torch

    fam, cfg = path.family, path.cfg
    x = torch.from_numpy(image).to(device)
    maps = {}
    with torch.inference_mode():
        for node, (name, extra, fn) in enumerate(
                fam.layer_fns(cfg, **path.plain)):
            p = fam.layer_params(model.params, name)
            if extra:
                want = frozenset(path.tap_nodes.get(node, ()))
                out = fn(p, {"o": x}, want=want,
                         node_params=path.params_of(node))
                if want:
                    maps[node] = {ch: out[ch] for ch in want}
            else:
                out = fn(p, {"o": x})
            x = out["o"]
    return x, maps


def check_response(raw, path, plain, tag, bf16=True):
    """Shapes, finiteness, row sums and agreement with the plain path.
    Returns ({output: max abs err}, {output: the share of its bound that
    err uses})."""
    from interactive_vit_tpu_torch.wire.codec import Response

    out = Response.decode(raw)
    head = out[path.head_node]["o"]
    if head.shape != path.head_shape:
        raise AssertionError(f"{tag}: head output shape {head.shape}")
    if not np.isfinite(head).all():
        raise AssertionError(f"{tag}: non-finite head output")
    p_head, p_maps = plain
    pairs = {"head": (head, p_head.float().cpu().numpy())}
    for i, chs in path.tap_nodes.items():
        for ch in chs:
            arr = out[i][ch]
            if arr.shape != path.tap_shape(path, i, ch):
                raise AssertionError(f"{tag}: node {i} {ch} {arr.shape}")
            if not np.isfinite(arr).all():
                raise AssertionError(f"{tag}: non-finite node {i} {ch}")
            if ch == "attn":
                row_err = float(np.abs(arr.sum(-1) - 1.0).max())
                if row_err > ROW_SUM_BOUND:
                    raise AssertionError(
                        f"{tag}: node {i} probs rows sum to 1 within "
                        f"{row_err} > {ROW_SUM_BOUND}")
            if path.check_tap is not None:
                path.check_tap(path, i, arr, tag, bf16)
            pairs[f"{ch}{i}"] = (arr, p_maps[i][ch].float().cpu().numpy())
    errs, uses = {}, {}
    for key, (got, ref) in pairs.items():
        scale = float(np.abs(ref).max())
        if not bf16:
            bound = F32_BOUND
        else:
            bound = SLICE_REL * (max(1.0, scale) if key == "head" else scale)
        errs[key] = float(np.abs(got - ref).max())
        uses[key] = errs[key] / bound
    bad = {k: f"{errs[k]:.3g} ({uses[k]:.2f} of its bound)"
           for k in errs if uses[k] > 1.0}
    if bad:
        raise AssertionError(f"{tag}: served vs plain path outside bounds: "
                             f"{bad}")
    return errs, uses


def run_path(path, device, graphs_dir, counters) -> dict:
    """One path: warm-up, then with every launch count at 0, ``seq``
    requests in sequence, ``conc`` at once (and one request to
    ``path.other``), then (``path.f32``) one f32 request on a fresh f32
    server; the counts are read after it. Returns the counts and the
    p50."""
    rng = np.random.default_rng(0)
    shape = path.img if isinstance(path.img, tuple) else (path.img, path.img)
    images = [rng.random((3, *shape), dtype=np.float32)
              for _ in range(path.seq + path.conc)]
    opath = path.other
    variants = [path.model] + ([opath.model] if opath else [])
    tag = f"{path.model} {path.dtype}"
    app, httpd, url = serve(variants, path.dtype, device, graphs_dir,
                            path.attn)
    try:
        graph = app.graphs.load(path.model + ".json")
        model = app.reg.get_node(path.model + ":head").model
        bodies = [chain_request(graph, im, path.taps(), path.node_params)
                  for im in images]
        other_raw = None
        if opath:
            other_image = images[0][:, :opath.img, :opath.img]
            other_body = chain_request(app.graphs.load(opath.model + ".json"),
                                       other_image, opath.taps())
            other_model = app.reg.get_node(opath.model + ":head").model
        post(url + "/compute", bodies[0])  # warms the allocator

        for fn in counters.values():  # the path starts here
            fn.launches = 0
        batches0 = app.metrics.counters.get("batches", 0)
        lat, raws = [], []
        for body in bodies[:path.seq]:
            t0 = time.perf_counter()
            raws.append(post(url + "/compute", body))
            lat.append(time.perf_counter() - t0)
        per_request = {k: fn.launches / path.seq for k, fn in counters.items()}
        conc = [None] * path.conc

        def worker(k):
            conc[k] = post(url + "/compute", bodies[path.seq + k])

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(path.conc)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads) or None in conc:
            raise AssertionError("concurrent requests did not complete")
        # concurrent requests may share a batch, and a batch runs each
        # block once for all its requests
        batches = app.metrics.counters.get("batches", 0) - batches0
        if opath:
            other_raw = post(url + "/compute", other_body)
        counts = {k: fn.launches for k, fn in counters.items()}
        metrics = json.loads(urllib.request.urlopen(
            url + "/metrics", timeout=30).read())
        profile_request(app, chain_graph(graph, images[0], path.node_params),
                        path.taps(), tag)
    finally:
        stop(app, httpd)

    served = path.seq + path.conc
    expected = {k: path.kernels.get(k, 0) for k in counters}
    if per_request != expected:
        raise AssertionError(f"a sequential {tag} request launched "
                             f"{per_request}; expected {expected}")
    want = {k: n * batches + (opath.kernels.get(k, 0) if opath else 0)
            for k, n in path.kernels.items()}
    if batches < path.seq or any(counts[k] < n for k, n in want.items()):
        raise AssertionError(f"{counts} launches for {served} {tag} requests "
                             f"in {batches} batches; expected >= {want}")
    worst, worst_use = {}, {}
    for k, raw in enumerate(raws + conc):
        errs, uses = check_response(raw, path,
                                    plain_taps(path, model, images[k],
                                               device),
                                    f"{tag} request {k}")
        for key, v in errs.items():
            worst[key] = max(worst.get(key, 0.0), v)
            worst_use[key] = max(worst_use.get(key, 0.0), uses[key])
    p50 = float(np.median(lat)) * 1e3
    log(f"  {tag}: {path.seq} sequential + {path.conc} concurrent "
        f"requests{' + 1 ' + opath.model if opath else ''} in {batches} "
        f"{path.model} batches; launches a sequential request "
        f"{ {k: v for k, v in per_request.items() if v} }, all "
        f"{ {k: v for k, v in counts.items() if v} } (>= {want}); p50 "
        f"latency per request {p50:.2f} ms (client wall, sequential)")
    log("  server p50s (ms, all requests): " + ", ".join(
        f"{k.removesuffix('_p50_ms')} {metrics[k]:.2f}" for k in (
            "wire_p50_ms", "decode_p50_ms", "queue_p50_ms",
            "compute_p50_ms", "encode_p50_ms", "request_p50_ms"))
        + f"; mean batch {metrics['mean_batch_size']:.2f}")
    log(f"  {tag} vs plain path, worst max abs err (share of its bound): "
        + ", ".join(f"{k}={v:.3g} ({worst_use[k]:.2f})"
                    for k, v in sorted(worst.items())))
    if opath:
        errs, _ = check_response(other_raw, opath,
                                 plain_taps(opath, other_model, other_image,
                                            device),
                                 f"{opath.model} request")
        log(f"  {opath.model} head output vs plain {errs['head']:.3g}")
    if not path.f32:
        return {"launches": counts, "p50_ms": p50}

    # one f32 request: the output must match the plain path at 1e-4
    app, httpd, url = serve([path.model], "float32", device, graphs_dir,
                            path.attn)
    try:
        before = {k: fn.launches for k, fn in counters.items()}
        raw = post(url + "/compute", bodies[0])
        launches_f32 = {k: fn.launches - before[k]
                        for k, fn in counters.items()}
        counts = {k: counts[k] + launches_f32[k] for k in counters}
        model = app.reg.get_node(path.model + ":head").model
    finally:
        stop(app, httpd)
    if {k: launches_f32[k] for k in path.kernels} != path.kernels:
        raise AssertionError(f"f32 {path.model} request launched "
                             f"{launches_f32}; expected {path.kernels}")
    errs32, _ = check_response(raw, path,
                               plain_taps(path, model, images[0], device),
                               f"{path.model} f32 request", bf16=False)
    log(f"  {path.model} f32: 1 request, launches {path.kernels}; head output "
        f"max abs err vs plain {errs32['head']:.3g} (bound {F32_BOUND:g}), "
        f"taps {max(v for k, v in errs32.items() if k != 'head'):.3g}; path "
        f"launch counts { {k: v for k, v in counts.items() if v} }")
    return {"launches": counts, "p50_ms": p50}


def run_forwards(device, counters) -> int:
    """The monolithic forwards with the fused MLP kernel: ``vit.forward``
    at vit_b16 width (block kernel + MLP kernel) and ``swin.forward`` at
    swin_t width (window kernel + one MLP kernel per stage), bf16, B=1 and
    B=8, seeded random weights, against the same forwards with the
    kernels' plain versions. Every launch count is set to 0 before the
    checked forwards and the MLP kernel's count (12 a call) is read and
    returned straight after them; the forwards timed afterwards do not
    enter it."""
    import torch

    from interactive_vit_tpu_torch.models import swin, vit
    from interactive_vit_tpu_torch.ops import dispatch
    from interactive_vit_tpu_torch.ops import fused_block as fb
    from interactive_vit_tpu_torch.ops import fused_mlp as fm
    from interactive_vit_tpu_torch.ops import fused_window as fw

    dtype = torch.bfloat16
    vcfg, scfg = vit.resolve_variant("vit_b16"), swin.VARIANTS["swin_t"]
    vparams = vit.init_params(vcfg, torch.Generator().manual_seed(0), dtype,
                              device)
    sparams = swin.init_params(scfg, torch.Generator().manual_seed(0), dtype,
                               device)
    stages = range(len(scfg.depths))
    kernel_kw = {
        "vit_b16": {
            "block_impl": dispatch.default_block_impl(
                "auto", dtype, vcfg.tokens, vcfg.width, vcfg.heads, device),
            "mlp_impl": dispatch.default_mlp_impl(
                "fused", dtype, vcfg.width, vcfg.mlp_dim, device=device)},
        "swin_t": {
            "window_impl": dispatch.default_window_impl(
                "auto", dtype, scfg, device),
            "mlp_impls": [dispatch.default_mlp_impl(
                "fused", dtype, scfg.stage_dim(s),
                scfg.stage_dim(s) * scfg.mlp_ratio, device=device)
                for s in stages]},
    }
    plain_kw = {
        "vit_b16": {"block_impl": fb.fused_attn_block_reference,
                    "mlp_impl": fm.fused_mlp_block_reference},
        "swin_t": {"window_impl": fw.fused_window_attn_reference,
                   "mlp_impls": [fm.fused_mlp_block_reference for _ in stages]},
    }
    if (kernel_kw["vit_b16"]["block_impl"] is not fb.fused_attn_block
            or kernel_kw["swin_t"]["window_impl"] is not fw.fused_window_attn):
        raise AssertionError("dispatch did not pick the kernels on the card")
    runs = {"vit_b16": (vit.forward, vparams, vcfg, "fused_attn_block"),
            "swin_t": (swin.forward, sparams, scfg, "fused_window_attn")}

    def wall_ms(fn, iters=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    cases = [(name, b, torch.rand((b, 3, runs[name][2].img_size,
                                   runs[name][2].img_size),
                                  generator=torch.Generator().manual_seed(b)
                                  ).to(device))
             for name in runs for b in (1, 8)]
    for fn in counters.values():  # the path starts here
        fn.launches = 0
    lines = {}
    with torch.inference_mode():
        for name, b, imgs in cases:
            forward, params, cfg, attn_kernel = runs[name]
            before = {k: f.launches for k, f in counters.items()}
            got = forward(params, imgs, cfg, want_attn=True,
                          **kernel_kw[name])
            torch.cuda.synchronize()
            delta = {k: f.launches - before[k]
                     for k, f in counters.items() if f.launches > before[k]}
            if delta != {attn_kernel: 12, "fused_mlp_block": 12}:
                raise AssertionError(f"{name} forward B={b} launched "
                                     f"{delta}; expected 12 {attn_kernel} "
                                     f"and 12 fused_mlp_block")
            ref = forward(params, imgs, cfg, want_attn=True,
                          **plain_kw[name])
            logits, rlogits = got["logits"].float(), ref["logits"].float()
            if (logits.shape != (b, cfg.num_classes)
                    or not torch.isfinite(logits).all()):
                raise AssertionError(f"{name} forward B={b}: logits "
                                     f"{tuple(logits.shape)} or non-finite")
            bound = SLICE_REL * max(1.0, rlogits.abs().max().item())
            err = (logits - rlogits).abs().max().item()
            map_use = max(
                ((g.float() - r.float()).abs().max()
                 / (SLICE_REL * r.float().abs().max())).item()
                for g, r in zip(got["attn"], ref["attn"]))
            if err > bound or map_use > 1.0:
                raise AssertionError(
                    f"{name} forward B={b}: logits {err:.3g} (bound "
                    f"{bound:.3g}), maps {map_use:.2f} of their bound")
            lines[name, b] = (
                f"  {name} forward B={b} bf16, {attn_kernel} + "
                f"fused_mlp_block: launches {delta}; logits max abs err "
                f"vs the plain versions {err:.3g} (bound {bound:.3g}), "
                f"maps {map_use:.2f} of their bound")
        # the path ends here: the count is read before the timed forwards
        count = counters["fused_mlp_block"].launches
        if count != 12 * len(cases):
            raise AssertionError(f"fused_mlp_block launched {count} times in "
                                 f"{len(cases)} forwards; expected "
                                 f"{12 * len(cases)}")
        for name, b, imgs in cases:
            forward, params, cfg, _ = runs[name]
            t_k = wall_ms(lambda: forward(params, imgs, cfg,
                                          **kernel_kw[name]))
            t_p = wall_ms(lambda: forward(params, imgs, cfg,
                                          **plain_kw[name]))
            log(lines[name, b] + f"; maps off: kernels {t_k:.2f} ms, plain "
                f"versions {t_p:.2f} ms (host wall, synchronized)")
    return count


class FwdBwdCount:
    """The forward and backward launch counts of a trainable attention as
    one ``launches`` counter: reading sums them, setting sets both."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self) -> int:
        return self.fn.fwd_launches + self.fn.bwd_launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.fwd_launches = self.fn.bwd_launches = value


def train_bound(ref, dtype):
    """(bound of each element of a trainable-attention output or gradient
    against the plain ``ref``; its description)."""
    import torch

    scale = ref.float().abs().max().item()
    if dtype == torch.float32:
        return TRAIN_F32_REL * scale, f"{TRAIN_F32_REL * scale:.3g}"
    return (TRAIN_BF16_REL * ref.float().abs() + TRAIN_BF16_SCALE * scale,
            f"2^-6|ref|+{TRAIN_BF16_SCALE * scale:.3g}")


def check_train(tag, got, ref, dtype, labels, quiet=False):
    """Max abs errors of o, dq, dk, dv (or o, dqkv) against the plain
    versions' and their bounds; raises outside a bound."""
    errs, parts, ok = [], [], True
    for g, r, label in zip(got, ref, labels):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{tag}: {label} is {tuple(g.shape)} "
                                 f"{g.dtype}, plain {tuple(r.shape)} "
                                 f"{r.dtype}")
        bound, text = train_bound(r, dtype)
        diff = (g.float() - r.float()).abs()
        use = (diff / bound).max().item()
        ok = ok and use <= 1.0
        errs.append(diff.max().item())
        parts.append(f"{label}={errs[-1]:.3g} (bound {text}, {use:.2f} of "
                     f"it)")
    line = f"  {tag}: max abs err " + ", ".join(parts)
    if not ok:
        if not quiet:
            log(line)
        raise AssertionError(f"{tag} outside its bounds")
    return errs, line


def check_train_refuse(tag, got, ref, dtype, labels) -> None:
    """Each bound must refuse its output or gradient zeroed or halved."""
    for i in range(len(got)):
        for factor in (0.0, 0.5):
            bad = list(got)
            bad[i] = got[i] * factor
            try:
                check_train(tag, bad, ref, dtype, labels, quiet=True)
            except AssertionError:
                continue
            raise AssertionError(f"{tag}: {labels[i]} x {factor} passed "
                                 f"the bounds")


def train_attn_cost(b, h, n, dh, esize):
    """Bytes and FLOPs of attention's forward and backward on [b, h, n, dh]:
    the forward reads q, k, v and writes o; the backward reads q, k, v, do
    and writes dq, dk, dv; per head 4 n^2 dh FLOPs forward (S, PV) and
    10 n^2 dh backward (S, dv, dP, dq, dk)."""
    return 11 * b * h * n * dh * esize, 14 * b * h * n * n * dh


def phase_train_kernel(device, packed: bool) -> dict:
    """``attention_train`` (or, ``packed``, ``attention_train_packed``)
    forward and backward against the plain versions; returns the main
    path's numbers (vit_b16 packed, vit_t16 [B, H, N, dh]; bf16) with
    SDPA forward + backward beside them."""
    import torch
    import torch.nn.functional as F

    from interactive_vit_tpu_torch.ops import attention_vjp as av

    name = "attention_train_packed" if packed else "attention_train"
    served = TRAIN_B16 if packed else TRAIN_T16
    cases = [TRAIN_B16] + ([] if packed else [TRAIN_T16])
    out = {}
    for shape, n_real in [(c, None) for c in cases] + [((8, 2, 208, 64),
                                                        197)]:
        b, h, n, dh = shape
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            g = torch.Generator().manual_seed(n + h)
            qkv = torch.randn((b, n, 3 * h * dh), generator=g).to(device,
                                                                  dtype)
            do = torch.randn((b, n, h * dh), generator=g).to(device, dtype)
            if packed:
                inputs = [qkv.clone().requires_grad_(True)]
                fn = functools.partial(av.attention_train_packed,
                                       n_real=n_real)
                dout, labels = do, ("o", "dqkv")

                def plain():
                    return (av.attention_train_packed_reference(qkv, n_real),
                            av.packed_head_grads_reference(qkv, do, n_real))
            else:
                # q, k, v as qkv_proj makes them: views of one [B, N, 3D]
                views = [qkv.reshape(b, n, 3, h, dh)[:, :, i].transpose(1, 2)
                         for i in range(3)]
                inputs = [t.detach().requires_grad_(True) for t in views]
                fn = functools.partial(av.attention_train, n_real=n_real)
                dout = do.reshape(b, n, h, dh).transpose(1, 2)
                labels = ("o", "dq", "dk", "dv")

                def plain():
                    return (av.attention_train_reference(*views, n_real),
                            *av.head_grads_reference(*views, dout, n_real))

            def kernel():
                o = fn(*inputs)
                return (o.detach(), *torch.autograd.grad(o, inputs, dout))

            got, ref = kernel(), plain()
            torch.cuda.synchronize()
            tag = (f"{name} {(b, n, 3 * h * dh) if packed else shape} {dt}"
                   + (f" n_real={n_real}" if n_real else ""))
            errs, line = check_train(tag, got, ref, dtype, labels)
            check_train_refuse(tag, got, ref, dtype, labels)
            if n_real is not None:
                dk_dv = (got[1][:, n_real:].reshape(b, n - n_real, h, 3,
                                                    dh)[:, :, :, 1:]
                         if packed else torch.stack(got[2:])[:, :, :,
                                                             n_real:])
                if not torch.all(dk_dv == 0):
                    raise AssertionError(f"{tag}: masked keys got dk or dv")
                log(line)
                continue
            t_k, t_p = time_turns(kernel, plain)
            # SDPA on the [B, H, N, dh] views, forward + backward
            sv = ([t.detach().requires_grad_(True) for t in
                   (qkv.reshape(b, n, h, 3, dh)[:, :, :, i].transpose(1, 2)
                    for i in range(3))] if packed else inputs)
            sdo = do.reshape(b, n, h, dh).transpose(1, 2)

            def sdpa():
                o = F.scaled_dot_product_attention(*sv)
                return torch.autograd.grad(o, sv, sdo)

            t_lib = time_ms(sdpa)
            if packed:
                t_f = time_ms(lambda: av._packed_fwd(qkv, n))
                t_b = time_ms(lambda: av._packed_bwd(qkv, do, n))
            else:
                t_f = time_ms(lambda: av._fwd(*views, n))
                t_b = time_ms(lambda: av._bwd(*views, dout, n))
            nbytes, flops = train_attn_cost(b, h, n, dh, qkv.element_size())
            bms, by = bound(nbytes, flops, dt)
            line += (f"; kernel fwd+bwd {t_k:.4f} ms (fwd {t_f:.4f}, bwd "
                     f"{t_b:.4f}), plain {t_p:.4f} ms; bound {bms:.5f} ms "
                     f"({by}); scaled_dot_product_attention fwd+bwd "
                     f"{t_lib:.4f} ms")
            if (shape, dt) == (served, "bfloat16"):
                out = {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p,
                       "bound_ms": bms, "bound_by": by, "library_ms": t_lib}
            log(line)
    return out


def profile_train_step(cfg, device, attn, compute_dtype, dtype, tag):
    """One train step of ``parallel.train.setup``'s under torch.profiler
    after two warm-up steps (``report_profile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from interactive_vit_tpu_torch.parallel import train as train_lib

    params, state, step, _ = train_lib.setup(
        cfg, device=device, seed=1, attn_impl=attn, remat=False,
        dtype=dtype, compute_dtype=compute_dtype)
    g = torch.Generator().manual_seed(2)
    images = torch.randn((64, 3, cfg.img_size, cfg.img_size),
                         generator=g).to(device)
    labels = torch.randint(0, cfg.num_classes, (64,), generator=g).to(device)
    for _ in range(2):
        params, state, loss = step(params, state, images, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, loss = step(params, state, images, labels)
        float(loss)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, wall_ms, f"{tag} profile of one step")


def run_train(tag, argv, counters, expect) -> dict:
    """``tools.train.main(argv)`` with every count set to 0 just before and
    read just after; ``expect``: {kernel: (forward, backward) launches}
    (every other kernel 0). Checks a finite loss at every logged step;
    returns main's result with ``counts`` and steady ``ms_per_step`` (the
    steps after the first two, when every step is logged)."""
    import math

    import torch

    from interactive_vit_tpu_torch.tools import train as train_tool

    for fn in counters.values():  # the run starts here
        fn.launches = 0
    res = train_tool.main(argv)
    torch.cuda.synchronize()
    counts = {k: ((fn.fn.fwd_launches, fn.fn.bwd_launches)
                  if isinstance(fn, FwdBwdCount) else fn.launches)
              for k, fn in counters.items()}
    want = {k: expect.get(k, (0, 0) if isinstance(fn, FwdBwdCount) else 0)
            for k, fn in counters.items()}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, expected {want}")
    losses = [loss for _, loss, _ in res["history"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: loss not finite: {losses}")
    t = [s for _, _, s in res["history"]]
    res["counts"] = counts
    if len(t) > 2:
        res["ms_per_step"] = (t[-1] - t[1]) / (len(t) - 2) * 1e3
    return res


def phase_train(device, counters) -> dict:
    """Phase 5: the trainer's runs (a)-(d); returns the launches of the
    two trainable attentions (forward + backward) in their main-path runs."""
    import torch

    from interactive_vit_tpu_torch.models import vit
    from interactive_vit_tpu_torch.ops import attention_vjp as av
    from interactive_vit_tpu_torch.parallel import mesh
    from interactive_vit_tpu_torch.parallel import train as train_lib
    from interactive_vit_tpu_torch.tools.train import pattern_set

    launches = {}
    # (a) vit_b16, mixed precision, the packed kernels
    steps, batch = 10, 64
    res = run_train(
        "train vit_b16", ["--variant", "vit_b16", "--dtype", "mixed",
                          "--attn", "auto", "--batch", str(batch),
                          "--steps", str(steps), "--memorize", "64",
                          "--log-every", "1"],
        counters, {"attention_train_packed": (12 * steps, 12 * steps)})
    if res["remat"] is not False:
        raise AssertionError(f"--remat auto resolved to {res['remat']} for "
                             f"vit_b16 at B=64 on this card")
    losses = [loss for _, loss, _ in res["history"]]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train vit_b16: loss did not fall: {losses}")
    launches["attention_train_packed"] = sum(res["counts"][
        "attention_train_packed"])
    log(f"  train vit_b16 @224 mixed, B={batch}, {steps} steps: remat auto "
        f"-> off, head-major {res['head_major']}, packed launches "
        f"{res['counts']['attention_train_packed']} (12 + 12 a step); loss "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; {res['ms_per_step']:.2f} ms a step, "
        f"{batch * 1e3 / res['ms_per_step']:.1f} images/s (steps 3-{steps})")
    cfg = vit.VARIANTS["vit_b16"]
    profile_train_step(cfg, device, "auto", torch.bfloat16, None,
                       "train vit_b16 mixed, kernels")
    profile_train_step(cfg, device, "reference", torch.bfloat16, None,
                       "train vit_b16 mixed, plain attention")

    # (b) vit_t16, bf16, 3 heads: the [B, H, N, dh] kernels
    steps = 5
    res = run_train(
        "train vit_t16", ["--variant", "vit_t16", "--dtype", "bfloat16",
                          "--batch", str(batch), "--steps", str(steps),
                          "--log-every", "1"],
        counters, {"attention_train": (12 * steps, 12 * steps)})
    launches["attention_train"] = sum(res["counts"]["attention_train"])
    log(f"  train vit_t16 @224 bf16, B={batch}, {steps} steps: head-major "
        f"{res['head_major']}, launches {res['counts']['attention_train']} "
        f"(12 + 12 a step), packed 0; loss "
        + " ".join(f"{x:.4f}" for _, x, _ in res["history"])
        + f"; {res['ms_per_step']:.2f} ms a step, "
        f"{batch * 1e3 / res['ms_per_step']:.1f} images/s (steps 3-{steps})")
    profile_train_step(vit.VARIANTS["vit_t16"], device, "auto", None,
                       torch.bfloat16, "train vit_t16 bf16, kernels")

    # (c) remat on: the blocks' forwards run again in the backward
    steps = 2
    res = run_train(
        "train vit_b16 remat", ["--variant", "vit_b16", "--dtype", "mixed",
                                "--batch", str(batch), "--steps",
                                str(steps), "--remat", "on",
                                "--log-every", "1"],
        counters, {"attention_train_packed": (24 * steps, 12 * steps)})
    log(f"  train vit_b16 --remat on, {steps} steps: packed launches "
        f"{res['counts']['attention_train_packed']} (24 + 12 a step); loss "
        + " ".join(f"{x:.4f}" for _, x, _ in res["history"]))

    # (d) first-step f32 gradients: kernels against the plain attention
    params = vit.init_params(cfg, torch.Generator().manual_seed(3),
                             device=device)
    images, labels = pattern_set(3, 8, cfg.img_size, cfg.num_classes)
    images = torch.from_numpy(images).to(device)
    labels = torch.from_numpy(labels).to(device)

    def value_and_grads(p, **kw):
        leaves = [x.detach().requires_grad_(True)
                  for x in train_lib.tree_leaves(p)]
        loss = train_lib.loss_fn(train_lib.tree_unflatten(p, leaves),
                                 images, labels, cfg, **kw)
        return loss.item(), torch.autograd.grad(loss, leaves)

    for fn in counters.values():
        fn.launches = 0
    loss_k, g_k = value_and_grads(mesh.permute_qkv_head_major(params,
                                                              cfg.heads),
                                  attn_impl=av.trainable_flash_mhsa,
                                  qkv_head_major=True)
    torch.cuda.synchronize()
    counts = (av.attention_train_packed.fwd_launches,
              av.attention_train_packed.bwd_launches)
    if counts != (12, 12):
        raise AssertionError(f"gradients: packed launches {counts}")
    g_k = train_lib.tree_leaves(mesh.unpermute_qkv_head_major(
        train_lib.tree_unflatten(params, g_k), cfg.heads))
    loss_r, g_r = value_and_grads(params)
    if abs(loss_k - loss_r) > 1e-5 * max(1.0, abs(loss_r)):
        raise AssertionError(f"gradients: loss {loss_k} vs plain {loss_r}")
    worst = (0.0, "")
    for (path, _), a, b in zip(train_lib.tree_leaves_with_path(params), g_k,
                               g_r):
        use = ((a - b).abs().max() / (TRAIN_GRAD_REL * b.abs().max())).item()
        if not use <= 1.0:
            raise AssertionError(f"gradients: {path} at {use:.2f} of its "
                                 f"bound")
        worst = max(worst, (use, path))
    log(f"  train vit_b16 f32 first-step gradients, B=8: kernels (packed, "
        f"12 + 12 launches) vs plain attention: loss {loss_k:.6f} vs "
        f"{loss_r:.6f}; every parameter's gradient within {TRAIN_GRAD_REL:g} "
        f"of its largest value, the nearest {worst[1]} at {worst[0]:.3f} of "
        f"its bound")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "interactive_vit_tpu_torch")):
        raise SystemExit("chip_smoke.py: run it from a checkout of the "
                         "repository (interactive_vit_tpu_torch/ missing)")
    t_start = time.perf_counter()
    import torch

    from interactive_vit_tpu_torch.ops import attention_vjp as av
    from interactive_vit_tpu_torch.ops import flash_attention as fa
    from interactive_vit_tpu_torch.ops import fused_block as fb
    from interactive_vit_tpu_torch.ops import fused_mlp as fm
    from interactive_vit_tpu_torch.ops import fused_window as fw
    from interactive_vit_tpu_torch.runtime import cuda_build

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script runs "
                         "the port on the card and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(f"phase 1 device: {kind}, {torch.cuda.device_count()} visible, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi[0])

    # 2. build: one nvcc per source, all at once
    t0 = time.perf_counter()
    sources = sorted({os.path.basename(src)[:-3]
                      for src, _ in KERNELS.values()})
    cuda_build.build_all(sources)
    fb.load_kernel()
    fb.load_headwise_kernel()
    fa.load_kernel()
    fa.load_online_kernel()
    fw.load_kernel()
    fm.load_kernel()
    fm.load_w8a8_kernel()
    av.load_kernel()
    log(f"phase 2 build: {', '.join(sources)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    counters = {"fused_attn_block": fb.fused_attn_block,
                "headwise_attn_block": fb.headwise_attn_block,
                "flash_attention": fa.flash_attention,
                "fused_window_attn": fw.fused_window_attn,
                "fused_mlp_block": fm.fused_mlp_block,
                "flash_attention_online": fa.flash_attention_online,
                "fused_mlp_w8a8_block": fm.fused_mlp_w8a8_block,
                "fused_attn_block_s8": fb.fused_attn_block_s8,
                "attention_train": FwdBwdCount(av.attention_train),
                "attention_train_packed": FwdBwdCount(
                    av.attention_train_packed)}
    if set(counters) != set(KERNELS):
        raise AssertionError("every kernel needs its launch count")

    # 3. kernels against their plain versions
    log("phase 3 kernels vs plain versions on the card:")
    numbers = {
        "fused_attn_block": phase_block_kernel(
            device, "fused_attn_block", fb.fused_attn_block,
            fb.fused_attn_block_reference,
            (("vit_b16", 1, 197, 768, 12), ("vit_b16", 8, 197, 768, 12),
             ("vit_t16", 1, 197, 192, 3), ("vit_t16@256", 1, 257, 192, 3)),
            lambda heads: {
                "maps_off": {},
                "maps_mean": {"want_attn": True, "want_mean": True},
                "subset": {"want_attn": True,
                           "attn_heads": tuple(sorted({0, heads // 2,
                                                       heads - 1}))}},
            ("vit_b16", 1, "bfloat16", "maps_mean")),
        "headwise_attn_block": phase_block_kernel(
            device, "headwise_attn_block", fb.headwise_attn_block,
            fb.headwise_attn_block_reference,
            (("vit_l16", 1, 577, 1024, 16), ("vit_l16", 4, 577, 1024, 16)),
            lambda heads: {
                "maps_off": {},
                "maps_mean": {"want_attn": True, "want_mean": True},
                "subset": {"want_attn": True, "want_mean": True,
                           "attn_heads": (0, 7, 15)}},
            ("vit_l16", 1, "bfloat16", "maps_mean")),
        "flash_attention": phase_flash_kernel(device),
        "fused_window_attn": phase_window_kernel(device),
        "fused_mlp_block": phase_mlp_kernel(device),
        "flash_attention_online": phase_online_kernel(device),
        "fused_mlp_w8a8_block": phase_w8a8_kernel(device),
        "fused_attn_block_s8": phase_block_kernel(
            device, "fused_attn_block_s8", fb.fused_attn_block_s8,
            functools.partial(fb.fused_attn_block_reference,
                              int8_scores=True),
            (("vit_b16", 1, 197, 768, 12), ("vit_b16", 8, 197, 768, 12)),
            lambda heads: {
                "maps_off": {},
                "maps_mean": {"want_attn": True, "want_mean": True},
                "subset": {"want_attn": True, "attn_heads": (0, 6, 11)},
                "qk_maps_mean": {"want_attn": True, "want_mean": True,
                                 "int8_pv": False}},
            ("vit_b16", 1, "bfloat16", "maps_mean"), s8=True),
        "attention_train": phase_train_kernel(device, packed=False),
        "attention_train_packed": phase_train_kernel(device, packed=True),
    }

    # 4. the paths through the server
    log("phase 4 slice through the HTTP server:")
    from interactive_vit_tpu_torch.models import swin, vit

    def vit_path(name, img, taps, kernels, plain, seq, conc, **kw):
        return Path(name, vit, vit.resolve_variant(name), img, taps, kernels,
                    plain, vit_tap_shape, seq, conc, **kw)

    b16_taps = {2: ("attn", "r"), 7: ("attn", "r"), 13: ("attn", "r")}
    b16_plain = {"block_impl": fb.fused_attn_block_reference}
    paths = [
        vit_path("vit_b16", 224, b16_taps, {"fused_attn_block": 12},
                 b16_plain, seq=5, conc=4,
                 other=vit_path("vit_t16", 224, b16_taps,
                                {"fused_attn_block": 12}, b16_plain, seq=1,
                                conc=0)),
        vit_path("vit_l16", 384, {2: ("attn", "r"), 14: ("attn", "r"),
                                  25: ("r",)}, {"headwise_attn_block": 24},
                 {"block_impl": fb.headwise_attn_block_reference}, seq=3,
                 conc=2, node_params={14: {"attn_heads": "[0,7,15]"}}),
        vit_path("dinov2_s14_reg", 518, {2: ("attn", "r"), 8: ("r",),
                                         13: ("r",)}, {"flash_attention": 12},
                 {"attn_impl": fa.flash_attention_reference}, seq=3, conc=0),
        # nodes 2, 3: stages.0.0 and stages.0.1 (shifted); 13: stages.2.5;
        # 16: stages.3.1; a non-square image exercises the bicubic resize
        Path("swin_t", swin, swin.VARIANTS["swin_t"], (240, 300),
             {2: ("attn",), 3: ("attn",), 13: ("attn",), 16: ("attn",)},
             {"fused_window_attn": 12},
             {"window_impl": fw.fused_window_attn_reference},
             swin_tap_shape, seq=5, conc=4, check_tap=swin_check_tap,
             node_params={13: {"attn_win": "2"},
                          16: {"attn_heads": "[0,11,23]"}}),
        # a 53 x 53 grid: N=2814, the online kernel in all 12 blocks; the
        # block outputs o of blocks 0, 6, 11 and the CLS features
        vit_path("dinov2_s14_reg@742", 742, {2: ("o",), 8: ("o",),
                                             13: ("o",)},
                 {"flash_attention_online": 12}, {"attn_impl": online_plain},
                 seq=2, conc=0),
        # the repository's saved graph for an @ geometry (N=257)
        vit_path("vit_t16@256", 256, {2: ("attn", "r"), 8: ("attn", "r"),
                                      13: ("r",)}, {"fused_attn_block": 12},
                 b16_plain, seq=2, conc=0),
        # W8A8 fc1/fc2 and the s8 block in every block
        vit_path("vit_b16", 224, b16_taps,
                 {"fused_mlp_w8a8_block": 12, "fused_attn_block_s8": 12},
                 {"block_impl": functools.partial(
                     fb.fused_attn_block_reference, int8_scores=True),
                  "mlp_impl": fm.fused_mlp_w8a8_reference},
                 seq=3, conc=0, dtype="int8w8a8", attn="int8-scores",
                 f32=False),
        # weight-only int8: the unfused path, no kernel
        vit_path("vit_b16", 224, b16_taps, {}, {}, seq=2, conc=0,
                 dtype="int8", f32=False),
    ]
    tmp = tempfile.mkdtemp(prefix="ivt_chip_smoke_")
    try:
        graphs_dir = os.path.join(tmp, "graphs")
        shutil.copytree(os.path.join(HERE, "static", "graphs"), graphs_dir)
        for path in paths:
            res = run_path(path, device, graphs_dir, counters)
            for k in path.kernels:  # a kernel's first path gives its count
                numbers[k].setdefault("launches", res["launches"][k])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers["fused_mlp_block"]["launches"] = run_forwards(device, counters)

    # 5. the trainer
    log("phase 5 train through tools.train.main:")
    for k, n in phase_train(device, counters).items():
        numbers[k]["launches"] = n

    # 6. result
    log(f"phase 6 result: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        nums = numbers[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": nums["launches"],
            "max_abs_err": nums["max_abs_err"], "ms": nums["ms"],
            "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"],
            "bound_by": nums["bound_by"], "library_ms": nums["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
