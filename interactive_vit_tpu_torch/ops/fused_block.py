"""Fused attention blocks: LN1 + QKV + MHSA + proj + residual.

Counterparts of ``interactive_vit_tpu/ops/fused_block.py``'s two Pallas TPU
kernels, each in three pieces, as every kernel of this package has:

* ``fused_attn_block`` / ``headwise_attn_block`` -- the wrappers. For a
  CUDA tensor each launches its hand-written kernel
  (``csrc/fused_attn_block.cu``, ``csrc/headwise_attn_block.cu``, built at
  first use) or raises; for a CPU tensor it runs the plain version. Each
  counts its kernel launches in ``<wrapper>.launches``.
* ``fused_attn_block_reference`` / ``headwise_attn_block_reference`` -- the
  plain PyTorch versions with the same cast points, used on the CPU and to
  check the kernels on the card.
* ``fits`` / ``fits_headwise`` -- the kernels' shape envelopes, used by
  ``ops/dispatch.py``: the whole-image kernel holds one head's K and V for
  all keys in shared memory; the headwise one streams keys in tiles and
  takes the longer sequences (vit_l16 at 384 px).

A public wrapper reaches its kernels on a CUDA tensor through its
``torch.library`` custom op (``ops/custom_ops.py``: the launch is the op's
body, so ``torch.export`` records the op where fake tensors have no
address to route by).

Numerics (the JAX kernels'): f32 LayerNorm cast to the activation dtype;
qkv f32-accumulated plus bias, cast; per-head scores and softmax in f32 --
``fast_softmax`` is ``exp(min(s, 80))`` with no max subtraction and the
normalisation deferred; heads whose maps are emitted (or feed the mean)
multiply by the reciprocal row sum and cast the probs before PV, the others
fold it into the [N, dh] output; heads concatenate and cast; the
projection accumulates in f32 and the residual is added in f32. The
headwise block runs LN1 and QKV as plain PyTorch ops before its kernel
(XLA ops outside the Pallas kernel in JAX), and recomputes the maps of an
``attn_heads`` subset outside the kernel with an exact max-subtracted
softmax while the kernel runs maps-off, as the JAX function does.

The headwise block has two routes on Hopper's tensor cores, chosen by
``headwise_route``, a pure function of dtype, head width and alignment,
each with the same contract and plain version and its own launch count:
bf16 heads of a width in ``HEADWISE_TC_DHS`` (64, 80) with 16-byte aligned
operands run ``headwise_attn_block_mma`` (``csrc/headwise_attn_block_mma.cu``,
mma.sync bf16), f32 ones ``headwise_attn_block_tf32x3``
(``csrc/headwise_attn_block_tf32.cu``, three TF32 products a product);
every other operand keeps the FMA kernel (``headwise_attn_block.launches``).

The whole-image block has the same three routes, chosen by
``block_route`` (dtype, head width, row width and 16-byte alignment of x
and the six weights): bf16 heads of a width in ``ROW1_TC_DHS`` (64, 80)
run ``fused_attn_block_mma`` (``csrc/fused_attn_block_mma.cu``: LN1 + QKV,
the attention and the projection on mma.sync bf16), f32 ones
``fused_attn_block_tf32x3`` (``csrc/fused_attn_block_tf32.cu``, split
TF32), in the s8 mode ``fused_attn_block_s8_mma`` and
``fused_attn_block_s8_tf32x3`` (the same sources; the s8 attention on
int8 mma.sync m16n8k32); every other operand keeps the FMA kernel
(``fused_attn_block.launches``, ``fused_attn_block_s8.launches``). A
launch with ToMe's operands also counts in its route wrapper's
``tome_launches``.

The s8 mode (JAX ``int8_scores`` / ``int8_pv``, the server's ``--attn
int8-scores``) is a mode of the whole-image kernel with its own wrapper,
``fused_attn_block_s8`` (count ``fused_attn_block_s8.launches``):
per head, q and k are quantized per row with ``quant.quant_rows_mosaic``
(half up), the scores are ``si.f32 * (qs * scale) * ks`` from an exact
s8 x s8 -> s32 product and, with ``int8_pv``, the PV product is s8 too:
the probs (maps on) or the unnormalised fast-softmax p (maps off)
quantized per row, v per column, ``oi.f32 * ps * vs`` (maps off: ``oi.f32
* (ps * r) * vs``). The probs taps and the head-mean are as in the dense
mode.

ToMe's two operands (JAX ``key_bias=`` / ``want_metric=``) work in both
modes: ``key_bias`` [B, N] is added in f32 to every head's scaled scores
(after the s8 rescale in the s8 mode), before the softmax; ``want_metric``
appends the head-meaned keys [B, N, dh] f32, ``sum_h k_h`` in ascending
head order over the qkv in the activation dtype, times ``1 / heads``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from interactive_vit_tpu_torch.ops import layers as L
from interactive_vit_tpu_torch.ops import quant, tiled_attention
from interactive_vit_tpu_torch.ops.flash_attention import (
    MMA_ALIGN, _aligned, check_library_dhs,
)

Params = Dict[str, torch.Tensor]

# Overflow guard of the no-max-subtract softmax (the JAX kernel's):
# exp(80) * N stays below f32 max for N up to ~6000.
SOFTMAX_CLAMP = 80.0

# Query rows per block of the whole-image attention kernel (mirrors
# csrc/fused_attn_block.cu).
_QT = 32
_MAX_HEADS = 64  # the kernel's per-head emit mask is one 64-bit word

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attn_smem_bytes(n: int, dh: int) -> int:
    """Dynamic shared memory of the attention kernel: K [n][dh+4], V [n][dh],
    Q [32][dh] and scores [32][n], all f32."""
    return 4 * (n * (dh + 4) + n * dh + _QT * dh + _QT * n)


def attn_s8_extra_bytes(n: int, dh: int) -> int:
    """What the s8 mode adds to the attention kernel's shared memory: int8
    q [32][dh], k [n][dh] and v^T [dh][n] and probs [32][n] packed four to
    a 32-bit word (k and v^T rows padded to an odd word count), and the f32
    scales of q rows, k rows, v columns and probs rows."""
    def odd(w):
        return w | 1

    nw = (n + 3) // 4
    return 4 * (_QT * (dh // 4) + n * odd(dh // 4) + dh * odd(nw) + _QT * nw
                + _QT + n + dh + _QT)


def fits(n: int, d: int, heads: int, int8_scores: bool = False) -> bool:
    """True when the kernel takes a block of n tokens, width d, ``heads``
    heads: the width splits into heads of a multiple of 4 columns (float4
    rows), and one head's K and V for all n keys fit the attention
    kernel's shared memory -- with the s8 mode's int8 copies and scales
    when ``int8_scores`` (this card's shared memory, not the TPU's VMEM:
    N up to 341 at dh=64 dense, 268 in s8)."""
    if n <= 0 or heads <= 0 or heads > _MAX_HEADS or d % heads:
        return False
    dh = d // heads
    smem = attn_smem_bytes(n, dh) + (attn_s8_extra_bytes(n, dh)
                                     if int8_scores else 0)
    return dh % 4 == 0 and smem <= tiled_attention.SMEM_LIMIT


def _emit_heads(heads: int, want_attn: bool, attn_heads) -> Optional[Tuple[int, ...]]:
    """Sorted unique tap heads, or None for all heads (JAX validation)."""
    if not want_attn or attn_heads is None:
        return None
    emit = tuple(sorted(set(int(h) for h in attn_heads)))
    if not emit:
        raise ValueError("attn_heads must be non-empty when want_attn=True "
                         "(None = all heads)")
    if any(h < 0 or h >= heads for h in emit):
        raise ValueError(f"attn_heads {attn_heads} out of range for "
                         f"{heads} heads")
    return emit


def fused_attn_block_reference(
    x: torch.Tensor,
    p: Params,
    heads: int,
    eps: float = 1e-6,
    want_attn: bool = False,
    want_mean: bool = False,
    fast_softmax: bool = True,
    attn_heads: Optional[Tuple[int, ...]] = None,
    key_bias: Optional[torch.Tensor] = None,
    want_metric: bool = False,
    int8_scores: bool = False,
    int8_pv: bool = True,
):
    """Plain PyTorch version of the kernel, same contract and cast points.

    ``int8_scores`` (and ``int8_pv``): the s8 mode, with the JAX kernel's
    quantizers (``quant_rows_mosaic`` / ``quant_cols_mosaic``, half up) and
    exact integer products (float64 matmuls of the int8 values).
    ``key_bias`` / ``want_metric``: ToMe's operands (module docstring).

    Returns ``(y, probs | None)``, then ``mean`` when ``want_mean`` and
    ``metric`` when ``want_metric``."""
    emit = _emit_heads(heads, want_attn, attn_heads)
    kb = _key_bias(x, key_bias)
    dt = x.dtype
    b, n, d = x.shape
    dh = d // heads
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    ln = (xf - mu) * torch.rsqrt(var + eps)
    ln = (ln * p["ln1_s"].float() + p["ln1_b"].float()).to(dt)
    qkv = (torch.matmul(ln.float(), p["qkv_w"].float())
           + p["qkv_b"].float()).to(dt)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, dh)
               .transpose(1, 2) for i in range(3))          # [B, H, N, dh]
    scale = dh ** -0.5
    if int8_scores:
        qq, qs = quant.quant_rows_mosaic(q.float())
        kq, ks = quant.quant_rows_mosaic(k.float())
        si = quant.int_matmul(qq, kq.transpose(-1, -2))
        s = si.float() * (qs * scale) * ks.transpose(-1, -2)
    else:
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kb is not None:
        s = s + kb[:, None, None, :]
    if fast_softmax:
        pexp = torch.exp(torch.clamp(s, max=SOFTMAX_CLAMP))
    else:
        pexp = torch.exp(s - s.amax(dim=-1, keepdim=True))
    r = 1.0 / pexp.sum(dim=-1, keepdim=True)
    vf = v.float()
    # per head: normalise-then-PV where maps are emitted or meaned,
    # PV-then-rescale elsewhere
    norm = torch.zeros(heads, dtype=torch.bool, device=x.device)
    if want_mean or (want_attn and emit is None):
        norm[:] = True
    elif want_attn:
        norm[L.index_on(emit, x.device)] = True
    probs = pexp * r
    pb = probs.to(dt)
    if int8_scores and int8_pv:
        # probs (maps on) or the unnormalised p (off) per row, v per column
        vq, vs = quant.quant_cols_mosaic(vf)
        pq, ps = quant.quant_rows_mosaic(probs)
        o_norm = quant.int_matmul(pq, vq).float() * ps * vs
        pq, ps = quant.quant_rows_mosaic(pexp)
        o_raw = quant.int_matmul(pq, vq).float() * (ps * r) * vs
    else:
        o_norm = torch.matmul(pb.float(), vf)
        o_raw = torch.matmul(pexp.to(dt).float(), vf) * r
    o = torch.where(norm[None, :, None, None], o_norm, o_raw)
    o = o.transpose(1, 2).reshape(b, n, d).to(dt)
    y = (xf + torch.matmul(o.float(), p["proj_w"].float())
         + p["proj_b"].float()).to(dt)
    out = [y, None]
    if want_attn:
        out[1] = (pb if emit is None
                  else pb.index_select(1, L.index_on(emit, pb.device)))
    if want_mean:
        out.append(_head_mean(probs, heads).to(dt))
    if want_metric:
        out.append(_head_mean(k, heads))
    return tuple(out)


def _head_mean(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``sum_h t[:, h]`` in f32 in the kernels' head order (0 to heads-1),
    times ``1 / heads``: the probs' head-mean and ToMe's key metric."""
    acc = t[:, 0].float()
    for h in range(1, heads):
        acc = acc + t[:, h].float()
    return acc * (1.0 / heads)


def _key_bias(x: torch.Tensor, key_bias: Optional[torch.Tensor]
              ) -> Optional[torch.Tensor]:
    """ToMe's per-key logit bias as contiguous f32 [B, N]; raises
    ``ValueError`` unless it is [B, N] on x's device."""
    if key_bias is None:
        return None
    if (tuple(key_bias.shape) != tuple(x.shape[:2])
            or key_bias.device != x.device):
        raise ValueError(
            f"key_bias must be [B, N] = {tuple(x.shape[:2])} on {x.device}, "
            f"got {tuple(key_bias.shape)} on {key_bias.device}")
    return key_bias.float().contiguous()


# ``ivt_fused_attn_block``'s parameters (csrc/fused_attn_block.cu): dtype;
# x, the six weights, the qkv / o / probs workspaces, y, probs, mean, key
# bias and metric; B, N, D, H; eps, scale, 1/heads; fast, emit mask,
# n_emit, int8_mode; stream.
ENTRY_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 15
                  + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                  + [ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p])


# The head widths of the whole-image block's tensor-core routes
# (csrc/fused_attn_block_mma.cu, csrc/fused_attn_block_tf32.cu), in
# increasing order, and the widest row their LN1 + QKV kernel takes (a
# lane's LayerNorm units in registers: csrc/mlp_cluster.cuh's
# MC_MAX_WIDTH).
ROW1_TC_DHS = (64, 80)
ROW1_TC_MAX_WIDTH = 1280
# Rows of a tile of the bf16 LN1 + QKV kernel: 32 up to this many rows
# (csrc/fused_attn_block_mma.cu QKV_SMALL_M), else 64; the f32 one takes 32
ROW1_QKV_SMALL_M = 512
# Query rows of a block of the s8 tensor-core attention
# (csrc/attn_block_s8.cuh)
_S8_ROWS = 32
# The tensor-core entries take ``ivt_fused_attn_block``'s arguments
# without the dtype, and before the stream ``s8_parts``: null, or a host
# array of the six device pointers of ``S8_PARTS`` (a check of the s8 mode).
TC_ENTRY_ARGTYPES = ENTRY_ARGTYPES[1:-1] + [ctypes.c_void_p, ctypes.c_void_p]
S8_PARTS = ("q8", "k8", "v8", "p8", "si", "oi")


def block_route(dtype: torch.dtype, dh: int, addrs, strides) -> str:
    """The whole-image block's kernel for operands of ``dtype`` with heads
    ``dh`` wide, whose base addresses (bytes) are ``addrs`` and whose
    element strides and offsets are ``strides`` (the first the row width
    D): "mma" (bf16 on the tensor cores) or "tf32" (f32 on split TF32)
    when ``dh`` is in ``ROW1_TC_DHS``, D is at most ``ROW1_TC_MAX_WIDTH``
    and every address and stride is a multiple of 16 bytes; else "fma"
    (the FMA kernel). The same in the s8 mode."""
    esize = {torch.bfloat16: 2, torch.float32: 4}.get(dtype)
    if (esize is None or dh not in ROW1_TC_DHS
            or int(strides[0]) > ROW1_TC_MAX_WIDTH
            or not _aligned(addrs, strides, esize)):
        return "fma"
    return "mma" if dtype == torch.bfloat16 else "tf32"


def _block_route_of(x: torch.Tensor, p: Params, heads: int) -> str:
    """``block_route`` for a block's operands: x (and y, o: rows of D), the
    six weights (qkv_w rows of 3D, proj_w rows of D), and the qkv workspace
    the wrapper makes (its own allocation; q, k, v of a head at h dh, D +
    h dh, 2D + h dh)."""
    d = x.shape[-1]
    dh = d // heads
    return block_route(x.dtype, dh,
                       (x.data_ptr(), *(p[k].data_ptr() for k in (
                           "ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w",
                           "proj_b"))),
                       (d, 3 * d, dh))


def row1_s8_smem_bytes(n: int, dh: int, esize: int) -> int:
    """Dynamic shared memory of the s8 tensor-core attention
    (csrc/attn_block_s8.cuh ``s8_layout``) for n keys of heads dh wide in
    activations of ``esize`` bytes: f32 scores [32][NP + 8], v [NP][dh + 8
    (bf16) or + 4 (f32)], int8 q [32][DHP + 16] and k [NP][DHP + 16], int8
    p [32][NP + 16] (bf16: or bf16 p [32][NP + 8]), int8 v^T [dh][NP + 16]
    and the f32 scales, each region rounded up to 16 bytes; NP and DHP
    are n and dh rounded up to 32."""
    def up(b):
        return (b + 15) // 16 * 16

    np_, dhp = (n + 31) // 32 * 32, (dh + 31) // 32 * 32
    v_ld = dh + (8 if esize == 2 else 4)
    p_bytes = max(_S8_ROWS * (np_ + 16),
                  _S8_ROWS * (np_ + 8) * 2 if esize == 2 else 0)
    return (up(_S8_ROWS * (np_ + 8) * 4) + up(np_ * v_ld * esize)
            + up(_S8_ROWS * (dhp + 16)) + up(np_ * (dhp + 16)) + up(p_bytes)
            + up(dh * (np_ + 16)) + up((3 * _S8_ROWS + np_ + dh) * 4))


def row1_qkv_smem_bytes(d: int, esize: int, bm: int) -> int:
    """Dynamic shared memory of a tensor-core route's LN1 + QKV kernel for
    rows d wide and a tile of ``bm`` rows: the LN(x) panel [bm][d + 8] and
    a three-stage ring of weight tiles (bf16 [64][72], f32 [32][68])."""
    ring = 3 * (64 * 72 * 2 if esize == 2 else 32 * 68 * 4)
    return bm * (d + 8) * esize + ring


def _kernel_lib() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("fused_attn_block")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_fused_attn_block.argtypes = ENTRY_ARGTYPES
        lib.ivt_fused_attn_block.restype = ctypes.c_int
        for fn in (lib.ivt_attn_smem_bytes, lib.ivt_attn_s8_extra_bytes):
            fn.argtypes = [ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_size_t
        lib._ivt_bound = True
    return lib


def load_kernel() -> ctypes.CDLL:
    """Build and load the CUDA kernel now (``chip_smoke.py`` times this);
    checks that the library's shared-memory formula is the envelope's."""
    lib = _kernel_lib()
    for n, dh in ((197, 64), (50, 64), (17, 16), (257, 64)):
        if (lib.ivt_attn_smem_bytes(n, dh) != attn_smem_bytes(n, dh)
                or lib.ivt_attn_s8_extra_bytes(n, dh)
                != attn_s8_extra_bytes(n, dh)):
            raise RuntimeError("csrc/fused_attn_block.cu and fits() disagree "
                               "on the attention kernel's shared memory")
    return lib


# route -> (source, C entry, prefix of its shape entries)
_ROW1_TC = {
    "mma": ("fused_attn_block_mma", "ivt_fused_attn_block_mma",
            "ivt_fused_block_mma_"),
    "tf32": ("fused_attn_block_tf32", "ivt_fused_attn_block_tf32x3",
             "ivt_fused_block_tf32_"),
}


def _row1_tc_lib(route: str) -> ctypes.CDLL:
    """Build (first use) and load a tensor-core route's library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    source, entry, pre = _ROW1_TC[route]
    lib = cuda_build.load(source)
    if not getattr(lib, "_ivt_bound", False):
        getattr(lib, entry).argtypes = TC_ENTRY_ARGTYPES
        getattr(lib, entry).restype = ctypes.c_int
        for name, args, res in (
                ("dh", [ctypes.c_int], ctypes.c_int),
                ("max_width", [], ctypes.c_int),
                ("s8_smem", [ctypes.c_int, ctypes.c_int], ctypes.c_size_t)):
            fn = getattr(lib, pre + name)
            fn.argtypes, fn.restype = args, res
        if route == "mma":
            lib.ivt_fused_block_mma_qkv_rows.argtypes = [ctypes.c_int]
            lib.ivt_fused_block_mma_qkv_rows.restype = ctypes.c_int
            lib.ivt_fused_block_mma_qkv_smem.argtypes = [ctypes.c_int,
                                                         ctypes.c_int]
            lib.ivt_fused_block_mma_qkv_smem.restype = ctypes.c_size_t
        else:
            lib.ivt_fused_block_tf32_qkv_smem.argtypes = [ctypes.c_int]
            lib.ivt_fused_block_tf32_qkv_smem.restype = ctypes.c_size_t
        lib._ivt_bound = True
    return lib


def check_row1_library(lib, route: str) -> None:
    """Raises unless a tensor-core route's library takes exactly the head
    widths of ``ROW1_TC_DHS`` and rows up to ``ROW1_TC_MAX_WIDTH``, and its
    shared-memory formulas (the LN1 + QKV tile, the s8 attention) are this
    module's: the route must never send a block to a library that cannot
    take it."""
    source, _, pre = _ROW1_TC[route]
    src = f"csrc/{source}.cu"
    check_library_dhs(getattr(lib, pre + "dh"), src, ROW1_TC_DHS,
                      "ROW1_TC_DHS")
    esize = 2 if route == "mma" else 4
    widths = (192, 240, 384, 768, 1024, 1280)
    ok = getattr(lib, pre + "max_width")() == ROW1_TC_MAX_WIDTH and all(
        getattr(lib, pre + "s8_smem")(n, dh) == row1_s8_smem_bytes(n, dh,
                                                                   esize)
        for n in (11, 50, 197, 257, 268) for dh in ROW1_TC_DHS)
    if route == "mma":
        ok = ok and all(
            lib.ivt_fused_block_mma_qkv_rows(m) == (
                32 if m <= ROW1_QKV_SMALL_M else 64)
            for m in (1, 197, 512, 513, 1576)) and all(
            lib.ivt_fused_block_mma_qkv_smem(d, bm)
            == row1_qkv_smem_bytes(d, 2, bm) for d in widths for bm in (32, 64))
    else:
        ok = ok and all(lib.ivt_fused_block_tf32_qkv_smem(d)
                        == row1_qkv_smem_bytes(d, 4, 32) for d in widths)
    if not ok:
        raise RuntimeError(f"{src} and fused_block disagree on the widest "
                           f"row or the shared-memory formulas")


def load_mma_kernel() -> ctypes.CDLL:
    """Build and load the bf16 tensor-core route now; checks it
    (``check_row1_library``)."""
    lib = _row1_tc_lib("mma")
    check_row1_library(lib, "mma")
    return lib


def load_tf32_kernel() -> ctypes.CDLL:
    """Build and load the split-TF32 route now; checks it
    (``check_row1_library``)."""
    lib = _row1_tc_lib("tf32")
    check_row1_library(lib, "tf32")
    return lib


def _check_operands(x: torch.Tensor, p: Params, heads: int,
                    name: str = "fused_attn_block", fits_fn=fits,
                    **fits_kw) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"x must be [B, N, D], got shape {tuple(x.shape)}")
    b, n, d = x.shape
    if not fits_fn(n, d, heads, **fits_kw):
        raise ValueError(f"{name} kernel does not take n={n}, "
                         f"d={d}, heads={heads} (see {fits_fn.__name__}())")
    want = {"ln1_s": (d,), "ln1_b": (d,), "qkv_w": (d, 3 * d),
            "qkv_b": (3 * d,), "proj_w": (d, d), "proj_b": (d,)}
    for name, shape in want.items():
        t = p[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the kernel "
                             f"needs {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _launch_block(route, x, p, heads, eps, want_attn, want_mean,
                  fast_softmax, attn_heads, key_bias, want_metric,
                  int8_mode: int, parts: Optional[Dict[str, torch.Tensor]] = None):
    """One launch of the block's kernels on ``route`` ("fma":
    ``csrc/fused_attn_block.cu``; "mma", "tf32": the tensor-core sources;
    ``int8_mode``: 0 dense, 1 s8 scores with a dense PV product, 2 s8
    scores and PV) on operands already checked; returns the wrapper's
    result. ``parts`` (a tensor-core route's s8 mode): the tensors of
    ``S8_PARTS`` that the kernel fills. Counts nothing: the wrappers count
    their launches."""
    emit = _emit_heads(heads, want_attn, attn_heads)
    kb = _key_bias(x, key_bias)
    b, n, d = x.shape
    emit_list = (list(range(heads)) if emit is None else list(emit)) \
        if want_attn else []
    mask = 0
    for h in emit_list:
        mask |= 1 << h
    if route == "fma":
        entry, lead = _kernel_lib().ivt_fused_attn_block, (
            _DTYPE_CODE[x.dtype],)
    else:
        entry, lead = getattr(_row1_tc_lib(route), _ROW1_TC[route][1]), ()
    with torch.cuda.device(x.device):
        qkv_ws = torch.empty((b, n, 3 * d), dtype=x.dtype, device=x.device)
        o_ws = torch.empty((b, n, d), dtype=x.dtype, device=x.device)
        # f32 per-head probs, summed in head order by the head-mean pass
        probs_ws = (torch.empty((b, heads, n, n), dtype=torch.float32,
                                device=x.device) if want_mean else None)
        y = torch.empty_like(x)
        probs = (torch.empty((b, len(emit_list), n, n), dtype=x.dtype,
                             device=x.device) if want_attn else None)
        mean = (torch.empty((b, n, n), dtype=x.dtype, device=x.device)
                if want_mean else None)
        metric = (torch.empty((b, n, d // heads), dtype=torch.float32,
                              device=x.device) if want_metric else None)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(
            *lead, x.data_ptr(), p["ln1_s"].data_ptr(),
            p["ln1_b"].data_ptr(), p["qkv_w"].data_ptr(),
            p["qkv_b"].data_ptr(), p["proj_w"].data_ptr(),
            p["proj_b"].data_ptr(), qkv_ws.data_ptr(), o_ws.data_ptr(),
            None if probs_ws is None else probs_ws.data_ptr(), y.data_ptr(),
            None if probs is None else probs.data_ptr(),
            None if mean is None else mean.data_ptr(),
            None if kb is None else kb.data_ptr(),
            None if metric is None else metric.data_ptr(), b, n, d, heads,
            float(eps), float(d // heads) ** -0.5, 1.0 / heads,
            int(bool(fast_softmax)), mask, len(emit_list), int8_mode,
            *([] if route == "fma" else [None if parts is None else (
                ctypes.c_void_p * 6)(*(parts[k].data_ptr()
                                       for k in S8_PARTS))]), stream)
    if err != 0:
        raise RuntimeError(f"fused_attn_block kernel launch failed on the "
                           f"{route} route: cudaError {err}")
    out = [y, probs]
    if want_mean:
        out.append(mean)
    if want_metric:
        out.append(metric)
    return tuple(out)


def _on_device(x, name):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{x.device}")
    return x.device.type == "cuda"


def fused_attn_block(
    x: torch.Tensor,
    p: Params,
    heads: int,
    eps: float = 1e-6,
    want_attn: bool = False,
    want_mean: bool = False,
    fast_softmax: bool = True,
    attn_heads: Optional[Tuple[int, ...]] = None,
    key_bias: Optional[torch.Tensor] = None,
    want_metric: bool = False,
    int8_scores: bool = False,
    int8_pv: bool = True,
):
    """x [B, N, D] -> (x + proj(MHSA(LN(x))), probs [B, H|sel, N, N] | None)
    [, mean [B, N, N] when ``want_mean``][, metric [B, N, dh] f32 when
    ``want_metric``].

    Arguments as the JAX function's. ``attn_heads`` limits the probs tap
    to those heads (ascending order); the others are never written.
    ``key_bias`` [B, N] (on x's device, else ``ValueError``) and
    ``want_metric`` are ToMe's operands (module docstring).
    ``int8_scores`` / ``int8_pv`` run the s8 mode (``fused_attn_block_s8``).
    Operands that ``block_route`` sends to the tensor cores launch there,
    counted in ``fused_attn_block_mma`` (bf16) or
    ``fused_attn_block_tf32x3`` (f32); this wrapper's counts
    (``fused_attn_block.launches``, and ``.tome_launches`` for a launch
    with ToMe's operands) are the FMA kernel's."""
    kw = dict(want_attn=want_attn, want_mean=want_mean,
              fast_softmax=fast_softmax, attn_heads=attn_heads,
              key_bias=key_bias, want_metric=want_metric)
    if int8_scores:
        return fused_attn_block_s8(x, p, heads, eps, int8_pv=int8_pv, **kw)
    if not _on_device(x, "fused_attn_block"):
        return fused_attn_block_reference(x, p, heads, eps, **kw)
    _check_operands(x, p, heads)
    from interactive_vit_tpu_torch.ops import custom_ops

    return custom_ops.fused_attn_block(x, p, heads, eps, 0, **kw)


def _launch_counted(route, s8, x, p, heads, eps, int8_pv, kw):
    """One launch on ``route`` (the s8 mode when ``s8``) of operands already
    checked, counted in the wrapper of that route and mode
    (``_ROW1_WRAPPERS``): ``launches``, and ``tome_launches`` where either
    of ToMe's operands was given."""
    out = _launch_block(route, x, p, heads, eps,
                        int8_mode=(2 if int8_pv else 1) if s8 else 0, **kw)
    wrapper = _ROW1_WRAPPERS[route, s8]
    wrapper.launches += 1
    if kw["key_bias"] is not None or kw["want_metric"]:
        wrapper.tome_launches += 1
    return out


def fused_attn_block_s8(
    x: torch.Tensor,
    p: Params,
    heads: int,
    eps: float = 1e-6,
    want_attn: bool = False,
    want_mean: bool = False,
    fast_softmax: bool = True,
    attn_heads: Optional[Tuple[int, ...]] = None,
    key_bias: Optional[torch.Tensor] = None,
    want_metric: bool = False,
    int8_pv: bool = True,
):
    """The s8 mode of ``fused_attn_block`` (the JAX function's
    ``int8_scores=True``; ``int8_pv`` quantizes the PV product too), same
    contract, ToMe's operands included. On a CUDA tensor one launch of the
    block's kernels with the s8 attention (envelope ``fits(...,
    int8_scores=True)``): on the tensor cores where ``block_route`` sends
    the operands there (counted in ``fused_attn_block_s8_mma`` or
    ``fused_attn_block_s8_tf32x3``), else the FMA / ``__dp4a`` kernel,
    counted in ``fused_attn_block_s8.launches`` (and ``.tome_launches``);
    on a CPU tensor the plain version."""
    kw = dict(want_attn=want_attn, want_mean=want_mean,
              fast_softmax=fast_softmax, attn_heads=attn_heads,
              key_bias=key_bias, want_metric=want_metric)
    if not _on_device(x, "fused_attn_block_s8"):
        return fused_attn_block_reference(x, p, heads, eps, int8_scores=True,
                                          int8_pv=int8_pv, **kw)
    _check_operands(x, p, heads, int8_scores=True)
    from interactive_vit_tpu_torch.ops import custom_ops

    return custom_ops.fused_attn_block(x, p, heads, eps,
                                       2 if int8_pv else 1, **kw)


# the keyword arguments of a block launch, at the wrappers' defaults
_BLOCK_KW = dict(want_attn=False, want_mean=False, fast_softmax=True,
                 attn_heads=None, key_bias=None, want_metric=False)


def _row1_tc_wrapper(name: str, route: str, s8: bool, doc: str):
    """A tensor-core route's own wrapper, with ``fused_attn_block``'s
    arguments (and, ``s8``, ``int8_pv``): the plain version for a CPU
    tensor; on the card one launch, counted in its ``launches`` and
    ``tome_launches``, or ``ValueError`` for operands that ``block_route``
    does not send to ``route``."""
    def wrapper(x: torch.Tensor, p: Params, heads: int, eps: float = 1e-6,
                **kw):
        int8_pv = kw.pop("int8_pv", True) if s8 else True
        if set(kw) - set(_BLOCK_KW):
            raise TypeError(f"{name}() got unexpected keyword arguments "
                            f"{sorted(set(kw) - set(_BLOCK_KW))}")
        kw = dict(_BLOCK_KW, **kw)
        if not _on_device(x, name):
            return fused_attn_block_reference(x, p, heads, eps,
                                              int8_scores=s8,
                                              int8_pv=int8_pv, **kw)
        _check_operands(x, p, heads, name, int8_scores=s8)
        if _block_route_of(x, p, heads) != route:
            raise ValueError(
                f"{name} takes {'bf16' if route == 'mma' else 'f32'} heads "
                f"{' or '.join(map(str, ROW1_TC_DHS))} wide, rows up to "
                f"{ROW1_TC_MAX_WIDTH} wide, with 16-byte aligned operands, "
                f"got {x.dtype}, dh={x.shape[-1] // heads}, D={x.shape[-1]}")
        return _launch_counted(route, s8, x, p, heads, eps, int8_pv, kw)

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    return wrapper


fused_attn_block_mma = _row1_tc_wrapper(
    "fused_attn_block_mma", "mma", False,
    """``fused_attn_block``'s dense contract in bf16 on the tensor cores
    (``csrc/fused_attn_block_mma.cu``).""")
fused_attn_block_tf32x3 = _row1_tc_wrapper(
    "fused_attn_block_tf32x3", "tf32", False,
    """``fused_attn_block``'s dense contract in f32 on split-TF32
    tensor-core products (``csrc/fused_attn_block_tf32.cu``).""")
fused_attn_block_s8_mma = _row1_tc_wrapper(
    "fused_attn_block_s8_mma", "mma", True,
    """``fused_attn_block_s8``'s contract in bf16, the s8 attention on int8
    mma.sync (``csrc/fused_attn_block_mma.cu``).""")
fused_attn_block_s8_tf32x3 = _row1_tc_wrapper(
    "fused_attn_block_s8_tf32x3", "tf32", True,
    """``fused_attn_block_s8``'s contract in f32, the s8 attention on int8
    mma.sync and the GEMMs (and a dense PV) on split TF32
    (``csrc/fused_attn_block_tf32.cu``).""")
# (route, s8 mode) -> the wrapper that counts its launches
_ROW1_WRAPPERS = {
    ("fma", False): fused_attn_block, ("fma", True): fused_attn_block_s8,
    ("mma", False): fused_attn_block_mma,
    ("mma", True): fused_attn_block_s8_mma,
    ("tf32", False): fused_attn_block_tf32x3,
    ("tf32", True): fused_attn_block_s8_tf32x3}
for _w in _ROW1_WRAPPERS.values():
    _w.launches = 0
    _w.tome_launches = 0
del _w


def fused_attn_block_s8_parts(x: torch.Tensor, p: Params, heads: int,
                              eps: float = 1e-6, int8_pv: bool = True, **kw):
    """One launch of the s8 mode on the tensor-core route ``block_route``
    gives x (raises for "fma"), with its integer stages: returns (the
    wrapper's result, {"q8", "k8", "v8" [B, H, N, dh] int8, "si" [B, H, N,
    N] int32 (q8 k8^T), "p8" [B, H, N, N] int8, "oi" [B, H, N, dh] int32
    (p8 v8)}); v8, p8 and oi only with ``int8_pv``. A check of the
    kernel's exact integer products; counts nothing."""
    kw = dict(_BLOCK_KW, **kw)
    _check_operands(x, p, heads, int8_scores=True)
    route = _block_route_of(x, p, heads)
    if route == "fma":
        raise ValueError("fused_attn_block_s8_parts takes the tensor-core "
                         "routes' operands")
    b, n, d = x.shape
    dh = d // heads
    shapes = {"q8": dh, "k8": dh, "v8": dh, "p8": n, "si": n, "oi": dh}
    parts = {k: torch.zeros((b, heads, n, w), device=x.device,
                            dtype=torch.int32 if k in ("si", "oi")
                            else torch.int8) for k, w in shapes.items()}
    out = _launch_block(route, x, p, heads, eps, int8_mode=2 if int8_pv
                        else 1, parts=parts, **kw)
    if not int8_pv:
        parts = {k: parts[k] for k in ("q8", "k8", "si")}
    return out, parts


# -- headwise_attn_block ---------------------------------------------------------


def fits_headwise(n: int, d: int, heads: int) -> bool:
    """True when the headwise kernel takes a block of n tokens, width d,
    ``heads`` heads: heads of a multiple of 4 columns up to 128, and 32 (or
    16) query rows of f32 scores for all n keys in shared memory -- N up to
    ~1600 with 32 rows, ~3200 with 16, at dh=64."""
    if n <= 0 or heads <= 0 or d % heads:
        return False
    return tiled_attention.query_tile(n, d // heads) > 0


def _subset_maps(qkv: torch.Tensor, heads: int, emit: Tuple[int, ...]
                 ) -> torch.Tensor:
    """Maps of the ``emit`` heads from the untransposed qkv, with an exact
    max-subtracted softmax, cast to qkv's dtype: [B, |emit|, N, N]."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    idx = L.index_on(emit, qkv.device)
    q, k = (qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, dh)
            .index_select(2, idx).transpose(1, 2) for i in range(2))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh ** -0.5)
    return torch.softmax(s, dim=-1).to(qkv.dtype)


def _ln_qkv(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    return L.linear(L.layer_norm(x, p["ln1_s"], p["ln1_b"], eps),
                    p["qkv_w"], p["qkv_b"])


def headwise_attn_block_reference(
    x: torch.Tensor,
    p: Params,
    heads: int,
    eps: float = 1e-6,
    want_attn: bool = False,
    want_mean: bool = False,
    fast_softmax: bool = True,
    attn_heads: Optional[Tuple[int, ...]] = None,
):
    """Plain PyTorch version of the headwise block, same contract and cast
    points. Its kernel computes what the whole-image kernel computes with
    every head or no head emitted, so that plain version does the work; an
    ``attn_heads`` subset is recomputed with the exact softmax, as in the
    wrapper."""
    emit = _emit_heads(heads, want_attn, attn_heads)
    if emit is None:
        return fused_attn_block_reference(
            x, p, heads, eps, want_attn=want_attn, want_mean=want_mean,
            fast_softmax=fast_softmax)
    out = fused_attn_block_reference(x, p, heads, eps, want_mean=want_mean,
                                     fast_softmax=fast_softmax)
    return (out[0], _subset_maps(_ln_qkv(x, p, eps), heads, emit), *out[2:])


# ``ivt_headwise_attn_block``'s parameters (csrc/headwise_attn_block.cu):
# dtype; x, qkv, proj_w, proj_b, the o and probs workspaces, y, probs, mean;
# B, N, D, H; scale, 1/heads; fast; the stream. The tensor-core entries
# (``HEADWISE_TC_ARGTYPES``) take the same without the dtype.
HEADWISE_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                     + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                     + [ctypes.c_int, ctypes.c_void_p])
HEADWISE_TC_ARGTYPES = HEADWISE_ARGTYPES[1:]

# The head widths of the headwise block's tensor-core routes
# (csrc/headwise_attn_block_mma.cu, csrc/headwise_attn_block_tf32.cu), in
# increasing order; their 16-byte copies need the tensor-core flash
# kernels' alignment (``flash_attention.MMA_ALIGN``).
HEADWISE_TC_DHS = (64, 80)
# The key tile of each route's attention kernel at each head width (the
# order of its f32 sums; in bf16 p is cast before PV either way).
HEADWISE_MMA_BLOCK_K = 64
HEADWISE_TF32_BLOCK_K = {64: 32, 80: 64}
_TC_WIDTHS = " or ".join(map(str, HEADWISE_TC_DHS))


def headwise_route(dtype: torch.dtype, dh: int, addrs, strides) -> str:
    """The headwise block's kernel for operands of ``dtype`` with heads
    ``dh`` wide, whose base addresses (bytes) are ``addrs`` and whose
    element strides and offsets are ``strides``: "mma" (bf16 on the tensor
    cores) or "tf32" (f32 on split TF32) when ``dh`` is in
    ``HEADWISE_TC_DHS`` and every address and stride is a multiple of 16
    bytes; else "fma" (the FMA kernel)."""
    esize = {torch.bfloat16: 2, torch.float32: 4}.get(dtype)
    if (esize is None or dh not in HEADWISE_TC_DHS
            or not _aligned(addrs, strides, esize)):
        return "fma"
    return "mma" if dtype == torch.bfloat16 else "tf32"


def _route_of(x: torch.Tensor, p: Params, heads: int) -> str:
    """``headwise_route`` for a block's operands: x (and y, o, proj_w: rows
    of D), proj_b, and the qkv the wrapper makes (rows of 3D; q, k, v of a
    head at h dh, D + h dh, 2D + h dh; its own allocation, so its base is
    aligned)."""
    d = x.shape[-1]
    dh = d // heads
    return headwise_route(x.dtype, dh,
                          (x.data_ptr(), p["proj_w"].data_ptr(),
                           p["proj_b"].data_ptr()),
                          (d, 3 * d, dh))


def _headwise_lib() -> ctypes.CDLL:
    """Build (first use) and load the headwise kernel library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("headwise_attn_block")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_headwise_attn_block.argtypes = HEADWISE_ARGTYPES
        lib.ivt_headwise_attn_block.restype = ctypes.c_int
        lib._ivt_bound = True
    return lib


def load_headwise_kernel() -> ctypes.CDLL:
    """Build and load the headwise kernel now; checks that the library's
    shared-memory formula is the envelope's."""
    lib = _headwise_lib()
    tiled_attention.check_library(lib)
    return lib


# route -> (source, C entry, its head widths' entry)
_TC_SOURCES = {
    "mma": ("headwise_attn_block_mma", "ivt_headwise_attn_block_mma",
            "ivt_headwise_mma_dh"),
    "tf32": ("headwise_attn_block_tf32", "ivt_headwise_attn_block_tf32x3",
             "ivt_headwise_tf32_dh"),
}


def _headwise_tc_lib(route: str) -> ctypes.CDLL:
    """Build (first use) and load a tensor-core route's library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    source, entry, widths = _TC_SOURCES[route]
    lib = cuda_build.load(source)
    if not getattr(lib, "_ivt_bound", False):
        getattr(lib, entry).argtypes = HEADWISE_TC_ARGTYPES
        getattr(lib, entry).restype = ctypes.c_int
        getattr(lib, widths).argtypes = [ctypes.c_int]
        getattr(lib, widths).restype = ctypes.c_int
        if route == "tf32":
            lib.ivt_headwise_tf32_block_k.argtypes = [ctypes.c_int]
            lib.ivt_headwise_tf32_block_k.restype = ctypes.c_int
        lib._ivt_bound = True
    return lib


def check_headwise_dhs(width_of, source: str) -> None:
    """Raises unless the library built from ``source`` takes exactly the
    head widths of ``HEADWISE_TC_DHS``: the route must never send a width
    to a library without its instantiation."""
    check_library_dhs(width_of, source, HEADWISE_TC_DHS, "HEADWISE_TC_DHS")


def load_headwise_mma_kernel() -> ctypes.CDLL:
    """Build and load the bf16 tensor-core route now; checks its head
    widths against ``HEADWISE_TC_DHS``."""
    lib = _headwise_tc_lib("mma")
    check_headwise_dhs(lib.ivt_headwise_mma_dh,
                       "csrc/headwise_attn_block_mma.cu")
    return lib


def load_headwise_tf32_kernel() -> ctypes.CDLL:
    """Build and load the split-TF32 route now; checks its head widths
    against ``HEADWISE_TC_DHS`` and its key tiles against
    ``HEADWISE_TF32_BLOCK_K``."""
    lib = _headwise_tc_lib("tf32")
    check_headwise_dhs(lib.ivt_headwise_tf32_dh,
                       "csrc/headwise_attn_block_tf32.cu")
    if any(lib.ivt_headwise_tf32_block_k(dh) != HEADWISE_TF32_BLOCK_K[dh]
           for dh in HEADWISE_TC_DHS):
        raise RuntimeError("csrc/headwise_attn_block_tf32.cu and "
                           "HEADWISE_TF32_BLOCK_K disagree")
    return lib


def _launch_headwise(route, x, p, heads, eps, want_attn, want_mean,
                     fast_softmax, attn_heads):
    """LN1 + QKV, then one launch of the headwise block's kernel on
    ``route``; returns the wrapper's result. An ``attn_heads`` subset's
    maps are recomputed here and the kernel runs maps-off."""
    emit = _emit_heads(heads, want_attn, attn_heads)
    qkv = _ln_qkv(x, p, eps)
    if emit is None:
        return headwise_kernels(route, x, qkv, p, heads, want_attn,
                                want_mean, fast_softmax)
    out = headwise_kernels(route, x, qkv, p, heads, False, want_mean,
                           fast_softmax)
    return (out[0], _subset_maps(qkv, heads, emit), *out[2:])


def headwise_kernels(route: str, x: torch.Tensor, qkv: torch.Tensor,
                     p: Params, heads: int, want_attn: bool = False,
                     want_mean: bool = False, fast_softmax: bool = True):
    """The headwise block after LN1 + QKV: one launch of ``route``'s kernels
    ("fma", "mma" or "tf32") on x [B, N, D] and its qkv [B, N, 3D] (both
    contiguous on the card, the route ``headwise_route`` gives them);
    returns (y, probs [B, H, N, N] | None) [, mean]. Counts nothing: the
    wrappers count their launches."""
    b, n, d = x.shape
    if route == "fma":
        lib = _headwise_lib()
        entry, lead = lib.ivt_headwise_attn_block, (_DTYPE_CODE[x.dtype],)
    else:
        if qkv.data_ptr() % MMA_ALIGN:
            raise RuntimeError("headwise_attn_block: the qkv workspace is "
                               "off the 16-byte grid")
        lib = _headwise_tc_lib(route)
        entry, lead = getattr(lib, _TC_SOURCES[route][1]), ()
    with torch.cuda.device(x.device):
        o_ws = torch.empty((b, n, d), dtype=x.dtype, device=x.device)
        # f32 per-head probs, summed in head order by the head-mean pass
        probs_ws = (torch.empty((b, heads, n, n), dtype=torch.float32,
                                device=x.device) if want_mean else None)
        y = torch.empty_like(x)
        probs = (torch.empty((b, heads, n, n), dtype=x.dtype,
                             device=x.device) if want_attn else None)
        mean = (torch.empty((b, n, n), dtype=x.dtype, device=x.device)
                if want_mean else None)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(
            *lead, x.data_ptr(), qkv.data_ptr(), p["proj_w"].data_ptr(),
            p["proj_b"].data_ptr(), o_ws.data_ptr(),
            None if probs_ws is None else probs_ws.data_ptr(), y.data_ptr(),
            None if probs is None else probs.data_ptr(),
            None if mean is None else mean.data_ptr(), b, n, d, heads,
            float(d // heads) ** -0.5, 1.0 / heads, int(bool(fast_softmax)),
            stream)
    if err != 0:
        raise RuntimeError(f"headwise_attn_block kernel launch failed on the "
                           f"{route} route: cudaError {err}")
    if want_mean:
        return y, probs, mean
    return y, probs


def headwise_attn_block(
    x: torch.Tensor,
    p: Params,
    heads: int,
    eps: float = 1e-6,
    want_attn: bool = False,
    want_mean: bool = False,
    fast_softmax: bool = True,
    attn_heads: Optional[Tuple[int, ...]] = None,
):
    """x [B, N, D] -> (x + proj(MHSA(LN(x))), probs [B, H|sel, N, N] | None)
    [, mean [B, N, N] when ``want_mean``]; the contract of
    ``fused_attn_block`` for blocks too long for it.

    LN1 and QKV run as plain PyTorch ops, then one kernel launch does the
    per-head attention, the head-mean and the projection with the
    residual. An ``attn_heads`` subset's maps are recomputed outside the
    kernel (exact softmax) and the kernel runs maps-off. Operands that
    ``headwise_route`` sends to the tensor cores go to
    ``headwise_attn_block_mma`` (bf16) or ``headwise_attn_block_tf32x3``
    (f32), each counting its launches; this wrapper's count is the FMA
    kernel's."""
    kw = dict(want_attn=want_attn, want_mean=want_mean,
              fast_softmax=fast_softmax, attn_heads=attn_heads)
    if x.device.type == "cpu":
        return headwise_attn_block_reference(x, p, heads, eps, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"headwise_attn_block runs on cuda or cpu tensors, "
                         f"got {x.device}")
    _emit_heads(heads, want_attn, attn_heads)
    _check_operands(x, p, heads, "headwise_attn_block", fits_headwise)
    from interactive_vit_tpu_torch.ops import custom_ops

    return custom_ops.headwise_attn_block(x, p, heads, eps, **kw)


headwise_attn_block.launches = 0


def headwise_launch(x: torch.Tensor, p: Params, heads: int, eps: float,
                    **kw):
    """``ivt::headwise_attn_block``'s CUDA body (``ops/custom_ops.py``) on
    checked operands: the route ``headwise_route`` gives them, one launch
    counted in that route's wrapper."""
    route = _route_of(x, p, heads)
    if route == "mma":
        return headwise_attn_block_mma(x, p, heads, eps, **kw)
    if route == "tf32":
        return headwise_attn_block_tf32x3(x, p, heads, eps, **kw)
    out = _launch_headwise("fma", x, p, heads, eps, **kw)
    headwise_attn_block.launches += 1
    return out


def _headwise_tc(route, name, x, p, heads, eps, **kw):
    """A tensor-core route's wrapper: the plain version for a CPU tensor;
    on the card one launch, or ``ValueError`` for operands that
    ``headwise_route`` does not send to ``route``."""
    if x.device.type == "cpu":
        return headwise_attn_block_reference(x, p, heads, eps, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{x.device}")
    _emit_heads(heads, kw["want_attn"], kw["attn_heads"])
    _check_operands(x, p, heads, name, fits_headwise)
    if _route_of(x, p, heads) != route:
        raise ValueError(
            f"{name} takes {'bf16' if route == 'mma' else 'f32'} heads "
            f"{_TC_WIDTHS} wide with 16-byte aligned operands, got "
            f"{x.dtype}, dh={x.shape[-1] // heads}")
    return _launch_headwise(route, x, p, heads, eps, **kw)


def headwise_attn_block_mma(
    x: torch.Tensor,
    p: Params,
    heads: int,
    eps: float = 1e-6,
    want_attn: bool = False,
    want_mean: bool = False,
    fast_softmax: bool = True,
    attn_heads: Optional[Tuple[int, ...]] = None,
):
    """``headwise_attn_block``'s contract in bf16 on the tensor cores
    (``csrc/headwise_attn_block_mma.cu``): one launch for CUDA tensors,
    counted in ``headwise_attn_block_mma.launches``; raises on operands
    that ``headwise_route`` does not send there. For CPU tensors the plain
    version."""
    out = _headwise_tc("mma", "headwise_attn_block_mma", x, p, heads, eps,
                       want_attn=want_attn, want_mean=want_mean,
                       fast_softmax=fast_softmax, attn_heads=attn_heads)
    if x.device.type == "cuda":
        headwise_attn_block_mma.launches += 1
    return out


headwise_attn_block_mma.launches = 0


def headwise_attn_block_tf32x3(
    x: torch.Tensor,
    p: Params,
    heads: int,
    eps: float = 1e-6,
    want_attn: bool = False,
    want_mean: bool = False,
    fast_softmax: bool = True,
    attn_heads: Optional[Tuple[int, ...]] = None,
):
    """``headwise_attn_block``'s contract in f32 on split-TF32 tensor-core
    products (``csrc/headwise_attn_block_tf32.cu``): one launch for CUDA
    tensors, counted in ``headwise_attn_block_tf32x3.launches``; raises on
    operands that ``headwise_route`` does not send there. For CPU tensors
    the plain version."""
    out = _headwise_tc("tf32", "headwise_attn_block_tf32x3", x, p, heads,
                       eps, want_attn=want_attn, want_mean=want_mean,
                       fast_softmax=fast_softmax, attn_heads=attn_heads)
    if x.device.type == "cuda":
        headwise_attn_block_tf32x3.launches += 1
    return out


headwise_attn_block_tf32x3.launches = 0
