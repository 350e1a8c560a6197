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
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from interactive_vit_tpu_torch.ops import layers as L
from interactive_vit_tpu_torch.ops import quant, tiled_attention

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
    int8_scores: bool = False,
    int8_pv: bool = True,
):
    """Plain PyTorch version of the kernel, same contract and cast points.

    ``int8_scores`` (and ``int8_pv``): the s8 mode, with the JAX kernel's
    quantizers (``quant_rows_mosaic`` / ``quant_cols_mosaic``, half up) and
    exact integer products (float64 matmuls of the int8 values).

    Returns ``(y, probs | None)``, or ``(y, probs | None, mean)`` when
    ``want_mean``."""
    emit = _emit_heads(heads, want_attn, attn_heads)
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
        norm[list(emit)] = True
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
    tap = None
    if want_attn:
        tap = pb if emit is None else pb[:, list(emit)]
    if want_mean:
        msum = probs[:, 0]
        for h in range(1, heads):  # the kernel's head order, in f32
            msum = msum + probs[:, h]
        return y, tap, (msum * (1.0 / heads)).to(dt)
    return y, tap


def _kernel_lib() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("fused_attn_block")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_fused_attn_block.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 3
            + [ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p])
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


def _launch_block(x, p, heads, eps, want_attn, want_mean, fast_softmax,
                  attn_heads, int8_mode: int):
    """One launch of ``csrc/fused_attn_block.cu`` (``int8_mode``: 0 dense,
    1 s8 scores with a dense PV product, 2 s8 scores and PV); returns the
    wrapper's result."""
    emit = _emit_heads(heads, want_attn, attn_heads)
    _check_operands(x, p, heads, int8_scores=int8_mode > 0)
    b, n, d = x.shape
    emit_list = (list(range(heads)) if emit is None else list(emit)) \
        if want_attn else []
    mask = 0
    for h in emit_list:
        mask |= 1 << h
    lib = _kernel_lib()
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
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ivt_fused_attn_block(
            _DTYPE_CODE[x.dtype], x.data_ptr(), p["ln1_s"].data_ptr(),
            p["ln1_b"].data_ptr(), p["qkv_w"].data_ptr(),
            p["qkv_b"].data_ptr(), p["proj_w"].data_ptr(),
            p["proj_b"].data_ptr(), qkv_ws.data_ptr(), o_ws.data_ptr(),
            None if probs_ws is None else probs_ws.data_ptr(), y.data_ptr(),
            None if probs is None else probs.data_ptr(),
            None if mean is None else mean.data_ptr(), b, n, d, heads,
            float(eps), float(d // heads) ** -0.5, 1.0 / heads,
            int(bool(fast_softmax)), mask, len(emit_list), int8_mode, stream)
    if err != 0:
        raise RuntimeError(f"fused_attn_block kernel launch failed: "
                           f"cudaError {err}")
    if want_mean:
        return y, probs, mean
    return y, probs


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
    [, mean [B, N, N] when ``want_mean``].

    Arguments as the JAX function's. ``attn_heads`` limits the probs tap
    to those heads (ascending order); the others are never written.
    ``int8_scores`` / ``int8_pv`` run the s8 mode (``fused_attn_block_s8``,
    which counts those launches). ``key_bias``/``want_metric`` (ToMe) are
    not ported yet and raise ``NotImplementedError``."""
    if key_bias is not None or want_metric:
        raise NotImplementedError(
            "key_bias / want_metric (ToMe) are not ported to the CUDA block "
            "kernel yet")
    if int8_scores:
        return fused_attn_block_s8(
            x, p, heads, eps, want_attn=want_attn, want_mean=want_mean,
            fast_softmax=fast_softmax, attn_heads=attn_heads,
            int8_pv=int8_pv)
    if not _on_device(x, "fused_attn_block"):
        return fused_attn_block_reference(
            x, p, heads, eps, want_attn=want_attn, want_mean=want_mean,
            fast_softmax=fast_softmax, attn_heads=attn_heads)
    out = _launch_block(x, p, heads, eps, want_attn, want_mean,
                        fast_softmax, attn_heads, 0)
    fused_attn_block.launches += 1
    return out


fused_attn_block.launches = 0


def fused_attn_block_s8(
    x: torch.Tensor,
    p: Params,
    heads: int,
    eps: float = 1e-6,
    want_attn: bool = False,
    want_mean: bool = False,
    fast_softmax: bool = True,
    attn_heads: Optional[Tuple[int, ...]] = None,
    int8_pv: bool = True,
):
    """The s8 mode of ``fused_attn_block`` (the JAX function's
    ``int8_scores=True``; ``int8_pv`` quantizes the PV product too), same
    contract. On a CUDA tensor one launch of the block kernel with its s8
    attention (envelope ``fits(..., int8_scores=True)``), counted in
    ``fused_attn_block_s8.launches``; on a CPU tensor the plain version."""
    if not _on_device(x, "fused_attn_block_s8"):
        return fused_attn_block_reference(
            x, p, heads, eps, want_attn=want_attn, want_mean=want_mean,
            fast_softmax=fast_softmax, attn_heads=attn_heads,
            int8_scores=True, int8_pv=int8_pv)
    out = _launch_block(x, p, heads, eps, want_attn, want_mean,
                        fast_softmax, attn_heads, 2 if int8_pv else 1)
    fused_attn_block_s8.launches += 1
    return out


fused_attn_block_s8.launches = 0


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
    q, k = (qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, dh)
            [:, :, list(emit)].transpose(1, 2) for i in range(2))
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


def _headwise_lib() -> ctypes.CDLL:
    """Build (first use) and load the headwise kernel library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("headwise_attn_block")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_headwise_attn_block.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
        lib.ivt_headwise_attn_block.restype = ctypes.c_int
        lib._ivt_bound = True
    return lib


def load_headwise_kernel() -> ctypes.CDLL:
    """Build and load the headwise kernel now; checks that the library's
    shared-memory formula is the envelope's."""
    lib = _headwise_lib()
    tiled_attention.check_library(lib)
    return lib


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
    kernel (exact softmax) and the kernel runs maps-off."""
    if x.device.type == "cpu":
        return headwise_attn_block_reference(
            x, p, heads, eps, want_attn=want_attn, want_mean=want_mean,
            fast_softmax=fast_softmax, attn_heads=attn_heads)
    if x.device.type != "cuda":
        raise ValueError(f"headwise_attn_block runs on cuda or cpu tensors, "
                         f"got {x.device}")
    emit = _emit_heads(heads, want_attn, attn_heads)
    _check_operands(x, p, heads, "headwise_attn_block", fits_headwise)
    b, n, d = x.shape
    qkv = _ln_qkv(x, p, eps)
    sel = None
    if emit is not None:
        sel = _subset_maps(qkv, heads, emit)
        want_attn = False  # the kernel itself runs maps-off
    lib = _headwise_lib()
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
        err = lib.ivt_headwise_attn_block(
            _DTYPE_CODE[x.dtype], x.data_ptr(), qkv.data_ptr(),
            p["proj_w"].data_ptr(), p["proj_b"].data_ptr(), o_ws.data_ptr(),
            None if probs_ws is None else probs_ws.data_ptr(), y.data_ptr(),
            None if probs is None else probs.data_ptr(),
            None if mean is None else mean.data_ptr(), b, n, d, heads,
            float(d // heads) ** -0.5, 1.0 / heads, int(bool(fast_softmax)),
            stream)
    if err != 0:
        raise RuntimeError(f"headwise_attn_block kernel launch failed: "
                           f"cudaError {err}")
    headwise_attn_block.launches += 1
    if sel is not None:
        probs = sel
    if want_mean:
        return y, probs, mean
    return y, probs


headwise_attn_block.launches = 0
