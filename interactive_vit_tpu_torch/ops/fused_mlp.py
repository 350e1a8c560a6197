"""Fused MLP branch: LN2 + fc1 + GELU + fc2 + residual in one kernel.

Counterpart of ``interactive_vit_tpu/ops/fused_mlp.py``'s Pallas TPU kernel
``fused_mlp_block``, in three pieces, as every kernel of this package has:

* ``fused_mlp_block`` -- the wrapper. For a CUDA tensor it launches the
  hand-written kernel (``csrc/fused_mlp_block.cu``, built at first use) or
  raises; for a CPU tensor it runs the plain version. It counts its kernel
  launches in ``fused_mlp_block.launches``.
* ``fused_mlp_block_reference`` -- the plain PyTorch version with the same
  cast points, used on the CPU and to check the kernel on the card.
* ``fits`` -- the kernel's shape envelope, used by ``ops/dispatch.py``.

Numerics (the JAX kernel's): LayerNorm with f32 statistics cast to the
activation dtype; ``h = gelu_tanh(ln @ fc1_w + fc1_b)`` accumulated and
activated in f32, cast -- the tanh GELU in EVERY dtype, unlike
``layers.gelu`` (erf in f32); ``y = (x + h @ fc2_w) + fc2_b`` in f32, cast.
The hidden activations never reach device memory.

The W8A8 variant has the same three pieces: ``fused_mlp_w8a8_block``
(kernel ``csrc/fused_mlp_w8a8_block.cu``, count
``fused_mlp_w8a8_block.launches``), ``fused_mlp_w8a8_reference`` and
``fits_w8a8``. Its cast points are the JAX ``_w8a8_kernel``'s: LN cast to
the activation dtype and back, per-row ``quant_rows_mosaic`` (half up),
exact s8 x s8 -> s32 products, ``acc.f32 * (sx * s_w) + b``, the tanh GELU
on the activation dtype, per-row requantization, and the residual in f32.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict

import torch
import torch.nn.functional as F

from interactive_vit_tpu_torch.ops import quant
from interactive_vit_tpu_torch.ops.tiled_attention import SMEM_LIMIT

Params = Dict[str, Any]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Mirrors csrc/fused_mlp_block.cu: a thread owns up to 5 of the 256-column
# slots of a row's output, so the widest x is 1280 (its LN'd 16-row strip
# and one chunk of h take 98 KB of a block's shared memory, always inside
# the limit). ``load_kernel`` checks the number against the library's.
MAX_WIDTH = 5 * 256


def fits(d: int, mlp_dim: int) -> bool:
    """True when the kernel takes rows of width ``d`` with ``mlp_dim``
    hidden columns: the [16, d] accumulator fits a thread's registers
    (d <= 1280)."""
    return 0 < d <= MAX_WIDTH and mlp_dim > 0


def fused_mlp_block_reference(x: torch.Tensor, p: Params,
                              eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same contract and cast points:
    x [B, N, D] -> x + MLP(LN2(x))."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    ln = (xf - mu) * torch.rsqrt(var + eps)
    ln = (ln * p["ln2_s"].float() + p["ln2_b"].float()).to(dt)
    h = torch.matmul(ln.float(), p["fc1_w"].float()) + p["fc1_b"].float()
    h = F.gelu(h, approximate="tanh").to(dt)
    y = (xf + torch.matmul(h.float(), p["fc2_w"].float())
         + p["fc2_b"].float())
    return y.to(dt)


def _kernel_lib() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("fused_mlp_block")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_fused_mlp_block.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p])
        lib.ivt_fused_mlp_block.restype = ctypes.c_int
        lib.ivt_mlp_max_width.argtypes = []
        lib.ivt_mlp_max_width.restype = ctypes.c_int
        lib._ivt_bound = True
    return lib


def load_kernel() -> ctypes.CDLL:
    """Build and load the CUDA kernel now (``chip_smoke.py`` times this);
    checks that the library's widest row is the envelope's."""
    lib = _kernel_lib()
    if lib.ivt_mlp_max_width() != MAX_WIDTH:
        raise RuntimeError("csrc/fused_mlp_block.cu and fits() disagree on "
                           "the widest row the kernel takes")
    return lib


def _check_operands(x: torch.Tensor, p: Params) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_mlp_block kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"x must be [B, N, D], got shape {tuple(x.shape)}")
    d = x.shape[-1]
    md = p["fc1_w"].shape[-1]
    if not fits(d, md) or x.numel() == 0:
        raise ValueError(f"fused_mlp_block kernel does not take x "
                         f"{tuple(x.shape)} with mlp_dim={md} (see fits())")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (the kernel takes no strides)")
    want = {"ln2_s": (d,), "ln2_b": (d,), "fc1_w": (d, md), "fc1_b": (md,),
            "fc2_w": (md, d), "fc2_b": (d,)}
    for name, shape in want.items():
        t = p[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the kernel "
                             f"needs {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_mlp_block(x: torch.Tensor, p: Params,
                    eps: float = 1e-6) -> torch.Tensor:
    """x [B, N, D] -> x + MLP(LN2(x)) in one kernel launch; x must be
    contiguous. ``p`` holds ln2_s, ln2_b, fc1_w [D, 4D], fc1_b, fc2_w
    [4D, D], fc2_b."""
    if x.device.type == "cpu":
        return fused_mlp_block_reference(x, p, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_block runs on cuda or cpu tensors, got "
                         f"{x.device}")
    _check_operands(x, p)
    b, n, d = x.shape
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ivt_fused_mlp_block(
            _DTYPE_CODE[x.dtype], x.data_ptr(), p["ln2_s"].data_ptr(),
            p["ln2_b"].data_ptr(), p["fc1_w"].data_ptr(),
            p["fc1_b"].data_ptr(), p["fc2_w"].data_ptr(),
            p["fc2_b"].data_ptr(), y.data_ptr(), b * n, d,
            p["fc1_w"].shape[-1], float(eps), stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_block kernel launch failed: "
                           f"cudaError {err}")
    fused_mlp_block.launches += 1
    return y


fused_mlp_block.launches = 0


# -- fused_mlp_w8a8_block ----------------------------------------------------
#
# Mirrors csrc/fused_mlp_w8a8_block.cu: a block takes an 8-row strip and
# holds its q1 words, its whole hidden block h (activation dtype) and h's
# int8 form in shared memory; ``load_w8a8_kernel`` checks both numbers
# against the library's.
W8A8_ROWS = 8
W8A8_MAX_WIDTH = 5 * 256


def w8a8_smem_bytes(d: int, mlp_dim: int, esize: int) -> int:
    """Dynamic shared memory of the W8A8 kernel: q1 [8, d] int8, h [8,
    mlp_dim] in the activation dtype (``esize`` bytes), q2 [8, mlp_dim]
    int8."""
    return W8A8_ROWS * (d + mlp_dim * esize + mlp_dim)


def fits_w8a8(d: int, mlp_dim: int, dtype=torch.bfloat16) -> bool:
    """True when the W8A8 kernel takes rows of width ``d`` with ``mlp_dim``
    hidden columns in ``dtype``: both multiples of 4 (whole __dp4a words),
    d <= 1280 (the fc2 accumulator in registers) and the strip's hidden
    block inside the card's shared memory (mlp_dim up to ~9400 in bf16,
    ~5600 in f32 at d=1280)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    return (0 < d <= W8A8_MAX_WIDTH and mlp_dim > 0 and d % 4 == 0
            and mlp_dim % 4 == 0
            and w8a8_smem_bytes(d, mlp_dim, esize) <= SMEM_LIMIT)


def fused_mlp_w8a8_parts(x: torch.Tensor, p: Params, eps: float = 1e-6):
    """The plain version's result and its integer stages: ``(y, {"q1":
    int8 [B,N,D], "acc1": int32 [B,N,4D], "q2": int8 [B,N,4D], "acc2":
    int32 [B,N,D]})``. The products are float64 matmuls of the int8 values,
    exact (|acc| <= 127^2 * 4D < 2^53), so the accumulators are the
    integers the kernel's s32 sums hold."""
    dt = x.dtype
    w1, w2 = p["fc1_w"], p["fc2_w"]
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    ln = (xf - mu) * torch.rsqrt(var + eps)
    ln = (ln * p["ln2_s"].float() + p["ln2_b"].float()).to(dt).float()
    q1, sx1 = quant.quant_rows_mosaic(ln)
    acc1 = quant.int_matmul(q1, w1[quant.AQKEY])
    h = acc1.float() * (sx1 * w1[quant.ASKEY]) + p["fc1_b"].float()
    h = F.gelu(h.to(dt), approximate="tanh").float()
    q2, sx2 = quant.quant_rows_mosaic(h)
    acc2 = quant.int_matmul(q2, w2[quant.AQKEY])
    y = xf + acc2.float() * (sx2 * w2[quant.ASKEY]) + p["fc2_b"].float()
    return y.to(dt), {"q1": q1, "acc1": acc1, "q2": q2, "acc2": acc2}


def fused_mlp_w8a8_reference(x: torch.Tensor, p: Params,
                             eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the W8A8 kernel, same contract and cast
    points (``quant_rows_mosaic``: half up, as the kernel):
    x [B, N, D] -> x + MLP_w8a8(LN2(x))."""
    return fused_mlp_w8a8_parts(x, p, eps)[0]


def _w8a8_lib() -> ctypes.CDLL:
    """Build (first use) and load the W8A8 kernel library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("fused_mlp_w8a8_block")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_fused_mlp_w8a8_block.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p])
        lib.ivt_fused_mlp_w8a8_block.restype = ctypes.c_int
        lib.ivt_mlp_w8a8_max_width.argtypes = []
        lib.ivt_mlp_w8a8_max_width.restype = ctypes.c_int
        lib.ivt_mlp_w8a8_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ivt_mlp_w8a8_smem_bytes.restype = ctypes.c_size_t
        lib._ivt_bound = True
    return lib


def load_w8a8_kernel() -> ctypes.CDLL:
    """Build and load the W8A8 kernel now; checks that the library's widest
    row and shared-memory formula are the envelope's."""
    lib = _w8a8_lib()
    if lib.ivt_mlp_w8a8_max_width() != W8A8_MAX_WIDTH or any(
            lib.ivt_mlp_w8a8_smem_bytes(d, md, e) != w8a8_smem_bytes(d, md, e)
            for d, md, e in ((768, 3072, 2), (1280, 5120, 4), (96, 384, 2))):
        raise RuntimeError("csrc/fused_mlp_w8a8_block.cu and fits_w8a8() "
                           "disagree on the kernel's envelope")
    return lib


def _check_w8a8_operands(x: torch.Tensor, p: Params) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_mlp_w8a8_block kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"x must be a contiguous non-empty [B, N, D], got "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    for name in ("fc1_w", "fc2_w"):
        if not quant.is_w8a8(p[name]):
            raise ValueError(f"{name} must be a W8A8 leaf-dict "
                             f"(ops/quant.quantize_tree mode='w8a8')")
    md = p["fc1_w"][quant.AQKEY].shape[-1]
    if not fits_w8a8(d, md, x.dtype):
        raise ValueError(f"fused_mlp_w8a8_block kernel does not take x "
                         f"{tuple(x.shape)} with mlp_dim={md} in {x.dtype} "
                         f"(see fits_w8a8())")
    want = {"ln2_s": ((d,), x.dtype), "ln2_b": ((d,), x.dtype),
            "fc1_b": ((md,), x.dtype), "fc2_b": ((d,), x.dtype)}
    leaves = dict(p)
    for name, (q_shape, s_shape) in (("fc1_w", ((d, md), (md,))),
                                     ("fc2_w", ((md, d), (d,)))):
        leaves[name + ".q"] = p[name][quant.AQKEY]
        leaves[name + ".s"] = p[name][quant.ASKEY]
        want[name + ".q"] = (q_shape, torch.int8)
        want[name + ".s"] = (s_shape, torch.float32)
    for name, (shape, dtype) in want.items():
        t = leaves[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the kernel "
                             f"needs {dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_mlp_w8a8_block(x: torch.Tensor, p: Params, eps: float = 1e-6,
                         want_parts: bool = False):
    """x [B, N, D] -> x + MLP_w8a8(LN2(x)) in one kernel launch; x must be
    contiguous, ``p["fc1_w"]`` / ``p["fc2_w"]`` W8A8 leaf-dicts.
    ``want_parts`` also returns the integer stages ``{"q1", "acc1", "q2",
    "acc2"}`` (``fused_mlp_w8a8_parts``), written by the kernel itself on a
    CUDA tensor, so a check can hold its s32 sums against exact ones."""
    if x.device.type == "cpu":
        y, parts = fused_mlp_w8a8_parts(x, p, eps)
        return (y, parts) if want_parts else y
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_w8a8_block runs on cuda or cpu tensors, "
                         f"got {x.device}")
    _check_w8a8_operands(x, p)
    b, n, d = x.shape
    w1, w2 = p["fc1_w"], p["fc2_w"]
    md = w1[quant.AQKEY].shape[-1]
    lib = _w8a8_lib()
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        parts = ({"q1": torch.empty((b, n, d), dtype=torch.int8,
                                    device=x.device),
                  "acc1": torch.empty((b, n, md), dtype=torch.int32,
                                      device=x.device),
                  "q2": torch.empty((b, n, md), dtype=torch.int8,
                                    device=x.device),
                  "acc2": torch.empty((b, n, d), dtype=torch.int32,
                                      device=x.device)}
                 if want_parts else {})
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ivt_fused_mlp_w8a8_block(
            _DTYPE_CODE[x.dtype], x.data_ptr(), p["ln2_s"].data_ptr(),
            p["ln2_b"].data_ptr(), w1[quant.AQKEY].data_ptr(),
            w1[quant.ASKEY].data_ptr(), p["fc1_b"].data_ptr(),
            w2[quant.AQKEY].data_ptr(), w2[quant.ASKEY].data_ptr(),
            p["fc2_b"].data_ptr(), y.data_ptr(),
            *(parts[k].data_ptr() if parts else None
              for k in ("q1", "acc1", "q2", "acc2")),
            b * n, d, md, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_w8a8_block kernel launch failed: "
                           f"cudaError {err}")
    fused_mlp_w8a8_block.launches += 1
    return (y, parts) if want_parts else y


fused_mlp_w8a8_block.launches = 0
