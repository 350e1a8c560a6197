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

A public wrapper reaches its kernels on a CUDA tensor through its
``torch.library`` custom op (``ops/custom_ops.py``: the launch is the op's
body, so ``torch.export`` records the op where fake tensors have no
address to route by).

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

Both have kernels on Hopper's tensor cores, chosen by each wrapper by
dtype, shape and 16-byte alignment (``mlp_route``, ``w8a8_route``), never
by a failed build or launch:

* ``fused_mlp_block_mma`` (bf16, ``csrc/fused_mlp_block_mma.cu``, count
  ``fused_mlp_block_mma.launches``), ``fused_mlp_block_tf32x3`` (f32 on
  split TF32: three TF32 products a product, ``csrc/fused_mlp_block_tf32.cu``,
  count ``fused_mlp_block_tf32x3.launches``) and
  ``fused_mlp_w8a8_block_mma`` (bf16 or f32 activations,
  ``csrc/fused_mlp_w8a8_mma.cu``, count
  ``fused_mlp_w8a8_block_mma.launches``): rows a multiple of a chunk wide
  up to ``MMA_MAX_WIDTH`` (the chunk ``chunk_of(d)``: ``MMA_CHUNK`` = 128,
  or ``MMA_NARROW_CHUNK`` = 96 for rows a multiple of 96 but not of 128,
  swin_t's stages 0 and 1), a hidden
  dimension of whole chunks, the operands 16-byte aligned, the block's
  shared memory inside the card's. A cluster of ``cluster_of(d,
  mlp_dim)`` blocks takes a tile of 32 or 64 rows (``row_tile``) and each
  block a slice of the hidden dimension; fc2's partial sums are added over
  the cluster in rank order, so two calls give the same bits. The FMA and
  ``__dp4a`` kernels above keep every other operand and count their own
  launches only.

The 16-byte alignment these routes need is that of every operand they read
with 16-byte loads: x, ln2_s, ln2_b and the (int8) weight matrices.
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

# The C entries' parameters: the FMA kernel's (dtype, 8 pointers, M, D, MD,
# eps, stream), the bf16 and split-TF32 tensor-core kernels' (no dtype; the
# row tile after MD), the __dp4a kernel's (dtype, 14 pointers, M, D, MD,
# eps, stream) and the int8 tensor-core kernel's (the row tile after MD).
MLP_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                + [ctypes.c_float, ctypes.c_void_p])
MLP_MMA_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                    + [ctypes.c_float, ctypes.c_void_p])
W8A8_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 14
                 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
W8A8_MMA_ARGTYPES = W8A8_ARGTYPES[:18] + [ctypes.c_int] + W8A8_ARGTYPES[18:]


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
        lib.ivt_fused_mlp_block.argtypes = MLP_ARGTYPES
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
    [4D, D], fc2_b. Operands that ``mlp_route`` sends to the tensor cores
    go to ``fused_mlp_block_mma`` (bf16) or ``fused_mlp_block_tf32x3``
    (f32), which count them; this wrapper counts the FMA kernel's
    launches."""
    if x.device.type == "cpu":
        return fused_mlp_block_reference(x, p, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_block runs on cuda or cpu tensors, got "
                         f"{x.device}")
    _check_operands(x, p)
    from interactive_vit_tpu_torch.ops import custom_ops

    return custom_ops.fused_mlp_block(x, p, eps)


fused_mlp_block.launches = 0


def mlp_launch(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """``ivt::fused_mlp_block``'s CUDA body (``ops/custom_ops.py``) on
    checked operands: the tensor-core routes through their wrappers, which
    count them, else one FMA launch counted in
    ``fused_mlp_block.launches``."""
    route = _mlp_route_of(x, p)
    if route != "fma":
        return _MLP_ROUTE_WRAPPERS[route](x, p, eps)
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
        lib.ivt_fused_mlp_w8a8_block.argtypes = W8A8_ARGTYPES
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
    CUDA tensor, so a check can hold its s32 sums against exact ones.
    Operands that ``w8a8_route`` sends to the tensor cores go to
    ``fused_mlp_w8a8_block_mma``, which counts them; this wrapper counts
    the ``__dp4a`` kernel's launches."""
    if x.device.type == "cpu":
        y, parts = fused_mlp_w8a8_parts(x, p, eps)
        return (y, parts) if want_parts else y
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_w8a8_block runs on cuda or cpu tensors, "
                         f"got {x.device}")
    _check_w8a8_operands(x, p)
    if want_parts:
        return w8a8_launch(x, p, eps, True)
    from interactive_vit_tpu_torch.ops import custom_ops

    return custom_ops.fused_mlp_w8a8_block(x, p, eps)


fused_mlp_w8a8_block.launches = 0


def w8a8_launch(x: torch.Tensor, p: Params, eps: float,
                want_parts: bool = False):
    """``ivt::fused_mlp_w8a8_block``'s CUDA body (``ops/custom_ops.py``) on
    checked operands (and, with ``want_parts``, the wrapper's check of the
    integer stages, which calls it directly): the tensor-core route
    through its wrapper, which counts it, else one ``__dp4a`` launch
    counted in ``fused_mlp_w8a8_block.launches``."""
    if _w8a8_route_of(x, p) == "mma":
        return fused_mlp_w8a8_block_mma(x, p, eps, want_parts)
    lib = _w8a8_lib()
    out = _launch_w8a8(lib.ivt_fused_mlp_w8a8_block, x, p, eps, want_parts)
    fused_mlp_w8a8_block.launches += 1
    return out


def _launch_w8a8(entry, x: torch.Tensor, p: Params, eps: float,
                 want_parts: bool, tile=()):
    """One launch of a W8A8 kernel's C entry (the tensor-core kernel's
    also takes its row tile, ``tile``, after MD); returns y, or (y, parts)
    with ``want_parts``."""
    b, n, d = x.shape
    w1, w2 = p["fc1_w"], p["fc2_w"]
    md = w1[quant.AQKEY].shape[-1]
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
        err = entry(
            _DTYPE_CODE[x.dtype], x.data_ptr(), p["ln2_s"].data_ptr(),
            p["ln2_b"].data_ptr(), w1[quant.AQKEY].data_ptr(),
            w1[quant.ASKEY].data_ptr(), p["fc1_b"].data_ptr(),
            w2[quant.AQKEY].data_ptr(), w2[quant.ASKEY].data_ptr(),
            p["fc2_b"].data_ptr(), y.data_ptr(),
            *(parts[k].data_ptr() if parts else None
              for k in ("q1", "acc1", "q2", "acc2")),
            b * n, d, md, *tile, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"W8A8 MLP kernel launch failed: cudaError {err}")
    return (y, parts) if want_parts else y



# -- the tensor-core routes ------------------------------------------------------
#
# Mirrors csrc/mlp_cluster.cuh: a cluster of ``cluster_of(d, mlp_dim)``
# blocks takes a tile of 32 or MMA_ROWS rows (``row_tile`` picks by the
# row count; the bf16 and W8A8 envelopes are the larger tile's, the
# split-TF32 one its smallest tile's); block ``rank`` computes the hidden columns
# [rank * mlp_dim / S, (rank + 1) * mlp_dim / S), a chunk at a time, and
# fc2's output a chunk of columns at a time, whose S partial sums the
# cluster adds in rank order. The loaders check every number against the
# libraries'.
MMA_ROWS = 64
MMA_CHUNK = 128
MMA_NARROW_CHUNK = 96
MMA_MAX_CLUSTER = 8
MMA_MIN_CLUSTER = 4
MMA_MAX_WIDTH = 1280
MMA_ALIGN = 16
_MMA_STAGES = 3
# the bf16 kernel's weight stages at each chunk: (k rows, row stride in
# elements); the split-TF32 kernel's: TF32_STAGE_ROWS k rows of chunk + 4
# floats; at tiles of TF32_PRESPLIT_ROWS rows (chunks of 128 only) it keeps
# its A operands as hi and lo panels; the W8A8 kernel's: (k rows with bf16
# activations, with f32 ones, row stride in bytes)
_BF16_STAGE = {MMA_CHUNK: (64, MMA_CHUNK + 8),
               MMA_NARROW_CHUNK: (48, MMA_NARROW_CHUNK + 8)}
_W8_STAGE = {MMA_CHUNK: (128, 64, MMA_CHUNK + 32),
             MMA_NARROW_CHUNK: (96, 96, MMA_NARROW_CHUNK)}
TF32_STAGE_ROWS = 32
TF32_PRESPLIT_ROWS = 16


def cluster_size(mlp_dim: int, chunk: int = MMA_CHUNK) -> int:
    """Blocks of a cluster for ``mlp_dim`` hidden columns in chunks of
    ``chunk``: the largest power of two up to MMA_MAX_CLUSTER that divides
    mlp_dim / chunk, or 0 where that is below MMA_MIN_CLUSTER or mlp_dim is
    not a whole number of chunks (a 4x MLP on rows of a multiple of the
    chunk takes 4 or 8)."""
    if mlp_dim <= 0 or mlp_dim % chunk:
        return 0
    s = MMA_MAX_CLUSTER
    while mlp_dim % (chunk * s):
        s //= 2
    return s if s >= MMA_MIN_CLUSTER else 0


def chunk_of(d: int) -> int:
    """The chunk of the bf16 and split-TF32 kernels for rows of width
    ``d``: MMA_CHUNK where d is a multiple of it, else MMA_NARROW_CHUNK
    where d is a multiple of that (swin_t's 96 and 192), up to
    MMA_MAX_WIDTH; 0 otherwise."""
    if not 0 < d <= MMA_MAX_WIDTH:
        return 0
    if d % MMA_CHUNK == 0:
        return MMA_CHUNK
    return MMA_NARROW_CHUNK if d % MMA_NARROW_CHUNK == 0 else 0


def cluster_of(d: int, mlp_dim: int) -> int:
    """The cluster of the bf16 and split-TF32 kernels at rows of width
    ``d`` with ``mlp_dim`` hidden columns (in d's chunks), or 0."""
    chunk = chunk_of(d)
    return cluster_size(mlp_dim, chunk) if chunk else 0


def mma_smem_bytes(d: int, mlp_dim: int) -> int:
    """Dynamic shared memory of a bf16 tensor-core block of the larger
    tile: LN2's rows [64][d + 8] (later the two fc2 partial buffers of
    [64][chunk + 4] f32), h [64][slice + 8] and three weight tiles (64 x
    136 at chunks of 128, 48 x 104 at 96), bf16; 0 where the route takes no
    such shape."""
    s = cluster_of(d, mlp_dim)
    if not s:
        return 0
    chunk = chunk_of(d)
    rows, ld = _BF16_STAGE[chunk]
    return (max(MMA_ROWS * (d + 8) * 2, 2 * MMA_ROWS * (chunk + 4) * 4)
            + MMA_ROWS * (mlp_dim // s + 8) * 2 + _MMA_STAGES * rows * ld * 2)


def tf32_tiles(d: int) -> tuple:
    """The split-TF32 kernel's row tiles for rows of width ``d``: 16, 32
    and 64 at chunks of 128, 32 and 64 at chunks of 96."""
    return (16, 32, 64) if chunk_of(d) == MMA_CHUNK else (32, 64)


def tf32_smem_bytes(d: int, mlp_dim: int, bm: int) -> int:
    """Dynamic shared memory of a split-TF32 block with tiles of ``bm``
    rows: LN2's rows [bm][d + 8] (later the two fc2 partial buffers of
    [bm][chunk + 4]) and h [bm][slice + 8], each twice (hi and lo) at
    TF32_PRESPLIT_ROWS, and three weight tiles of 32 x (chunk + 4), all
    f32; 0 where the kernel has no such tile for the shape (a block over
    the card's shared memory is counted all the same)."""
    s = cluster_of(d, mlp_dim)
    if not s or bm not in tf32_tiles(d):
        return 0
    chunk = chunk_of(d)
    panels = 2 if bm == TF32_PRESPLIT_ROWS else 1
    return (max(panels * bm * (d + 8) * 4, 2 * bm * (chunk + 4) * 4)
            + panels * bm * (mlp_dim // s + 8) * 4
            + _MMA_STAGES * TF32_STAGE_ROWS * (chunk + 4) * 4)


def _tf32_fits(d: int, mlp_dim: int, bm: int) -> bool:
    return 0 < tf32_smem_bytes(d, mlp_dim, bm) <= SMEM_LIMIT


def w8a8_mma_smem_bytes(d: int, mlp_dim: int, esize: int) -> int:
    """Dynamic shared memory of a W8A8 tensor-core block of the larger tile
    for an activation type of ``esize`` bytes: the row scales and maxes (7 x
    64 f32), q1 [64][d + 16] int8 (later the two fc2 partial buffers of
    [64][chunk + 4] 32-bit words), h [64][slice + 16 / esize] in the
    activation type (before it, 32 rows of x for LN2), q2 [64][slice + 16]
    int8 and three weight tiles (at chunks of 128: rows of 160 bytes, 128
    rows with bf16 activations, 64 with f32; at 96: 96 rows of 96 bytes);
    0 where the route takes no such shape."""
    s = cluster_of(d, mlp_dim)
    if not s:
        return 0
    chunk = chunk_of(d)
    slice_ = mlp_dim // s
    bf16_rows, f32_rows, ld = _W8_STAGE[chunk]
    return (7 * MMA_ROWS * 4
            + max(MMA_ROWS * (d + 16), 2 * MMA_ROWS * (chunk + 4) * 4)
            + max(MMA_ROWS * (slice_ + 16 // esize), MMA_ROWS // 2 * d)
            * esize
            + MMA_ROWS * (slice_ + 16)
            + _MMA_STAGES * (bf16_rows if esize == 2 else f32_rows) * ld)


def fits_mma(d: int, mlp_dim: int) -> bool:
    """True when the bf16 tensor-core kernel takes rows of width ``d`` with
    ``mlp_dim`` hidden columns: d a multiple of 128 or 96 up to 1280,
    mlp_dim of whole chunks of d's (``chunk_of``), the block inside the
    card's shared memory."""
    return 0 < mma_smem_bytes(d, mlp_dim) <= SMEM_LIMIT


def fits_tf32(d: int, mlp_dim: int) -> bool:
    """``fits_mma`` for the split-TF32 kernel: the same chunks, the block
    of its smallest tile inside the card's shared memory (vit_b16's
    200,192 bytes at 16 rows fit; vit_h14's 298,496 do not)."""
    return chunk_of(d) > 0 and _tf32_fits(d, mlp_dim, tf32_tiles(d)[0])


def fits_w8a8_mma(d: int, mlp_dim: int, dtype=torch.bfloat16) -> bool:
    """``fits_mma`` for the W8A8 tensor-core kernel in ``dtype``: the same
    chunks (swin_t's 96- and 192-wide stages at 96), and f32 h takes twice
    bf16's room: vit_b16's 225,024 bytes still fit, with half the weight
    stage; swin_b's last stage (1024 wide, hidden 4096) does not."""
    esize = torch.tensor([], dtype=dtype).element_size()
    return 0 < w8a8_mma_smem_bytes(d, mlp_dim, esize) <= SMEM_LIMIT


def _aligned(addrs) -> bool:
    return all(int(a) % MMA_ALIGN == 0 for a in addrs)


def mlp_route(dtype: torch.dtype, d: int, mlp_dim: int, addrs) -> str:
    """The fused MLP's kernel for operands of ``dtype`` with rows of width
    ``d``, ``mlp_dim`` hidden columns and base addresses (bytes) ``addrs``
    (x, ln2_s, ln2_b, fc1_w, fc2_w: what the kernel reads 16 bytes at a
    time), when every address is a multiple of 16 bytes: "mma" (bf16 on
    the tensor cores) for bf16 whose shape fits ``fits_mma``, "tf32" (f32
    on split TF32) for f32 whose shape fits ``fits_tf32``; else "fma" (the
    FMA kernel: other dtypes, operands off the 16-byte grid, widths
    neither route takes, blocks over the card's shared memory)."""
    if not _aligned(addrs):
        return "fma"
    if dtype == torch.bfloat16 and fits_mma(d, mlp_dim):
        return "mma"
    if dtype == torch.float32 and fits_tf32(d, mlp_dim):
        return "tf32"
    return "fma"


def w8a8_route(dtype: torch.dtype, d: int, mlp_dim: int, addrs) -> str:
    """The W8A8 MLP's kernel for activations of ``dtype`` (bf16 or f32)
    with rows of width ``d``, ``mlp_dim`` hidden columns and base addresses
    ``addrs`` (x, ln2_s, ln2_b and the two int8 weight matrices): "mma"
    (int8 tensor cores) when the shape fits ``fits_w8a8_mma`` and every
    address is a multiple of 16 bytes, else "dp4a"."""
    if (dtype in _DTYPE_CODE and fits_w8a8_mma(d, mlp_dim, dtype)
            and _aligned(addrs)):
        return "mma"
    return "dp4a"


def _mlp_route_of(x: torch.Tensor, p: Params) -> str:
    return mlp_route(x.dtype, x.shape[-1], p["fc1_w"].shape[-1],
                     (x.data_ptr(), p["ln2_s"].data_ptr(),
                      p["ln2_b"].data_ptr(), p["fc1_w"].data_ptr(),
                      p["fc2_w"].data_ptr()))


def _w8a8_route_of(x: torch.Tensor, p: Params) -> str:
    return w8a8_route(x.dtype, x.shape[-1],
                      p["fc1_w"][quant.AQKEY].shape[-1],
                      (x.data_ptr(), p["ln2_s"].data_ptr(),
                       p["ln2_b"].data_ptr(),
                       p["fc1_w"][quant.AQKEY].data_ptr(),
                       p["fc2_w"][quant.AQKEY].data_ptr()))


# route -> (source, C entry, its argtypes, the entries' prefix)
_MMA_SOURCES = {
    "mma": ("fused_mlp_block_mma", "ivt_fused_mlp_block_mma",
            MLP_MMA_ARGTYPES, "ivt_mlp_mma_"),
    "w8a8": ("fused_mlp_w8a8_mma", "ivt_fused_mlp_w8a8_mma",
             W8A8_MMA_ARGTYPES, "ivt_mlp_w8a8_mma_"),
    "tf32": ("fused_mlp_block_tf32", "ivt_fused_mlp_block_tf32x3",
             MLP_MMA_ARGTYPES, "ivt_mlp_tf32_"),
}

# route -> its envelope entries and their int parameters: each kernel's
# chunk and cluster follow the row width (chunk(d), cluster(d, md));
# smem_bytes takes the activation size (W8A8) or the row tile (split TF32)
# third, max_clusters the dtype code first (W8A8)
ENVELOPE_NARGS = {
    "mma": {"rows": 0, "max_width": 0, "chunk": 1, "cluster": 2,
            "smem_bytes": 2, "max_clusters": 3, "prepare": 0},
    "w8a8": {"rows": 0, "max_width": 0, "chunk": 1, "cluster": 2,
             "smem_bytes": 3, "max_clusters": 4, "prepare": 0},
    "tf32": {"rows": 0, "max_width": 0, "chunk": 1, "cluster": 2,
             "smem_bytes": 3, "max_clusters": 3, "prepare": 0},
}


def bind_mma_library(lib, route: str):
    """Binds the ctypes signatures of a tensor-core route's library (built
    from ``csrc/`` or a variant of it) once; returns ``lib``."""
    _, entry, argtypes, pre = _MMA_SOURCES[route]
    if not getattr(lib, "_ivt_bound", False):
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
        for name, nargs in ENVELOPE_NARGS[route].items():
            fn = getattr(lib, pre + name)
            fn.argtypes = [ctypes.c_int] * nargs
            fn.restype = (ctypes.c_size_t if name == "smem_bytes"
                          else ctypes.c_int)
        lib._ivt_bound = True
    return lib


def _mma_lib(route: str) -> ctypes.CDLL:
    """Build (first use) and load a tensor-core route's library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    return bind_mma_library(cuda_build.load(_MMA_SOURCES[route][0]), route)


# shapes the loaders check the libraries' formulas at: vit_b16, swin_t's
# four stages, vit_h14's, and shapes each route refuses
_CHECK_SHAPES = ((768, 3072), (384, 1536), (1280, 5120), (256, 640),
                 (96, 384), (192, 768), (768, 100), (96, 288),
                 (1408, 5632))


def check_mma_library(lib, route: str) -> None:
    """Raises unless the library's tile, widest row, chunks, cluster
    sizes and shared-memory formula are this module's."""
    pre = _MMA_SOURCES[route][3]

    def entry(name):
        return getattr(lib, pre + name)

    ok = (entry("rows")() == MMA_ROWS
          and entry("max_width")() == MMA_MAX_WIDTH)
    for d, md in _CHECK_SHAPES:
        ok = (ok and entry("chunk")(d) == chunk_of(d)
              and entry("cluster")(d, md) == cluster_of(d, md))
        if route == "w8a8":
            ok = ok and all(entry("smem_bytes")(d, md, e)
                            == w8a8_mma_smem_bytes(d, md, e) for e in (2, 4))
        elif route == "tf32":
            ok = ok and all(entry("smem_bytes")(d, md, bm)
                            == tf32_smem_bytes(d, md, bm)
                            for bm in (16, 32, 64))
        else:
            ok = ok and entry("smem_bytes")(d, md) == mma_smem_bytes(d, md)
    if not ok:
        raise RuntimeError(f"csrc/{_MMA_SOURCES[route][0]}.cu and "
                           f"ops/fused_mlp.py disagree on the route's "
                           f"envelope")


def load_mma_kernel() -> ctypes.CDLL:
    """Build and load the bf16 tensor-core kernel now; checks its envelope
    (``check_mma_library``)."""
    lib = _mma_lib("mma")
    check_mma_library(lib, "mma")
    return lib


def load_w8a8_mma_kernel() -> ctypes.CDLL:
    """Build and load the W8A8 tensor-core kernel now; checks its envelope
    (``check_mma_library``)."""
    lib = _mma_lib("w8a8")
    check_mma_library(lib, "w8a8")
    return lib


def load_tf32_kernel() -> ctypes.CDLL:
    """Build and load the split-TF32 kernel now; checks its envelope
    (``check_mma_library``)."""
    lib = _mma_lib("tf32")
    check_mma_library(lib, "tf32")
    return lib


def _device_index(device) -> int:
    device = torch.device("cuda") if device is None else torch.device(device)
    return (torch.cuda.current_device() if device.index is None
            else device.index)


def library_clusters(lib, route: str, d: int, mlp_dim: int, dtype, device,
                     bm: int) -> int:
    """Clusters of ``lib``'s kernel (a route's library, bound) with tiles
    of ``bm`` rows that the card ``device`` holds at once at (d, mlp_dim)
    (``cudaOccupancyMaxActiveClusters``). Runs the library's prepare entry
    (the kernels' shared-memory attribute) once a device first, and asks
    the card once a (device, dtype, d, mlp_dim, bm)."""
    index = _device_index(device)
    key = (index, _DTYPE_CODE[dtype], d, mlp_dim, bm)
    counts = getattr(lib, "_ivt_clusters", None)
    if counts is None:
        counts = lib._ivt_clusters = {}
    if key not in counts:
        pre = _MMA_SOURCES[route][3]
        prepared = getattr(lib, "_ivt_prepared", None)
        if prepared is None:
            prepared = lib._ivt_prepared = set()
        with torch.cuda.device(index):
            if index not in prepared:
                err = getattr(lib, pre + "prepare")()
                if err != 0:
                    raise RuntimeError(f"{_MMA_SOURCES[route][0]}: setting "
                                       f"the kernels' shared memory failed: "
                                       f"cudaError {err}")
                prepared.add(index)
            fn = getattr(lib, pre + "max_clusters")
            n = (fn(key[1], d, mlp_dim, bm) if route == "w8a8"
                 else fn(d, mlp_dim, bm))
        if n < 0:
            raise RuntimeError(f"{_MMA_SOURCES[route][0]}: the occupancy of "
                               f"(d={d}, mlp_dim={mlp_dim}) with tiles of "
                               f"{bm} rows could not be read")
        counts[key] = n
    return counts[key]


def library_tile(lib, route: str, m: int, d: int, mlp_dim: int, dtype,
                 device) -> int:
    """``row_tile`` for ``lib``, a route's library (bound)."""
    tiles = ([bm for bm in tf32_tiles(d) if _tf32_fits(d, mlp_dim, bm)]
             if route == "tf32" else [32, 64])
    for bm in tiles:
        if -(-m // bm) <= library_clusters(lib, route, d, mlp_dim, dtype,
                                           device, bm):
            return bm
    return tiles[-1]


def max_active_clusters(route: str, d: int, mlp_dim: int,
                        dtype=torch.bfloat16, bm: int = MMA_ROWS,
                        device=None) -> int:
    """Clusters of a route's kernel with tiles of ``bm`` rows that the card
    holds at once at (d, mlp_dim) (``cudaOccupancyMaxActiveClusters``)."""
    return library_clusters(_mma_lib(route), route, d, mlp_dim, dtype,
                            device, bm)


def row_tile(route: str, m: int, d: int, mlp_dim: int,
             dtype=torch.bfloat16, device=None) -> int:
    """The rows of a cluster's tile for a route's launch on ``m`` rows, the
    one place that picks it: the smallest tile whose ceil(m / tile) tiles
    fit the clusters the card holds at once (one wave: one image of 197
    rows takes 7 clusters of 32 rows, not 4 of 64; the split-TF32 route
    also has tiles of 16 at chunks of 128, 13 clusters at vit_b16), else
    the largest whose block fits (each block reads its weight slice once
    for more rows; the split-TF32 route keeps 32 at vit_b16's widths)."""
    return library_tile(_mma_lib(route), route, m, d, mlp_dim, dtype, device)


def _mlp_tc(route: str, name: str, what: str, x: torch.Tensor, p: Params,
            eps: float) -> torch.Tensor:
    """One launch of the bf16 ("mma") or split-TF32 ("tf32") kernel for
    the wrapper ``name``; raises on operands ``mlp_route`` does not send
    there (``what`` names the dtype the route takes). For CPU tensors the
    plain version."""
    if x.device.type == "cpu":
        return fused_mlp_block_reference(x, p, eps)
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{x.device}")
    _check_operands(x, p)
    if _mlp_route_of(x, p) != route:
        raise ValueError(
            f"{name} takes {what} rows of a multiple of {MMA_CHUNK} or "
            f"{MMA_NARROW_CHUNK} up to {MMA_MAX_WIDTH} wide, whole chunks of "
            f"hidden columns, 16-byte aligned operands and a block inside "
            f"shared memory; got {x.dtype}, d={x.shape[-1]}, mlp_dim="
            f"{p['fc1_w'].shape[-1]}")
    b, n, d = x.shape
    md = p["fc1_w"].shape[-1]
    lib = _mma_lib(route)
    bm = library_tile(lib, route, b * n, d, md, x.dtype, x.device)
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _MMA_SOURCES[route][1])(
            x.data_ptr(), p["ln2_s"].data_ptr(), p["ln2_b"].data_ptr(),
            p["fc1_w"].data_ptr(), p["fc1_b"].data_ptr(),
            p["fc2_w"].data_ptr(), p["fc2_b"].data_ptr(), y.data_ptr(),
            b * n, d, md, bm, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return y


def fused_mlp_block_mma(x: torch.Tensor, p: Params,
                        eps: float = 1e-6) -> torch.Tensor:
    """``fused_mlp_block``'s contract in bf16 on the tensor cores
    (``csrc/fused_mlp_block_mma.cu``): one launch for CUDA tensors,
    counted in ``fused_mlp_block_mma.launches``; raises on operands that
    ``mlp_route`` does not send there. For CPU tensors the plain
    version."""
    y = _mlp_tc("mma", "fused_mlp_block_mma", "bf16", x, p, eps)
    if x.device.type == "cuda":
        fused_mlp_block_mma.launches += 1
    return y


fused_mlp_block_mma.launches = 0


def fused_mlp_block_tf32x3(x: torch.Tensor, p: Params,
                           eps: float = 1e-6) -> torch.Tensor:
    """``fused_mlp_block``'s contract in f32 on the tensor cores, three
    TF32 products a product (``csrc/fused_mlp_block_tf32.cu``): one launch
    for CUDA tensors, counted in ``fused_mlp_block_tf32x3.launches``;
    raises on operands that ``mlp_route`` does not send there. For CPU
    tensors the plain version."""
    y = _mlp_tc("tf32", "fused_mlp_block_tf32x3", "f32", x, p, eps)
    if x.device.type == "cuda":
        fused_mlp_block_tf32x3.launches += 1
    return y


fused_mlp_block_tf32x3.launches = 0

# route -> the wrapper that launches it (``fused_mlp_block``'s dispatch)
_MLP_ROUTE_WRAPPERS = {"mma": fused_mlp_block_mma,
                       "tf32": fused_mlp_block_tf32x3}


def fused_mlp_w8a8_block_mma(x: torch.Tensor, p: Params, eps: float = 1e-6,
                             want_parts: bool = False):
    """``fused_mlp_w8a8_block``'s contract on the int8 tensor cores
    (``csrc/fused_mlp_w8a8_mma.cu``): one launch for CUDA tensors, counted
    in ``fused_mlp_w8a8_block_mma.launches`` (and, for rows on chunks of
    96, the ``w8a8_mma96_kernel`` instantiation, also in
    ``fused_mlp_w8a8_block_mma.narrow_launches``); raises on operands that
    ``w8a8_route`` does not send there. For CPU tensors the plain
    version."""
    if x.device.type == "cpu":
        y, parts = fused_mlp_w8a8_parts(x, p, eps)
        return (y, parts) if want_parts else y
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_w8a8_block_mma runs on cuda or cpu "
                         f"tensors, got {x.device}")
    _check_w8a8_operands(x, p)
    if _w8a8_route_of(x, p) != "mma":
        raise ValueError(
            f"fused_mlp_w8a8_block_mma takes rows of a multiple of "
            f"{MMA_CHUNK} or {MMA_NARROW_CHUNK} up to {MMA_MAX_WIDTH} wide, "
            f"whole chunks of hidden columns, 16-byte aligned operands and a "
            f"block inside shared memory; got {x.dtype}, d={x.shape[-1]}, mlp_dim="
            f"{p['fc1_w'][quant.AQKEY].shape[-1]}")
    lib = _mma_lib("w8a8")
    b, n, d = x.shape
    bm = library_tile(lib, "w8a8", b * n, d,
                      p["fc1_w"][quant.AQKEY].shape[-1], x.dtype, x.device)
    out = _launch_w8a8(getattr(lib, _MMA_SOURCES["w8a8"][1]), x, p, eps,
                       want_parts, (bm,))
    fused_mlp_w8a8_block_mma.launches += 1
    if chunk_of(d) == MMA_NARROW_CHUNK:
        fused_mlp_w8a8_block_mma.narrow_launches += 1
    return out


fused_mlp_w8a8_block_mma.launches = 0
fused_mlp_w8a8_block_mma.narrow_launches = 0
