"""Row-resident attention with exact probs taps: q, k, v [B, H, N, dh].

Counterpart of ``interactive_vit_tpu/ops/flash_attention.py::flash_attention``
(the Pallas TPU kernels). Three pieces, as every kernel of this package has:

* ``flash_attention`` -- the wrapper. For CUDA tensors it launches the
  hand-written kernel ``csrc/flash_attention.cu`` (built at first use) or
  raises; for CPU tensors it runs the plain version. It counts its kernel
  launches in ``flash_attention.launches``.
* ``flash_attention_reference`` -- the plain PyTorch version with the same
  cast points, used on the CPU and to check the kernel on the card.
* ``fits`` -- the kernel's shape envelope.

A public wrapper reaches its kernels on a CUDA tensor through its
``torch.library`` custom op (``ops/custom_ops.py``: the launch is the op's
body, so ``torch.export`` records the op where fake tensors have no
address to route by).

Branches, by shape as in the JAX function: maps asked for with N above
``ROWFULL_MAX_N`` return ``attention_reference`` (f32 probs); maps off
above it go to the online-softmax kernel, which has the same three pieces:
``flash_attention_online`` (kernel ``csrc/flash_attention_online.cu``,
count ``flash_attention_online.launches``),
``flash_attention_online_reference`` and ``fits_online``; everything else
is the row-resident kernel (``fits``).

Routes on Hopper's tensor cores, chosen by dtype, head width and alignment
only, each with the same contract and plain version as the branch it
serves, and its own launch count:

* bf16 heads of a width in ``MMA_DHS`` (64 and 80 columns) with 16-byte
  aligned operands (``mma_route``): the row-resident branch runs
  ``flash_attention_mma`` (kernel ``csrc/flash_attention_mma.cu``, the
  probs tap included), the online branch ``flash_attention_online_mma``
  (``csrc/flash_attention_online_mma.cu``); each source holds one
  instantiation a width;
* f32 heads of a width in ``TF32_DHS`` (64 and 80 columns: vit_h14's
  heads are 80 wide) with 16-byte aligned operands (``tf32_route``): the
  row-resident branch runs ``flash_attention_tf32x3``
  (``csrc/flash_attention_tf32.cu``, the probs tap included), the online
  branch ``flash_attention_online_tf32x3``
  (``csrc/flash_attention_online_tf32.cu``): every product as three TF32
  products of a hi / lo split (``csrc/tf32_attention.cuh``), which keeps
  the f32 contract; each source holds one instantiation a width;
* everything else (operands off the 16-byte grid, other widths) keeps the
  FMA kernels.

Numerics (the JAX row-resident kernel's): f32 scores times dh^-0.5, keys
at or beyond ``n_real`` set to ``MASK_VALUE``, the row max subtracted,
probs = p / rowsum; probs cast to the value dtype feed PV, and the probs
tap comes back in the query dtype (bf16 for a bf16 model, where
``attention_reference`` returns f32). The online kernel's are the JAX
``_online_kernel``'s, key tile by key tile: a running max ``m`` from
-inf, ``alpha = exp(m_prev - m_next)``, ``p = exp(s - m_next)``,
``l = alpha * l + sum p``, ``acc = alpha * acc + p.to(v.dtype) @ v`` in
f32, ``o = acc / l``; masked keys' v rows are zeroed.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from interactive_vit_tpu_torch.ops import tiled_attention
from interactive_vit_tpu_torch.ops.attention import attention_reference

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
ROWFULL_MAX_N = 2048

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# Mirrors csrc/flash_attention_online.cu: 32 query rows per block, key tiles
# of 128 (the JAX kernel's block_k), heads up to 128 wide.
ONLINE_QT = 32
ONLINE_BLOCK_K = 128
# csrc/flash_attention_online_tf32.cu's key tile at each head width it
# takes (f32: p is never cast, so the tile changes only the rounding of the
# running sums); other widths' plain version on the CPU takes 64
ONLINE_TF32_BLOCK_K = {64: 64, 80: 32}


# The head widths of the bf16 tensor-core kernels (csrc/flash_attention_mma.cu,
# csrc/flash_attention_online_mma.cu), in increasing order, and the
# alignment their 16-byte copies need, in bytes. The trainable attention's
# tensor-core kernels keep their own widths (attention_vjp.TRAIN_MMA_DHS).
MMA_DHS = (64, 80)
_MMA_WIDTHS = " or ".join(map(str, MMA_DHS))
MMA_ALIGN = 16
# The head widths of the split-TF32 kernels (csrc/flash_attention_tf32.cu,
# csrc/flash_attention_online_tf32.cu), in increasing order.
TF32_DHS = (64, 80)
_TF32_WIDTHS = " or ".join(map(str, TF32_DHS))


def _aligned(addrs, strides, esize: int) -> bool:
    """Every base address (bytes) and every element stride (of ``esize``
    bytes) a multiple of ``MMA_ALIGN``."""
    return (all(int(a) % MMA_ALIGN == 0 for a in addrs)
            and all((int(s) * esize) % MMA_ALIGN == 0 for s in strides))


def mma_route(dtype: torch.dtype, dh: int, addrs, strides) -> bool:
    """True when operands take the bf16 tensor-core kernels: bf16, heads of
    a width in ``MMA_DHS``, every base address (bytes) and every (image,
    head, token) element stride a multiple of 16 bytes. f32 never does
    (TF32 would not keep the f32 contract; ``tf32_route`` is its own)."""
    return (dtype == torch.bfloat16 and dh in MMA_DHS
            and _aligned(addrs, strides, 2))


def tf32_route(dtype: torch.dtype, dh: int, addrs, strides) -> bool:
    """True when operands take the split-TF32 kernels: f32, heads of a
    width in ``TF32_DHS``, every base address and every (image, head,
    token) stride a multiple of 16 bytes."""
    return (dtype == torch.float32 and dh in TF32_DHS
            and _aligned(addrs, strides, 4))


def _route_operands(route, *tensors) -> bool:
    """``route`` for [B, H, N, dh] views (head dim contiguous)."""
    return (all(t.stride(-1) == 1 for t in tensors)
            and route(tensors[0].dtype, tensors[0].shape[-1],
                      [t.data_ptr() for t in tensors],
                      [s for t in tensors for s in t.stride()[:3]]))


def _mma_operands(*tensors) -> bool:
    """``mma_route`` for [B, H, N, dh] views (head dim contiguous)."""
    return _route_operands(mma_route, *tensors)


def _tf32_operands(*tensors) -> bool:
    """``tf32_route`` for [B, H, N, dh] views (head dim contiguous)."""
    return _route_operands(tf32_route, *tensors)


def fits(n: int, dh: int) -> bool:
    """True when the row-resident kernel takes N=n keys of width dh."""
    return n <= ROWFULL_MAX_N and tiled_attention.query_tile(n, dh) > 0


def online_smem_bytes(dh: int) -> int:
    """Dynamic shared memory of the online kernel: Q [32][dh], a K and a V
    tile [128][dh+4], the tile's scores [32][128] and the rows' alpha and
    l; all f32, whatever N is."""
    return 4 * (ONLINE_QT * dh + 2 * ONLINE_BLOCK_K * (dh + 4)
                + ONLINE_QT * ONLINE_BLOCK_K + 2 * ONLINE_QT)


def fits_online(n: int, dh: int) -> bool:
    """True when the online kernel takes N=n keys of width dh: any n >= 1,
    heads of a multiple of 4 columns up to 128 (its shared memory does not
    depend on n)."""
    return (n > 0 and 0 < dh <= tiled_attention.MAX_DH and dh % 4 == 0
            and online_smem_bytes(dh) <= tiled_attention.SMEM_LIMIT)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    want_attn: bool = False,
    n_real: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the row-resident kernel, same contract and
    cast points: ``(o [B,H,N,dh], probs [B,H,N,N] in q's dtype | None)``."""
    n, dh = q.shape[-2], q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh ** -0.5)
    if n_real is not None and n_real < n:
        col = torch.arange(n, device=q.device)
        s = torch.where(col < n_real, s, torch.full_like(s, MASK_VALUE))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    probs = p / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)
    return o, (probs.to(q.dtype) if want_attn else None)


def flash_attention_online_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_real: Optional[int] = None,
    block_k: int = ONLINE_BLOCK_K,
) -> torch.Tensor:
    """Plain PyTorch version of the online kernel, key tile by key tile of
    ``block_k`` keys (in bf16 the result depends on the width through the
    cast of p): o [B, H, N, dh] in q's dtype."""
    n, dh = q.shape[-2], q.shape[-1]
    n_real = n if n_real is None else min(int(n_real), n)
    qf = q.float()
    m = torch.full(q.shape[:-1] + (1,), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j0 in range(0, n, block_k):
        kt, vt = k[..., j0:j0 + block_k, :], v[..., j0:j0 + block_k, :]
        s = torch.matmul(qf, kt.float().transpose(-1, -2)) * (dh ** -0.5)
        live = torch.arange(j0, j0 + kt.shape[-2], device=q.device) < n_real
        s = torch.where(live, s, torch.full_like(s, MASK_VALUE))
        vt = torch.where(live[:, None], vt, torch.zeros_like(vt))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vt.float())
        m = m_next
    return (acc / l).to(q.dtype)


def _kernel_lib() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("flash_attention")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_flash_attention.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.ivt_flash_attention.restype = ctypes.c_int
        lib._ivt_bound = True
    return lib


def load_kernel() -> ctypes.CDLL:
    """Build and load the CUDA kernel now; checks that the library's
    shared-memory formula is the envelope's."""
    lib = _kernel_lib()
    tiled_attention.check_library(lib)
    return lib


def _check_operands(q, k, v, fits_fn=fits) -> None:
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.ndim != 4:
        raise ValueError(f"q must be [B, H, N, dh], got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; the kernel needs q's "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    n, dh = q.shape[2], q.shape[3]
    if not fits_fn(n, dh):
        raise ValueError(f"flash_attention kernel does not take n={n}, "
                         f"dh={dh} (see {fits_fn.__name__}())")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    want_attn: bool = False,
    n_real: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention on [B, H, N, dh]; the contract of
    ``attention.attention_reference``: returns ``(o, probs | None)``.
    ``n_real``: keys at or beyond it are masked (padded token domain).
    N above ``ROWFULL_MAX_N`` with maps off goes to
    ``flash_attention_online``, bf16 operands that ``mma_route`` takes to
    ``flash_attention_mma``, f32 ones that ``tf32_route`` takes to
    ``flash_attention_tf32x3``, each counting its launches; this wrapper's
    count is the f32 FMA row-resident kernel's."""
    b, h, n, dh = q.shape
    n_real = n if n_real is None else min(int(n_real), n)
    if want_attn and n > ROWFULL_MAX_N:
        # the JAX function's own fallback for maps on very long rows
        return attention_reference(q, k, v, want_attn=True, n_real=n_real)
    if n > ROWFULL_MAX_N:
        return flash_attention_online(q, k, v, n_real), None
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, want_attn, n_real)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    _check_operands(q, k, v)
    from interactive_vit_tpu_torch.ops import custom_ops

    return custom_ops.flash_attention(q, k, v, want_attn, n_real)


flash_attention.launches = 0


def rowfull_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   want_attn: bool, n_real: int):
    """``ivt::flash_attention``'s CUDA body (``ops/custom_ops.py``) on
    checked operands: bf16 operands that ``mma_route`` takes to
    ``flash_attention_mma``, f32 ones that ``tf32_route`` takes to
    ``flash_attention_tf32x3``, the rest to the FMA kernel, counted in
    ``flash_attention.launches``; returns ``(o, probs | None)``."""
    b, h, n, dh = q.shape
    if _mma_operands(q, k, v):
        return flash_attention_mma(q, k, v, want_attn, n_real)
    if _tf32_operands(q, k, v):
        return flash_attention_tf32x3(q, k, v, want_attn, n_real)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        # o is written token-major ([B, N, H, dh] in memory), so the
        # caller's transpose back to [B, N, D] is a view, not a copy
        o = torch.empty((b, n, h, dh), dtype=q.dtype,
                        device=q.device).transpose(1, 2)
        probs = (torch.empty((b, h, n, n), dtype=q.dtype, device=q.device)
                 if want_attn else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ivt_flash_attention(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), None if probs is None else probs.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], b, h, n, dh, n_real, float(dh) ** -0.5,
            MASK_VALUE, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return o, probs


def flash_mhsa(q, k, v, want_attn=False, n_real=None):
    """Drop-in ``attn_impl`` for ``attention.mhsa``."""
    return flash_attention(q, k, v, want_attn=want_attn, n_real=n_real)


# -- the row-resident kernel on the tensor cores (bf16) ---------------------------


# ivt_flash_attention_mma's parameters: q, k, v, o, probs; 12 strides; B,
# H, N, dh, n_real; scale, mask_value; the stream
FLASH_MMA_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
                      + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                      + [ctypes.c_void_p])


def _flash_mma_lib() -> ctypes.CDLL:
    """Build (first use) and load the tensor-core row-resident library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("flash_attention_mma")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_flash_attention_mma.argtypes = FLASH_MMA_ARGTYPES
        lib.ivt_flash_attention_mma.restype = ctypes.c_int
        lib.ivt_flash_mma_dh.argtypes = [ctypes.c_int]
        lib.ivt_flash_mma_dh.restype = ctypes.c_int
        lib._ivt_bound = True
    return lib


def load_mma_kernel() -> ctypes.CDLL:
    """Build and load the tensor-core row-resident kernel now; checks its
    head widths against ``MMA_DHS``."""
    lib = _flash_mma_lib()
    check_mma_dhs(lib.ivt_flash_mma_dh, "csrc/flash_attention_mma.cu")
    return lib


def flash_attention_mma(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    want_attn: bool = False,
    n_real: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``flash_attention``'s row-resident contract (probs tap included) on
    the bf16 tensor-core kernel ``csrc/flash_attention_mma.cu``: one launch
    for CUDA tensors, counted in ``flash_attention_mma.launches``; raises
    on operands that ``mma_route`` or ``fits`` refuses. For CPU tensors
    the plain version."""
    b, h, n, dh = q.shape
    n_real = n if n_real is None else min(int(n_real), n)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, want_attn, n_real)
    _check_operands(q, k, v)
    if not _mma_operands(q, k, v):
        raise ValueError(
            f"flash_attention_mma takes bf16 heads {_MMA_WIDTHS} wide with "
            f"16-byte aligned pointers and strides, got {q.dtype}, dh={dh}, "
            f"strides {[t.stride() for t in (q, k, v)]}")
    lib = _flash_mma_lib()
    with torch.cuda.device(q.device):
        # token-major o, as the FMA kernel's wrapper writes it
        o = torch.empty((b, n, h, dh), dtype=q.dtype,
                        device=q.device).transpose(1, 2)
        probs = (torch.empty((b, h, n, n), dtype=q.dtype, device=q.device)
                 if want_attn else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ivt_flash_attention_mma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if probs is None else probs.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], b, h, n, dh, n_real, float(dh) ** -0.5,
            MASK_VALUE, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_mma kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_mma.launches += 1
    return o, probs


flash_attention_mma.launches = 0


# -- the row-resident kernel on the tensor cores (f32, split TF32) -------------


# ivt_flash_attention_tf32x3's parameters: q, k, v, o, probs, stats; 12
# strides; B, H, N, dh, n_real; scale, mask_value; the stream
FLASH_TF32_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])


def _flash_tf32_lib() -> ctypes.CDLL:
    """Build (first use) and load the split-TF32 row-resident library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("flash_attention_tf32")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_flash_attention_tf32x3.argtypes = FLASH_TF32_ARGTYPES
        lib.ivt_flash_attention_tf32x3.restype = ctypes.c_int
        lib.ivt_flash_tf32_dh.argtypes = [ctypes.c_int]
        lib.ivt_flash_tf32_dh.restype = ctypes.c_int
        lib._ivt_bound = True
    return lib


def library_dhs(width_of) -> Tuple[int, ...]:
    """The head widths a library reports through ``width_of(i)`` (the
    i-th width, 0 past the last)."""
    dhs = []
    while (dh := width_of(len(dhs))) > 0:
        dhs.append(dh)
    return tuple(dhs)


def check_library_dhs(width_of, source: str, dhs, name: str) -> None:
    """Raises unless the library built from ``source`` takes exactly the
    head widths ``dhs`` (the route's ``name``): the route must never send
    a width to a library without its instantiation."""
    if library_dhs(width_of) != dhs:
        raise RuntimeError(f"{source} and {name} disagree: the library "
                           f"takes heads {library_dhs(width_of)} wide, "
                           f"the route {dhs}")


def check_tf32_dhs(width_of, source: str) -> None:
    """Raises unless the library built from ``source`` takes exactly the
    head widths of ``TF32_DHS``."""
    check_library_dhs(width_of, source, TF32_DHS, "TF32_DHS")


def check_mma_dhs(width_of, source: str) -> None:
    """Raises unless the library built from ``source`` takes exactly the
    head widths of ``MMA_DHS``."""
    check_library_dhs(width_of, source, MMA_DHS, "MMA_DHS")


def load_tf32_kernel() -> ctypes.CDLL:
    """Build and load the split-TF32 row-resident kernel now; checks its
    head widths against ``TF32_DHS``."""
    lib = _flash_tf32_lib()
    check_tf32_dhs(lib.ivt_flash_tf32_dh, "csrc/flash_attention_tf32.cu")
    return lib


def launch_flash_tf32(ptrs, strides, device, b: int, h: int, n: int,
                      dh: int, n_real: int, probs_ptr=None,
                      stats_ptr=None) -> None:
    """One launch of ``csrc/flash_attention_tf32.cu`` on element pointers
    ``ptrs`` (q, k, v, o) of heads ``dh`` wide and their (image, head,
    token) stride triples; ``probs_ptr``: a [B, H, N, N] f32 tap or None;
    ``stats_ptr``: an f32 [2, B, H, N] buffer for each row's (m, l) or
    None. Raises on a failed launch. The trainable attention's f32 forward
    calls it too."""
    lib = _flash_tf32_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ivt_flash_attention_tf32x3(
            *ptrs, probs_ptr, stats_ptr, *(s for st in strides for s in st),
            b, h, n, dh, n_real, float(dh) ** -0.5, MASK_VALUE, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_tf32x3 kernel launch failed: "
                           f"cudaError {err}")


def flash_attention_tf32x3(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    want_attn: bool = False,
    n_real: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``flash_attention``'s row-resident contract (probs tap included) in
    f32 on the split-TF32 tensor-core kernel ``csrc/flash_attention_tf32.cu``:
    one launch for CUDA tensors, counted in
    ``flash_attention_tf32x3.launches``; raises on operands that
    ``tf32_route`` or ``fits`` refuses. For CPU tensors the plain
    version."""
    b, h, n, dh = q.shape
    n_real = n if n_real is None else min(int(n_real), n)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, want_attn, n_real)
    _check_operands(q, k, v)
    if not _tf32_operands(q, k, v):
        raise ValueError(
            f"flash_attention_tf32x3 takes f32 heads {_TF32_WIDTHS} wide "
            f"with 16-byte aligned pointers and strides, got {q.dtype}, "
            f"dh={dh}, strides {[t.stride() for t in (q, k, v)]}")
    # token-major o, as the FMA kernel's wrapper writes it
    o = torch.empty((b, n, h, dh), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    probs = (torch.empty((b, h, n, n), dtype=q.dtype, device=q.device)
             if want_attn else None)
    ts = (q, k, v, o)
    launch_flash_tf32([t.data_ptr() for t in ts], [t.stride()[:3] for t in ts],
                      q.device, b, h, n, dh, n_real,
                      None if probs is None else probs.data_ptr())
    flash_attention_tf32x3.launches += 1
    return o, probs


flash_attention_tf32x3.launches = 0


# -- the online-softmax kernel ------------------------------------------------


def _online_lib() -> ctypes.CDLL:
    """Build (first use) and load the online kernel library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("flash_attention_online")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_flash_attention_online.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.ivt_flash_attention_online.restype = ctypes.c_int
        lib.ivt_online_smem_bytes.argtypes = [ctypes.c_int]
        lib.ivt_online_smem_bytes.restype = ctypes.c_size_t
        lib.ivt_online_block_k.argtypes = []
        lib.ivt_online_block_k.restype = ctypes.c_int
        lib._ivt_bound = True
    return lib


def load_online_kernel() -> ctypes.CDLL:
    """Build and load the online kernel now; checks that the library's key
    tile and shared-memory formula are the envelope's."""
    lib = _online_lib()
    if lib.ivt_online_block_k() != ONLINE_BLOCK_K or any(
            lib.ivt_online_smem_bytes(dh) != online_smem_bytes(dh)
            for dh in (16, 64, 128)):
        raise RuntimeError("csrc/flash_attention_online.cu and "
                           "fits_online() disagree on the kernel's envelope")
    return lib


def flash_attention_online(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_real: Optional[int] = None,
) -> torch.Tensor:
    """Online-softmax attention on [B, H, N, dh], no maps: o [B, H, N, dh].
    For CUDA tensors one launch: bf16 operands that ``mma_route`` takes go
    to the tensor-core kernel (``flash_attention_online_mma``), f32 ones
    that ``tf32_route`` takes to the split-TF32 kernel
    (``flash_attention_online_tf32x3``), each counting its launches; the
    rest to ``csrc/flash_attention_online.cu``, counted in
    ``flash_attention_online.launches``; for CPU tensors the plain version
    at the kernel's key tile."""
    b, h, n, dh = q.shape
    n_real = n if n_real is None else min(int(n_real), n)
    if q.device.type == "cpu":
        return flash_attention_online_reference(q, k, v, n_real)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_online runs on cuda or cpu "
                         f"tensors, got {q.device}")
    _check_operands(q, k, v, fits_online)
    from interactive_vit_tpu_torch.ops import custom_ops

    return custom_ops.flash_attention_online(q, k, v, n_real)


flash_attention_online.launches = 0


def online_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_real: int) -> torch.Tensor:
    """``ivt::flash_attention_online``'s CUDA body (``ops/custom_ops.py``)
    on checked operands: the tensor-core kernels where ``mma_route`` or
    ``tf32_route`` take them, else ``csrc/flash_attention_online.cu``,
    counted in ``flash_attention_online.launches``; returns o."""
    b, h, n, dh = q.shape
    if _mma_operands(q, k, v):
        return flash_attention_online_mma(q, k, v, n_real)
    if _tf32_operands(q, k, v):
        return flash_attention_online_tf32x3(q, k, v, n_real)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    lib = _online_lib()
    with torch.cuda.device(q.device):
        # token-major, as the row-resident wrapper writes it
        o = torch.empty((b, n, h, dh), dtype=q.dtype,
                        device=q.device).transpose(1, 2)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ivt_flash_attention_online(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], b, h, n, dh, n_real, float(dh) ** -0.5,
            MASK_VALUE, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_online kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_online.launches += 1
    return o


# -- the online kernel on the tensor cores (bf16) -------------------------------


# ivt_flash_attention_online_mma's parameters: q, k, v, o; 12 strides; B,
# H, N, dh, n_real; scale, mask_value; the stream
ONLINE_MMA_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])


def _online_mma_lib() -> ctypes.CDLL:
    """Build (first use) and load the tensor-core online kernel library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("flash_attention_online_mma")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_flash_attention_online_mma.argtypes = ONLINE_MMA_ARGTYPES
        lib.ivt_flash_attention_online_mma.restype = ctypes.c_int
        lib.ivt_online_mma_block_k.argtypes = []
        lib.ivt_online_mma_block_k.restype = ctypes.c_int
        lib.ivt_online_mma_dh.argtypes = [ctypes.c_int]
        lib.ivt_online_mma_dh.restype = ctypes.c_int
        lib._ivt_bound = True
    return lib


def load_online_mma_kernel() -> ctypes.CDLL:
    """Build and load the tensor-core online kernel now; checks its head
    widths against ``MMA_DHS`` and its key tile (the same at every width:
    in bf16 the result depends on it) against ``ONLINE_BLOCK_K``."""
    lib = _online_mma_lib()
    check_mma_dhs(lib.ivt_online_mma_dh,
                  "csrc/flash_attention_online_mma.cu")
    if lib.ivt_online_mma_block_k() != ONLINE_BLOCK_K:
        raise RuntimeError("csrc/flash_attention_online_mma.cu and "
                           "ONLINE_BLOCK_K disagree")
    return lib


def flash_attention_online_mma(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_real: Optional[int] = None,
) -> torch.Tensor:
    """``flash_attention_online``'s contract on the bf16 tensor-core kernel
    ``csrc/flash_attention_online_mma.cu``: one launch for CUDA tensors,
    counted in ``flash_attention_online_mma.launches``; raises on operands
    that ``mma_route`` refuses. For CPU tensors the plain version."""
    b, h, n, dh = q.shape
    n_real = n if n_real is None else min(int(n_real), n)
    if q.device.type == "cpu":
        return flash_attention_online_reference(q, k, v, n_real)
    _check_operands(q, k, v, fits_online)
    if not _mma_operands(q, k, v):
        raise ValueError(
            f"flash_attention_online_mma takes bf16 heads {_MMA_WIDTHS} wide "
            f"with 16-byte aligned pointers and strides, got {q.dtype}, "
            f"dh={dh}, strides {[t.stride() for t in (q, k, v)]}")
    lib = _online_mma_lib()
    with torch.cuda.device(q.device):
        o = torch.empty((b, n, h, dh), dtype=q.dtype,
                        device=q.device).transpose(1, 2)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ivt_flash_attention_online_mma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], b, h, n, dh, n_real, float(dh) ** -0.5,
            MASK_VALUE, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_online_mma kernel launch "
                           f"failed: cudaError {err}")
    flash_attention_online_mma.launches += 1
    return o


flash_attention_online_mma.launches = 0


# -- the online kernel on the tensor cores (f32, split TF32) --------------------


# ivt_flash_attention_online_tf32x3's parameters: those of the bf16 entry
ONLINE_TF32_ARGTYPES = ONLINE_MMA_ARGTYPES


def _online_tf32_lib() -> ctypes.CDLL:
    """Build (first use) and load the split-TF32 online kernel library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("flash_attention_online_tf32")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_flash_attention_online_tf32x3.argtypes = ONLINE_TF32_ARGTYPES
        lib.ivt_flash_attention_online_tf32x3.restype = ctypes.c_int
        lib.ivt_online_tf32_block_k.argtypes = [ctypes.c_int]
        lib.ivt_online_tf32_block_k.restype = ctypes.c_int
        lib.ivt_online_tf32_dh.argtypes = [ctypes.c_int]
        lib.ivt_online_tf32_dh.restype = ctypes.c_int
        lib._ivt_bound = True
    return lib


def load_online_tf32_kernel() -> ctypes.CDLL:
    """Build and load the split-TF32 online kernel now; checks its head
    widths against ``TF32_DHS`` and its key tile at each against
    ``ONLINE_TF32_BLOCK_K``."""
    lib = _online_tf32_lib()
    check_tf32_dhs(lib.ivt_online_tf32_dh,
                   "csrc/flash_attention_online_tf32.cu")
    if any(lib.ivt_online_tf32_block_k(dh) != ONLINE_TF32_BLOCK_K[dh]
           for dh in TF32_DHS):
        raise RuntimeError("csrc/flash_attention_online_tf32.cu and "
                           "ONLINE_TF32_BLOCK_K disagree")
    return lib


def flash_attention_online_tf32x3(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_real: Optional[int] = None,
) -> torch.Tensor:
    """``flash_attention_online``'s contract in f32 on the split-TF32
    tensor-core kernel ``csrc/flash_attention_online_tf32.cu``: one launch
    for CUDA tensors, counted in ``flash_attention_online_tf32x3.launches``;
    raises on operands that ``tf32_route`` refuses. For CPU tensors the
    plain version at the kernel's key tile for their head width."""
    b, h, n, dh = q.shape
    n_real = n if n_real is None else min(int(n_real), n)
    if q.device.type == "cpu":
        return flash_attention_online_reference(
            q, k, v, n_real, block_k=ONLINE_TF32_BLOCK_K.get(dh, 64))
    _check_operands(q, k, v, fits_online)
    if not _tf32_operands(q, k, v):
        raise ValueError(
            f"flash_attention_online_tf32x3 takes f32 heads {_TF32_WIDTHS} "
            f"wide with 16-byte aligned pointers and strides, got "
            f"{q.dtype}, dh={dh}, strides {[t.stride() for t in (q, k, v)]}")
    lib = _online_tf32_lib()
    with torch.cuda.device(q.device):
        o = torch.empty((b, n, h, dh), dtype=q.dtype,
                        device=q.device).transpose(1, 2)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ivt_flash_attention_online_tf32x3(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], b, h, n, dh, n_real, float(dh) ** -0.5,
            MASK_VALUE, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_online_tf32x3 kernel launch "
                           f"failed: cudaError {err}")
    flash_attention_online_tf32x3.launches += 1
    return o


flash_attention_online_tf32x3.launches = 0
