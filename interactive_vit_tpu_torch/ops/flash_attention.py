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

Branches, by shape as in the JAX function: maps asked for with N above
``ROWFULL_MAX_N`` return ``attention_reference`` (f32 probs); maps off
above it go to the online-softmax kernel, which has the same three pieces:
``flash_attention_online`` (kernel ``csrc/flash_attention_online.cu``,
count ``flash_attention_online.launches``),
``flash_attention_online_reference`` and ``fits_online``; everything else
is the row-resident kernel (``fits``).

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
    ``flash_attention_online``, which counts those launches; this
    wrapper's count is the row-resident kernel's."""
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


flash_attention.launches = 0


def flash_mhsa(q, k, v, want_attn=False, n_real=None):
    """Drop-in ``attn_impl`` for ``attention.mhsa``."""
    return flash_attention(q, k, v, want_attn=want_attn, n_real=n_real)


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
    For CUDA tensors one launch of ``csrc/flash_attention_online.cu``,
    counted in ``flash_attention_online.launches``; for CPU tensors the
    plain version at the kernel's key tile."""
    b, h, n, dh = q.shape
    n_real = n if n_real is None else min(int(n_real), n)
    if q.device.type == "cpu":
        return flash_attention_online_reference(q, k, v, n_real)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_online runs on cuda or cpu "
                         f"tensors, got {q.device}")
    _check_operands(q, k, v, fits_online)
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


flash_attention_online.launches = 0
