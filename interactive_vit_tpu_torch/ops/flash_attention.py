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
above it is the online-softmax kernel, not ported yet (the wrapper raises
on CUDA, the CPU runs the plain version); everything else is the
row-resident kernel.

Numerics (the JAX row-resident kernel's): f32 scores times dh^-0.5, keys
at or beyond ``n_real`` set to ``MASK_VALUE``, the row max subtracted,
probs = p / rowsum; probs cast to the value dtype feed PV, and the probs
tap comes back in the query dtype (bf16 for a bf16 model, where
``attention_reference`` returns f32).
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


def fits(n: int, dh: int) -> bool:
    """True when the row-resident kernel takes N=n keys of width dh."""
    return n <= ROWFULL_MAX_N and tiled_attention.query_tile(n, dh) > 0


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


def _check_operands(q, k, v) -> None:
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
    if not fits(n, dh):
        raise ValueError(f"flash_attention kernel does not take n={n}, "
                         f"dh={dh} (see fits())")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    want_attn: bool = False,
    n_real: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention on [B, H, N, dh]; the contract of
    ``attention.attention_reference``: returns ``(o, probs | None)``.
    ``n_real``: keys at or beyond it are masked (padded token domain)."""
    b, h, n, dh = q.shape
    n_real = n if n_real is None else min(int(n_real), n)
    if want_attn and n > ROWFULL_MAX_N:
        # the JAX function's own fallback for maps on very long rows
        return attention_reference(q, k, v, want_attn=True, n_real=n_real)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, want_attn, n_real)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    if n > ROWFULL_MAX_N:
        raise NotImplementedError(
            f"N={n} > {ROWFULL_MAX_N} with maps off is the online-softmax "
            f"kernel, which is not ported to CUDA yet")
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
