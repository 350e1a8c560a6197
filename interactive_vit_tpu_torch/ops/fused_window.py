"""Fused Swin window-attention branch: QKV + W-MSA + proj on an NHWC map.

Counterpart of ``interactive_vit_tpu/ops/fused_window.py``'s Pallas TPU
kernel, in three pieces, as every kernel of this package has:

* ``fused_window_attn`` -- the wrapper. For a CUDA tensor it launches the
  hand-written kernel (``csrc/fused_window_attn.cu``, built at first use)
  or raises; for a CPU tensor it runs the plain version. It counts its
  kernel launches in ``fused_window_attn.launches``.
* ``fused_window_attn_reference`` -- the plain PyTorch version with the
  same cast points, used on the CPU and to check the kernel on the card.
* ``fits`` -- the kernel's shape envelope, used by ``ops/dispatch.py``: one
  (window, head) of q, k, v and its T x T scores must fit a block's shared
  memory, which holds for window 7 (T=49) and window 12 (T=144) at dh=32.

The contract is the attention BRANCH: ``y`` is the LayerNorm'd (and, for
shifted blocks, already rolled) map; the output is in the same rolled
space; ``models/swin.py::block`` owns LN, roll and residual.

Numerics (the JAX kernel's): qkv f32-accumulated plus bias, cast to the
activation dtype; per window and head ``s = (q . k) * dh^-0.5`` in f32 --
scaled AFTER the dot, unlike the unfused ``swin.window_attention``, which
scales q in the activation dtype first -- plus the f32 relative-position
bias, plus the f32 seam mask of shifted blocks; ``fast_softmax`` is
``exp(min(s, 80))`` with no max subtraction and the normalisation
deferred; with maps on, ``probs = p * (1 / rowsum)`` cast to the activation
dtype are the tap AND feed PV; with maps off the unnormalised p is cast,
multiplied by V in f32 and scaled by ``1 / rowsum``; heads concatenate and
cast; the projection accumulates in f32, plus bias, cast.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from interactive_vit_tpu_torch.ops.fused_block import SOFTMAX_CLAMP
from interactive_vit_tpu_torch.ops.tiled_attention import SMEM_LIMIT

Params = Dict[str, torch.Tensor]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# grid dimensions y (heads) and z (images) of the attention kernel
_MAX_GRID_YZ = 65535


def window_smem_bytes(t: int, dh: int) -> int:
    """Dynamic shared memory of the window attention kernel: Q [t][dh],
    K [t][dh+4], V [t][dh], scores [t][t] and 1/rowsum [t], all f32."""
    return 4 * (t * dh + t * (dh + 4) + t * dh + t * t + t)


def fits(res: int, window: int, c: int, heads: int) -> bool:
    """True when the kernel takes a ``res`` x ``res`` map of width ``c``
    with ``heads`` heads in windows of ``window``: the map splits into
    whole windows, the width into heads of a multiple of 4 columns (float4
    rows), and one (window, head) fits the attention kernel's shared
    memory."""
    if res <= 0 or window <= 0 or res % window:
        return False
    if heads <= 0 or heads > _MAX_GRID_YZ or c <= 0 or c % heads:
        return False
    dh = c // heads
    return (dh % 4 == 0
            and window_smem_bytes(window * window, dh) <= SMEM_LIMIT)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, nW, T, C] with T = window^2, windows row-major
    over the map (a reshape and a transpose; ``models/swin.py`` uses it on
    the unfused path)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, (h // window) * (w // window), window * window, c)


def window_merge(x: torch.Tensor, window: int, h: int,
                 w: int) -> torch.Tensor:
    """Inverse of ``window_partition``: [B, nW, T, C] -> [B, H, W, C]."""
    b, _, _, c = x.shape
    x = x.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _mask_tensor(mask, device) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    return torch.as_tensor(mask, dtype=torch.float32, device=device)


def fused_window_attn_reference(
    y: torch.Tensor,
    p: Params,
    heads: int,
    window: int,
    bias: torch.Tensor,
    mask=None,
    want_attn: bool = False,
    fast_softmax: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel, same contract and cast points.

    Returns ``(a [B, H, W, C], probs [B, nW, heads, T, T] | None)``."""
    b, hres, wres, c = y.shape
    if hres % window or wres % window:
        raise ValueError(f"{hres}x{wres} map not divisible by {window}")
    dt = y.dtype
    t = window * window
    dh = c // heads
    qkv = (torch.matmul(y.float(), p["qkv_w"].float())
           + p["qkv_b"].float()).to(dt)                  # [B, H, W, 3C]
    qkv = window_partition(qkv, window)                  # [B, nW, T, 3C]
    nw = qkv.shape[1]
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, nw, t, heads, dh)
               .transpose(2, 3) for i in range(3))       # [B, nW, h, T, dh]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh ** -0.5)
    s = s + bias.float()
    m = _mask_tensor(mask, y.device)
    if m is not None:
        s = s + m[None, :, None]
    if fast_softmax:
        pexp = torch.exp(torch.clamp(s, max=SOFTMAX_CLAMP))
    else:
        pexp = torch.exp(s - s.amax(dim=-1, keepdim=True))
    r = 1.0 / pexp.sum(dim=-1, keepdim=True)
    probs = None
    if want_attn:
        probs = (pexp * r).to(dt)
        o = torch.matmul(probs.float(), v.float())
    else:
        o = torch.matmul(pexp.to(dt).float(), v.float()) * r
    o = o.transpose(2, 3).reshape(b, nw, t, c).to(dt)
    a = (torch.matmul(o.float(), p["proj_w"].float())
         + p["proj_b"].float()).to(dt)
    return window_merge(a, window, hres, wres), probs


def _kernel_lib() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("fused_window_attn")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_fused_window_attn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.ivt_fused_window_attn.restype = ctypes.c_int
        lib.ivt_window_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ivt_window_smem_bytes.restype = ctypes.c_size_t
        lib._ivt_bound = True
    return lib


def load_kernel() -> ctypes.CDLL:
    """Build and load the CUDA kernel now (``chip_smoke.py`` times this);
    checks that the library's shared-memory formula is the envelope's."""
    lib = _kernel_lib()
    for t, dh in ((49, 32), (144, 32), (16, 8), (49, 64)):
        if lib.ivt_window_smem_bytes(t, dh) != window_smem_bytes(t, dh):
            raise RuntimeError("csrc/fused_window_attn.cu and fits() disagree "
                               "on the attention kernel's shared memory")
    return lib


def _check_operands(y: torch.Tensor, p: Params, heads: int, window: int,
                    bias: torch.Tensor, mask) -> None:
    if y.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_window_attn kernel takes float32 or "
                        f"bfloat16, got {y.dtype}")
    if y.ndim != 4:
        raise ValueError(f"y must be [B, H, W, C], got shape "
                         f"{tuple(y.shape)}")
    b, hres, wres, c = y.shape
    if (not fits(hres, window, c, heads) or not fits(wres, window, c, heads)
            or b > _MAX_GRID_YZ):
        raise ValueError(f"fused_window_attn kernel does not take a "
                         f"{b}x{hres}x{wres}x{c} map with heads={heads}, "
                         f"window={window} (see fits())")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous (the kernel takes no strides)")
    want = {"qkv_w": (c, 3 * c), "qkv_b": (3 * c,), "proj_w": (c, c),
            "proj_b": (c,)}
    for name, shape in want.items():
        t = p[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != y.dtype or t.device != y.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the kernel "
                             f"needs {y.dtype} on {y.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    tt = window * window
    if tuple(bias.shape) != (heads, tt, tt):
        raise ValueError(f"bias must be {(heads, tt, tt)}, got "
                         f"{tuple(bias.shape)}")
    nw = (hres // window) * (wres // window)
    if mask is not None and tuple(mask.shape) != (nw, tt, tt):
        raise ValueError(f"mask must be {(nw, tt, tt)}, got "
                         f"{tuple(mask.shape)}")


def fused_window_attn(
    y: torch.Tensor,
    p: Params,
    heads: int,
    window: int,
    bias: torch.Tensor,
    mask=None,
    want_attn: bool = False,
    fast_softmax: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """W-MSA branch on an NHWC map: y [B, H, W, C] -> (a, probs | None).

    Arguments as the JAX function's. ``y`` is the LayerNorm'd (and, for
    shifted blocks, rolled) map and must be contiguous; ``a`` is the branch
    output in the same space. ``bias`` is the gathered [heads, T, T]
    relative-position bias; ``mask`` the [nW, T, T] additive seam mask of a
    shifted block (numpy array or tensor) or None. ``probs`` is
    [B, nW, heads, T, T] in the activation dtype, windows row-major over
    the (rolled) map."""
    if y.device.type == "cpu":
        return fused_window_attn_reference(
            y, p, heads, window, bias, mask, want_attn=want_attn,
            fast_softmax=fast_softmax)
    if y.device.type != "cuda":
        raise ValueError(f"fused_window_attn runs on cuda or cpu tensors, "
                         f"got {y.device}")
    _check_operands(y, p, heads, window, bias, mask)
    b, hres, wres, c = y.shape
    t = window * window
    nw = (hres // window) * (wres // window)
    bias_f = bias.to(device=y.device, dtype=torch.float32).contiguous()
    mask_f = _mask_tensor(mask, y.device)
    if mask_f is not None:
        mask_f = mask_f.contiguous()
    lib = _kernel_lib()
    with torch.cuda.device(y.device):
        qkv_ws = torch.empty((b, hres, wres, 3 * c), dtype=y.dtype,
                             device=y.device)
        o_ws = torch.empty_like(y)
        a = torch.empty_like(y)
        probs = (torch.empty((b, nw, heads, t, t), dtype=y.dtype,
                             device=y.device) if want_attn else None)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.ivt_fused_window_attn(
            _DTYPE_CODE[y.dtype], y.data_ptr(), p["qkv_w"].data_ptr(),
            p["qkv_b"].data_ptr(), p["proj_w"].data_ptr(),
            p["proj_b"].data_ptr(), bias_f.data_ptr(),
            None if mask_f is None else mask_f.data_ptr(),
            qkv_ws.data_ptr(), o_ws.data_ptr(), a.data_ptr(),
            None if probs is None else probs.data_ptr(), b, hres, wres, c,
            heads, window, float(c // heads) ** -0.5,
            int(bool(fast_softmax)), stream)
    if err != 0:
        raise RuntimeError(f"fused_window_attn kernel launch failed: "
                           f"cudaError {err}")
    fused_window_attn.launches += 1
    return a, probs


fused_window_attn.launches = 0
