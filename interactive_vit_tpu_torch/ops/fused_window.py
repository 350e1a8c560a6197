"""Fused Swin window-attention branch: QKV + W-MSA + proj on an NHWC map.

Counterpart of ``interactive_vit_tpu/ops/fused_window.py``'s Pallas TPU
kernel, in three pieces, as every kernel of this package has:

* ``fused_window_attn`` -- the wrapper. For a CUDA tensor it launches a
  hand-written kernel (built at first use) or raises; for a CPU tensor it
  runs the plain version. ``window_route`` picks the kernel from the
  dtype, the shape and the operands' alignment alone: bf16 heads 32 wide
  in windows of at most 64 tokens on the tensor cores
  (``csrc/fused_window_attn_mma.cu``, counted in
  ``fused_window_attn_mma.launches``), f32 ones on split-TF32 tensor-core
  products (``csrc/fused_window_attn_tf32.cu``,
  ``fused_window_attn_tf32x3.launches``), other operands the FMA kernel
  (``csrc/fused_window_attn.cu``, counted in
  ``fused_window_attn.launches``). ``fused_window_attn_mma`` and
  ``fused_window_attn_tf32x3`` are the two routes' own wrappers.
* ``fused_window_attn_reference`` -- the plain PyTorch version with the
  same cast points, used on the CPU and to check the kernel on the card.
* ``fits`` -- the FMA kernel's shape envelope, used by ``ops/dispatch.py``:
  one (window, head) of q, k, v and its T x T scores must fit a block's
  shared memory, which holds for window 7 (T=49) and window 12 (T=144) at
  dh=32. The tensor-core routes take a subset of it.

A public wrapper reaches its kernels on a CUDA tensor through its
``torch.library`` custom op (``ops/custom_ops.py``: the launch is the op's
body, so ``torch.export`` records the op where fake tensors have no
address to route by).

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

from interactive_vit_tpu_torch.ops.flash_attention import (
    MMA_ALIGN, check_library_dhs,
)
from interactive_vit_tpu_torch.ops.fused_block import (
    ROW1_QKV_SMALL_M, SOFTMAX_CLAMP, _on_device, row1_qkv_smem_bytes,
)
from interactive_vit_tpu_torch.ops.tiled_attention import SMEM_LIMIT

Params = Dict[str, torch.Tensor]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# grid dimensions y (heads) and z (images) of the attention kernel
_MAX_GRID_YZ = 65535

# ``ivt_fused_window_attn``'s parameters (csrc/fused_window_attn.cu):
# dtype; y, the four weights, bias, mask, the qkv and o workspaces, a,
# probs; B, H, W, C, heads, window; scale; fast; stream. The tensor-core
# entries take the same without the dtype.
ENTRY_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
TC_ENTRY_ARGTYPES = ENTRY_ARGTYPES[1:]

# The tensor-core routes' envelope (csrc/fused_window_attn_mma.cu,
# csrc/fused_window_attn_tf32.cu): heads of these widths, windows of at
# most this many tokens (one tile of 64 rows), maps of channels a multiple
# of 16 up to this many (the QKV kernel's panel).
WINDOW_TC_DHS = (32,)
WINDOW_TC_MAX_TOKENS = 64
WINDOW_TC_MAX_WIDTH = 1280


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


def window_route(dtype: torch.dtype, window: int, dh: int, c: int,
                 addrs) -> str:
    """The window attention's kernel for operands of ``dtype`` in windows
    of ``window`` x ``window`` tokens, heads ``dh`` wide, maps of ``c``
    channels, whose base addresses (bytes) are ``addrs`` (y, the weights
    and the biases): "mma" (bf16 on the tensor cores) or "tf32" (f32 on
    split TF32) when a window holds at most ``WINDOW_TC_MAX_TOKENS``
    tokens, ``dh`` is in ``WINDOW_TC_DHS``, ``c`` is a multiple of 16 up to
    ``WINDOW_TC_MAX_WIDTH``, the route's QKV panel fits a block's shared
    memory and every address is a multiple of 16 bytes (then so is every
    row and head stride); else "fma" (the FMA kernel)."""
    esize = {torch.bfloat16: 2, torch.float32: 4}.get(dtype)
    if (esize is None or window * window > WINDOW_TC_MAX_TOKENS
            or dh not in WINDOW_TC_DHS or c % 16 or c > WINDOW_TC_MAX_WIDTH
            or row1_qkv_smem_bytes(c, esize, 64 if esize == 2 else 32)
            > SMEM_LIMIT
            or not all(int(a) % MMA_ALIGN == 0 for a in addrs)):
        return "fma"
    return "mma" if dtype == torch.bfloat16 else "tf32"


def _window_route_of(y: torch.Tensor, p: Params, heads: int,
                     window: int) -> str:
    """``window_route`` for a branch's operands: y and the four weights
    (the workspaces are the wrapper's own allocations)."""
    c = y.shape[-1]
    return window_route(y.dtype, window, c // heads, c,
                        (y.data_ptr(), *(p[k].data_ptr() for k in (
                            "qkv_w", "qkv_b", "proj_w", "proj_b"))))


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
    """Build (first use) and load the FMA kernel's library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("fused_window_attn")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_fused_window_attn.argtypes = ENTRY_ARGTYPES
        lib.ivt_fused_window_attn.restype = ctypes.c_int
        lib.ivt_window_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ivt_window_smem_bytes.restype = ctypes.c_size_t
        lib._ivt_bound = True
    return lib


def load_kernel() -> ctypes.CDLL:
    """Build and load the FMA kernel now (``chip_smoke.py`` times this);
    checks that the library's shared-memory formula is the envelope's."""
    lib = _kernel_lib()
    for t, dh in ((49, 32), (144, 32), (16, 8), (49, 64)):
        if lib.ivt_window_smem_bytes(t, dh) != window_smem_bytes(t, dh):
            raise RuntimeError("csrc/fused_window_attn.cu and fits() disagree "
                               "on the attention kernel's shared memory")
    return lib


# route -> (source, C entry, prefix of its shape entries)
_WINDOW_TC = {
    "mma": ("fused_window_attn_mma", "ivt_fused_window_attn_mma",
            "ivt_window_mma_"),
    "tf32": ("fused_window_attn_tf32", "ivt_fused_window_attn_tf32x3",
             "ivt_window_tf32_"),
}


def _window_tc_lib(route: str) -> ctypes.CDLL:
    """Build (first use) and load a tensor-core route's library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    source, entry, pre = _WINDOW_TC[route]
    lib = cuda_build.load(source)
    if not getattr(lib, "_ivt_bound", False):
        getattr(lib, entry).argtypes = TC_ENTRY_ARGTYPES
        getattr(lib, entry).restype = ctypes.c_int
        shape_entries = [("dh", [ctypes.c_int], ctypes.c_int),
                         ("max_tokens", [], ctypes.c_int),
                         ("max_width", [], ctypes.c_int)]
        if route == "mma":
            shape_entries += [("qkv_rows", [ctypes.c_int], ctypes.c_int),
                              ("qkv_smem", [ctypes.c_int, ctypes.c_int],
                               ctypes.c_size_t)]
        else:
            shape_entries += [("qkv_smem", [ctypes.c_int], ctypes.c_size_t)]
        for name, args, res in shape_entries:
            fn = getattr(lib, pre + name)
            fn.argtypes, fn.restype = args, res
        lib._ivt_bound = True
    return lib


def check_window_library(lib, route: str) -> None:
    """Raises unless a tensor-core route's library takes exactly the head
    widths of ``WINDOW_TC_DHS``, windows of up to ``WINDOW_TC_MAX_TOKENS``
    tokens and maps up to ``WINDOW_TC_MAX_WIDTH`` channels, and its QKV
    kernel's tile and shared memory are ``fused_block``'s formulas: the
    route must never send a branch to a library that cannot take it."""
    source, _, pre = _WINDOW_TC[route]
    src = f"csrc/{source}.cu"
    check_library_dhs(getattr(lib, pre + "dh"), src, WINDOW_TC_DHS,
                      "WINDOW_TC_DHS")
    widths = (96, 128, 192, 384, 768, 1024, 1280)
    ok = (getattr(lib, pre + "max_tokens")() == WINDOW_TC_MAX_TOKENS
          and getattr(lib, pre + "max_width")() == WINDOW_TC_MAX_WIDTH)
    if route == "mma":
        ok = ok and all(
            lib.ivt_window_mma_qkv_rows(m) == (
                32 if m <= ROW1_QKV_SMALL_M else 64)
            for m in (49, 196, 512, 513, 3136, 25088)) and all(
            lib.ivt_window_mma_qkv_smem(d, bm)
            == row1_qkv_smem_bytes(d, 2, bm) for d in widths
            for bm in (32, 64))
    else:
        ok = ok and all(lib.ivt_window_tf32_qkv_smem(d)
                        == row1_qkv_smem_bytes(d, 4, 32) for d in widths)
    if not ok:
        raise RuntimeError(f"{src} and fused_window disagree on the window, "
                           f"the widest map or the QKV kernel's tile")


def load_mma_kernel() -> ctypes.CDLL:
    """Build and load the bf16 tensor-core route now; checks it
    (``check_window_library``)."""
    lib = _window_tc_lib("mma")
    check_window_library(lib, "mma")
    return lib


def load_tf32_kernel() -> ctypes.CDLL:
    """Build and load the split-TF32 route now; checks it
    (``check_window_library``)."""
    lib = _window_tc_lib("tf32")
    check_window_library(lib, "tf32")
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


def _launch(route: str, y: torch.Tensor, p: Params, heads: int, window: int,
            bias: torch.Tensor, mask, want_attn: bool, fast_softmax: bool):
    """One launch of the branch's kernels on ``route`` ("fma":
    ``csrc/fused_window_attn.cu``; "mma", "tf32": the tensor-core sources)
    on operands already checked; returns ``(a, probs | None)``. Counts
    nothing: the wrappers count their launches."""
    b, hres, wres, c = y.shape
    t = window * window
    nw = (hres // window) * (wres // window)
    bias_f = bias.to(device=y.device, dtype=torch.float32).contiguous()
    mask_f = _mask_tensor(mask, y.device)
    if mask_f is not None:
        mask_f = mask_f.contiguous()
    if route == "fma":
        entry, lead = _kernel_lib().ivt_fused_window_attn, (
            _DTYPE_CODE[y.dtype],)
    else:
        entry, lead = getattr(_window_tc_lib(route), _WINDOW_TC[route][1]), ()
    with torch.cuda.device(y.device):
        qkv_ws = torch.empty((b, hres, wres, 3 * c), dtype=y.dtype,
                             device=y.device)
        o_ws = torch.empty_like(y)
        a = torch.empty_like(y)
        probs = (torch.empty((b, nw, heads, t, t), dtype=y.dtype,
                             device=y.device) if want_attn else None)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = entry(
            *lead, y.data_ptr(), p["qkv_w"].data_ptr(),
            p["qkv_b"].data_ptr(), p["proj_w"].data_ptr(),
            p["proj_b"].data_ptr(), bias_f.data_ptr(),
            None if mask_f is None else mask_f.data_ptr(),
            qkv_ws.data_ptr(), o_ws.data_ptr(), a.data_ptr(),
            None if probs is None else probs.data_ptr(), b, hres, wres, c,
            heads, window, float(c // heads) ** -0.5,
            int(bool(fast_softmax)), stream)
    if err != 0:
        raise RuntimeError(f"fused_window_attn kernel launch failed on the "
                           f"{route} route: cudaError {err}")
    return a, probs


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
    the (rolled) map. Operands that ``window_route`` sends to the tensor
    cores launch there, counted in ``fused_window_attn_mma`` (bf16) or
    ``fused_window_attn_tf32x3`` (f32); this wrapper's count
    (``fused_window_attn.launches``) is the FMA kernel's."""
    if not _on_device(y, "fused_window_attn"):
        return fused_window_attn_reference(
            y, p, heads, window, bias, mask, want_attn=want_attn,
            fast_softmax=fast_softmax)
    _check_operands(y, p, heads, window, bias, mask)
    from interactive_vit_tpu_torch.ops import custom_ops

    return custom_ops.fused_window_attn(y, p, heads, window, bias,
                                        _mask_tensor(mask, y.device),
                                        want_attn, fast_softmax)


def window_launch(y: torch.Tensor, p: Params, heads: int, window: int,
                  bias: torch.Tensor, mask, want_attn: bool,
                  fast_softmax: bool):
    """``ivt::fused_window_attn``'s CUDA body (``ops/custom_ops.py``) on
    checked operands: one launch on the route ``window_route`` gives them,
    counted in that route's wrapper; returns ``(a, probs | None)``."""
    route = _window_route_of(y, p, heads, window)
    out = _launch(route, y, p, heads, window, bias, mask, want_attn,
                  fast_softmax)
    _WINDOW_WRAPPERS[route].launches += 1
    return out


def _window_tc_wrapper(name: str, route: str, doc: str):
    """A tensor-core route's own wrapper, with ``fused_window_attn``'s
    arguments: the plain version for a CPU tensor; on the card one launch,
    counted in its ``launches``, or ``ValueError`` for operands that
    ``window_route`` does not send to ``route``."""
    def wrapper(y: torch.Tensor, p: Params, heads: int, window: int,
                bias: torch.Tensor, mask=None, want_attn: bool = False,
                fast_softmax: bool = True):
        if not _on_device(y, name):
            return fused_window_attn_reference(
                y, p, heads, window, bias, mask, want_attn=want_attn,
                fast_softmax=fast_softmax)
        _check_operands(y, p, heads, window, bias, mask)
        if _window_route_of(y, p, heads, window) != route:
            raise ValueError(
                f"{name} takes {'bf16' if route == 'mma' else 'f32'} heads "
                f"{' or '.join(map(str, WINDOW_TC_DHS))} wide, windows of at "
                f"most {WINDOW_TC_MAX_TOKENS} tokens, maps of a multiple of "
                f"16 channels up to {WINDOW_TC_MAX_WIDTH}, with 16-byte "
                f"aligned operands; got {y.dtype}, window={window}, "
                f"dh={y.shape[-1] // heads}, C={y.shape[-1]}")
        out = _launch(route, y, p, heads, window, bias, mask, want_attn,
                      fast_softmax)
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    return wrapper


fused_window_attn_mma = _window_tc_wrapper(
    "fused_window_attn_mma", "mma",
    """``fused_window_attn``'s contract in bf16 on the tensor cores
    (``csrc/fused_window_attn_mma.cu``).""")
fused_window_attn_tf32x3 = _window_tc_wrapper(
    "fused_window_attn_tf32x3", "tf32",
    """``fused_window_attn``'s contract in f32 on split-TF32 tensor-core
    products (``csrc/fused_window_attn_tf32.cu``).""")
# route -> the wrapper that counts its launches
_WINDOW_WRAPPERS = {"fma": fused_window_attn, "mma": fused_window_attn_mma,
                    "tf32": fused_window_attn_tf32x3}
for _w in _WINDOW_WRAPPERS.values():
    _w.launches = 0
del _w
