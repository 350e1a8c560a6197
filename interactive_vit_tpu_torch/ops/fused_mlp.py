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
The hidden activations never reach device memory. The int8 variant
(``fused_mlp_w8a8_block``) is not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

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
