"""Trainable attention: autograd Functions whose forward and backward are
hand-written kernels.

Counterpart of ``interactive_vit_tpu/ops/attention_vjp.py`` (the Pallas
TPU kernels ``attention_train`` and ``attention_train_packed``). Two
layouts, one kernel pair for each direction:

* ``attention_train(q, k, v, n_real=None)`` on ``[B, H, N, dh]``;
* ``attention_train_packed(qkv, n_real=None)`` on the head-major
  ``[B, N, 3D]`` activation (columns ``[H][3][dh]``,
  ``parallel/mesh.permute_qkv_head_major`` weights): it returns
  ``[B, N, D]`` in head order and its backward writes the gradient straight
  into a ``[B, N, 3D]`` dqkv, so no cat or transpose exists around it.

For CUDA tensors both launch hand-written kernels: the forward is the
row-resident kernel of ``csrc/flash_attention.cu`` (given the layout's
element strides, no copies), the backward ``csrc/attention_bwd.cu``; a
failed build or launch raises. For CPU tensors they run the plain
versions beside them (``attention_train_reference``,
``head_grads_reference`` and their packed twins), in f32 for f32 and bf16
inputs and in f64 for f64 ones (``torch.autograd.gradcheck``). Launches are
counted on ``attention_train.fwd_launches`` / ``.bwd_launches`` and
``attention_train_packed.fwd_launches`` / ``.bwd_launches``.

Numerics (the JAX kernels'): the forward is the row-resident kernel's (f32
scores times dh^-0.5, keys at or beyond ``n_real`` at ``MASK_VALUE``, the
row max subtracted, probs = p / rowsum, probs cast to v's dtype for PV).
The backward is ``_head_grads``: probs recomputed from (q, k) in f32;
dv = probs.to(do.dtype)^T do; dP = do v^T; delta = rowsum(dP * probs);
ds = (probs * (dP - delta) * scale).to(q.dtype); dq = ds k and
dk = ds^T q, f32-accumulated; all three cast to q's dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from interactive_vit_tpu_torch.ops import flash_attention as fa
from interactive_vit_tpu_torch.ops.attention import attention_reference

MASK_VALUE = fa.MASK_VALUE
# The JAX kernel's sequence limit (one program held a whole [N, N] per
# head); above it ``trainable_flash_mhsa`` takes the plain attention, as in
# JAX. The CUDA kernels' shared memory does not depend on N.
TRAIN_MAX_N = 1024
# The packed layout's head width and pairing (a TPU lane rule in JAX); kept
# so the packed path is chosen for the same models as there.
PACKED_DH = 64

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The widest head csrc/attention_bwd.cu takes (its entry refuses wider).
BWD_MAX_DH = 128


def packed_ok(heads: int, dh: int, n: int) -> bool:
    """The packed kernels' applicability (``attention.mhsa`` consults it)."""
    return dh == PACKED_DH and heads % 2 == 0 and n <= TRAIN_MAX_N


def fits(n: int, dh: int) -> bool:
    """True when the forward and backward kernels take N=n of width dh."""
    return fa.fits(n, dh) and 0 < dh <= BWD_MAX_DH and dh % 4 == 0


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for f32 and bf16, f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def _probs(q, k, n_real):
    """Masked softmax(q k^T * dh^-0.5) in the accumulation dtype."""
    acc = _acc_dtype(q.dtype)
    n, dh = q.shape[-2], q.shape[-1]
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * (dh ** -0.5)
    if n_real < n:
        col = torch.arange(n, device=q.device)
        s = torch.where(col < n_real, s, torch.full_like(s, MASK_VALUE))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def attention_train_reference(q, k, v, n_real: Optional[int] = None):
    """Plain version of the forward on [B, H, N, dh] (the row-resident
    kernel's contract, no maps): o in q's dtype."""
    n = q.shape[-2]
    nr = n if n_real is None else min(int(n_real), n)
    acc = _acc_dtype(q.dtype)
    probs = _probs(q, k, nr)
    return torch.matmul(probs.to(v.dtype).to(acc), v.to(acc)).to(q.dtype)


def head_grads_reference(q, k, v, do, n_real: Optional[int] = None):
    """Plain version of the backward on [B, H, N, dh]: ``_head_grads`` of
    the JAX package written out with its cast points (not autograd of the
    forward). Returns (dq, dk, dv) in q's dtype."""
    n, dh = q.shape[-2], q.shape[-1]
    nr = n if n_real is None else min(int(n_real), n)
    acc = _acc_dtype(q.dtype)
    scale = dh ** -0.5
    probs = _probs(q, k, nr)
    dof = do.to(acc)
    dv = torch.matmul(probs.to(do.dtype).to(acc).transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.to(acc).transpose(-1, -2))
    delta = (dp * probs).sum(dim=-1, keepdim=True)
    ds = (probs * (dp - delta) * scale).to(q.dtype).to(acc)
    dq = torch.matmul(ds, k.to(acc))
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _split_packed(qkv):
    """[B, N, 3D] head-major -> q, k, v views [B, H, N, dh]."""
    b, n, d3 = qkv.shape
    heads = d3 // (3 * PACKED_DH)
    t = qkv.reshape(b, n, heads, 3, PACKED_DH)
    return tuple(t[:, :, :, i].transpose(1, 2) for i in range(3))


def attention_train_packed_reference(qkv, n_real: Optional[int] = None):
    """Plain version of the packed forward: [B, N, 3D] -> [B, N, D]."""
    b, n, d3 = qkv.shape
    o = attention_train_reference(*_split_packed(qkv), n_real)
    return o.transpose(1, 2).reshape(b, n, d3 // 3)


def packed_head_grads_reference(qkv, do, n_real: Optional[int] = None):
    """Plain version of the packed backward: (qkv [B, N, 3D], do [B, N, D])
    -> dqkv [B, N, 3D] in the head-major column layout."""
    b, n, d3 = qkv.shape
    heads = d3 // (3 * PACKED_DH)
    doh = do.reshape(b, n, heads, PACKED_DH).transpose(1, 2)
    grads = head_grads_reference(*_split_packed(qkv), doh, n_real)
    # [B, H, N, dh] x3 -> [B, N, H, 3, dh] -> [B, N, 3D]
    return torch.stack(grads, dim=3).transpose(1, 2).reshape(b, n, d3)


# -- the kernels ----------------------------------------------------------------


def _bwd_lib() -> ctypes.CDLL:
    """Build (first use) and load the backward kernel library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("attention_bwd")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_attention_bwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.ivt_attention_bwd.restype = ctypes.c_int
        lib._ivt_bound = True
    return lib


def load_kernel() -> ctypes.CDLL:
    """Build and load the forward's and the backward's libraries now."""
    fa.load_kernel()
    return _bwd_lib()


def _check_cuda(name, tensors, n, dh):
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernels take float32 or bfloat16, got "
                        f"{dtype}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: operands on {t.device} {t.dtype}, "
                             f"expected {dev} {dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
    if not fits(n, dh):
        raise ValueError(f"{name} kernels do not take n={n}, dh={dh} "
                         f"(see fits())")


def _ptr(t: torch.Tensor, offset: int = 0) -> int:
    return t.data_ptr() + offset * t.element_size()


def _strides(t: torch.Tensor, layout):
    """(image, head, token) element strides of a [B, H, N, dh] view, or
    of a packed [B, N, W] tensor whose heads are ``layout`` columns
    apart."""
    if layout is None:
        return t.stride()[:3]
    return (t.stride(0), layout, t.stride(1))


def _launch_fwd(q, k, v, o, offs, strides, b, h, n, dh, n_real) -> None:
    """One launch of the row-resident forward kernel on strided views."""
    lib = fa._kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ivt_flash_attention(
            _DTYPE_CODE[q.dtype], _ptr(q, offs[0]), _ptr(k, offs[1]),
            _ptr(v, offs[2]), _ptr(o), None, *strides[0], *strides[1],
            *strides[2], *strides[3], b, h, n, dh, n_real,
            float(dh) ** -0.5, MASK_VALUE, stream)
    if err != 0:
        raise RuntimeError(f"attention forward kernel launch failed: "
                           f"cudaError {err}")


def _launch_bwd(ptrs, strides, dtype, device, b, h, n, dh, n_real) -> None:
    """One launch of the backward kernel pair. ``ptrs``: q, k, v, do, dq,
    dk, dv; ``strides``: their (image, head, token) element strides."""
    lib = _bwd_lib()
    flat = (ctypes.c_longlong * 21)(*[s for st in strides for s in st])
    with torch.cuda.device(device):
        # per (image, head, query row): the row max, the row sum and delta
        stats = torch.empty((3, b, h, n), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ivt_attention_bwd(
            _DTYPE_CODE[dtype], *ptrs, stats.data_ptr(),
            ctypes.addressof(flat), b, h, n, dh, n_real, float(dh) ** -0.5,
            MASK_VALUE, stream)
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: "
                           f"cudaError {err}")


def _fwd(q, k, v, n_real):
    if q.device.type == "cpu":
        return attention_train_reference(q, k, v, n_real)
    b, h, n, dh = q.shape
    _check_cuda("attention_train", (q, k, v), n, dh)
    # token-major, so the caller's transpose back to [B, N, D] is a view
    o = torch.empty((b, n, h, dh), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    _launch_fwd(q, k, v, o, (0, 0, 0),
                [_strides(t, None) for t in (q, k, v, o)], b, h, n, dh,
                n_real)
    attention_train.fwd_launches += 1
    return o


def _bwd(q, k, v, do, n_real):
    if q.device.type == "cpu":
        return head_grads_reference(q, k, v, do, n_real)
    b, h, n, dh = q.shape
    if do.stride(-1) != 1:
        do = do.contiguous()
    _check_cuda("attention_train", (q, k, v, do), n, dh)
    dq, dk, dv = (torch.empty((b, n, h, dh), dtype=q.dtype,
                              device=q.device).transpose(1, 2)
                  for _ in range(3))
    ts = (q, k, v, do, dq, dk, dv)
    _launch_bwd([_ptr(t) for t in ts], [_strides(t, None) for t in ts],
                q.dtype, q.device, b, h, n, dh, n_real)
    attention_train.bwd_launches += 1
    return dq, dk, dv


class _AttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_real):
        n = q.shape[-2]
        nr = n if n_real is None else min(int(n_real), n)
        ctx.n_real = nr
        # residuals: q, k, v only, as in JAX; the backward recomputes P
        ctx.save_for_backward(q, k, v)
        return _fwd(q, k, v, nr)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, do, ctx.n_real)
        return dq, dk, dv, None


def attention_train(q, k, v, n_real: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v on [B, H, N, dh] with a kernel backward.
    Value contract: ``attention.attention_reference(want_attn=False)``;
    gradient contract: ``head_grads_reference``. ``n_real`` masks keys at
    or beyond it."""
    return _AttentionTrain.apply(q, k, v, n_real)


attention_train.fwd_launches = 0
attention_train.bwd_launches = 0


def _packed_fwd(qkv, n_real):
    if qkv.device.type == "cpu":
        return attention_train_packed_reference(qkv, n_real)
    b, n, d3 = qkv.shape
    d, dh = d3 // 3, PACKED_DH
    h = d // dh
    if qkv.stride(-1) != 1:
        qkv = qkv.contiguous()
    _check_cuda("attention_train_packed", (qkv,), n, dh)
    o = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    # q, k and v of head h start at columns 3*dh*h, +dh, +2dh
    s_in = _strides(qkv, 3 * dh)
    _launch_fwd(qkv, qkv, qkv, o, (0, dh, 2 * dh),
                [s_in, s_in, s_in, _strides(o, dh)], b, h, n, dh, n_real)
    attention_train_packed.fwd_launches += 1
    return o


def _packed_bwd(qkv, do, n_real):
    if qkv.device.type == "cpu":
        return packed_head_grads_reference(qkv, do, n_real)
    b, n, d3 = qkv.shape
    dh = PACKED_DH
    h = d3 // (3 * dh)
    if do.stride(-1) != 1:
        do = do.contiguous()
    _check_cuda("attention_train_packed", (qkv, do), n, dh)
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    s_in, s_do, s_out = (_strides(qkv, 3 * dh), _strides(do, dh),
                         _strides(dqkv, 3 * dh))
    ptrs = [_ptr(qkv), _ptr(qkv, dh), _ptr(qkv, 2 * dh), _ptr(do),
            _ptr(dqkv), _ptr(dqkv, dh), _ptr(dqkv, 2 * dh)]
    _launch_bwd(ptrs, [s_in, s_in, s_in, s_do, s_out, s_out, s_out],
                qkv.dtype, qkv.device, b, h, n, dh, n_real)
    attention_train_packed.bwd_launches += 1
    return dqkv


class _AttentionTrainPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, n_real):
        n = qkv.shape[1]
        ctx.n_real = n if n_real is None else min(int(n_real), n)
        ctx.save_for_backward(qkv)
        return _packed_fwd(qkv, ctx.n_real)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        return _packed_bwd(qkv, do, ctx.n_real), None


def attention_train_packed(qkv, n_real: Optional[int] = None
                           ) -> torch.Tensor:
    """Attention on the head-major qkv activation [B, N, 3D] (columns
    [H][3][dh], dh = ``PACKED_DH``): returns [B, N, D] in head order; the
    gradient comes back as one [B, N, 3D] tensor in the same layout."""
    return _AttentionTrainPacked.apply(qkv, n_real)


attention_train_packed.fwd_launches = 0
attention_train_packed.bwd_launches = 0


def trainable_flash_mhsa(q, k, v, want_attn: bool = False,
                         n_real: Optional[int] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Drop-in ``attn_impl`` for ``attention.mhsa`` inside train steps.
    Falls back to ``attention_reference`` where the JAX function does, by
    shape: maps asked for, or N above ``TRAIN_MAX_N``."""
    if want_attn or q.shape[2] > TRAIN_MAX_N:
        return attention_reference(q, k, v, want_attn=want_attn,
                                   n_real=n_real)
    return attention_train(q, k, v, n_real), None


trainable_flash_mhsa.packed = attention_train_packed
trainable_flash_mhsa.packed_ok = packed_ok
