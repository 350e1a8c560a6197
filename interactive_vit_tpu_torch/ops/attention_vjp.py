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

For CUDA tensors both launch hand-written kernels, on one of three routes
chosen by dtype, head width and alignment (``flash_attention.mma_route``
and ``_tf32_ok``, read on the element pointers and strides), never by a
failure: a failed build or launch raises.

* bf16, heads of a width in ``TRAIN_MMA_DHS`` (64, and vit_h14's 80),
  16-byte aligned operands: the tensor-core kernels of
  ``csrc/attention_train_mma.cu`` (a forward, and a backward pair: dq,
  then dk / dv; one instantiation a width). Counted on
  ``.mma_fwd_launches`` / ``.mma_bwd_launches``.
* f32, heads of a width in ``TRAIN_TF32_DHS`` (64 and 80), 16-byte
  aligned operands: the split-TF32 tensor-core kernels, the forward row
  3's ``csrc/flash_attention_tf32.cu`` (given the layout's element
  strides), the backward pair ``csrc/attention_train_tf32.cu``; every
  product as three TF32 products of a hi / lo split. Counted on
  ``.tf32_fwd_launches`` / ``.tf32_bwd_launches``.
* everything else (f32 and bf16 of other widths or alignments): the f32
  FMA kernels, the forward the row-resident kernel of
  ``csrc/flash_attention.cu`` (given the layout's element strides, no
  copies), the backward ``csrc/attention_bwd.cu``. Counted on
  ``.fwd_launches`` / ``.bwd_launches``.

On both tensor-core routes the forward also returns each row's softmax
statistics (m, l) in f32, which the autograd Function saves beside q, k, v
for the backward (an internal residual: the JAX kernels save q, k, v only;
outputs and gradients do not change). The counters live on
``attention_train`` and ``attention_train_packed``.
For CPU tensors they run the plain versions beside them
(``attention_train_reference``, ``head_grads_reference`` and their packed
twins; ``row_stats_reference`` for (m, l)), in f32 for f32 and bf16 inputs
and in f64 for f64 ones (``torch.autograd.gradcheck``).

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
# The head widths of the bf16 tensor-core kernels (csrc/attention_train_mma.cu),
# in increasing order, and so of the bf16 train route.
TRAIN_MMA_DHS = (64, 80)
# The head widths of the split-TF32 backward (csrc/attention_train_tf32.cu),
# in increasing order, and so of the f32 train route; its forward, row 3's
# split-TF32 kernel, takes each of them (flash_attention.TF32_DHS).
TRAIN_TF32_DHS = (64, 80)
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


def row_stats_reference(q, k, n_real: Optional[int] = None):
    """Plain version of the tensor-core forward's per-row statistics: the
    masked scores' row max m and l = rowsum(exp(s - m)), f32 [B, H, N]
    each (so that probs = exp(s - m) / l)."""
    n, dh = q.shape[-2], q.shape[-1]
    nr = n if n_real is None else min(int(n_real), n)
    acc = _acc_dtype(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * (dh ** -0.5)
    if nr < n:
        col = torch.arange(n, device=q.device)
        s = torch.where(col < nr, s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1)
    return m, torch.exp(s - m[..., None]).sum(dim=-1)


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


# ivt_attention_train_fwd_mma's parameters: q, k, v, o, stats, strides; B,
# H, N, dh, n_real; scale, mask_value; the stream
TRAIN_MMA_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                          + [ctypes.c_float] * 2 + [ctypes.c_void_p])
# ivt_attention_train_bwd_mma's: q, k, v, do, dq, dk, dv, stats, delta,
# strides; then as the forward
TRAIN_MMA_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                          + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def _mma_lib() -> ctypes.CDLL:
    """Build (first use) and load the tensor-core kernels' library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("attention_train_mma")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_attention_train_fwd_mma.argtypes = TRAIN_MMA_FWD_ARGTYPES
        lib.ivt_attention_train_fwd_mma.restype = ctypes.c_int
        lib.ivt_attention_train_bwd_mma.argtypes = TRAIN_MMA_BWD_ARGTYPES
        lib.ivt_attention_train_bwd_mma.restype = ctypes.c_int
        lib.ivt_train_mma_dh.argtypes = [ctypes.c_int]
        lib.ivt_train_mma_dh.restype = ctypes.c_int
        lib._ivt_bound = True
    return lib


def load_mma_kernel() -> ctypes.CDLL:
    """Build and load the tensor-core kernels now; checks their head widths
    against ``TRAIN_MMA_DHS``."""
    lib = _mma_lib()
    fa.check_library_dhs(lib.ivt_train_mma_dh, "csrc/attention_train_mma.cu",
                         TRAIN_MMA_DHS, "TRAIN_MMA_DHS")
    return lib


# ivt_attention_train_bwd_tf32's parameters: those of the bf16 entry
TRAIN_TF32_BWD_ARGTYPES = TRAIN_MMA_BWD_ARGTYPES


def _tf32_lib() -> ctypes.CDLL:
    """Build (first use) and load the split-TF32 backward's library."""
    from interactive_vit_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("attention_train_tf32")
    if not getattr(lib, "_ivt_bound", False):
        lib.ivt_attention_train_bwd_tf32.argtypes = TRAIN_TF32_BWD_ARGTYPES
        lib.ivt_attention_train_bwd_tf32.restype = ctypes.c_int
        lib.ivt_train_tf32_dh.argtypes = [ctypes.c_int]
        lib.ivt_train_tf32_dh.restype = ctypes.c_int
        lib._ivt_bound = True
    return lib


def load_tf32_kernel() -> ctypes.CDLL:
    """Build and load the split-TF32 forward and backward now; checks the
    forward's head widths against ``flash_attention.TF32_DHS`` and the
    backward's against ``TRAIN_TF32_DHS``."""
    fa.load_tf32_kernel()
    lib = _tf32_lib()
    fa.check_library_dhs(lib.ivt_train_tf32_dh,
                         "csrc/attention_train_tf32.cu", TRAIN_TF32_DHS,
                         "TRAIN_TF32_DHS")
    return lib


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


def _mma_ok(dtype, dh, ptrs, strides) -> bool:
    """The bf16 tensor-core train route on element pointers and (image,
    head, token) stride triples: ``flash_attention.mma_route`` (bf16,
    16-byte aligned) at the train kernels' own widths, ``TRAIN_MMA_DHS``;
    widening rows 3-4's widths never sends a train step to a kernel without
    its width."""
    return dh in TRAIN_MMA_DHS and fa.mma_route(
        dtype, dh, ptrs, [s for st in strides for s in st])


def _tf32_ok(dtype, dh, ptrs, strides) -> bool:
    """The split-TF32 train route on element pointers and (image, head,
    token) stride triples: ``flash_attention.tf32_route`` (f32, 16-byte
    aligned) at the backward's own widths, ``TRAIN_TF32_DHS``; widening the
    forward's widths never sends a backward to a kernel without its
    width."""
    return dh in TRAIN_TF32_DHS and fa.tf32_route(
        dtype, dh, ptrs, [s for st in strides for s in st])


def _tc_ok(dtype, dh, ptrs, strides) -> bool:
    """Either tensor-core route (bf16 or f32: their dtypes differ)."""
    return (_mma_ok(dtype, dh, ptrs, strides)
            or _tf32_ok(dtype, dh, ptrs, strides))


def _launch_fwd_mma(ptrs, strides, device, b, h, n, dh, n_real):
    """One launch of the tensor-core forward on heads ``dh`` wide.
    ``ptrs``: q, k, v, o; ``strides``: their stride triples. Returns the
    rows' (m, l), f32 [2, B, H, N]."""
    lib = _mma_lib()
    flat = (ctypes.c_longlong * 12)(*[s for st in strides for s in st])
    with torch.cuda.device(device):
        stats = torch.empty((2, b, h, n), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ivt_attention_train_fwd_mma(
            *ptrs, stats.data_ptr(), ctypes.addressof(flat), b, h, n, dh,
            n_real, float(dh) ** -0.5, MASK_VALUE, stream)
    if err != 0:
        raise RuntimeError(f"tensor-core attention forward launch failed: "
                           f"cudaError {err}")
    return stats


def _launch_fwd_tf32(ptrs, strides, device, b, h, n, dh, n_real):
    """One launch of the split-TF32 forward (row 3's kernel with the (m, l)
    output) on heads ``dh`` wide. ``ptrs``: q, k, v, o; ``strides``: their
    stride triples. Returns the rows' (m, l), f32 [2, B, H, N]."""
    stats = torch.empty((2, b, h, n), dtype=torch.float32, device=device)
    fa.launch_flash_tf32(ptrs, strides, device, b, h, n, dh, n_real,
                         stats_ptr=stats.data_ptr())
    return stats


def _launch_bwd_tc(ptrs, strides, stats, dtype, device, b, h, n, dh,
                   n_real) -> None:
    """One launch of a tensor-core backward pair on heads ``dh`` wide: bf16
    on ``csrc/attention_train_mma.cu``, f32 on
    ``csrc/attention_train_tf32.cu``. ``ptrs``: q, k, v, do, dq, dk, dv;
    ``strides``: their stride triples; ``stats``: the forward's (m, l)."""
    entry = (_tf32_lib().ivt_attention_train_bwd_tf32
             if dtype == torch.float32
             else _mma_lib().ivt_attention_train_bwd_mma)
    flat = (ctypes.c_longlong * 21)(*[s for st in strides for s in st])
    with torch.cuda.device(device):
        # delta per (image, head, query row), from the dq kernel to dk / dv
        delta = torch.empty((b, h, n), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(
            *ptrs, stats.data_ptr(), delta.data_ptr(), ctypes.addressof(flat),
            b, h, n, dh, n_real, float(dh) ** -0.5, MASK_VALUE, stream)
    if err != 0:
        raise RuntimeError(f"tensor-core attention backward launch failed: "
                           f"cudaError {err}")


def _fwd(q, k, v, n_real):
    """-> (o, the rows' (m, l) on a tensor-core route, else None)."""
    if q.device.type == "cpu":
        return attention_train_reference(q, k, v, n_real), None
    b, h, n, dh = q.shape
    _check_cuda("attention_train", (q, k, v), n, dh)
    # token-major, so the caller's transpose back to [B, N, D] is a view
    o = torch.empty((b, n, h, dh), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    strides = [_strides(t, None) for t in (q, k, v, o)]
    ptrs = [_ptr(t) for t in (q, k, v, o)]
    if _mma_ok(q.dtype, dh, ptrs, strides):
        stats = _launch_fwd_mma(ptrs, strides, q.device, b, h, n, dh,
                                n_real)
        attention_train.mma_fwd_launches += 1
        return o, stats
    if _tf32_ok(q.dtype, dh, ptrs, strides):
        stats = _launch_fwd_tf32(ptrs, strides, q.device, b, h, n, dh,
                                 n_real)
        attention_train.tf32_fwd_launches += 1
        return o, stats
    _launch_fwd(q, k, v, o, (0, 0, 0), strides, b, h, n, dh, n_real)
    attention_train.fwd_launches += 1
    return o, None


def _bwd(q, k, v, do, n_real, stats=None):
    """dq, dk, dv; ``stats``: the forward's (m, l) where it took a
    tensor-core route (the backward takes the same one), else None."""
    if q.device.type == "cpu":
        return head_grads_reference(q, k, v, do, n_real)
    b, h, n, dh = q.shape
    if do.stride(-1) != 1 or (stats is not None and not _tc_ok(
            do.dtype, dh, [_ptr(do)], [_strides(do, None)])):
        do = do.contiguous()
    _check_cuda("attention_train", (q, k, v, do), n, dh)
    dq, dk, dv = (torch.empty((b, n, h, dh), dtype=q.dtype,
                              device=q.device).transpose(1, 2)
                  for _ in range(3))
    ts = (q, k, v, do, dq, dk, dv)
    ptrs, strides = [_ptr(t) for t in ts], [_strides(t, None) for t in ts]
    if stats is not None:
        _launch_bwd_tc(ptrs, strides, stats, q.dtype, q.device, b, h, n, dh,
                       n_real)
        if q.dtype == torch.float32:
            attention_train.tf32_bwd_launches += 1
        else:
            attention_train.mma_bwd_launches += 1
        return dq, dk, dv
    _launch_bwd(ptrs, strides, q.dtype, q.device, b, h, n, dh, n_real)
    attention_train.bwd_launches += 1
    return dq, dk, dv


class _AttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_real):
        n = q.shape[-2]
        nr = n if n_real is None else min(int(n_real), n)
        ctx.n_real = nr
        # residuals: q, k, v, as in JAX, and on a tensor-core route the
        # rows' (m, l); the backward recomputes P
        o, stats = _fwd(q, k, v, nr)
        ctx.save_for_backward(q, k, v, stats)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, stats = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, do, ctx.n_real, stats)
        return dq, dk, dv, None


def attention_train(q, k, v, n_real: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v on [B, H, N, dh] with a kernel backward.
    Value contract: ``attention.attention_reference(want_attn=False)``;
    gradient contract: ``head_grads_reference``. ``n_real`` masks keys at
    or beyond it."""
    return _AttentionTrain.apply(q, k, v, n_real)


attention_train.fwd_launches = 0
attention_train.bwd_launches = 0
attention_train.mma_fwd_launches = 0
attention_train.mma_bwd_launches = 0
attention_train.tf32_fwd_launches = 0
attention_train.tf32_bwd_launches = 0


def _packed_fwd(qkv, n_real):
    """-> (o [B, N, D], the rows' (m, l) on a tensor-core route, else
    None)."""
    if qkv.device.type == "cpu":
        return attention_train_packed_reference(qkv, n_real), None
    b, n, d3 = qkv.shape
    d, dh = d3 // 3, PACKED_DH
    h = d // dh
    if qkv.stride(-1) != 1:
        qkv = qkv.contiguous()
    _check_cuda("attention_train_packed", (qkv,), n, dh)
    o = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    # q, k and v of head h start at columns 3*dh*h, +dh, +2dh
    s_in = _strides(qkv, 3 * dh)
    strides = [s_in, s_in, s_in, _strides(o, dh)]
    ptrs = [_ptr(qkv), _ptr(qkv, dh), _ptr(qkv, 2 * dh), _ptr(o)]
    if _mma_ok(qkv.dtype, dh, ptrs, strides):
        stats = _launch_fwd_mma(ptrs, strides, qkv.device, b, h, n, dh,
                                n_real)
        attention_train_packed.mma_fwd_launches += 1
        return o, stats
    if _tf32_ok(qkv.dtype, dh, ptrs, strides):
        stats = _launch_fwd_tf32(ptrs, strides, qkv.device, b, h, n, dh,
                                 n_real)
        attention_train_packed.tf32_fwd_launches += 1
        return o, stats
    _launch_fwd(qkv, qkv, qkv, o, (0, dh, 2 * dh), strides, b, h, n, dh,
                n_real)
    attention_train_packed.fwd_launches += 1
    return o, None


def _packed_bwd(qkv, do, n_real, stats=None):
    """dqkv [B, N, 3D]; ``stats`` as ``_bwd``'s."""
    if qkv.device.type == "cpu":
        return packed_head_grads_reference(qkv, do, n_real)
    b, n, d3 = qkv.shape
    dh = PACKED_DH
    h = d3 // (3 * dh)
    if do.stride(-1) != 1 or (stats is not None and not _tc_ok(
            do.dtype, dh, [_ptr(do)], [_strides(do, dh)])):
        do = do.contiguous()
    _check_cuda("attention_train_packed", (qkv, do), n, dh)
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    s_in, s_do, s_out = (_strides(qkv, 3 * dh), _strides(do, dh),
                         _strides(dqkv, 3 * dh))
    ptrs = [_ptr(qkv), _ptr(qkv, dh), _ptr(qkv, 2 * dh), _ptr(do),
            _ptr(dqkv), _ptr(dqkv, dh), _ptr(dqkv, 2 * dh)]
    strides = [s_in, s_in, s_in, s_do, s_out, s_out, s_out]
    if stats is not None:
        _launch_bwd_tc(ptrs, strides, stats, qkv.dtype, qkv.device, b, h, n,
                       dh, n_real)
        if qkv.dtype == torch.float32:
            attention_train_packed.tf32_bwd_launches += 1
        else:
            attention_train_packed.mma_bwd_launches += 1
        return dqkv
    _launch_bwd(ptrs, strides, qkv.dtype, qkv.device, b, h, n, dh, n_real)
    attention_train_packed.bwd_launches += 1
    return dqkv


class _AttentionTrainPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, n_real):
        n = qkv.shape[1]
        ctx.n_real = n if n_real is None else min(int(n_real), n)
        o, stats = _packed_fwd(qkv, ctx.n_real)
        ctx.save_for_backward(qkv, stats)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, stats = ctx.saved_tensors
        return _packed_bwd(qkv, do, ctx.n_real, stats), None


def attention_train_packed(qkv, n_real: Optional[int] = None
                           ) -> torch.Tensor:
    """Attention on the head-major qkv activation [B, N, 3D] (columns
    [H][3][dh], dh = ``PACKED_DH``): returns [B, N, D] in head order; the
    gradient comes back as one [B, N, 3D] tensor in the same layout."""
    return _AttentionTrainPacked.apply(qkv, n_real)


attention_train_packed.fwd_launches = 0
attention_train_packed.bwd_launches = 0
attention_train_packed.mma_fwd_launches = 0
attention_train_packed.mma_bwd_launches = 0
attention_train_packed.tf32_fwd_launches = 0
attention_train_packed.tf32_bwd_launches = 0


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
