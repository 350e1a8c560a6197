"""The bf16 tensor-core route of the port's attention kernels, on the CPU:
the route predicate (heads 64 and 80 wide), the new C entries' ctypes
signatures read from their sources, and the plain version of the
tensor-core forward's row statistics (m, l) against the JAX package's
``_probs_recompute`` on shared inputs.

The kernels themselves (``csrc/flash_attention_online_mma.cu``,
``csrc/attention_train_mma.cu``) run only on the card: their ``cuda``-marked
tests are in ``tests/test_torch_cuda_kernel.py``.

Tolerances: (m, l) are f32 statistics of f32 scores; numpy's float64
logsumexp of the same scores differs from m + log(l) by f32 rounding,
~1e-7 of the scores' scale: bound 1e-5. The probabilities exp(s - m) / l
against JAX's f32 ``_probs_recompute`` (HIGHEST precision): 1e-6
absolute, as a probability in [0, 1] rounds by less than 6e-8.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interactive_vit_tpu.ops import attention_vjp as jav
from interactive_vit_tpu.ops.layers import precision_for
from interactive_vit_tpu_torch.ops import attention_vjp as av
from interactive_vit_tpu_torch.ops import flash_attention as fa
from interactive_vit_tpu_torch.runtime import cuda_build

torch.set_num_threads(2)

BF16 = torch.bfloat16


# -- the route predicate ----------------------------------------------------------

# (dtype, dh, byte addresses, element strides, tensor cores?)
ROUTE_CASES = [
    # vit_b16's packed qkv [64, 197, 2304]: q, k, v slabs 128 bytes apart
    (BF16, 64, (0, 128, 256), (197 * 2304, 192, 2304), True),
    # dinov2's [B, H, N, dh] views of a [1, 2814, 1152] qkv
    (BF16, 64, (4096, 4096 + 768, 4096 + 1536), (2814 * 1152, 64, 1152), True),
    # f32 never takes the tensor cores (TF32 would break the f32 contract)
    (torch.float32, 64, (0, 256, 512), (197 * 2304, 192, 2304), False),
    (torch.float16, 64, (0, 128, 256), (197 * 2304, 192, 2304), False),
    # other head widths
    (BF16, 128, (0, 256, 512), (197 * 4608, 384, 4608), False),
    (BF16, 32, (0, 64, 128), (197 * 1152, 96, 1152), False),
    (BF16, 16, (0, 32, 64), (17 * 48, 48, 48), False),
    # a pointer off the 16-byte grid
    (BF16, 64, (0, 130, 256), (197 * 2304, 192, 2304), False),
    (BF16, 64, (8, 136, 264), (197 * 2304, 192, 2304), False),
    # a token stride of 196 elements (392 bytes) or an image stride of 4
    (BF16, 64, (0, 128, 256), (197 * 196, 64, 196), False),
    (BF16, 64, (0, 128, 256), (4, 192, 2304), False),
    # heads 80 wide, vit_h14's: @224's [B, H, N, dh] views of a
    # [1, 257, 3840] bf16 qkv
    (BF16, 80, (4096, 4096 + 2560, 4096 + 5120), (257 * 3840, 80, 3840),
     True),
    # vit_h14@742's (N=2810)
    (BF16, 80, (0, 2560, 5120), (2810 * 3840, 80, 3840), True),
    # head-major slabs: q, k, v 160 bytes apart, heads 240 elements
    (BF16, 80, (0, 160, 320), (197 * 3840, 240, 3840), True),
    # contiguous [B, H, N, dh] tensors
    (BF16, 80, (0, 1 << 20, 2 << 20), (16 * 257 * 80, 257 * 80, 80), True),
    # off the 16-byte grid: a pointer, a token stride of 3842 elements,
    # a head stride of 84
    (BF16, 80, (0, 168, 320), (197 * 3840, 240, 3840), False),
    (BF16, 80, (0, 2560, 5120), (257 * 3842, 80, 3842), False),
    (BF16, 80, (0, 2560, 5120), (257 * 3840, 84, 3840), False),
    # f32 and f16 at 80 wide never take the bf16 route
    (torch.float32, 80, (0, 320, 640), (197 * 3840, 240, 3840), False),
    (torch.float16, 80, (0, 160, 320), (197 * 3840, 240, 3840), False),
    # other widths at 80 wide's alignment: no instantiation
    (BF16, 96, (0, 192, 384), (197 * 4608, 288, 4608), False),
    (BF16, 128, (0, 256, 512), (197 * 4608, 384, 4608), False),
    (BF16, 72, (0, 144, 288), (197 * 3456, 216, 3456), False),
    (BF16, 48, (0, 96, 192), (197 * 2304, 144, 2304), False),
]


@pytest.mark.parametrize("dtype,dh,addrs,strides,want", ROUTE_CASES)
def test_mma_route_by_dtype_width_and_alignment(dtype, dh, addrs, strides,
                                                want):
    assert fa.mma_route(dtype, dh, addrs, strides) is want


@pytest.mark.parametrize("layout", ["bhnd", "packed"])
@pytest.mark.parametrize("dtype,dh,want", [(BF16, 64, True),
                                           (torch.float32, 64, False),
                                           (BF16, 128, False)])
def test_mma_route_of_the_port_layouts(layout, dtype, dh, want):
    """The strides and pointers the wrappers hand the predicate: the
    [B, H, N, dh] views of one qkv tensor and the head-major packed
    slabs, as ``_fwd`` / ``_packed_fwd`` form them."""
    b, n, h = 2, 197, 4
    qkv = torch.zeros((b, n, 3 * h * dh), dtype=dtype)
    if layout == "bhnd":
        views = [qkv.reshape(b, n, 3, h, dh)[:, :, i].transpose(1, 2)
                 for i in range(3)]
        ptrs = [av._ptr(t) for t in views]
        strides = [av._strides(t, None) for t in views]
    else:
        ptrs = [av._ptr(qkv, i * dh) for i in range(3)]
        strides = [av._strides(qkv, 3 * dh)] * 3
    # a torch allocation is at least 64-byte aligned
    assert av._mma_ok(dtype, dh, ptrs, strides) is want
    if layout == "bhnd":
        assert fa._mma_operands(*views) is want


def test_wrappers_keep_the_plain_version_on_the_cpu():
    """CPU tensors run the plain versions whatever the route would be; no
    launch is counted and the forward saves no statistics."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 40, 64), generator=g).to(BF16)
               for _ in range(3))
    counts = (fa.flash_attention_online.launches,
              fa.flash_attention_online_mma.launches,
              av.attention_train.mma_fwd_launches,
              av.attention_train.mma_bwd_launches)
    ref = fa.flash_attention_online_reference(q, k, v)
    assert torch.equal(fa.flash_attention_online(q, k, v), ref)
    assert torch.equal(fa.flash_attention_online_mma(q, k, v), ref)
    o, stats = av._fwd(q, k, v, 40)
    assert stats is None
    assert torch.equal(o, av.attention_train_reference(q, k, v))
    qkv = torch.randn((1, 40, 3 * 2 * 64), generator=g).to(BF16)
    o, stats = av._packed_fwd(qkv, 40)
    assert stats is None
    assert (fa.flash_attention_online.launches,
            fa.flash_attention_online_mma.launches,
            av.attention_train.mma_fwd_launches,
            av.attention_train.mma_bwd_launches) == counts


# -- the C entries' signatures ------------------------------------------------------

_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}


def _entry_kinds(source: str, entry: str):
    with open(os.path.join(cuda_build.CSRC_DIR, source)) as f:
        src = f.read()
    params = re.search(r"int " + entry + r"\(([^)]*)\)", src).group(1)
    kinds, names = [], []
    for decl in (" ".join(p.split()) for p in params.split(",")):
        ctype = decl.rsplit(" ", 1)[0].replace("const ", "")
        kinds.append(ctypes.c_void_p if "*" in decl else _C_TYPES[ctype])
        names.append(decl.split()[-1].lstrip("*"))
    return kinds, names


@pytest.mark.parametrize("source,entry,argtypes,first", [
    ("flash_attention_online_mma.cu", "ivt_flash_attention_online_mma",
     fa.ONLINE_MMA_ARGTYPES, ["q", "k", "v", "o", "q_sb"]),
    ("attention_train_mma.cu", "ivt_attention_train_fwd_mma",
     av.TRAIN_MMA_FWD_ARGTYPES, ["q", "k", "v", "o", "stats", "strides"]),
    ("attention_train_mma.cu", "ivt_attention_train_bwd_mma",
     av.TRAIN_MMA_BWD_ARGTYPES, ["q", "k", "v", "dout", "dq", "dk", "dv",
                                 "stats", "delta", "strides"]),
    ("flash_attention_mma.cu", "ivt_flash_attention_mma",
     fa.FLASH_MMA_ARGTYPES, ["q", "k", "v", "o", "probs", "q_sb"]),
    ("flash_attention_online_tf32.cu", "ivt_flash_attention_online_tf32x3",
     fa.ONLINE_TF32_ARGTYPES, ["q", "k", "v", "o", "q_sb"]),
    ("flash_attention_tf32.cu", "ivt_flash_attention_tf32x3",
     fa.FLASH_TF32_ARGTYPES, ["q", "k", "v", "o", "probs", "stats", "q_sb"]),
    ("attention_train_tf32.cu", "ivt_attention_train_bwd_tf32",
     av.TRAIN_TF32_BWD_ARGTYPES, ["q", "k", "v", "dout", "dq", "dk", "dv",
                                  "stats", "delta", "strides"]),
])
def test_mma_entry_matches_its_ctypes_signature(source, entry, argtypes,
                                                first):
    """Each tensor-core C entry's parameters, read from its source, against
    the argtypes its Python module binds: the same count and kinds in
    order (a pointer cut to a 32-bit int would otherwise go unnoticed)."""
    kinds, names = _entry_kinds(source, entry)
    assert names[:len(first)] == first
    assert names[-1] == "stream"
    assert kinds == argtypes


def test_mma_sources_share_one_header():
    """Both tensor-core sources include ``mma_attention.cuh`` and use
    mma.sync, ldmatrix and cp.async through it; the FMA sources do not."""
    with open(os.path.join(cuda_build.CSRC_DIR, "mma_attention.cuh")) as f:
        header = f.read()
    for op in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
               "ldmatrix.sync.aligned.m8n8.x4.shared.b16",
               "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
               "cp.async.cg.shared.global", "cp.async.wait_group"):
        assert op in header, op
    for name in ("flash_attention_online_mma.cu", "attention_train_mma.cu"):
        with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
            assert '#include "mma_attention.cuh"' in f.read()
    for name in ("flash_attention_online.cu", "attention_bwd.cu"):
        with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
            assert "mma_attention.cuh" not in f.read()


# -- the row statistics -------------------------------------------------------------


def _scores(q, k, n_real):
    """Masked f32 scores of numpy q, k [H, N, dh], in float64."""
    dh = q.shape[-1]
    s = np.einsum("hnd,hmd->hnm", q.astype(np.float64),
                  k.astype(np.float64)) * dh ** -0.5
    s[..., n_real:] = av.MASK_VALUE
    return s


@pytest.mark.parametrize("n,n_real", [(197, 197), (208, 197), (17, 17),
                                      (577, 577)])
def test_row_stats_reference_against_logsumexp_and_jax(n, n_real):
    rng = np.random.default_rng(n)
    h, dh = 3, 64
    q, k = (rng.standard_normal((h, n, dh)).astype(np.float32)
            for _ in range(2))
    m, l = av.row_stats_reference(torch.from_numpy(q)[None],
                                  torch.from_numpy(k)[None], n_real)
    assert m.shape == l.shape == (1, h, n) and m.dtype == torch.float32
    m, l = m[0].numpy().astype(np.float64), l[0].numpy().astype(np.float64)
    s = _scores(q, k, n_real)
    mx = s.max(axis=-1)
    lse = mx + np.log(np.exp(s - mx[..., None]).sum(axis=-1))
    np.testing.assert_allclose(m, mx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(m + np.log(l), lse, rtol=0, atol=1e-5)
    # exp(s - m) / l are JAX's _probs_recompute for each head
    for i in range(h):
        jp = np.asarray(jav._probs_recompute(
            jnp.asarray(q[i]), jnp.asarray(k[i]), dh ** -0.5, n_real,
            precision_for(jnp.float32)))
        mine = np.exp(s[i] - m[i][:, None]) / l[i][:, None]
        np.testing.assert_allclose(mine, jp, rtol=0, atol=1e-6)
        if n_real < n:
            assert not jp[:, n_real:].any() and not mine[:, n_real:].any()


def test_row_stats_reference_in_bf16_uses_f32_scores():
    """bf16 q, k: the statistics come from f32 scores of the bf16 values,
    as the kernel forms them."""
    g = torch.Generator().manual_seed(7)
    q, k = (torch.randn((2, 2, 50, 64), generator=g).to(BF16)
            for _ in range(2))
    m, l = av.row_stats_reference(q, k)
    m32, l32 = av.row_stats_reference(q.float(), k.float())
    assert m.dtype == l.dtype == torch.float32
    assert torch.equal(m, m32) and torch.equal(l, l32)
