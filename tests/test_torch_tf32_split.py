"""The f32 split-TF32 route of the port's online flash attention and the
bf16 tensor-core route of its row-resident one, on the CPU: the f32 route
predicate, an emulation of the 3xTF32 split that the kernel
``csrc/flash_attention_online_tf32.cu`` computes, held against the JAX
package's online kernel on shared inputs, and the wrappers' CPU path.

The kernels themselves run only on the card: their ``cuda``-marked tests
are in ``tests/test_torch_cuda_kernel.py``; their C entries' ctypes
signatures are read from the sources in ``tests/test_torch_mma_attention.py``.

The emulation. The kernel rounds each f32 operand x to TF32 with
``cvt.rna.tf32.f32`` (10 mantissa bits, to nearest, ties away from zero):
hi = rna(x), lo = rna(x - hi), and takes a b as a_hi b_hi + (a_lo b_hi +
a_hi b_lo) on the tensor cores, the hi products and the correction terms in
two f32 accumulators over one key tile, added with round-to-nearest f32
operations. Here ``tf32_rna`` rounds the same way on the f32 bit pattern,
and each product of two TF32 values (22 significant bits at most) is exact
in f32, so the emulation differs from the kernel only in how its f32 sums
round: in order and to nearest here, where the tensor cores truncate
within an accumulator (which is why the kernel keeps those sums short).
It shows the split's error budget. The JAX online kernel runs
in interpret mode with ``ROWFULL_MAX_N`` lowered inside the test (the
module is not edited), f32, at its ``block_k=128``; the emulation at the
kernel's key tile of 64.

Tolerances. hi + lo is within 2^-22 of |x| (the rounding of lo; the
dropped a_lo b_lo adds about as much to a product), so a score of these
inputs (|q . k| dh^-0.5 up to ~15) moves by ~1e-5 at most, p by that share
of itself and o by less than 1e-5 of max|v|: the f32 contract's 1e-4
bound holds with room. Plain TF32 (a_hi b_hi alone, 2^-11 of each
operand) moves o by ~1e-3 on the same inputs, and the same bound must
refuse it.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interactive_vit_tpu.ops import flash_attention as jfa
from interactive_vit_tpu_torch.ops import flash_attention as fa
from interactive_vit_tpu_torch.runtime import cuda_build
from interactive_vit_tpu_torch.tools import kernel_variants

torch.set_num_threads(2)

F32 = torch.float32
BF16 = torch.bfloat16
F32_BOUND = 1e-4


@pytest.fixture
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        jfa.pl, "pallas_call", functools.partial(pl.pallas_call,
                                                 interpret=True))


# -- the f32 route predicate --------------------------------------------------------

# (dtype, dh, byte addresses, element strides, split-TF32 kernel?)
TF32_ROUTE_CASES = [
    # dinov2_s14_reg@742's [B, H, N, dh] views of a [1, 2814, 1152] f32 qkv
    (F32, 64, (4096, 4096 + 1536, 4096 + 3072), (2814 * 1152, 64, 1152),
     True),
    # contiguous [B, H, N, dh] tensors
    (F32, 64, (0, 1 << 20, 2 << 20), (6 * 2814 * 64, 2814 * 64, 64), True),
    # bf16 takes its own route (mma_route), never this one
    (BF16, 64, (0, 128, 256), (197 * 2304, 192, 2304), False),
    (torch.float16, 64, (0, 256, 512), (197 * 2304, 192, 2304), False),
    # other head widths stay on the FMA kernel
    (F32, 128, (0, 512, 1024), (197 * 4608, 384, 4608), False),
    (F32, 32, (0, 128, 256), (197 * 1152, 96, 1152), False),
    (F32, 80, (0, 320, 640), (197 * 3840, 240, 3840), False),
    # a pointer off the 16-byte grid
    (F32, 64, (0, 1540, 3072), (2814 * 1152, 64, 1152), False),
    (F32, 64, (8, 1544, 3080), (2814 * 1152, 64, 1152), False),
    # a token stride of 1154 elements (4616 bytes: off the grid by 8)
    (F32, 64, (0, 1536, 3072), (2814 * 1154, 64, 1154), False),
    # a head stride of 66 elements
    (F32, 64, (0, 1536, 3072), (2814 * 1152, 66, 1152), False),
]


@pytest.mark.parametrize("dtype,dh,addrs,strides,want", TF32_ROUTE_CASES)
def test_tf32_route_by_dtype_width_and_alignment(dtype, dh, addrs, strides,
                                                 want):
    assert fa.tf32_route(dtype, dh, addrs, strides) is want


@pytest.mark.parametrize("dtype,dh,pad,tf32,mma", [
    (F32, 64, 0, True, False),
    (F32, 64, 4, True, False),    # a token stride of 1156: still 16 bytes
    (F32, 64, 2, False, False),   # 1154: off the grid, the FMA kernel
    (BF16, 64, 0, False, True),
    (BF16, 64, 4, False, False),  # 8 bytes off: the FMA kernel
    (F32, 128, 0, False, False),
])
def test_routes_of_qkv_views(dtype, dh, pad, tf32, mma):
    """q, k, v as ``qkv_proj`` makes them (views of one [B, N, 3D] tensor,
    padded by ``pad`` elements a token): the two tensor-core predicates
    never both hold."""
    b, n, h = 1, 40, 3
    qkv = torch.zeros((b, n, 3 * h * dh + pad), dtype=dtype)[..., :3 * h * dh]
    q, k, v = (qkv.reshape(b, n, 3, h, dh)[:, :, i].transpose(1, 2)
               for i in range(3))
    assert fa._tf32_operands(q, k, v) is tf32
    assert fa._mma_operands(q, k, v) is mma


# -- the split -------------------------------------------------------------------------


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits' unit to
    the magnitude, then clear them."""
    bits = x.to(F32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(F32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel takes it: the correction terms, then the hi
    product."""
    ah, al = split(a)
    bh, bl = split(b)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in plain TF32: one product of the rounded operands."""
    return torch.matmul(tf32_rna(a), tf32_rna(b))


def online_emulated(q, k, v, n_real, matmul, block_k=fa.ONLINE_TF32_BLOCK_K):
    """The split-TF32 kernel's arithmetic on f32 [B, H, N, dh]: the online
    update of ``flash_attention_online_reference`` with ``matmul`` for
    both products."""
    n, dh = q.shape[-2], q.shape[-1]
    m = torch.full(q.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=F32)
    for j0 in range(0, n, block_k):
        kt, vt = k[..., j0:j0 + block_k, :], v[..., j0:j0 + block_k, :]
        s = matmul(q, kt.transpose(-1, -2)) * (dh ** -0.5)
        live = torch.arange(j0, j0 + kt.shape[-2]) < n_real
        s = torch.where(live, s, torch.full_like(s, fa.MASK_VALUE))
        vt = torch.where(live[:, None], vt, torch.zeros_like(vt))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + matmul(p, vt)
        m = m_next
    return acc / l


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),             # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),             # just below the tie
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2 * 2.0 ** -10),      # a tie above an odd value
    (2.0 - 2.0 ** -23, 2.0),                          # rounds into the next binade
    (0.0, 0.0),
    (3.0e-39, 3.0e-39 - 3.0e-39 % 2.0 ** -136),       # a denormal
])
def test_tf32_rna_rounds_to_nearest_ties_away(x, want):
    got = tf32_rna(torch.tensor([x], dtype=F32)).item()
    assert got == torch.tensor([want], dtype=F32).item()


def test_split_keeps_f32_precision():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.uniform(-6, 6, 100_000))
                         .astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()  # TF32 values
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    # hi alone is TF32's 2^-11
    assert ((x.double() - hi.double()).abs()
            <= 2.0 ** -11 * x.double().abs()).all()


def _qkv(b, h, n, dh, seed):
    rng = np.random.default_rng(seed)
    return [(2 * rng.standard_normal((b, h, n, dh))).astype(np.float32)
            for _ in range(3)]


def _jax_online(q, k, v, n_real, monkeypatch):
    monkeypatch.setattr(jfa, "ROWFULL_MAX_N", 64)
    o, probs = jfa.flash_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                   n_real=n_real, block_k=128)
    assert probs is None
    return np.asarray(o)


@pytest.mark.parametrize("b,h,n,n_real", [
    (1, 2, 300, None),    # 5 of the kernel's key tiles, the last of 44 keys
    (1, 3, 300, 257),     # keys masked beyond n_real inside a tile
    (2, 2, 130, None),    # just above the lowered threshold: 3 tiles
    (1, 2, 200, 129),
])
def test_split_emulation_matches_jax_online_kernel(
        pallas_interpret, monkeypatch, b, h, n, n_real):
    q, k, v = _qkv(b, h, n, fa.MMA_DH, seed=n + h)
    want = _jax_online(q, k, v, n_real, monkeypatch)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    nr = n if n_real is None else n_real
    got = online_emulated(tq, tk, tv, nr, matmul_3xtf32).numpy()
    assert np.abs(got - want).max() <= F32_BOUND
    # the bound is tight enough to refuse plain TF32 on the same inputs
    plain = online_emulated(tq, tk, tv, nr, matmul_tf32).numpy()
    assert np.abs(plain - want).max() > F32_BOUND
    # and the plain version at the kernel's tile agrees with both
    ref = fa.flash_attention_online_reference(
        tq, tk, tv, nr, block_k=fa.ONLINE_TF32_BLOCK_K).numpy()
    assert np.abs(ref - want).max() <= 1e-5
    assert np.abs(got - ref).max() <= F32_BOUND


# -- the wrappers on the CPU ---------------------------------------------------------


def _counts():
    return (fa.flash_attention.launches, fa.flash_attention_mma.launches,
            fa.flash_attention_online.launches,
            fa.flash_attention_online_mma.launches,
            fa.flash_attention_online_tf32x3.launches)


@pytest.mark.parametrize("n_real", [None, 33])
def test_wrappers_keep_the_plain_versions_on_the_cpu(n_real):
    """CPU tensors run the plain versions whatever the route would be; no
    launch is counted."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 2, 40, 64), generator=g) for _ in range(3))
    before = _counts()
    o, p = fa.flash_attention_mma(q.to(BF16), k.to(BF16), v.to(BF16),
                                  want_attn=True, n_real=n_real)
    ro, rp = fa.flash_attention_reference(q.to(BF16), k.to(BF16),
                                          v.to(BF16), True, n_real)
    assert torch.equal(o, ro) and torch.equal(p, rp)
    assert p.dtype == BF16 and p.shape == (1, 2, 40, 40)
    if n_real is not None:
        assert not p[..., n_real:].any()
    assert torch.equal(fa.flash_attention(q.to(BF16), k.to(BF16),
                                          v.to(BF16), True, n_real)[1], rp)
    o = fa.flash_attention_online_tf32x3(q, k, v, n_real)
    assert torch.equal(o, fa.flash_attention_online_reference(
        q, k, v, n_real, block_k=fa.ONLINE_TF32_BLOCK_K))
    assert torch.equal(fa.flash_attention_online(q, k, v, n_real),
                       fa.flash_attention_online_reference(q, k, v, n_real))
    assert _counts() == before


def test_new_sources_use_their_instructions():
    """The split-TF32 source rounds with cvt.rna and multiplies on m16n8k8
    tf32; both new sources take their copies from ``mma_attention.cuh``."""
    def read(name):
        with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
            return f.read()

    tf32 = read("flash_attention_online_tf32.cu")
    for op in ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
               "cvt.rna.tf32.f32", '#include "mma_attention.cuh"'):
        assert op in tf32, op
    row = read("flash_attention_mma.cu")
    assert '#include "mma_attention.cuh"' in row
    assert "__fdiv_rn" in row  # probs = p / l, a division


@pytest.mark.parametrize("name", sorted(kernel_variants.VARIANTS))
def test_kernel_variants_apply_to_their_sources(name):
    """``tools/kernel_variants.py`` rewrites the sources by exact text:
    each of its replacements must match its source once, so a source edit
    that would silently leave a variant unchanged fails here."""
    source, replacements = kernel_variants.VARIANTS[name]
    text = kernel_variants.variant_source(source, replacements)
    for _, new in replacements:
        assert new in text
