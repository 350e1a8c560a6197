"""The f32 split-TF32 routes of the port's attention kernels and the bf16
tensor-core route of its row-resident one, on the CPU: the f32 route
predicate, emulations of the 3xTF32 split that the kernels compute, held
against the JAX package on shared inputs, and the wrappers' CPU path:

* row 4, ``csrc/flash_attention_online_tf32.cu``, against the JAX online
  kernel, heads 64 and 80 wide;
* row 3, ``csrc/flash_attention_tf32.cu`` (two key walks: each key part's
  online (m, l), combined; the normalised probs; PV), against the JAX
  row-resident kernel, o and the probs tap, heads 64 and 80 wide;
* rows 8-9's backward, ``csrc/attention_train_tf32.cu`` ((a) dq from S = Q
  K^T, (b) dk and dv from S^T = K Q^T, both from the forward's saved (m,
  l)), with row 3's emulation as the forward, against ``jax.vjp`` of the
  JAX ``attention_train`` (heads 64 and 80 wide) and
  ``attention_train_packed``.

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
kernel's key tile (64 for heads 64 wide, 32 for 80). Every emulation runs
at both of the kernels' head widths, ``TF32_DHS``.

Tolerances. hi + lo is within 2^-22 of |x| (the rounding of lo; the
dropped a_lo b_lo adds about as much to a product), so a score of these
inputs (|q . k| dh^-0.5 up to ~15) moves by ~1e-5 at most, p by that share
of itself and o by less than 1e-5 of max|v|: the f32 contract's 1e-4
bound holds with room. Plain TF32 (a_hi b_hi alone, 2^-11 of each
operand) moves o by ~1e-3 on the same inputs, and the same bound must
refuse it. The trainable attention's gradients take the f32 train bound,
1e-5 of each tensor's largest value (``chip_smoke.TRAIN_F32_REL``): each
product's ~2^-21 and the f32 sums over N=197 keys or queries (the kernel
sums dq, dk and dv per tile of 32 and folds with round to nearest)
stay near 1e-6 of the scale; plain TF32's 2^-11 per operand does not.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

from interactive_vit_tpu.ops import attention_vjp as jav
from interactive_vit_tpu.ops import flash_attention as jfa
from interactive_vit_tpu_torch.ops import attention_vjp as av
from interactive_vit_tpu_torch.ops import flash_attention as fa
from interactive_vit_tpu_torch.runtime import cuda_build
from interactive_vit_tpu_torch.tools import kernel_variants

torch.set_num_threads(2)

F32 = torch.float32
BF16 = torch.bfloat16
F32_BOUND = 1e-4
TRAIN_F32_REL = 1e-5


@pytest.fixture
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    interp = functools.partial(pl.pallas_call, interpret=True)
    # the trainable attention's forward rides flash_attention's call; its
    # backward and the packed kernels are attention_vjp's own
    monkeypatch.setattr(jfa.pl, "pallas_call", interp)
    monkeypatch.setattr(jav.pl, "pallas_call", interp)


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
    # vit_h14's heads, 80 wide, take the split-TF32 kernels' second width
    (F32, 80, (0, 320, 640), (197 * 3840, 240, 3840), True),
    (F32, 80, (4096, 4096 + 5120, 4096 + 10240), (2810 * 3840, 80, 3840),
     True),
    # bf16 at 80 wide takes its own route (mma_route), never this one
    (BF16, 80, (0, 160, 320), (197 * 3840, 240, 3840), False),
    # 80 wide off the 16-byte grid: a pointer, a head stride of 82
    (F32, 80, (0, 328, 640), (197 * 3840, 240, 3840), False),
    (F32, 80, (0, 320, 640), (197 * 3840, 82, 3840), False),
    # other head widths stay on the FMA kernel
    (F32, 128, (0, 512, 1024), (197 * 4608, 384, 4608), False),
    (F32, 32, (0, 128, 256), (197 * 1152, 96, 1152), False),
    (F32, 96, (0, 384, 768), (197 * 4608, 288, 4608), False),
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
    (F32, 80, 0, True, False),    # vit_h14's heads
    (F32, 80, 2, False, False),
    (BF16, 80, 0, False, True),   # bf16 at 80 wide: the tensor cores
    (BF16, 80, 4, False, False),  # 8 bytes off: the FMA kernel
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


def online_emulated(q, k, v, n_real, matmul):
    """The split-TF32 kernel's arithmetic on f32 [B, H, N, dh]: the online
    update of ``flash_attention_online_reference`` with ``matmul`` for
    both products, at the kernel's key tile for the head width."""
    n, dh = q.shape[-2], q.shape[-1]
    block_k = fa.ONLINE_TF32_BLOCK_K[dh]
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


@pytest.mark.parametrize("dh", fa.TF32_DHS)
@pytest.mark.parametrize("b,h,n,n_real", [
    (1, 2, 300, None),    # 5 of the kernel's key tiles, the last of 44 keys
    (1, 3, 300, 257),     # keys masked beyond n_real inside a tile
    (2, 2, 130, None),    # just above the lowered threshold: 3 tiles
    (1, 2, 200, 129),
])
def test_split_emulation_matches_jax_online_kernel(
        pallas_interpret, monkeypatch, b, h, n, n_real, dh):
    q, k, v = _qkv(b, h, n, dh, seed=n + h + dh)
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
        tq, tk, tv, nr, block_k=fa.ONLINE_TF32_BLOCK_K[dh]).numpy()
    assert np.abs(ref - want).max() <= 1e-5
    assert np.abs(got - ref).max() <= F32_BOUND


def _masked_scores(q, k, n_real, matmul):
    """(q . k) dh^-0.5 through ``matmul``, keys at or beyond n_real at
    MASK_VALUE: [..., N, N] f32."""
    s = matmul(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    live = torch.arange(k.shape[-2]) < n_real
    return torch.where(live, s, torch.full_like(s, fa.MASK_VALUE))


def rowfull_emulated(q, k, v, n_real, matmul, parts=1, kw=64):
    """Row 3's split-TF32 kernel's arithmetic on f32 [B, H, N, dh]: tiles
    of ``parts`` x ``kw`` keys (keys past N masked), each part's (m, l) by
    the online update over its ``kw`` keys of every tile, the parts
    combined (m the max, l = sum l_j exp(m_j - m), in part order), probs =
    exp(s - m) / l, and o = the parts' partial PV sums (each a run of
    ``kw``-key products a tile) added in part order. Returns (o, probs,
    (m, l))."""
    n = q.shape[-2]
    kt = kw * parts
    n_pad = -(-n // kt) * kt
    s = _masked_scores(q, k, n_real, matmul)
    s = torch.cat([s, torch.full(s.shape[:-1] + (n_pad - n,), fa.MASK_VALUE)],
                  dim=-1)
    vp = torch.cat([v, torch.zeros(v.shape[:-2] + (n_pad - n, v.shape[-1]))],
                   dim=-2)
    stats = []
    for j in range(parts):
        m = torch.full(s.shape[:-1], float("-inf"))
        l = torch.zeros_like(m)
        for j0 in range(j * kw, n_pad, kt):
            st = s[..., j0:j0 + kw]
            m_next = torch.maximum(m, st.amax(dim=-1))
            l = torch.exp(m - m_next) * l + torch.exp(
                st - m_next[..., None]).sum(dim=-1)
            m = m_next
        stats.append((m, l))
    m = functools.reduce(torch.maximum, [mj for mj, _ in stats])
    l = torch.zeros_like(m)
    for mj, lj in stats:
        l = l + lj * torch.exp(mj - m)
    probs = torch.exp(s - m[..., None]) / l[..., None]
    o = torch.zeros(q.shape, dtype=F32)
    for j in range(parts):
        oj = torch.zeros(q.shape, dtype=F32)
        for j0 in range(j * kw, n_pad, kt):
            oj = oj + matmul(probs[..., j0:j0 + kw], vp[..., j0:j0 + kw, :])
        o = o + oj
    return o, probs[..., :n], (m, l)


def _jax_rowfull(q, k, v, n_real):
    o, probs = jfa.flash_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                   want_attn=True, n_real=n_real)
    return np.asarray(o), np.asarray(probs)


@pytest.mark.parametrize("dh", fa.TF32_DHS)
@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("b,h,n,n_real", [
    (1, 2, 300, None),    # 5 of the 64-key tiles, the last of 44 keys
    (1, 3, 300, 257),     # keys masked beyond n_real inside a tile
    (2, 2, 130, None),    # two parts: the second part's last tile is empty
    (1, 2, 197, 180),
])
def test_rowfull_split_emulation_matches_jax_kernel(
        pallas_interpret, b, h, n, n_real, parts, dh):
    q, k, v = _qkv(b, h, n, dh, seed=n + h + parts + dh)
    want_o, want_p = _jax_rowfull(q, k, v, n_real)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    nr = n if n_real is None else n_real
    o, probs, (m, l) = rowfull_emulated(tq, tk, tv, nr, matmul_3xtf32, parts)
    assert np.abs(o.numpy() - want_o).max() <= F32_BOUND
    assert np.abs(probs.numpy() - want_p).max() <= F32_BOUND
    assert not probs[..., nr:].any() and not want_p[..., nr:].any()
    # the bound refuses plain TF32 on the same inputs
    plain_o, _, _ = rowfull_emulated(tq, tk, tv, nr, matmul_tf32, parts)
    assert np.abs(plain_o.numpy() - want_o).max() > F32_BOUND
    # the (m, l) the kernel saves for the backward are the plain statistics
    rm, rl = av.row_stats_reference(tq, tk, n_real)
    assert ((m - rm).abs() <= 1e-5 * (1 + rm.abs())).all()
    assert ((l - rl).abs() <= 1e-4 * rl).all()
    # and the plain version agrees with JAX within the same bound
    ro, rp = fa.flash_attention_reference(tq, tk, tv, True, nr)
    assert np.abs(ro.numpy() - want_o).max() <= F32_BOUND
    assert np.abs(rp.numpy() - want_p).max() <= F32_BOUND


def backward_emulated(q, k, v, do, stats, n_real, matmul, tile=32):
    """The split-TF32 backward's arithmetic on f32 [B, H, N, dh], from the
    forward's (m, l): (a) S = Q K^T, P, dP = dO V^T, delta = rowsum(dP P),
    ds = P (dP - delta) scale, dq summed over key tiles of ``tile``; (b)
    S^T = K Q^T, P^T from each query's (m, l), dP^T = V dO^T, dv = P^T dO
    and dk = dS^T Q summed over query tiles of ``tile``. Returns (dq, dk,
    dv)."""
    n, dh = q.shape[-2], q.shape[-1]
    scale = dh ** -0.5
    m, l = stats
    p = torch.exp(_masked_scores(q, k, n_real, matmul) - m[..., None]) / l[
        ..., None]
    dp = matmul(do, v.transpose(-1, -2))
    delta = (dp * p).sum(dim=-1)
    ds = p * (dp - delta[..., None]) * scale
    # (b): keys as rows, each query's statistics along the columns
    st = matmul(k, q.transpose(-1, -2)) * scale
    live = (torch.arange(n) < n_real)[:, None]
    st = torch.where(live, st, torch.full_like(st, fa.MASK_VALUE))
    pt = torch.exp(st - m[..., None, :]) / l[..., None, :]
    dpt = matmul(v, do.transpose(-1, -2))
    dst = pt * (dpt - delta[..., None, :]) * scale
    dq, dk, dv = (torch.zeros(q.shape, dtype=F32) for _ in range(3))
    for c in range(0, n, tile):
        dq = dq + matmul(ds[..., c:c + tile], k[..., c:c + tile, :])
        dv = dv + matmul(pt[..., c:c + tile], do[..., c:c + tile, :])
        dk = dk + matmul(dst[..., c:c + tile], q[..., c:c + tile, :])
    return dq, dk, dv


def _train_use(got, want):
    """The largest share of the f32 train bound (1e-5 of each tensor's
    largest value) over the tensors."""
    return max(float(np.abs(g - w).max() / (TRAIN_F32_REL * np.abs(w).max()))
               for g, w in zip(got, want))


def _jax_vjp(fn, arrays, ct):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def train_tile(dh: int) -> int:
    """The backward kernel's streamed tile at head width ``dh``, as
    ``csrc/attention_train_tf32.cu`` sets it (``TT_KT``, ``TT_KT_80``)."""
    with open(os.path.join(cuda_build.CSRC_DIR,
                           "attention_train_tf32.cu")) as f:
        src = f.read()
    name = "TT_KT" if dh == 64 else f"TT_KT_{dh}"
    return int(re.search(r"\b" + name + r" = (\d+)", src).group(1))


def _emulated_train(q, k, v, do, n_real, matmul, parts):
    """o, dq, dk, dv: row 3's forward emulation, then the backward's at
    the kernel's tile for the head width."""
    o, _, stats = rowfull_emulated(q, k, v, n_real, matmul, parts)
    return [o, *backward_emulated(q, k, v, do, stats, n_real, matmul,
                                  tile=train_tile(q.shape[-1]))]


@pytest.mark.parametrize("dh,b,h,n,n_real,parts", [
    (64, 2, 2, 197, None, 1),   # vit_t16's N: four 64-row tiles, 77% real
    (64, 1, 3, 208, 197, 1),    # keys masked beyond n_real
    (64, 1, 2, 130, None, 2),
    # vit_h14's heads, 80 wide: one query tile, a ragged key tile; keys
    # masked inside the seventh of nine 16-key tiles; the forward's two
    # parts
    (80, 1, 2, 33, None, 1),
    (80, 1, 2, 130, 100, 1),
    (80, 1, 2, 130, None, 2),
])
def test_train_split_emulation_matches_jax_vjp(pallas_interpret, dh, b, h, n,
                                               n_real, parts):
    """Row 3's split-TF32 forward (its ``parts`` key parts) and the
    backward's split products at the kernel's own tiles (32 at 64 wide, 16
    at 80; the 80-wide kernel takes the products one 8-column tile at a
    time, which sums the same products in the same order) against
    ``jax.vjp`` of the JAX kernel, at both widths."""
    assert dh in av.TRAIN_TF32_DHS
    assert train_tile(dh) == {64: 32, 80: 16}[dh]
    q, k, v, do = _qkv(b, h, n, dh, seed=n + 7) + _qkv(
        b, h, n, dh, seed=n + 8)[:1]
    want = _jax_vjp(functools.partial(jav.attention_train, n_real=n_real),
                    (q, k, v), do)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    nr = n if n_real is None else n_real
    got = _emulated_train(tq, tk, tv, tdo, nr, matmul_3xtf32, parts)
    assert _train_use([t.numpy() for t in got], want) <= 1.0
    if n_real is not None:  # masked keys' dk and dv exactly 0
        assert not got[2][..., n_real:, :].any()
        assert not got[3][..., n_real:, :].any()
    # the bound refuses plain TF32 on the same inputs
    plain = _emulated_train(tq, tk, tv, tdo, nr, matmul_tf32, parts)
    assert _train_use([t.numpy() for t in plain], want) > 1.0
    # and the plain versions agree with JAX
    ref = [av.attention_train_reference(tq, tk, tv, n_real),
           *av.head_grads_reference(tq, tk, tv, tdo, n_real)]
    assert _train_use([t.numpy() for t in ref], want) <= 0.5


def _pack_head_major(q, k, v):
    """[B, H, N, dh] x3 -> the head-major qkv activation [B, N, 3HD]."""
    b, h, n, d = q.shape
    qkv = np.stack([q, k, v], axis=2)  # [B, H, 3, N, dh]
    return np.ascontiguousarray(qkv.transpose(0, 3, 1, 2, 4)
                                .reshape(b, n, 3 * h * d))


@pytest.mark.parametrize("n,n_real", [(197, None), (208, 197)])
def test_packed_train_split_emulation_matches_jax_vjp(pallas_interpret, n,
                                                      n_real):
    """The same kernels on the head-major strides: the emulation per head
    against ``jax.vjp`` of the JAX packed kernel, dqkv in its layout."""
    b, h = 1, 2
    q, k, v, do = _qkv(b, h, n, av.PACKED_DH, seed=n + 9) + _qkv(
        b, h, n, av.PACKED_DH, seed=n + 10)[:1]
    qkv = _pack_head_major(q, k, v)
    dout = np.ascontiguousarray(do.transpose(0, 2, 1, 3).reshape(b, n, -1))
    want = _jax_vjp(functools.partial(jav.attention_train_packed,
                                      n_real=n_real), (qkv,), dout)
    nr = n if n_real is None else n_real
    for matmul, ok in ((matmul_3xtf32, True), (matmul_tf32, False)):
        o, dq, dk, dv = _emulated_train(
            *(torch.from_numpy(t) for t in (q, k, v, do)), nr, matmul, 1)
        got_o = o.transpose(1, 2).reshape(b, n, -1).numpy()
        got_g = (torch.stack([dq, dk, dv], dim=2).permute(0, 3, 1, 2, 4)
                 .reshape(b, n, -1).numpy())
        assert (_train_use([got_o, got_g], want) <= 1.0) is ok


# (dtype, pad elements a token, dh, split-TF32 route?)
# (heads 80 wide, vit_h14's: the split-TF32 forward and backward take them
# on the 16-byte grid; off it the trainable attention keeps the FMA pair)
TRAIN_ROUTE_CASES = [(F32, 0, 64, True), (F32, 4, 64, True),
                     (F32, 2, 64, False), (F32, 0, 128, False),
                     (BF16, 0, 64, False), (F32, 0, 80, True),
                     (F32, 4, 80, True), (F32, 2, 80, False),
                     (BF16, 0, 80, False)]


@pytest.mark.parametrize("layout", ["bhnd", "packed"])
@pytest.mark.parametrize("dtype,pad,dh,want", TRAIN_ROUTE_CASES)
def test_tf32_route_of_the_train_layouts(layout, dtype, pad, dh, want):
    """The pointers and strides the trainable attention's wrappers hand the
    predicate: [B, H, N, dh] views of one qkv tensor, and the head-major
    packed slabs, each with ``pad`` extra elements a token (2: f32 rows off
    the 16-byte grid)."""
    b, n, h = 2, 197, 4
    qkv = torch.zeros((b, n, 3 * h * dh + pad), dtype=dtype)[..., :3 * h * dh]
    if layout == "bhnd":
        views = [qkv.reshape(b, n, 3, h, dh)[:, :, i].transpose(1, 2)
                 for i in range(3)]
        ptrs = [av._ptr(t) for t in views]
        strides = [av._strides(t, None) for t in views]
    else:
        ptrs = [av._ptr(qkv, i * dh) for i in range(3)]
        strides = [av._strides(qkv, 3 * dh)] * 3
    assert av._tf32_ok(dtype, dh, ptrs, strides) is want
    assert av._tc_ok(dtype, dh, ptrs, strides) is (
        want or av._mma_ok(dtype, dh, ptrs, strides))
    assert not (want and av._mma_ok(dtype, dh, ptrs, strides))
    # the train route at 80 wide is row 3's split-TF32 route (its forward)
    if dh == 80 and dtype == F32:
        assert fa.tf32_route(dtype, dh, ptrs,
                             [s for st in strides for s in st]) is want


# -- the wrappers on the CPU ---------------------------------------------------------


def _counts():
    return (fa.flash_attention.launches, fa.flash_attention_mma.launches,
            fa.flash_attention_online.launches,
            fa.flash_attention_online_mma.launches,
            fa.flash_attention_online_tf32x3.launches,
            fa.flash_attention_tf32x3.launches,
            *(getattr(fn, c) for fn in (av.attention_train,
                                        av.attention_train_packed)
              for c in ("fwd_launches", "bwd_launches", "mma_fwd_launches",
                        "mma_bwd_launches", "tf32_fwd_launches",
                        "tf32_bwd_launches")))


@pytest.mark.parametrize("dh", fa.TF32_DHS)
@pytest.mark.parametrize("n_real", [None, 33])
def test_wrappers_keep_the_plain_versions_on_the_cpu(n_real, dh):
    """CPU tensors run the plain versions whatever the route would be; no
    launch is counted."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 2, 40, dh), generator=g) for _ in range(3))
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
        q, k, v, n_real, block_k=fa.ONLINE_TF32_BLOCK_K[dh]))
    assert torch.equal(fa.flash_attention_online(q, k, v, n_real),
                       fa.flash_attention_online_reference(q, k, v, n_real))
    # f32 heads of 64 or 80: the split-TF32 route on a card
    for maps in (False, True):
        ref = fa.flash_attention_reference(q, k, v, maps, n_real)
        for fn in (fa.flash_attention_tf32x3, fa.flash_attention):
            got = fn(q, k, v, maps, n_real)
            assert all(torch.equal(a, b) for a, b in zip(got, ref)
                       if b is not None)
            assert (got[1] is None) is (not maps)
    assert _counts() == before


@pytest.mark.parametrize("dh", fa.TF32_DHS)
@pytest.mark.parametrize("n_real", [None, 33])
def test_train_wrappers_keep_the_plain_versions_on_the_cpu(n_real, dh):
    """f32 heads of 64 or 80 (the split-TF32 route on a card): on CPU
    tensors the autograd Functions run the plain versions, save no
    statistics and count no launch; the packed layout (heads of
    ``PACKED_DH``) at 64 only."""
    g = torch.Generator().manual_seed(2)
    b, h, n = 2, 2, 40
    nr = n if n_real is None else n_real
    qkv = torch.randn((b, n, 3 * h * dh), generator=g)
    q, k, v = (qkv.reshape(b, n, 3, h, dh)[:, :, i].transpose(1, 2)
               for i in range(3))
    do = torch.randn((b, h, n, dh), generator=g)
    before = _counts()
    o, stats = av._fwd(q, k, v, nr)
    assert stats is None
    assert torch.equal(o, av.attention_train_reference(q, k, v, n_real))
    grads = av._bwd(q, k, v, do, nr)
    for got, want in zip(grads, av.head_grads_reference(q, k, v, do,
                                                        n_real)):
        assert torch.equal(got, want)
    if dh == av.PACKED_DH:
        o, stats = av._packed_fwd(qkv, nr)
        assert stats is None
        assert torch.equal(o, av.attention_train_packed_reference(qkv,
                                                                  n_real))
        dout = do.transpose(1, 2).reshape(b, n, h * dh)
        assert torch.equal(av._packed_bwd(qkv, dout, nr),
                           av.packed_head_grads_reference(qkv, dout, n_real))
    assert _counts() == before


def _widths(dhs):
    """A library's ``ivt_*_tf32_dh(i)``: the i-th of ``dhs``, 0 past the
    last."""
    return lambda i: dhs[i] if 0 <= i < len(dhs) else 0


@pytest.mark.parametrize("dhs,ok", [
    ((64, 80), True),
    ((64,), False),       # a library built before heads 80 wide
    ((80,), False),
    ((64, 80, 96), False),
    ((80, 64), False),    # the order is part of the contract
    ((), False),
])
def test_tf32_dh_check_refuses_a_library_that_disagrees(dhs, ok):
    """The split-TF32 loaders read the library's head widths and refuse
    any list other than ``TF32_DHS``: the route must never send a width to
    a library without its instantiation."""
    assert fa.library_dhs(_widths(dhs)) == dhs
    if ok:
        fa.check_tf32_dhs(_widths(dhs), "csrc/flash_attention_tf32.cu")
        return
    with pytest.raises(RuntimeError, match="disagree"):
        fa.check_tf32_dhs(_widths(dhs), "csrc/flash_attention_tf32.cu")


def test_new_sources_use_their_instructions():
    """The split-TF32 header rounds with cvt.rna and multiplies on m16n8k8
    tf32, and takes its copies from ``mma_attention.cuh``; the three
    split-TF32 sources include it, and the row-resident sources divide."""
    def read(name):
        with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
            return f.read()

    header = read("tf32_attention.cuh")
    for op in ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
               "cvt.rna.tf32.f32", '#include "mma_attention.cuh"'):
        assert op in header, op
    for name in ("flash_attention_online_tf32.cu", "flash_attention_tf32.cu",
                 "attention_train_tf32.cu"):
        src = read(name)
        assert '#include "tf32_attention.cuh"' in src, name
        # the split lives in the header alone
        assert "asm(" not in src and "asm volatile" not in src, name
    for name in ("flash_attention_mma.cu", "flash_attention_tf32.cu"):
        assert "__fdiv_rn" in read(name), name  # probs = p / l, a division
    assert '#include "mma_attention.cuh"' in read("flash_attention_mma.cu")


@pytest.mark.parametrize("name", sorted(kernel_variants.VARIANTS))
def test_kernel_variants_apply_to_their_sources(name):
    """``tools/kernel_variants.py`` rewrites the sources by exact text:
    each of its replacements must match its source once, so a source edit
    that would silently leave a variant unchanged fails here."""
    source, replacements = kernel_variants.VARIANTS[name]
    text = kernel_variants.variant_source(source, replacements)
    for _, new in replacements:
        assert new in text
