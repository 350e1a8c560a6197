"""The headwise attention block's tensor-core routes, on the CPU: the route
predicate, emulations of the two kernels' arithmetic held against the JAX
package's Pallas ``headwise_attn_block`` in interpret mode on shared
inputs, the C entries' ctypes signatures read from their sources, the
loaders' head-width check and the wrappers' CPU path:

* f32, ``csrc/headwise_attn_block_tf32.cu``: every product as three TF32
  products of a hi / lo split (``cvt.rna`` rounding), the hi products and
  the correction terms summed apart over one short run and folded with
  round-to-nearest adds: a score over dh, PV over one key tile
  (``HEADWISE_TF32_BLOCK_K``: 32 keys at 64 wide, 64 at 80), the
  projection over k-tiles of 32;
* bf16, ``csrc/headwise_attn_block_mma.cu``: the cast points. With maps
  and mean off the unnormalised p is cast to bf16 before PV and the f32
  result is scaled by 1 / rowsum; with maps or mean on the probs p / rowsum
  are cast once, and that cast is both the tap and PV's operand; PV
  summed in f32 key tile by key tile (``HEADWISE_MMA_BLOCK_K``).

The kernels themselves run only on the card: their ``cuda``-marked tests
are in ``tests/test_torch_cuda_kernel.py``, and ``chip_smoke.py`` holds
them against the plain version at the served shapes.

Inputs and parameters are made with numpy from a seed and handed to both
packages; the JAX package runs its Pallas kernel in interpret mode,
unchanged. Widths d=128 (2 heads of 64, which JAX packs two to a 128-lane
block) and d=160 (2 heads of 80, its per-head fallback); N = 17, 50 and 130
(above one key tile at either width).

Tolerances. f32: 1e-4 on y, the maps and the mean, the contract's. The
split's products are within ~2^-21 of the f32 products (the rounding of lo
and the dropped lo x lo), and the emulation's sums round in another order
than the kernel's, so y, whose scale here is a few units, moves by ~1e-6;
plain TF32 (2^-11 an operand) moves it by ~1e-3 and the same bound
refuses it. bf16: the bounds of ``chip_smoke.py``'s ``output_bound``: y
within 2^-6 of max(1, its largest value), each probs and mean element
within min(2^-7, 2^-5 of the JAX value + 1e-6): both sides round at the
same points, so they differ where an f32 sum, taken in another order,
lands within its rounding error of a bf16 boundary.
"""

import ctypes
import functools
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.ops import fused_block as jfb
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import fused_block as tfb
from interactive_vit_tpu_torch.runtime import cuda_build

torch.set_num_threads(2)

F32 = torch.float32
BF16 = torch.bfloat16
F32_BOUND = 1e-4
BF16_Y_REL = 2.0 ** -6
BF16_P_REL, BF16_P_ABS, BF16_P_CAP = 2.0 ** -5, 1e-6, 2.0 ** -7
HEADS = 2
# (want_attn, want_mean, attn_heads): maps off, maps + mean, a subset + mean
MODES = [(False, False, None), (True, True, None), (True, True, (1,))]


@pytest.fixture
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(jfb.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# -- the route predicate ------------------------------------------------------------

# (dtype, dh, byte addresses, element strides and offsets, route)
ROUTE_CASES = [
    # vit_l16@384: x, proj_w, proj_b; rows of D=1024, qkv rows of 3D,
    # heads 64 wide
    (BF16, 64, (0, 1 << 21, 1 << 22), (1024, 3072, 64), "mma"),
    (F32, 64, (0, 1 << 22, 1 << 23), (1024, 3072, 64), "tf32"),
    # vit_h14's heads, 80 wide (D=1280)
    (BF16, 80, (4096, 8192, 12288), (1280, 3840, 80), "mma"),
    (F32, 80, (4096, 8192, 12288), (1280, 3840, 80), "tf32"),
    # other head widths and dtypes keep the FMA kernel
    (BF16, 24, (0, 256, 512), (96, 288, 24), "fma"),
    (F32, 96, (0, 256, 512), (768, 2304, 96), "fma"),
    (F32, 128, (0, 256, 512), (1024, 3072, 128), "fma"),
    (torch.float16, 64, (0, 256, 512), (1024, 3072, 64), "fma"),
    # an operand off the 16-byte grid: x one element in, proj_w, proj_b
    (BF16, 64, (2, 1 << 21, 1 << 22), (1024, 3072, 64), "fma"),
    (F32, 80, (4096, 8196, 12288), (1280, 3840, 80), "fma"),
    (F32, 64, (0, 1 << 22, (1 << 23) + 8), (1024, 3072, 64), "fma"),
    # 80 wide over an odd head count: D=240 is 16-byte rows in f32 (960
    # bytes) and bf16 (480)
    (BF16, 80, (0, 512, 1024), (240, 720, 80), "mma"),
    # a row stride off the grid (a width the routes could never see from
    # heads of 64 or 80, kept to show the strides are read)
    (F32, 64, (0, 256, 512), (1026, 3078, 64), "fma"),
]


@pytest.mark.parametrize("dtype,dh,addrs,strides,route", ROUTE_CASES)
def test_headwise_route_by_dtype_width_and_alignment(dtype, dh, addrs,
                                                     strides, route):
    assert tfb.headwise_route(dtype, dh, addrs, strides) == route


def _operands(b, n, d, dtype, offset=0, param_offset=0):
    """x [B, N, D] and a block's parameters as contiguous CPU tensors, x
    (and proj_w) starting ``offset`` (``param_offset``) elements into their
    storage."""
    def at(shape, off):
        size = int(np.prod(shape))
        return torch.zeros(size + off, dtype=dtype)[off:].view(shape)

    p = {"ln1_s": at((d,), 0), "ln1_b": at((d,), 0),
         "qkv_w": at((d, 3 * d), 0), "qkv_b": at((3 * d,), 0),
         "proj_w": at((d, d), param_offset), "proj_b": at((d,), 0)}
    return at((b, n, d), offset), p


@pytest.mark.parametrize("dtype,d,heads,offset,param_offset,route", [
    (BF16, 1024, 16, 0, 0, "mma"),     # vit_l16@384's block
    (F32, 1024, 16, 0, 0, "tf32"),
    (F32, 1280, 16, 0, 0, "tf32"),     # vit_h14's
    (BF16, 1280, 16, 0, 0, "mma"),
    (BF16, 1024, 16, 1, 0, "fma"),     # x 2 bytes off the grid
    (F32, 1024, 16, 2, 0, "fma"),      # x 8 bytes off
    (F32, 1024, 16, 4, 0, "tf32"),     # 16 bytes off: on the grid
    (BF16, 1280, 16, 0, 3, "fma"),     # proj_w off the grid
    (F32, 96, 4, 0, 0, "fma"),         # heads 24 wide
    (BF16, 768, 6, 0, 0, "fma"),       # heads 128 wide
])
def test_route_of_a_blocks_operands(dtype, d, heads, offset, param_offset,
                                    route):
    """The pointers and strides the wrapper hands the predicate: x, proj_w
    and proj_b, rows of D, the qkv it makes (rows of 3D, heads at h dh)."""
    x, p = _operands(1, 3, d, dtype, offset, param_offset)
    assert x.is_contiguous() and p["proj_w"].is_contiguous()
    assert tfb._route_of(x, p, heads) == route


# -- the emulations -----------------------------------------------------------------


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``."""
    bits = x.to(F32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(F32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: the correction terms, then the hi
    product, on the split operands."""
    ah = tf32_rna(a)
    al = tf32_rna(a - ah)
    bh = tf32_rna(b)
    bl = tf32_rna(b - bh)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in plain TF32: one product of the rounded operands."""
    return torch.matmul(tf32_rna(a), tf32_rna(b))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def _tiled(matmul, a, b, tile):
    """a @ b with the product over the contracted dim in runs of ``tile``,
    each run's sum added to the running sum in order."""
    acc = None
    for k0 in range(0, a.shape[-1], tile):
        part = matmul(a[..., k0:k0 + tile], b[..., k0:k0 + tile, :])
        acc = part if acc is None else acc + part
    return acc


def headwise_emulated(x, p, heads, want_attn, want_mean, attn_heads, fast,
                      matmul, block_k, proj_tile, eps=1e-6):
    """A tensor-core route's arithmetic on CPU tensors of the activation
    dtype: LN1 + QKV and an ``attn_heads`` subset's maps as the wrapper
    makes them (plain PyTorch), then the kernel's: scores through
    ``matmul``, p (fast or exact), l and r = 1 / l in f32; maps or mean on:
    probs = p r cast to the dtype, the tap and PV's operand; off: p cast,
    PV, then times r; PV and the projection through ``matmul`` in runs of
    ``block_k`` keys and ``proj_tile`` columns; y = (x + o W) + b; the mean
    over the f32 probs in head order."""
    dt = x.dtype
    b, n, d = x.shape
    dh = d // heads
    emit = tfb._emit_heads(heads, want_attn, attn_heads)
    qkv = tfb._ln_qkv(x, p, eps)
    sel = tfb._subset_maps(qkv, heads, emit) if emit is not None else None
    norm = want_mean or (want_attn and emit is None)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, dh)
               .transpose(1, 2).float() for i in range(3))
    s = matmul(q, k.transpose(-1, -2)) * (dh ** -0.5)
    if fast:
        pe = torch.exp(torch.clamp(s, max=tfb.SOFTMAX_CLAMP))
    else:
        pe = torch.exp(s - s.amax(dim=-1, keepdim=True))
    r = 1.0 / pe.sum(dim=-1, keepdim=True)
    if norm:
        probs = pe * r
        o = _tiled(matmul, probs.to(dt).float(), v, block_k)
    else:
        o = _tiled(matmul, pe.to(dt).float(), v, block_k) * r
    o = o.transpose(1, 2).reshape(b, n, d).to(dt)
    y = ((x.float() + _tiled(matmul, o.float(), p["proj_w"].float(),
                             proj_tile))
         + p["proj_b"].float()).to(dt)
    out = [y, None]
    if want_attn:
        out[1] = sel if sel is not None else probs.to(dt)
    if want_mean:
        out.append(tfb._head_mean(probs, heads).to(dt))
    return tuple(out)


def _block(d, n, seed, b=2):
    """A block's attention parameters (non-trivial LN and biases) and an
    input batch, as numpy f32."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (rng.standard_normal(shape) * std + mean).astype(np.float32)

    p = {"ln1_s": rnd(d, std=0.1, mean=1.0), "ln1_b": rnd(d, std=0.1),
         "qkv_w": rnd(d, 3 * d, std=d ** -0.5), "qkv_b": rnd(3 * d, std=0.1),
         "proj_w": rnd(d, d, std=d ** -0.5), "proj_b": rnd(d, std=0.1)}
    return p, rnd(b, n, d)


def _jax_headwise(p, x, kw, dtype):
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    out = jfb.headwise_attn_block(jnp.asarray(x, jdt),
                                  jax.tree.map(lambda a: jnp.asarray(a, jdt),
                                               p), HEADS, 1e-6, **kw)
    return [None if o is None else torch.from_numpy(
        np.array(o.astype(jnp.float32))) for o in out]


def _f32_use(got, want):
    return max(float((g.float() - w).abs().max()) / F32_BOUND
               for g, w in zip(got, want) if w is not None)


def _bf16_use(got, want):
    uses = []
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        diff = (g.float() - w).abs()
        if i == 0:
            bound = BF16_Y_REL * max(1.0, float(w.abs().max()))
        else:
            bound = (BF16_P_REL * w.abs() + BF16_P_ABS).clamp(max=BF16_P_CAP)
        uses.append(float((diff / bound).max()))
    return max(uses)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("want_attn,want_mean,attn_heads", MODES)
@pytest.mark.parametrize("n", [17, 50, 130])
@pytest.mark.parametrize("d", [128, 160])  # heads 64 and 80 wide
def test_tf32_route_emulation_matches_jax(pallas_interpret, d, n, want_attn,
                                          want_mean, attn_heads, fast):
    p, x = _block(d, n, seed=d + n + 3 * fast)
    kw = dict(want_attn=want_attn, want_mean=want_mean, fast_softmax=fast,
              attn_heads=attn_heads)
    want = _jax_headwise(p, x, kw, F32)
    tp, tx = from_jax(p), torch.from_numpy(x)
    got = headwise_emulated(tx, tp, HEADS, want_attn, want_mean, attn_heads,
                            fast, matmul_3xtf32,
                            tfb.HEADWISE_TF32_BLOCK_K[d // HEADS], 32)
    assert len(got) == len(want)
    assert all((g is None) == (w is None) for g, w in zip(got, want))
    assert got[0].dtype == F32 and got[0].shape == (2, n, d)
    assert _f32_use(got, want) <= 1.0
    # the plain version, which the kernel is held against on the card,
    # agrees with both
    ref = tfb.headwise_attn_block_reference(tx, tp, HEADS, 1e-6, **kw)
    assert _f32_use(ref, want) <= 0.1
    assert _f32_use(got, [r for r in ref]) <= 1.0


@pytest.mark.parametrize("d", [128, 160])
def test_tf32_bound_refuses_plain_tf32(pallas_interpret, d):
    """The same bound refuses the kernels' products in plain TF32 (one
    product of the rounded operands), maps off and maps + mean."""
    p, x = _block(d, 130, seed=d)
    tp, tx = from_jax(p), torch.from_numpy(x)
    for want_attn, want_mean, _ in MODES[:2]:
        kw = dict(want_attn=want_attn, want_mean=want_mean)
        want = _jax_headwise(p, x, kw, F32)
        plain = headwise_emulated(tx, tp, HEADS, want_attn, want_mean, None,
                                  True, matmul_tf32,
                                  tfb.HEADWISE_TF32_BLOCK_K[d // HEADS], 32)
        assert _f32_use(plain[:1], want[:1]) > 1.0


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("want_attn,want_mean,attn_heads", MODES)
@pytest.mark.parametrize("n", [17, 130])
@pytest.mark.parametrize("d", [128, 160])
def test_bf16_route_emulation_matches_jax(pallas_interpret, d, n, want_attn,
                                          want_mean, attn_heads, fast):
    """The bf16 route's cast points against the JAX kernel in bf16: p cast
    before PV when maps and mean are off, the probs cast once when on (the
    tap is that cast)."""
    p, x = _block(d, n, seed=d + n + 5 * fast)
    # the activations and parameters in bf16 on both sides
    p = {k: np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
         for k, v in p.items()}
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    kw = dict(want_attn=want_attn, want_mean=want_mean, fast_softmax=fast,
              attn_heads=attn_heads)
    want = _jax_headwise(p, x, kw, BF16)
    tp = {k: v.to(BF16) for k, v in from_jax(p).items()}
    tx = torch.from_numpy(x).to(BF16)
    got = headwise_emulated(tx, tp, HEADS, want_attn, want_mean, attn_heads,
                            fast, matmul_f32, tfb.HEADWISE_MMA_BLOCK_K, 64)
    assert all((g is None) == (w is None) for g, w in zip(got, want))
    assert all(g.dtype == BF16 for g in got if g is not None)
    assert _bf16_use(got, want) <= 1.0
    if want_attn and attn_heads is None:
        # the tap is the cast of the probs that fed PV: its rows sum to 1
        # within bf16's rounding
        assert float((got[1].float().sum(-1) - 1).abs().max()) <= 2.0 ** -7
    # a zeroed or halved tap or mean is refused by the same bounds
    for i in range(1, len(got)):
        if got[i] is None:
            continue
        for factor in (0.0, 0.5):
            bad = list(got)
            bad[i] = got[i] * factor
            assert _bf16_use(bad, want) > 1.0


# -- the C entries and the loaders ----------------------------------------------------

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
    ("headwise_attn_block_mma.cu", "ivt_headwise_attn_block_mma",
     tfb.HEADWISE_TC_ARGTYPES, ["x", "qkv", "proj_w", "proj_b", "o_ws"]),
    ("headwise_attn_block_tf32.cu", "ivt_headwise_attn_block_tf32x3",
     tfb.HEADWISE_TC_ARGTYPES, ["x", "qkv", "proj_w", "proj_b", "o_ws"]),
    ("headwise_attn_block.cu", "ivt_headwise_attn_block",
     tfb.HEADWISE_ARGTYPES, ["dtype", "x", "qkv", "proj_w", "proj_b"]),
])
def test_headwise_entry_matches_its_ctypes_signature(source, entry, argtypes,
                                                     first):
    """Each headwise C entry's parameters, read from its source, against
    the argtypes the wrapper binds: the same count and kinds in order."""
    kinds, names = _entry_kinds(source, entry)
    assert names[:len(first)] == first
    assert names[-1] == "stream"
    assert kinds == argtypes


@pytest.mark.parametrize("source,entry", [
    ("headwise_attn_block_mma.cu", "ivt_headwise_mma_dh"),
    ("headwise_attn_block_tf32.cu", "ivt_headwise_tf32_dh"),
    ("headwise_attn_block_tf32.cu", "ivt_headwise_tf32_block_k"),
])
def test_width_entries_take_one_int(source, entry):
    kinds, names = _entry_kinds(source, entry)
    assert kinds == [ctypes.c_int]


def _widths(dhs):
    return lambda i: dhs[i] if 0 <= i < len(dhs) else 0


@pytest.mark.parametrize("dhs,ok", [
    ((64, 80), True),
    ((64,), False),       # a library without the 80-wide instantiation
    ((80, 64), False),    # the order is part of the contract
    ((64, 80, 96), False),
    ((), False),
])
def test_headwise_dh_check_refuses_a_library_that_disagrees(dhs, ok):
    if ok:
        tfb.check_headwise_dhs(_widths(dhs), "csrc/headwise_attn_block_mma.cu")
        return
    with pytest.raises(RuntimeError, match="disagree"):
        tfb.check_headwise_dhs(_widths(dhs), "csrc/headwise_attn_block_mma.cu")


def test_sources_use_their_instructions():
    """The bf16 source takes mma.sync, ldmatrix and cp.async from
    ``mma_attention.cuh`` (templated on the head width), the f32 one the
    split from ``tf32_attention.cuh``; neither has its own asm; the FMA
    source stays on ``common.cuh`` alone."""
    def read(name):
        with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
            return f.read()

    mma, tf32 = (read("headwise_attn_block_mma.cu"),
                 read("headwise_attn_block_tf32.cu"))
    assert '#include "mma_attention.cuh"' in mma
    assert '#include "tf32_attention.cuh"' in tf32
    for src in (mma, tf32):
        assert "asm(" not in src and "asm volatile" not in src
        assert "launch_head_mean" in src  # the deterministic head-mean pass
    assert "mma_attention.cuh" not in read("headwise_attn_block.cu")
    header = read("mma_attention.cuh")
    assert "struct MmaDims" in header
    assert "ldmatrix rows conflict-free" in header


# -- the wrappers on the CPU ------------------------------------------------------


def _counts():
    return (tfb.headwise_attn_block.launches,
            tfb.headwise_attn_block_mma.launches,
            tfb.headwise_attn_block_tf32x3.launches)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [128, 160])
def test_route_wrappers_keep_the_plain_version_on_the_cpu(dtype, d):
    """CPU tensors run the plain version whatever the route would be on a
    card; no launch is counted."""
    p, x = _block(d, 17, seed=d)
    tp = {k: v.to(dtype) for k, v in from_jax(p).items()}
    tx = torch.from_numpy(x).to(dtype)
    before = _counts()
    kw = dict(want_attn=True, want_mean=True, attn_heads=(1,))
    ref = tfb.headwise_attn_block_reference(tx, tp, HEADS, **kw)
    for fn in (tfb.headwise_attn_block, tfb.headwise_attn_block_mma,
               tfb.headwise_attn_block_tf32x3):
        got = fn(tx, tp, HEADS, **kw)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert _counts() == before


@pytest.mark.parametrize("fn", ["headwise_attn_block_mma",
                                "headwise_attn_block_tf32x3"])
def test_route_wrappers_refuse_devices_they_have_no_path_for(fn):
    p, x = _block(128, 17, seed=1)
    with pytest.raises(ValueError):
        getattr(tfb, fn)(torch.from_numpy(x).to("meta"), from_jax(p), HEADS)
