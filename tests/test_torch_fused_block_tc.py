"""The whole-image attention block's (row 1's) tensor-core routes, on the
CPU: the route predicate and the dispatch around it, emulations of the
kernels' arithmetic held against the JAX package's Pallas
``fused_attn_block`` in interpret mode on shared inputs, the bounds'
refusal of emulations that get a step wrong, the C entries' ctypes
signatures and the instructions read from their sources, the loaders'
checks and the wrappers' CPU path:

* f32, ``csrc/fused_attn_block_tf32.cu``: every product as three TF32
  products of a hi / lo split (``cvt.rna`` rounding), the hi products and
  the correction terms summed apart over one short run and folded with
  round-to-nearest adds: LN1 + QKV and the projection over k-tiles of 32,
  a score over dh, PV over one key tile (``HEADWISE_TF32_BLOCK_K``);
* bf16, ``csrc/fused_attn_block_mma.cu``: the cast points. LN(x), qkv and
  the head outputs cast to bf16; maps and mean off for a head: p cast
  before PV, the f32 result times 1 / rowsum; a head tapped or meaned:
  probs = p / rowsum cast once, the tap and PV's operand; the f32 sums of
  the GEMMs over k-tiles of 64 and of PV over key tiles of 64;
* the s8 mode (``csrc/attn_block_s8.cuh``, either route): q and k
  quantized per row, si = q8 k8^T exact, s = si.f32 * (qs * scale) * ks in
  that order; with int8_pv the probs (or the unnormalised p) per row and v
  per column, oi = p8 v8 exact, o = oi.f32 * ps * vs (* r first where not
  normalised); else the PV product dense.

The kernels themselves run only on the card: their ``cuda``-marked tests
are in ``tests/test_torch_cuda_kernel.py``, and ``chip_smoke.py`` holds
them against the plain version at the served shapes.

Inputs and parameters are made with numpy from a seed and handed to both
packages; the JAX package runs its Pallas kernel in interpret mode,
unchanged. Widths d=128 and 192 (2 and 3 heads of 64), N = 11, 50 and 197,
B = 1 and 2; maps off, maps + mean, an attn_heads subset, and ToMe's
key_bias with want_metric.

Tolerances. f32: 1e-4 on y, the maps, the mean and the metric, the
contract's (the split's products are within ~2^-21 of the f32 ones). bf16:
``chip_smoke.py``'s bounds: y and the metric within 2^-6 of max(1, their
largest value), each probs and mean element within min(2^-7, 2^-5 of the
JAX value + 1e-6). The s8 mode: the integer stages (q8, k8, p8, v8 and the
s32 sums) exactly the plain version's on the same qkv, and so the f32
scores that the rescale makes of them, bit for bit; y within the s8
bounds of ``chip_smoke.py`` against the JAX kernel. The key metric: bit-
equal to the plain version's on the same qkv.
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
from interactive_vit_tpu_torch.ops import dispatch, quant
from interactive_vit_tpu_torch.ops import fused_block as tfb
from interactive_vit_tpu_torch.runtime import cuda_build

torch.set_num_threads(2)

F32 = torch.float32
BF16 = torch.bfloat16
F32_BOUND = 1e-4
BF16_Y_REL = 2.0 ** -6
BF16_P_REL, BF16_P_ABS, BF16_P_CAP = 2.0 ** -5, 1e-6, 2.0 ** -7
S8_P_REL, S8_P_CAP = 2.0 ** -4, 2.0 ** -5

# name -> the block's taps and ToMe's operands
MODES = {
    "maps_off": dict(),
    "maps_mean": dict(want_attn=True, want_mean=True),
    "subset": dict(want_attn=True, want_mean=True, attn_heads=(1,)),
    "tome": dict(want_attn=True, want_mean=True, key_bias=True,
                 want_metric=True),
}
# the refusal tests' other subset: head 2 of 3, at tap row 0
SUBSET_2 = dict(want_attn=True, want_mean=True, attn_heads=(2,))
# (d, n, b): 2 heads of 64 at N=11, 3 heads at N=50 (B=2) and N=197
SHAPES = [(128, 11, 1), (192, 50, 2), (192, 197, 1)]


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(jfb.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# -- the route and the dispatch ---------------------------------------------------

# (dtype, dh, byte addresses, element strides and offsets, route)
ROUTE_CASES = [
    # vit_b16: x and the six weights, rows of D=768, qkv rows of 3D
    (BF16, 64, (0, 1 << 20, 1 << 21, 1 << 22, 1 << 23, 1 << 24, 1 << 25),
     (768, 2304, 64), "mma"),
    (F32, 64, (0, 4096, 8192), (768, 2304, 64), "tf32"),
    # vit_t16 (D=192) and heads 80 wide (vit_h14@224, D=1280)
    (BF16, 64, (0, 512), (192, 576, 64), "mma"),
    (F32, 80, (0, 512), (1280, 3840, 80), "tf32"),
    (BF16, 80, (0, 512), (1280, 3840, 80), "mma"),
    # rows wider than the LN1 + QKV kernel's registers take
    (BF16, 64, (0, 512), (1536, 4608, 64), "fma"),
    # other head widths and dtypes keep the FMA kernel
    (BF16, 16, (0, 512), (64, 192, 16), "fma"),
    (F32, 96, (0, 512), (768, 2304, 96), "fma"),
    (torch.float16, 64, (0, 512), (768, 2304, 64), "fma"),
    # an operand off the 16-byte grid: x, ln1_b, qkv_b
    (BF16, 64, (2, 512, 1024), (768, 2304, 64), "fma"),
    (F32, 64, (0, 520, 1024), (768, 2304, 64), "fma"),
    (BF16, 64, (0, 512, 1032), (768, 2304, 64), "fma"),
    # 80 wide over three heads: D=240, rows of 480 / 960 bytes
    (BF16, 80, (0, 512), (240, 720, 80), "mma"),
]


@pytest.mark.parametrize("dtype,dh,addrs,strides,route", ROUTE_CASES)
def test_block_route_by_dtype_width_and_alignment(dtype, dh, addrs, strides,
                                                  route):
    assert tfb.block_route(dtype, dh, addrs, strides) == route


def _operands(b, n, d, dtype, offsets=None):
    """x [B, N, D] and a block's parameters as contiguous CPU tensors, each
    starting ``offsets[name]`` elements into its storage."""
    offsets = offsets or {}

    def at(name, shape):
        size, off = int(np.prod(shape)), offsets.get(name, 0)
        return torch.zeros(size + off, dtype=dtype)[off:].view(shape)

    p = {k: at(k, s) for k, s in (("ln1_s", (d,)), ("ln1_b", (d,)),
                                  ("qkv_w", (d, 3 * d)), ("qkv_b", (3 * d,)),
                                  ("proj_w", (d, d)), ("proj_b", (d,)))}
    return at("x", (b, n, d)), p


@pytest.mark.parametrize("dtype,d,heads,offsets,route", [
    (BF16, 768, 12, {}, "mma"),        # vit_b16's block
    (F32, 768, 12, {}, "tf32"),
    (BF16, 192, 3, {}, "mma"),         # vit_t16's
    (F32, 1280, 16, {}, "tf32"),       # vit_h14@224's, heads 80 wide
    (BF16, 768, 12, {"x": 1}, "fma"),  # x 2 bytes off the grid
    (F32, 768, 12, {"x": 2}, "fma"),   # 8 bytes off
    (F32, 768, 12, {"x": 4}, "tf32"),  # 16 bytes off: on the grid
    (BF16, 768, 12, {"ln1_s": 3}, "fma"),
    (BF16, 768, 12, {"qkv_w": 1}, "fma"),
    (F32, 768, 12, {"qkv_b": 1}, "fma"),
    (BF16, 768, 12, {"proj_b": 4}, "fma"),
    (BF16, 64, 4, {}, "fma"),          # heads 16 wide
])
def test_route_of_a_blocks_operands(dtype, d, heads, offsets, route):
    """The pointers and strides the wrapper hands the predicate: x and the
    six weights, rows of D, the qkv workspace (rows of 3D)."""
    x, p = _operands(1, 3, d, dtype, offsets)
    assert tfb._block_route_of(x, p, heads) == route


# (policy, dtype, n, d, heads, device) -> the parent's choice
DISPATCH_CASES = [
    ("auto", BF16, 197, 768, 12, "cuda", "fused_attn_block"),
    ("auto", F32, 197, 192, 3, "cuda", "fused_attn_block"),
    ("auto", BF16, 257, 192, 3, "cuda", "fused_attn_block"),
    ("auto", BF16, 257, 1280, 16, "cuda", "fused_attn_block"),
    ("auto", BF16, 341, 768, 12, "cuda", "fused_attn_block"),
    ("auto", BF16, 342, 768, 12, "cuda", "headwise_attn_block"),
    ("auto", BF16, 577, 1024, 16, "cuda", "headwise_attn_block"),
    ("auto", F32, 2810, 1280, 16, "cuda", "headwise_attn_block"),
    ("auto", BF16, 197, 768, 12, "cpu", None),
    ("auto", torch.float16, 197, 768, 12, "cuda", None),
    ("fused", BF16, 0, 0, 0, None, "fused_attn_block"),
    ("headwise", BF16, 0, 0, 0, None, "headwise_attn_block"),
    ("none", BF16, 197, 768, 12, "cuda", None),
]


@pytest.mark.parametrize("policy,dtype,n,d,heads,device,want", DISPATCH_CASES)
def test_dispatch_decisions_are_the_parents(policy, dtype, n, d, heads,
                                            device, want):
    """Rows 1 and 2 are chosen as before, by ``fits`` / ``fits_headwise``;
    the route inside the row-1 wrapper changes nothing there."""
    got = dispatch.default_block_impl(policy, dtype, n, d, heads, device)
    assert (None if got is None else got.__name__) == want


@pytest.mark.parametrize("policy,int8_pv", [("int8-scores", True),
                                            ("int8-scores-qk", False)])
def test_s8_dispatch_is_the_parents(policy, int8_pv):
    got = dispatch.default_block_impl(policy, BF16, 197, 768, 12, "cuda")
    assert got.func is tfb.fused_attn_block_s8
    assert got.keywords == {"int8_pv": int8_pv}
    with pytest.raises(ValueError):  # beyond the s8 envelope
        dispatch.default_block_impl(policy, BF16, 269, 768, 12, "cuda")


@pytest.mark.parametrize("n,d,heads,s8,fits", [
    (341, 768, 12, False, True), (342, 768, 12, False, False),
    (268, 768, 12, True, True), (269, 768, 12, True, False),
    (257, 1280, 16, False, True), (257, 1280, 16, True, False),
    (222, 160, 2, True, True), (223, 160, 2, True, False),
])
def test_envelope_is_the_parents(n, d, heads, s8, fits):
    assert tfb.fits(n, d, heads, int8_scores=s8) == fits


@pytest.mark.parametrize("dh", tfb.ROW1_TC_DHS)
@pytest.mark.parametrize("esize", [2, 4])
def test_every_block_in_the_envelope_fits_the_tensor_core_kernels(dh, esize):
    """Each N that ``fits`` admits in the s8 mode fits the s8 attention's
    shared memory, and every row width the routes take fits the LN1 + QKV
    kernel's (the panel of 64 rows in bf16, 32 in f32)."""
    limit = 232448
    n_max = max(n for n in range(1, 512)
                if tfb.fits(n, 2 * dh, 2, int8_scores=True))
    assert all(tfb.row1_s8_smem_bytes(n, dh, esize) <= limit
               for n in range(1, n_max + 1))
    bm = 64 if esize == 2 else 32
    assert tfb.row1_qkv_smem_bytes(tfb.ROW1_TC_MAX_WIDTH, esize, bm) <= limit


# -- the emulations -----------------------------------------------------------------


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero (``cvt.rna``)."""
    bits = x.to(F32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(F32)


def matmul_3xtf32(a, b):
    """a @ b as the kernels take it: the correction terms, then the hi
    product, on the split operands."""
    ah = tf32_rna(a)
    al = tf32_rna(a - ah)
    bh = tf32_rna(b)
    bl = tf32_rna(b - bh)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def matmul_f32(a, b):
    return torch.matmul(a.float(), b.float())


def _tiled(matmul, a, b, tile):
    """a @ b with the contracted dim in runs of ``tile``, each run's sum
    added to the running sum in order."""
    acc = None
    for k0 in range(0, a.shape[-1], tile):
        part = matmul(a[..., k0:k0 + tile], b[..., k0:k0 + tile, :])
        acc = part if acc is None else acc + part
    return acc


def _ln(x, p, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    z = (xf - mu) * torch.rsqrt(var + eps)
    return (z * p["ln1_s"].float() + p["ln1_b"].float()).to(x.dtype)


def emulate(x, p, heads, route, want_attn=False, want_mean=False,
            fast_softmax=True, attn_heads=None, key_bias=None,
            want_metric=False, int8_scores=False, int8_pv=True, qkv=None,
            eps=1e-6, wrong=None):
    """A route's arithmetic on CPU tensors of the activation dtype; returns
    the wrapper's outputs and, in the s8 mode, the integer stages and the
    rescaled scores. ``qkv``: the qkv to start from (LN1 + QKV skipped).
    ``wrong``: a step taken wrongly, for the refusal tests: "no_bias",
    "all_heads" (every head tapped), "tap_rows" (the subset's heads at
    their own rows), "rescale" (si.f32 * (qs * ks) * scale)."""
    dt = x.dtype
    b, n, d = x.shape
    dh = d // heads
    mm = matmul_f32 if route == "mma" else matmul_3xtf32
    gemm_tile = 64 if route == "mma" else 32
    pv_tile = (tfb.HEADWISE_MMA_BLOCK_K if route == "mma"
               else tfb.HEADWISE_TF32_BLOCK_K[dh])
    emit = tfb._emit_heads(heads, want_attn, attn_heads)
    if qkv is None:
        qkv = (_tiled(mm, _ln(x, p, eps).float(), p["qkv_w"].float(),
                      gemm_tile) + p["qkv_b"].float()).to(dt)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, dh)
               .transpose(1, 2).float() for i in range(3))
    scale = dh ** -0.5
    parts = {}
    if int8_scores:
        q8, qs = quant.quant_rows_mosaic(q)
        k8, ks = quant.quant_rows_mosaic(k)
        si = quant.int_matmul(q8, k8.transpose(-1, -2))
        if wrong == "rescale":
            s = si.float() * (qs * ks.transpose(-1, -2)) * scale
        else:
            s = si.float() * (qs * scale) * ks.transpose(-1, -2)
        parts.update(q8=q8, k8=k8, si=si)
    else:
        s = mm(q, k.transpose(-1, -2)) * scale
    if key_bias is not None and wrong != "no_bias":
        s = s + key_bias.float()[:, None, None, :]
    parts["s"] = s
    if fast_softmax:
        pe = torch.exp(torch.clamp(s, max=tfb.SOFTMAX_CLAMP))
    else:
        pe = torch.exp(s - s.amax(dim=-1, keepdim=True))
    r = 1.0 / pe.sum(dim=-1, keepdim=True)
    probs = pe * r
    tapped = (range(heads) if emit is None or wrong == "all_heads"
              else emit) if want_attn else ()
    norm = torch.zeros(heads, dtype=torch.bool)
    norm[list(range(heads)) if want_mean else list(tapped)] = True
    norm = norm[None, :, None, None]
    if int8_scores and int8_pv:
        v8, vs = quant.quant_cols_mosaic(v)
        p8n, psn = quant.quant_rows_mosaic(probs)
        p8r, psr = quant.quant_rows_mosaic(pe)
        p8 = torch.where(norm, p8n, p8r)
        oi = quant.int_matmul(p8, v8)
        o = torch.where(norm, oi.float() * psn * vs,
                        oi.float() * (psr * r) * vs)
        parts.update(v8=v8, p8=p8, oi=oi)
    else:
        pa = torch.where(norm, probs.to(dt).float(), pe.to(dt).float())
        o = _tiled(mm, pa, v, pv_tile)
        o = torch.where(norm, o, o * r)
    o = o.transpose(1, 2).reshape(b, n, d).to(dt)
    y = ((x.float() + _tiled(mm, o.float(), p["proj_w"].float(), gemm_tile))
         + p["proj_b"].float()).to(dt)
    out = [y, None]
    if want_attn:
        rows = list(tapped)
        tap = probs[:, rows].to(dt)
        if wrong == "tap_rows" and emit is not None:
            tap = probs[:, list(range(len(rows)))].to(dt)
        out[1] = tap
    if want_mean:
        out.append(tfb._head_mean(probs, heads).to(dt))
    if want_metric:
        out.append(tfb._head_mean(k, heads))
    return tuple(out), parts


def _block(d, n, b, seed):
    """A block's parameters (non-trivial LN and biases), an input batch and
    a ToMe key bias (the log of token sizes 1..16), as numpy f32."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (rng.standard_normal(shape) * std + mean).astype(np.float32)

    p = {"ln1_s": rnd(d, std=0.1, mean=1.0), "ln1_b": rnd(d, std=0.1),
         "qkv_w": rnd(d, 3 * d, std=d ** -0.5), "qkv_b": rnd(3 * d, std=0.1),
         "proj_w": rnd(d, d, std=d ** -0.5), "proj_b": rnd(d, std=0.1)}
    kb = np.log(rng.integers(1, 17, (b, n))).astype(np.float32)
    return p, rnd(b, n, d), kb


_JAX_CACHE = {}


def _case(d, n, b, dtype, mode, s8=False, int8_pv=True):
    """(torch x, params, the wrapper's keywords, the JAX kernel's outputs
    as f32 torch tensors) for a shape, dtype and mode; the JAX results are
    computed once a case."""
    p, x, kb = _block(d, n, b, seed=d + n + b)
    if dtype == BF16:  # the same bf16 values on both sides
        p = {k: np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
             for k, v in p.items()}
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    kw = dict(SUBSET_2 if mode == "subset_2" else MODES[mode])
    key = (d, n, b, str(dtype), mode, s8, int8_pv)
    if key not in _JAX_CACHE:
        jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
        jkw = dict(kw, key_bias=jnp.asarray(kb) if kw.get("key_bias")
                   else None)
        if s8:
            jkw.update(int8_scores=True, int8_pv=int8_pv)
        out = jfb.fused_attn_block(
            jnp.asarray(x, jdt), jax.tree.map(lambda a: jnp.asarray(a, jdt), p),
            d // 64, 1e-6, **jkw)
        _JAX_CACHE[key] = [None if o is None else torch.from_numpy(
            np.array(o.astype(jnp.float32))) for o in out]
    tp = {k: v.to(dtype) for k, v in from_jax(p).items()}
    tkw = dict(kw, key_bias=torch.from_numpy(kb) if kw.get("key_bias")
               else None)
    return torch.from_numpy(x).to(dtype), tp, tkw, _JAX_CACHE[key]


def _use(got, want, dtype, s8=False, metric=False):
    """The largest share of its bound any output of ``got`` takes against
    ``want`` (inf where a shape differs); the metric (the last output when
    ``metric``) is bound as y is."""
    uses = []
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        if tuple(g.shape) != tuple(w.shape):
            return float("inf")
        diff = (g.float() - w).abs()
        kind = 0 if metric and i == len(want) - 1 else i
        if s8 and kind > 0:
            bound = (S8_P_REL * w.abs() + BF16_P_ABS).clamp(max=S8_P_CAP)
        elif dtype == F32 and not s8:
            bound = F32_BOUND
        elif kind == 0:
            bound = BF16_Y_REL * max(1.0, float(w.abs().max()))
        else:
            bound = (BF16_P_REL * w.abs() + BF16_P_ABS).clamp(max=BF16_P_CAP)
        uses.append(float((diff / bound).max()))
    return max(uses)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("d,n,b", SHAPES)
def test_tf32_route_emulation_matches_jax(d, n, b, mode):
    x, p, kw, want = _case(d, n, b, F32, mode)
    got, _ = emulate(x, p, d // 64, "tf32", **kw)
    assert len(got) == len(want)
    assert got[0].dtype == F32 and got[0].shape == (b, n, d)
    assert _use(got, want, F32, metric=mode == "tome") <= 1.0
    # the plain version, which the kernel is held against on the card,
    # agrees with it too
    ref = tfb.fused_attn_block_reference(x, p, d // 64, 1e-6, **kw)
    assert _use(got, [r.float() if r is not None else None for r in ref],
                F32, metric=mode == "tome") <= 1.0


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("d,n,b", SHAPES)
def test_bf16_route_emulation_matches_jax(d, n, b, mode):
    x, p, kw, want = _case(d, n, b, BF16, mode)
    got, _ = emulate(x, p, d // 64, "mma", **kw)
    assert all(g.dtype == BF16 for g in got[:3] if g is not None)
    assert _use(got, want, BF16, metric=mode == "tome") <= 1.0
    if kw.get("want_attn") and kw.get("attn_heads") is None:
        # the tap is the cast of the probs that fed PV: rows sum to 1
        assert float((got[1].float().sum(-1) - 1).abs().max()) <= 2.0 ** -7


@pytest.mark.parametrize("dtype,route", [(F32, "tf32"), (BF16, "mma")])
@pytest.mark.parametrize("mode,wrong", [("tome", "no_bias"),
                                        ("subset", "all_heads"),
                                        ("subset_2", "tap_rows")])
def test_bounds_refuse_a_wrong_step(dtype, route, mode, wrong):
    """The same bounds refuse an emulation that drops the key bias, taps
    every head where a subset was asked for, or writes a subset's head
    where its own index would put it (head 2 of 3 belongs in tap row 0)."""
    x, p, kw, want = _case(192, 50, 2, dtype, mode)
    metric = mode == "tome"
    good, _ = emulate(x, p, 3, route, **kw)
    assert _use(good, want, dtype, metric=metric) <= 1.0
    bad, _ = emulate(x, p, 3, route, wrong=wrong, **kw)
    assert _use(bad, want, dtype, metric=metric) > 1.0


@pytest.mark.parametrize("dtype,route", [(F32, "tf32"), (BF16, "mma")])
@pytest.mark.parametrize("mode,int8_pv", [("maps_off", True),
                                          ("maps_mean", True),
                                          ("subset", True), ("tome", True),
                                          ("maps_mean", False)])
def test_s8_emulation_integer_stages_match_the_plain_version(dtype, route,
                                                             mode, int8_pv):
    """On the plain version's qkv the emulated s8 kernel's integer stages
    and rescaled scores are the plain version's exactly (the s32 sums are
    exact), and its outputs agree with the JAX kernel's s8 mode within the
    s8 bounds (where an f32 value lands across a .5 boundary an int8
    flips)."""
    d, n, b = 192, 197, 1
    x, p, kw, want = _case(d, n, b, dtype, mode, s8=True, int8_pv=int8_pv)
    heads = d // 64
    qkv = tfb._ln_qkv(x, p, 1e-6)
    got, parts = emulate(x, p, heads, route, int8_scores=True,
                         int8_pv=int8_pv, qkv=qkv, **kw)
    plain = _plain_s8_stages(qkv, heads, kw, int8_pv)
    assert set(parts) == set(plain)
    for k in plain:
        assert torch.equal(parts[k], plain[k]), k
    assert _use(got, want, dtype, s8=True, metric=mode == "tome") <= 1.0
    if mode == "maps_mean" and int8_pv:
        # the other rescale order moves some scores by a rounding, which
        # the bit-exact check refuses
        _, bad = emulate(x, p, heads, route, int8_scores=True, qkv=qkv,
                         wrong="rescale", **kw)
        assert not torch.equal(bad["s"], plain["s"])


def _plain_s8_stages(qkv, heads, kw, int8_pv):
    """The plain version's s8 stages (``fused_attn_block_reference``'s
    steps, written out) on ``qkv``."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, d // heads)
               .transpose(1, 2).float() for i in range(3))
    q8, qs = quant.quant_rows_mosaic(q)
    k8, ks = quant.quant_rows_mosaic(k)
    si = quant.int_matmul(q8, k8.transpose(-1, -2))
    s = si.float() * (qs * (d // heads) ** -0.5) * ks.transpose(-1, -2)
    if kw.get("key_bias") is not None:
        s = s + kw["key_bias"].float()[:, None, None, :]
    out = dict(q8=q8, k8=k8, si=si, s=s)
    if int8_pv:
        pe = torch.exp(torch.clamp(s, max=tfb.SOFTMAX_CLAMP))
        probs = pe * (1.0 / pe.sum(dim=-1, keepdim=True))
        v8, _ = quant.quant_cols_mosaic(v)
        tapped = kw.get("want_attn") or kw.get("want_mean")
        norm = torch.zeros(heads, dtype=torch.bool)
        if kw.get("want_mean") or (kw.get("want_attn")
                                   and kw.get("attn_heads") is None):
            norm[:] = True
        elif tapped:
            norm[list(kw["attn_heads"])] = True
        p8 = torch.where(norm[None, :, None, None],
                         quant.quant_rows_mosaic(probs)[0],
                         quant.quant_rows_mosaic(pe)[0])
        out.update(v8=v8, p8=p8, oi=quant.int_matmul(p8, v8))
    return out


@pytest.mark.parametrize("dtype,route", [(F32, "tf32"), (BF16, "mma")])
def test_metric_is_bit_equal_on_the_same_qkv(dtype, route):
    x, p, kw, _ = _case(192, 50, 2, dtype, "tome")
    qkv = tfb._ln_qkv(x, p, 1e-6)
    got, _ = emulate(x, p, 3, route, qkv=qkv, **kw)
    # the plain version's metric on its own qkv (the same qkv)
    ref = tfb.fused_attn_block_reference(x, p, 3, 1e-6, **kw)
    assert torch.equal(got[-1], ref[-1])


# -- the C entries, the instructions, the loaders ------------------------------------

_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "unsigned long long": ctypes.c_ulonglong}


def _read(name):
    with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
        return f.read()


def _entry_kinds(source: str, entry: str):
    params = re.search(r"\b(?:int|size_t) " + entry + r"\(([^)]*)\)",
                       _read(source)).group(1)
    kinds, names = [], []
    for decl in (" ".join(p.split()) for p in params.split(",") if p.strip()):
        ctype = decl.rsplit(" ", 1)[0].replace("const ", "")
        kinds.append(ctypes.c_void_p if "*" in decl else _C_TYPES[ctype])
        names.append(decl.split()[-1].lstrip("*"))
    return kinds, names


@pytest.mark.parametrize("source,entry", [
    ("fused_attn_block_mma.cu", "ivt_fused_attn_block_mma"),
    ("fused_attn_block_tf32.cu", "ivt_fused_attn_block_tf32x3"),
])
def test_tc_entry_matches_its_ctypes_signature(source, entry):
    """Each tensor-core C entry's parameters, read from its source, against
    the argtypes the wrapper binds: the FMA entry's without the dtype, and
    the s8 parts before the stream."""
    kinds, names = _entry_kinds(source, entry)
    assert kinds == tfb.TC_ENTRY_ARGTYPES
    assert names[:3] == ["x", "ln_s", "ln_b"]
    assert names[-2:] == ["s8_parts", "stream"]
    fma_kinds, fma_names = _entry_kinds("fused_attn_block.cu",
                                        "ivt_fused_attn_block")
    assert fma_kinds == tfb.ENTRY_ARGTYPES
    assert names[:-2] == fma_names[1:-1]


@pytest.mark.parametrize("source,entry,args", [
    ("fused_attn_block_mma.cu", "ivt_fused_block_mma_dh", [ctypes.c_int]),
    ("fused_attn_block_mma.cu", "ivt_fused_block_mma_max_width", []),
    ("fused_attn_block_mma.cu", "ivt_fused_block_mma_qkv_rows",
     [ctypes.c_int]),
    ("fused_attn_block_mma.cu", "ivt_fused_block_mma_qkv_smem",
     [ctypes.c_int, ctypes.c_int]),
    ("fused_attn_block_mma.cu", "ivt_fused_block_mma_s8_smem",
     [ctypes.c_int, ctypes.c_int]),
    ("fused_attn_block_tf32.cu", "ivt_fused_block_tf32_dh", [ctypes.c_int]),
    ("fused_attn_block_tf32.cu", "ivt_fused_block_tf32_max_width", []),
    ("fused_attn_block_tf32.cu", "ivt_fused_block_tf32_qkv_smem",
     [ctypes.c_int]),
    ("fused_attn_block_tf32.cu", "ivt_fused_block_tf32_s8_smem",
     [ctypes.c_int, ctypes.c_int]),
])
def test_shape_entries_take_ints(source, entry, args):
    assert _entry_kinds(source, entry)[0] == args


def test_sources_use_their_instructions():
    """bf16: mma.sync m16n8k16 (mma_attention.cuh) for LN1 + QKV, the
    attention and the projection; f32: the split's m16n8k8 tf32
    (tf32_attention.cuh); both: the s8 attention on m16n8k32 s8
    (attn_block_s8.cuh, mma_s8 of mlp_cluster.cuh), LN1 by mc_ln_row, the
    key metric and the head-mean passes of common.cuh. Row 2 shares its
    attention and projection through the two block headers, and row 5
    the QKV kernel and the projection, so the products sit in the headers
    each source includes; no source holds asm of its own, and the FMA
    source keeps __dp4a."""
    mma = _read("fused_attn_block_mma.cu")
    tf32 = _read("fused_attn_block_tf32.cu")
    mma_h, tf32_h = _read("attn_block_mma.cuh"), _read("attn_block_tf32.cuh")
    s8 = _read("attn_block_s8.cuh")
    assert ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"
            in _read("mma_attention.cuh"))
    assert ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"
            in _read("tf32_attention.cuh"))
    assert ("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32"
            in _read("mlp_cluster.cuh"))
    assert '#include "attn_block_mma.cuh"' in mma
    assert '#include "attn_block_tf32.cuh"' in tf32
    # LN1 + QKV and the projection: the headers' kernels on mma.sync
    assert "launch_qkv_bm<" in mma and "proj_mma_kernel<<<" in mma
    assert "launch_qkv_tf32(" in tf32 and "proj_tf32_kernel<<<" in tf32
    for kernel in ("row1_qkv_mma_kernel(", "proj_mma_kernel("):
        body = mma_h[mma_h.index(kernel):]
        assert "mma_bf16(" in body[:body.index("\n}\n")]
    for kernel in ("row1_qkv_tf32_kernel(", "proj_tf32_kernel("):
        body = tf32_h[tf32_h.index(kernel):]
        assert ("mma_3xtf32(" in body[:body.index("\n}\n")]
                or "mma_tf32(" in body[:body.index("\n}\n")])
    for src in (mma, tf32):
        assert '#include "attn_block_s8.cuh"' in src
        assert "mc_ln_row<" in src and "launch_key_mean<" in src
        assert "launch_head_mean<" in src and "attend_head<" in src
        assert "asm(" not in src and "asm volatile" not in src
        assert "__dp4a(" not in src
    assert "mma_s8(" in s8 and "__dp4a(" not in s8
    assert "mma_bf16(" in s8 and "mma_3xtf32(" in s8  # the dense PV
    for name, header in (("headwise_attn_block_mma.cu", "attn_block_mma.cuh"),
                         ("headwise_attn_block_tf32.cu",
                          "attn_block_tf32.cuh")):
        assert f'#include "{header}"' in _read(name)
        assert "void attend_head(" in _read(header)
    assert "__dp4a(" in _read("fused_attn_block.cu")


class _FakeLib:
    """A library's shape entries from tables, for the loader check."""

    def __init__(self, route, dhs=tfb.ROW1_TC_DHS,
                 width=tfb.ROW1_TC_MAX_WIDTH, s8_extra=0, qkv_extra=0):
        pre = tfb._ROW1_TC[route][2]
        esize = 2 if route == "mma" else 4
        setattr(self, pre + "dh",
                lambda i: dhs[i] if 0 <= i < len(dhs) else 0)
        setattr(self, pre + "max_width", lambda: width)
        setattr(self, pre + "s8_smem", lambda n, dh: tfb.row1_s8_smem_bytes(
            n, dh, esize) + s8_extra)
        self.ivt_fused_block_mma_qkv_rows = lambda m: 32 if m <= 512 else 64
        self.ivt_fused_block_mma_qkv_smem = (
            lambda d, bm: tfb.row1_qkv_smem_bytes(d, 2, bm) + qkv_extra)
        self.ivt_fused_block_tf32_qkv_smem = (
            lambda d: tfb.row1_qkv_smem_bytes(d, 4, 32) + qkv_extra)


@pytest.mark.parametrize("route", ["mma", "tf32"])
@pytest.mark.parametrize("fault,ok", [
    ({}, True),
    ({"dhs": (64,)}, False),          # a library without the 80-wide kernels
    ({"dhs": (80, 64)}, False),       # the order is part of the contract
    ({"width": 1024}, False),
    ({"s8_extra": 16}, False),        # another s8 layout
    ({"qkv_extra": 16}, False),       # another LN1 + QKV panel or ring
])
def test_loader_refuses_a_library_that_disagrees(route, fault, ok):
    lib = _FakeLib(route, **fault)
    if ok:
        tfb.check_row1_library(lib, route)
        return
    with pytest.raises(RuntimeError, match="disagree"):
        tfb.check_row1_library(lib, route)


# -- the wrappers on the CPU ------------------------------------------------------

_WRAPPERS = ("fused_attn_block", "fused_attn_block_mma",
             "fused_attn_block_tf32x3", "fused_attn_block_s8",
             "fused_attn_block_s8_mma", "fused_attn_block_s8_tf32x3")


def _counts():
    return tuple((getattr(tfb, n).launches,
                  getattr(getattr(tfb, n), "tome_launches", 0))
                 for n in _WRAPPERS)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_route_wrappers_keep_the_plain_version_on_the_cpu(dtype):
    """CPU tensors run the plain version whatever the route would be on a
    card; no launch is counted."""
    p, x, kb = _block(128, 17, 1, seed=5)
    tp = {k: v.to(dtype) for k, v in from_jax(p).items()}
    tx = torch.from_numpy(x).to(dtype)
    kw = dict(want_attn=True, want_mean=True, attn_heads=(1,),
              key_bias=torch.from_numpy(kb), want_metric=True)
    before = _counts()
    for s8 in (False, True):
        ref = tfb.fused_attn_block_reference(tx, tp, 2, 1e-6,
                                             int8_scores=s8, **kw)
        names = _WRAPPERS[3:] if s8 else _WRAPPERS[:3]
        for name in names:
            got = getattr(tfb, name)(tx, tp, 2, 1e-6, **kw)
            assert all((g is None and r is None) or torch.equal(g, r)
                       for g, r in zip(got, ref)), name
    assert _counts() == before


@pytest.mark.parametrize("name", _WRAPPERS[1:3] + _WRAPPERS[4:])
def test_route_wrappers_refuse_devices_they_have_no_path_for(name):
    p, x, _ = _block(128, 17, 1, seed=1)
    with pytest.raises(ValueError):
        getattr(tfb, name)(torch.from_numpy(x).to("meta"), from_jax(p), 2)


@pytest.mark.parametrize("route", ["fma", "mma", "tf32"])
@pytest.mark.parametrize("s8", [False, True])
def test_each_launch_is_counted_once_in_its_routes_wrapper(monkeypatch,
                                                           route, s8):
    """With the launch stubbed and x taken for a card's: the dispatching
    wrapper (and, off "fma", the route's own wrapper) launches once in the
    mode asked for and moves only the count of that route and mode, its
    ``tome_launches`` with ToMe's operands; a route's own wrapper refuses
    operands that ``block_route`` sends elsewhere."""
    calls = []

    def launch(rt, x, p, heads, eps, int8_mode, **kw):
        calls.append((rt, int8_mode))
        # the launch's result: y, probs | None, then mean and metric
        return (torch.empty_like(x), None) + tuple(
            torch.empty(0) for k in ("want_mean", "want_metric") if kw[k])

    monkeypatch.setattr(tfb, "_on_device", lambda x, name: True)
    monkeypatch.setattr(tfb, "_block_route_of", lambda x, p, heads: route)
    monkeypatch.setattr(tfb, "_launch_block", launch)
    p, x, kb = _block(128, 17, 1, seed=3)
    tp, tx = from_jax(p), torch.from_numpy(x)
    tome = dict(key_bias=torch.from_numpy(kb), want_metric=True)
    dispatch_fn = tfb.fused_attn_block_s8 if s8 else tfb.fused_attn_block
    own = tfb._ROW1_WRAPPERS[route, s8]
    fns = [dispatch_fn] + ([own] if route != "fma" else [])
    for fn in fns:
        for kw, tome_step in (({}, 0), (tome, 1)):
            for int8_pv in ((True, False) if s8 else (True,)):
                before = _counts()
                extra = {"int8_pv": int8_pv} if s8 else {}
                fn(tx, tp, 2, 1e-6, **kw, **extra)
                want = [list(c) for c in before]
                i = _WRAPPERS.index(own.__name__)
                want[i][0] += 1
                want[i][1] += tome_step
                assert _counts() == tuple(map(tuple, want))
                mode = (2 if int8_pv else 1) if s8 else 0
                assert calls.pop() == (route, mode)
    assert not calls
    for other in {"fma", "mma", "tf32"} - {route, "fma"}:
        with pytest.raises(ValueError):
            tfb._ROW1_WRAPPERS[other, s8](tx, tp, 2, 1e-6)
    if not s8 and route != "fma":
        with pytest.raises(TypeError):  # the dense wrappers take no int8_pv
            own(tx, tp, 2, 1e-6, int8_pv=False)
