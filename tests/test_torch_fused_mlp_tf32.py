"""Row 6's routes off the FMA kernel (the fused MLP branch), on the CPU:

* f32 on split TF32, ``csrc/fused_mlp_block_tf32.cu``: both products on
  mma.sync m16n8k8 TF32 as three products a product (hi = cvt.rna.tf32(v),
  lo = cvt.rna.tf32(v - hi); a_hi b_hi summed apart from a_lo b_hi + a_hi
  b_lo over each 32-deep weight stage, the two folded into the running sum
  with round-to-nearest adds), on the cluster split of ``mlp_cluster.cuh``;
* bf16 at chunks of 96 (``mlp_mma96_kernel`` of
  ``csrc/fused_mlp_block_mma.cu``): rows a multiple of 96 but not of 128,
  swin_t's stages 0 and 1 (d = 96 and 192, hidden 384 and 768: clusters of
  4 and 8 whose slice is one chunk).

Covered: the route predicate, the chunk, cluster, shared-memory and
row-tile arithmetic at both chunk widths, the numbers the sources hold,
the instructions the new source uses, and emulations of both routes'
arithmetic in the kernels' order held against the JAX package's Pallas
kernel in interpret mode on shared numpy-seeded inputs. The kernels run
only on the card: their ``cuda``-marked tests are in
``tests/test_torch_cuda_kernel.py``, and ``chip_smoke.py`` holds them
against the plain version at the main paths' shapes.

Tolerances: f32 within 1e-5 of the Pallas kernel's y (the row-6 tests'
bound: only the order of f32 sums and the split's ~2^-21 relative error
differ); bf16 within 2^-6 of y's scale (``chip_smoke.py``'s bound). The
same bounds refuse an emulation that takes one TF32 product a product (no
split) and one that drops a cluster rank's fc2 partial.
"""

import functools
import os
import re
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from interactive_vit_tpu.ops import fused_mlp as jfm
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import fused_mlp as fm
from interactive_vit_tpu_torch.ops.tiled_attention import SMEM_LIMIT
from interactive_vit_tpu_torch.runtime import cuda_build

torch.set_num_threads(2)

F32 = torch.float32
BF16 = torch.bfloat16
ATOL = 1e-5
BF16_Y_REL = 2.0 ** -6
# (d, mlp_dim): chunks of 96 (clusters of 4 and 8) and of 128 (the same)
WIDTHS = [(96, 384), (192, 768), (128, 512), (256, 1024)]


@pytest.fixture
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(jfm.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _read(name):
    with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
        return f.read()


# -- the arithmetic of the routes ---------------------------------------------------


@pytest.mark.parametrize("d,chunk", [
    (768, 128), (384, 128), (1280, 128), (96, 96), (192, 96), (288, 96),
    (480, 96), (1152, 128), (160, 0), (64, 0), (0, 0), (1408, 0),
    (1344, 0)])
def test_chunk_of(d, chunk):
    """128 where it divides the row, else 96 (swin_t's 96 and 192), up to
    1280 wide."""
    assert fm.chunk_of(d) == chunk


@pytest.mark.parametrize("md,chunk,s", [
    (384, 96, 4), (768, 96, 8), (1536, 96, 8), (1152, 96, 4), (288, 96, 0),
    (192, 96, 0), (512, 96, 0), (384, 128, 0), (3072, 128, 8)])
def test_cluster_size_by_chunk(md, chunk, s):
    """Hidden 384 is four chunks of 96, 768 eight: clusters of 4 and 8 as at
    128; three chunks (288) or a hidden dimension off the chunk is refused."""
    assert fm.cluster_size(md, chunk) == s


@pytest.mark.parametrize("d,md,s", [
    (96, 384, 4), (192, 768, 8), (384, 1536, 4), (768, 3072, 8),
    (96, 288, 0), (160, 640, 0), (128, 384, 0)])
def test_cluster_of(d, md, s):
    assert fm.cluster_of(d, md) == s


@pytest.mark.parametrize("d,md,bm,smem", [
    (768, 3072, 16, 200192), (768, 3072, 32, 200192),
    (768, 3072, 64, 349696),
    (384, 1536, 16, 151040), (384, 1536, 32, 151040),
    (384, 1536, 64, 251392),
    (96, 384, 32, 77312), (96, 384, 64, 116224),
    (192, 768, 32, 77312), (192, 768, 64, 116224),
    (1280, 5120, 16, 298496), (1152, 1024, 16, 216576),
    (1152, 1024, 32, 216576),
    (96, 288, 32, 0), (96, 384, 16, 0), (768, 3072, 8, 0)])
def test_tf32_smem_bytes(d, md, bm, smem):
    """The split-TF32 block (LN2's rows, h, both as hi and lo panels at 16
    rows, and three weight tiles): vit_b16 and swin_t's stage 3 (the
    numbers in the source's note; 64 rows do not fit), stage 2, stages 0
    and 1 on chunks of 96 (no 16-row tile there), vit_h14's (over 227 KB
    even at 16 rows), a row over 1024 wide, and shapes it refuses."""
    assert fm.tf32_smem_bytes(d, md, bm) == smem


@pytest.mark.parametrize("d,tiles", [(768, (16, 32, 64)), (384, (16, 32, 64)),
                                     (96, (32, 64)), (192, (32, 64)),
                                     (160, (32, 64))])
def test_tf32_tiles(d, tiles):
    """16-row tiles put the eight warps across a chunk of 128 (16 columns
    each); a chunk of 96 has no such split."""
    assert fm.tf32_tiles(d) == tiles


@pytest.mark.parametrize("d,md,fits", [
    (768, 3072, True), (384, 1536, True), (96, 384, True), (192, 768, True),
    (1280, 5120, False), (1152, 1024, True), (96, 288, False),
    (200, 800, False)])
def test_fits_tf32(d, md, fits):
    assert fm.fits_tf32(d, md) is fits
    smallest = fm.tf32_tiles(d)[0]
    assert fm.fits_tf32(d, md) == (0 < fm.tf32_smem_bytes(d, md, smallest)
                                   <= SMEM_LIMIT)


@pytest.mark.parametrize("dtype,d,md,route", [
    (F32, 768, 3072, "tf32"), (F32, 96, 384, "tf32"), (F32, 192, 768, "tf32"),
    (F32, 384, 1536, "tf32"), (F32, 1280, 5120, "fma"), (F32, 96, 288, "fma"),
    (BF16, 96, 384, "mma"), (BF16, 192, 768, "mma"), (BF16, 96, 288, "fma"),
    (torch.float16, 96, 384, "fma"), (torch.float64, 768, 3072, "fma")])
def test_route_by_dtype_at_both_chunks(dtype, d, md, route):
    """On the 16-byte grid: f32 on split TF32 wherever its block fits, bf16
    on the tensor cores at either chunk; other dtypes on the FMA kernel
    (which raises on them)."""
    assert fm.mlp_route(dtype, d, md, (0, 256, 512, 1024, 2048)) == route


@pytest.mark.parametrize("addr", [(4, 256, 512), (0, 260, 512),
                                  (0, 256, 520), (0, 256, 512, 1028),
                                  (0, 256, 512, 1024, 2056)])
@pytest.mark.parametrize("dtype,d", [(F32, 768), (F32, 96), (BF16, 192)])
def test_off_the_grid_takes_the_fma_kernel(dtype, d, addr):
    assert fm.mlp_route(dtype, d, 4 * d, addr) == "fma"


def _tile_lib(clusters):
    """A route library whose occupancy at tiles of bm rows is
    ``clusters[bm]``, read from the cache library_clusters keeps."""
    return types.SimpleNamespace(_ivt_clusters={
        (0, code, d, md, bm): n
        for code in (0, 1) for d, md in ((768, 3072), (96, 384), (192, 768),
                                         (384, 1536))
        for bm, n in clusters.items()})


@pytest.mark.parametrize("route,dtype,m,d,md,clusters,tile", [
    # vit_b16 B=1: 13 tiles of 16 in one wave
    ("tf32", F32, 197, 768, 3072, {16: 16, 32: 15}, 16),
    # B=8: no tile in one wave, 64 rows do not fit: the largest that does
    ("tf32", F32, 1576, 768, 3072, {16: 16, 32: 15}, 32),
    ("tf32", F32, 3136, 96, 384, {32: 66, 64: 33}, 64),     # swin_t stage 0
    ("tf32", F32, 784, 192, 768, {32: 33, 64: 16}, 32),     # stage 1 B=1
    ("tf32", F32, 6272, 192, 768, {32: 33, 64: 16}, 64),    # stage 1 B=8
    ("tf32", F32, 196, 384, 1536, {16: 33, 32: 33}, 16),    # stage 2 B=1
    ("tf32", F32, 1568, 384, 1536, {16: 33, 32: 33}, 32),   # B=8
    ("mma", BF16, 3136, 96, 384, {32: 66, 64: 33}, 64),
    ("mma", BF16, 784, 192, 768, {32: 33, 64: 16}, 32),
    ("mma", BF16, 197, 768, 3072, {32: 15, 64: 15}, 32),
    ("mma", BF16, 1576, 768, 3072, {32: 15, 64: 15}, 64)])
def test_row_tile_by_route(route, dtype, m, d, md, clusters, tile):
    """The smallest tile whose tiles fit the card's clusters in one wave,
    else the largest whose block fits: 32 or 64 for bf16, 16 (chunks of 128
    only), 32 or 64 for split TF32, whose 64-row block does not fit at
    vit_b16's or swin_t stage 2's widths."""
    lib = _tile_lib(clusters)
    assert fm.library_tile(lib, route, m, d, md, dtype, "cuda:0") == tile


# -- the sources ----------------------------------------------------------------------


def test_tf32_source_uses_split_tf32_on_a_cluster():
    """The new source multiplies with mma.sync m16n8k8 TF32 on split
    operands (tf32_attention.cuh's split: cvt.rna.tf32.f32), folds with
    round-to-nearest adds, and runs on mlp_cluster.cuh's cluster split:
    launched with the cluster attribute, LN2 gathered and fc2's partials
    summed in rank order over DSMEM at either chunk."""
    src = _read("fused_mlp_block_tf32.cu")
    assert '#include "mlp_cluster.cuh"' in src
    assert '#include "tf32_attention.cuh"' in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "split(" in src and "fold_rn(" in src and "__fadd_rn(" in src
    assert "cvt.rna.tf32.f32" in _read("tf32_attention.cuh")
    assert "cg::this_cluster()" in src and "mc_launch(" in src
    assert "mc_sum_ranks<float4, NC>" in src and "mc_gather_rows(" in src
    assert src.count("cluster.sync()") >= 2
    assert "gelu_tanh(" in src
    assert "mlp_tf32_kernel<32, MC_NC_NARROW>" in src
    assert "mlp_tf32_kernel<64, MC_NC>" in src
    assert "mlp_tf32_kernel<16, MC_NC>" in src
    assert "tf_pair(" in src and "if constexpr (PRE)" in src
    assert "cudaLaunchAttributeClusterDimension" in _read("mlp_cluster.cuh")
    assert "mlp_cluster.cuh" not in _read("fused_mlp_block.cu")


def test_bf16_source_instantiates_the_narrow_chunk():
    """The bf16 source keeps its 128-wide kernel and adds one at chunks of
    96 (a warp on three n8 tiles, the third by ldmatrix .x2 .trans)."""
    src = _read("fused_mlp_block_mma.cu")
    header = _read("mlp_cluster.cuh")
    assert "mlp_mma_body<BM, MC_NC>(a)" in src
    assert "mlp_mma_body<BM, MC_NC_NARROW>(a)" in src
    assert "mc_mma_bf16_stage<MT, NC>" in src
    assert "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16" in header
    assert re.search(r"constexpr int MC_NC_NARROW = (\d+);",
                     header).group(1) == str(fm.MMA_NARROW_CHUNK)
    assert re.search(r"constexpr int MC_NC = (\d+);",
                     header).group(1) == str(fm.MMA_CHUNK)
    # the W8A8 source takes the narrow chunk too (its row predicate is
    # mc_chunk_of's, no 128-only rule is left)
    w8 = _read("fused_mlp_w8a8_mma.cu")
    assert "w8a8_mma_body<T, BM, MC_NC_NARROW>(a)" in w8
    assert "mc_width_ok" not in header + w8


def test_stage_shapes_match_the_sources():
    """The weight stages the envelope formulas count: bf16 48 k rows of 104
    at chunks of 96 (48 divides 96 and a slice of 96), split TF32 32 k rows
    of chunk + 4 floats."""
    header = _read("mlp_cluster.cuh")
    rows = int(re.search(r"ROWS = NC == MC_NC \? MC_BF_ROWS : (\d+);",
                         header).group(1))
    assert fm._BF16_STAGE[fm.MMA_NARROW_CHUNK] == (rows, fm.MMA_NARROW_CHUNK
                                                   + 8)
    assert 96 % rows == 0 and 192 % rows == 0
    src = _read("fused_mlp_block_tf32.cu")
    kr = int(re.search(r"constexpr int TF_KR = (\d+);", src).group(1))
    assert kr == fm.TF32_STAGE_ROWS
    assert "static constexpr int LD = NC + 4;" in src
    assert "constexpr bool tf_presplit(int bm) { return bm == %d; }" % (
        fm.TF32_PRESPLIT_ROWS) in src
    assert "L.total = L.ring + (size_t)MC_STAGES * TF_KR" in src


@pytest.mark.parametrize("source", ["mlp_cluster.cuh",
                                    "fused_mlp_block_tf32.cu"])
@pytest.mark.parametrize("bm", [16, 32, 64])
@pytest.mark.parametrize("chunk", [96, 128])
@pytest.mark.parametrize("s", [4, 8])
def test_reduction_items_cover_the_chunk(source, bm, chunk, s):
    """McTile's and TfTile's ITEMS (read from the sources) give every
    thread enough 4-column groups for the block's NC / S columns of all BM
    rows: with chunks of 96 or tiles of 16 the count rounds up (three
    groups a row at S = 8; 64 groups at 16 rows)."""
    expr = re.search(r"static constexpr int ITEMS = ([^;]+);",
                     _read(source)).group(1)
    items = eval(expr.replace("BM", str(bm)).replace("NC", str(chunk))
                 .replace("MC_MIN_CLUSTER", "4").replace("MC_THREADS", "256")
                 .replace("/", "//"))
    groups = bm * (chunk // s // 4)
    assert items * 256 >= groups
    assert (items - 1) * 256 < bm * chunk // 4 // 4


# -- the emulations -------------------------------------------------------------------


def _tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(a, b, mode):
    """a [m, k] @ b [k, n] as the kernel takes it over its weight stages of
    32 k: "split" three TF32 products (hi products and corrections summed
    apart over a stage, then folded into the sum with round-to-nearest f32
    adds); "tf32" one TF32 product a product (the hi products alone); "f32"
    a plain f32 product (the bf16 route's values, exact in f32)."""
    if mode == "f32":
        return a @ b
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=F32)
    for k0 in range(0, a.shape[1], fm.TF32_STAGE_ROWS):
        ah, al = _split(a[:, k0:k0 + fm.TF32_STAGE_ROWS])
        bh, bl = _split(b[k0:k0 + fm.TF32_STAGE_ROWS])
        big = ah @ bh
        small = (al @ bh + ah @ bl) if mode == "split" else 0.0
        acc = acc + (big + small)
    return acc


def mlp_emulated(x, p, eps=1e-6, mode="split", drop=None):
    """Row 6's tensor-core arithmetic in its order on CPU tensors: LN2 in
    f32 cast to the dtype; on each slice r of the S = cluster_of(d, md)
    hidden slices, h_r = gelu_tanh(ln @ fc1_w[:, r] + fc1_b[r]) cast to the
    dtype, and its f32 partial h_r @ fc2_w[r, :] (products by ``mode``); the
    partials added in rank order; y = (x + acc) + fc2_b, cast. ``drop``: a
    rank whose partial is left out (a broken reduction the bounds must
    refuse)."""
    b, n, d = x.shape
    md = p["fc1_w"].shape[-1]
    s = fm.cluster_of(d, md)
    sl = md // s
    xf = x.float().reshape(b * n, d)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    ln = ((xf - mu) * torch.rsqrt(var + eps) * p["ln2_s"].float()
          + p["ln2_b"].float()).to(x.dtype).float()
    acc = None
    for r in range(s):
        cols = slice(r * sl, (r + 1) * sl)
        h = F.gelu(_product(ln, p["fc1_w"][:, cols].float(), mode)
                   + p["fc1_b"][cols].float(), approximate="tanh")
        part = _product(h.to(x.dtype).float(), p["fc2_w"][cols, :].float(),
                        mode)
        if r == drop:
            continue
        acc = part if acc is None else acc + part
    y = (xf + acc) + p["fc2_b"].float()
    return y.to(x.dtype).reshape(b, n, d)


def _mlp_params(d, md, seed):
    rng = np.random.default_rng(seed)
    jp = {"ln2_s": 1.0 + 0.2 * rng.standard_normal(d),
          "ln2_b": 0.2 * rng.standard_normal(d),
          "fc1_w": rng.standard_normal((d, md)) * d ** -0.5,
          "fc1_b": 0.2 * rng.standard_normal(md),
          "fc2_w": rng.standard_normal((md, d)) * md ** -0.5,
          "fc2_b": 0.2 * rng.standard_normal(d)}
    return {k: v.astype(np.float32) for k, v in jp.items()}


def _f32_case(d, md, batch, n):
    jp = _mlp_params(d, md, d + md + batch)
    x = np.random.default_rng(n).standard_normal((batch, n, d)).astype(
        np.float32)
    want = np.asarray(jfm.fused_mlp_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in jp.items()}, 1e-6))
    return from_jax(jp), torch.from_numpy(x), want


@pytest.mark.parametrize("batch,n", [(1, 9), (2, 20)])
@pytest.mark.parametrize("d,md", WIDTHS)
def test_split_tf32_emulation_matches_jax(pallas_interpret, d, md, batch, n):
    """The split-TF32 route's arithmetic in f32 against the Pallas kernel:
    within 1e-5 at both chunk widths."""
    tp, tx, want = _f32_case(d, md, batch, n)
    got = mlp_emulated(tx, tp).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("d,md", WIDTHS)
def test_bounds_refuse_one_tf32_product(pallas_interpret, d, md):
    """One TF32 product a product (10-bit operands, no split) misses the
    f32 bound the split route meets on the same inputs."""
    tp, tx, want = _f32_case(d, md, 1, 13)
    got = mlp_emulated(tx, tp, mode="tf32").numpy()
    assert np.abs(got - want).max() > ATOL


@pytest.mark.parametrize("d,md", WIDTHS)
def test_bounds_refuse_a_dropped_rank_f32(pallas_interpret, d, md):
    """One cluster rank's fc2 partial left out is refused in f32."""
    tp, tx, want = _f32_case(d, md, 2, 11)
    s = fm.cluster_of(d, md)
    for drop in (0, s - 1):
        got = mlp_emulated(tx, tp, drop=drop).numpy()
        assert np.abs(got - want).max() > ATOL


@pytest.mark.parametrize("batch,n", [(1, 9), (2, 17)])
@pytest.mark.parametrize("d,md", WIDTHS[:2])
def test_narrow_chunk_bf16_emulation_matches_jax(pallas_interpret, d, md,
                                                 batch, n):
    """The bf16 route at chunks of 96 (swin_t's widths) against the Pallas
    kernel in bf16: within 2^-6 of y's scale; one rank's partial left out
    is refused."""
    jp = _mlp_params(d, md, d + md + n)
    jp = {k: np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
          for k, v in jp.items()}
    x = np.array(jnp.asarray(np.random.default_rng(d + n).standard_normal(
        (batch, n, d)).astype(np.float32), jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jfm.fused_mlp_block(
        jnp.asarray(x, jnp.bfloat16),
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in jp.items()},
        1e-6).astype(jnp.float32))
    tp = {k: v.to(BF16) for k, v in from_jax(jp).items()}
    tx = torch.from_numpy(x).to(BF16)
    bound = BF16_Y_REL * max(1.0, float(np.abs(want).max()))
    got = mlp_emulated(tx, tp, mode="f32").float().numpy()
    assert np.abs(got - want).max() <= bound
    broken = mlp_emulated(tx, tp, mode="f32",
                          drop=fm.cluster_of(d, md) - 1).float().numpy()
    assert np.abs(broken - want).max() > bound


def test_split_tf32_rounds_to_nearest_ties_away():
    """The emulation's cvt.rna.tf32: 10 mantissa bits, ties away from zero,
    and hi + lo within 2^-21 of the value."""
    one = torch.tensor([1.0], dtype=F32)
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 3.0], dtype=F32)
    assert _tf32(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 3.0]
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    hi, lo = _split(v)
    assert ((hi + lo - v).abs() <= v.abs() * 2.0 ** -21).all()
    assert _tf32(one).item() == 1.0


def test_tf32_wrapper_keeps_the_plain_version_on_the_cpu():
    """CPU tensors run the plain version; no launch is counted."""
    tp = from_jax(_mlp_params(96, 384, 2))
    tx = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 5, 96)).astype(np.float32))
    before = fm.fused_mlp_block_tf32x3.launches
    assert torch.equal(fm.fused_mlp_block_tf32x3(tx, tp),
                       fm.fused_mlp_block_reference(tx, tp))
    assert fm.fused_mlp_block_tf32x3.launches == before
