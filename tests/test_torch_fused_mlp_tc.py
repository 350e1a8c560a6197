"""The fused MLP branch's tensor-core routes (rows 6 and 7), on the CPU: the
route predicates, the C entries' ctypes signatures read from their sources,
the instructions the sources use, emulations of the two kernels' arithmetic
in their order held against the JAX package's Pallas kernels in interpret
mode on shared inputs, the loaders' envelope check and the wrappers' CPU
path:

* row 7, ``csrc/fused_mlp_w8a8_mma.cu``: a cluster of ``cluster_size(md)``
  blocks, each its slice of the hidden columns: q1 of the whole row tile in
  every block, acc1 -> h -> GELU on the slice, each slice's row max |h|,
  the cluster's max of those (one sx2 for every block), q2 of the slice,
  the slice's s32 partial of fc2, the partials summed;
* row 6, ``csrc/fused_mlp_block_mma.cu``: LN2 cast to the dtype, fc1 +
  bias + tanh GELU on each slice cast to the dtype, each slice's f32 fc2
  partial, the partials added in rank order, then (x + acc) + b2.

The kernels themselves run only on the card: their ``cuda``-marked tests
are in ``tests/test_torch_cuda_kernel.py``, and ``chip_smoke.py`` holds
them against the plain versions at the main paths' shapes.

Inputs and parameters are made with numpy from a seed and handed to both
packages. Widths: d = 128 and 256 (the routes take rows of whole
128-column chunks), mlp_dim 512 and 1024, so the cluster has 4 or 8 blocks
and a slice is one chunk.

Tolerances. Row 7: the integer stages (q1, acc1, q2, acc2) of the
emulation equal the plain version's exactly (the split changes no integer:
a max over slices is the max over the row, an s32 sum of partials the
whole product), and y in f32 is within 1e-5 of the Pallas kernel's, the
bound of ``tests/test_torch_quant.py``. Row 6: f32 within 1e-5 of the
Pallas kernel's, the JAX test's own bound (only the order of f32 sums
differs); bf16 within 2^-6 of y's scale, ``chip_smoke.py``'s bound. The
same bounds refuse an emulation that drops one slice's partial, and row
7's integer check refuses sx2 taken per slice instead of over the cluster.
"""

import ctypes
import functools
import os
import re
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from interactive_vit_tpu.ops import fused_mlp as jfm
from interactive_vit_tpu.ops import quant as jq
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import dispatch
from interactive_vit_tpu_torch.ops import fused_mlp as fm
from interactive_vit_tpu_torch.ops import quant as tq
from interactive_vit_tpu_torch.runtime import cuda_build

torch.set_num_threads(2)

F32 = torch.float32
BF16 = torch.bfloat16
ATOL = 1e-5
BF16_Y_REL = 2.0 ** -6
# (d, mlp_dim): clusters of 4 and 8 blocks
WIDTHS = [(128, 512), (128, 1024), (256, 1024)]


@pytest.fixture
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(jfm.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# -- the routes -------------------------------------------------------------------


@pytest.mark.parametrize("md,s", [
    (3072, 8), (1536, 4), (1024, 8), (512, 4), (5120, 8), (7680, 4),
    (768, 0), (384, 0), (640, 0), (100, 0), (0, 0), (192, 0)])
def test_cluster_size(md, s):
    """Clusters of 4 or 8 blocks: a block sums at most two 4-column groups
    of a chunk; a 4x MLP on rows of a multiple of 128 always takes them."""
    assert fm.cluster_size(md) == s


@pytest.mark.parametrize("d,md,smem", [
    (768, 3072, 201728), (384, 1536, 169984), (1280, 5120, 300032),
    (1152, 1024, 218112), (96, 384, 94464), (768, 100, 0), (1408, 5632, 0),
    (192, 768, 94464), (96, 288, 0), (160, 640, 0)])
def test_mma_smem_bytes(d, md, smem):
    """The bf16 route's block at vit_b16 (the number in its source's note),
    swin_t's stage 2 (S = 4), vit_h14's (over the card's 227 KB), a row
    over 1024 wide that fits, swin_t's stages 0 and 1 on chunks of 96 (the
    partial buffers [64][100] f32 over LN2's rows, three 48 x 104 weight
    tiles), and shapes it refuses (three chunks of 96, rows neither 128
    nor 96 divides)."""
    assert fm.mma_smem_bytes(d, md) == smem


@pytest.mark.parametrize("d,md,esize,smem", [
    (768, 3072, 2, 206592), (768, 3072, 4, 225024),
    (1280, 5120, 2, 271104), (1152, 1024, 2, 220928),
    (1152, 1024, 4, 263936), (96, 384, 2, 101120)])
def test_w8a8_mma_smem_bytes(d, md, esize, smem):
    """vit_b16's block (the number in its source's note), rows over
    1024 wide, and swin_t's stage 0 on chunks of 96 (the partial buffers
    [64][100] 32-bit words over q1, three 96 x 96-byte weight tiles)."""
    assert fm.w8a8_mma_smem_bytes(d, md, esize) == smem


# (dtype, d, mlp_dim, byte addresses of x, ln2_s, ln2_b, fc1_w, fc2_w, route;
# three addresses where ln2_s and ln2_b do not matter)
MLP_ROUTES = [
    (BF16, 768, 3072, (0, 1 << 20, 1 << 22), "mma"),     # vit_b16, swin stage 3
    (BF16, 384, 1536, (256, 4096, 8192), "mma"),         # swin_t stage 2
    (BF16, 256, 640, (0, 256, 512), "fma"),              # a cluster of one
    (BF16, 256, 1024, (0, 256, 512), "mma"),
    (F32, 768, 3072, (0, 1 << 20, 1 << 22), "tf32"),     # f32 on split TF32
    (torch.float16, 768, 3072, (0, 256, 512), "fma"),
    (BF16, 96, 384, (0, 256, 512), "mma"),               # swin_t stage 0
    (BF16, 192, 768, (0, 256, 512), "mma"),              # swin_t stage 1
    (BF16, 1280, 5120, (0, 256, 512), "fma"),            # over 227 KB
    (BF16, 1152, 1024, (0, 256, 512), "mma"),            # 72 units a row
    (BF16, 768, 3000, (0, 256, 512), "fma"),             # no whole chunks
    (BF16, 768, 3072, (2, 1 << 20, 1 << 22), "fma"),     # x off the grid
    (BF16, 768, 3072, (0, (1 << 20) + 8, 1 << 22), "fma"),
    (BF16, 768, 3072, (0, 1 << 20, (1 << 22) + 4), "fma"),
    (BF16, 768, 3072, (0, 32, 64, 1 << 20, 1 << 22), "mma"),
    (BF16, 768, 3072, (0, 34, 64, 1 << 20, 1 << 22), "fma"),   # ln2_s
    (BF16, 768, 3072, (0, 32, 72, 1 << 20, 1 << 22), "fma"),   # ln2_b
    (BF16, 96, 288, (0, 256, 512), "fma"),               # three chunks of 96
    (BF16, 160, 640, (0, 256, 512), "fma"),              # neither chunk
    (BF16, 96, 384, (0, 264, 512), "fma"),               # ln2_s off the grid
    (F32, 96, 384, (0, 256, 512), "tf32"),
    (F32, 192, 768, (0, 256, 512), "tf32"),
    (F32, 384, 1536, (0, 256, 512), "tf32"),             # swin_t stage 2
    (F32, 1280, 5120, (0, 256, 512), "fma"),             # 32 rows over 227 KB
    (F32, 1152, 1024, (0, 256, 512), "tf32"),
    (F32, 768, 3072, (4, 256, 512), "fma"),              # x off the grid
    (F32, 96, 288, (0, 256, 512), "fma"),
]


@pytest.mark.parametrize("dtype,d,md,addrs,route", MLP_ROUTES)
def test_mlp_route_by_dtype_shape_and_alignment(dtype, d, md, addrs, route):
    assert fm.mlp_route(dtype, d, md, addrs) == route


W8A8_ROUTES = [
    (BF16, 768, 3072, (0, 1 << 20, 1 << 22), "mma"),     # the served vit_b16
    (F32, 768, 3072, (0, 1 << 20, 1 << 22), "mma"),
    (BF16, 384, 1536, (0, 256, 512), "mma"),
    (F32, 1280, 5120, (0, 256, 512), "dp4a"),            # f32 h over 227 KB
    (BF16, 1280, 5120, (0, 256, 512), "dp4a"),
    (BF16, 100, 400, (0, 256, 512), "dp4a"),
    (torch.float16, 768, 3072, (0, 256, 512), "dp4a"),
    (BF16, 768, 3072, (2, 256, 512), "dp4a"),
    (F32, 768, 3072, (0, 257, 512), "dp4a"),             # int8 fc1 off the grid
    (BF16, 1152, 1024, (0, 256, 512), "mma"),            # 72 units a row
    (F32, 1152, 1024, (0, 256, 512), "dp4a"),            # f32 over 227 KB
    (F32, 768, 3072, (0, 36, 64, 256, 512), "dp4a"),     # ln2_s
    (BF16, 768, 3072, (0, 32, 66, 256, 512), "dp4a"),    # ln2_b
]


@pytest.mark.parametrize("dtype,d,md,addrs,route", W8A8_ROUTES)
def test_w8a8_route_by_dtype_shape_and_alignment(dtype, d, md, addrs, route):
    assert fm.w8a8_route(dtype, d, md, addrs) == route


def _at(shape, dtype, off=0):
    """A contiguous CPU tensor starting ``off`` elements into its storage."""
    size = int(np.prod(shape))
    return torch.zeros(size + off, dtype=dtype)[off:].view(shape)


@pytest.mark.parametrize("dtype,d,offset,w_offset,ln_offset,route", [
    (BF16, 768, 0, 0, 0, "mma"), (F32, 768, 0, 0, 0, "tf32"),
    (BF16, 768, 1, 0, 0, "fma"), (BF16, 768, 8, 0, 0, "mma"),
    (BF16, 768, 0, 4, 0, "fma"), (BF16, 96, 0, 0, 0, "mma"),
    (BF16, 768, 0, 0, 1, "fma"), (BF16, 768, 0, 0, 8, "mma"),
    (F32, 768, 2, 0, 0, "fma"), (F32, 768, 4, 0, 0, "tf32"),
    (F32, 96, 0, 0, 0, "tf32"), (F32, 192, 0, 1, 0, "fma")])
def test_route_of_an_mlp_blocks_operands(dtype, d, offset, w_offset,
                                         ln_offset, route):
    """The pointers the wrapper hands the predicate: x, ln2_s, ln2_b (read
    16 bytes at a time by the LayerNorm), fc1_w and fc2_w."""
    md = 4 * d
    p = {"ln2_s": _at((d,), dtype, ln_offset), "ln2_b": _at((d,), dtype),
         "fc1_w": _at((d, md), dtype, w_offset), "fc2_w": _at((md, d), dtype)}
    assert fm._mlp_route_of(_at((1, 3, d), dtype, offset), p) == route


@pytest.mark.parametrize("dtype,offset,q_offset,ln_offset,route", [
    (BF16, 0, 0, 0, "mma"), (F32, 0, 0, 0, "mma"), (BF16, 1, 0, 0, "dp4a"),
    (F32, 2, 0, 0, "dp4a"), (F32, 4, 0, 0, "mma"), (BF16, 0, 3, 0, "dp4a"),
    (F32, 0, 0, 1, "dp4a"), (BF16, 0, 0, 3, "dp4a")])
def test_route_of_a_w8a8_blocks_operands(dtype, offset, q_offset, ln_offset,
                                         route):
    d, md = 768, 3072
    p = {"ln2_s": _at((d,), dtype), "ln2_b": _at((d,), dtype, ln_offset),
         "fc1_w": {tq.AQKEY: _at((d, md), torch.int8, q_offset)},
         "fc2_w": {tq.AQKEY: _at((md, d), torch.int8)}}
    assert fm._w8a8_route_of(_at((1, 3, d), dtype, offset), p) == route


def test_dispatch_policy_is_unchanged():
    """The route is the wrappers' choice: ``default_mlp_impl`` still hands
    out the FMA and ``__dp4a`` wrappers, and dense "auto" stays unfused."""
    assert dispatch.default_mlp_impl("fused", BF16, 768, 3072) is \
        fm.fused_mlp_block
    assert dispatch.default_mlp_impl("w8a8", BF16, 768, 3072) is \
        fm.fused_mlp_w8a8_block
    assert dispatch.default_mlp_impl("auto", BF16, 768, 3072,
                                     device="cuda") is None


# -- the C entries ------------------------------------------------------------------

_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def _entry_kinds(source: str, entry: str):
    with open(os.path.join(cuda_build.CSRC_DIR, source)) as f:
        src = f.read()
    params = re.search(r"\n\w+ " + entry + r"\(([^)]*)\)", src).group(1)
    kinds, names = [], []
    for decl in (" ".join(p.split()) for p in params.split(",") if p.strip()):
        ctype = decl.rsplit(" ", 1)[0].replace("const ", "")
        kinds.append(ctypes.c_void_p if "*" in decl else _C_TYPES[ctype])
        names.append(decl.split()[-1].lstrip("*"))
    return kinds, names


@pytest.mark.parametrize("source,entry,argtypes,first", [
    ("fused_mlp_block_mma.cu", "ivt_fused_mlp_block_mma",
     fm.MLP_MMA_ARGTYPES, ["x", "ln_s", "ln_b", "w1", "b1", "w2", "b2", "y",
                           "M", "D", "MD", "bm", "eps"]),
    ("fused_mlp_block.cu", "ivt_fused_mlp_block", fm.MLP_ARGTYPES,
     ["dtype", "x", "ln_s", "ln_b", "w1", "b1", "w2", "b2", "y"]),
    ("fused_mlp_w8a8_mma.cu", "ivt_fused_mlp_w8a8_mma", fm.W8A8_MMA_ARGTYPES,
     ["dtype", "x", "ln_s", "ln_b", "w1", "s1", "b1", "w2", "s2", "b2", "y",
      "q1_out", "acc1_out", "q2_out", "acc2_out", "M", "D", "MD", "bm",
      "eps"]),
    ("fused_mlp_w8a8_block.cu", "ivt_fused_mlp_w8a8_block", fm.W8A8_ARGTYPES,
     ["dtype", "x", "ln_s", "ln_b", "w1", "s1", "b1", "w2", "s2", "b2", "y",
      "q1_out", "acc1_out", "q2_out", "acc2_out", "M", "D", "MD", "eps"]),
    ("fused_mlp_block_tf32.cu", "ivt_fused_mlp_block_tf32x3",
     fm.MLP_MMA_ARGTYPES, ["x", "ln_s", "ln_b", "w1", "b1", "w2", "b2", "y",
                           "M", "D", "MD", "bm", "eps"]),
])
def test_mlp_entry_matches_its_ctypes_signature(source, entry, argtypes,
                                                first):
    """Each MLP C entry's parameters, read from its source, against the
    argtypes the wrapper binds: the same count and kinds in order (the two
    W8A8 kernels take the same arguments, the tensor-core one also its row
    tile)."""
    kinds, names = _entry_kinds(source, entry)
    assert names[:len(first)] == first
    assert names[-1] == "stream"
    assert kinds == argtypes


@pytest.mark.parametrize("route,name,nargs", [
    (route, name, nargs)
    for route in fm._MMA_SOURCES
    for name, nargs in fm.ENVELOPE_NARGS[route].items()])
def test_envelope_entries_take_ints(route, name, nargs):
    """The envelope entries the loader binds: that many int parameters
    (each route's chunk and cluster take the row width)."""
    source, _, _, pre = fm._MMA_SOURCES[route]
    kinds, _ = _entry_kinds(source + ".cu", pre + name)
    assert kinds == [ctypes.c_int] * nargs


def _read(name):
    with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
        return f.read()


def test_sources_use_their_instructions():
    """The int8 route multiplies with mma.sync m16n8k32 s8 (its B operand
    transposed in shared memory by prmt, no __dp4a); the bf16 route with
    mma.sync m16n8k16 bf16 and ldmatrix .trans; both stream the weights
    with cp.async, split the hidden dimension over a thread-block cluster
    launched with the cluster attribute, and sum fc2's partials over DSMEM
    (map_shared_rank) between cluster barriers. The FMA and __dp4a sources
    stay as they were."""
    header = _read("mlp_cluster.cuh")
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in header
    assert "__byte_perm" in header
    assert "cp_async16(" in header and "ldmatrix_x4_trans(" in header
    assert "mma_bf16(" in header
    assert "cudaLaunchAttributeClusterDimension" in header
    assert "cudaOccupancyMaxActiveClusters" in header
    assert "map_shared_rank" in header
    mma = _read("mma_attention.cuh")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in mma
    assert "cp.async.cg.shared.global" in mma
    for name, step in (("fused_mlp_w8a8_mma.cu", "mc_mma_s8_stage<"),
                       ("fused_mlp_block_mma.cu", "mc_mma_bf16_stage<")):
        src = _read(name)
        assert '#include "mlp_cluster.cuh"' in src
        assert step in src and "cg::this_cluster()" in src
        assert src.count("cluster.sync()") >= 2  # a chunk's, and the last
        assert "mc_sum_ranks" in src
        assert "asm(" not in src and "asm volatile" not in src
        assert "__dp4a(" not in src
    assert "map_shared_rank(rmax" in _read("fused_mlp_w8a8_mma.cu")
    assert "mc_pack16_mma(q)" in _read("fused_mlp_w8a8_mma.cu")
    assert "pack4(q[0], q[4], q[8], q[12])" in header
    for name in ("fused_mlp_block.cu", "fused_mlp_w8a8_block.cu"):
        assert "mlp_cluster.cuh" not in _read(name)
    assert "__dp4a(" in _read("fused_mlp_w8a8_block.cu")


def test_layernorm_units_cover_the_widest_row():
    """``mc_ln_row`` holds a lane's 16-column units of a row in MC_UNITS
    register slots and reads only those: for every width the routes take,
    the lane that owns the most units (lane 0, (d / 16 + 31) / 32 of them)
    must find a slot for each (1152 and 1280 have 72 and 80 units, so
    lanes 0-7 and 0-15 own three)."""
    header = _read("mlp_cluster.cuh")
    width = int(re.search(r"constexpr int MC_MAX_WIDTH = (\d+);",
                          header).group(1))
    assert width == fm.MMA_MAX_WIDTH
    expr = re.search(r"constexpr int MC_UNITS = ([^;]+);", header).group(1)
    slots = eval(expr.replace("MC_MAX_WIDTH", str(width)).replace("/", "//"))
    for d in range(fm.MMA_CHUNK, width + 1, fm.MMA_CHUNK):
        assert max((d // 16 - lane + 31) // 32 for lane in range(32)) <= slots
    assert slots == 3


@pytest.mark.parametrize("k", range(64))
def test_int8_operand_order_is_a_4x4_transpose(k):
    """The shared-memory position of an int8 activation's column
    (``mc_pack16_mma``: byte 4 w + i of a 16-byte group holds column w +
    4 i): each group's 4 x 4 transpose, its own inverse, the order in which
    a thread's four weight rows t, t + 4, t + 8, t + 12 meet mma index
    4 t + i."""
    p = (k & ~15) | ((k & 3) << 2) | ((k >> 2) & 3)
    assert p // 16 == k // 16
    assert (p & ~15) | ((p & 3) << 2) | ((p >> 2) & 3) == k
    t, i = (p % 16) // 4, p % 4
    assert k % 16 == t + 4 * i


# -- the emulations -----------------------------------------------------------------


def _ln(x, p, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    ln = (xf - mu) * torch.rsqrt(var + eps)
    return (ln * p["ln2_s"].float() + p["ln2_b"].float()).to(x.dtype)


def mlp_emulated(x, p, eps=1e-6, drop=None):
    """Row 6's tensor-core arithmetic in its order on CPU tensors: LN2 cast
    to the dtype; on each slice r of S = cluster_size(md) hidden columns,
    h_r = gelu_tanh(ln @ fc1_w[:, r] + fc1_b[r]) in f32 cast to the dtype
    and its f32 partial h_r @ fc2_w[r, :]; the partials added in rank
    order; y = (x + acc) + fc2_b, cast. ``drop``: a rank whose partial is
    left out (a broken reduction the bounds must refuse)."""
    md = p["fc1_w"].shape[-1]
    s = fm.cluster_of(x.shape[-1], md)
    sl = md // s
    ln = _ln(x, p, eps).float()
    acc = None
    for r in range(s):
        cols = slice(r * sl, (r + 1) * sl)
        h = F.gelu(ln @ p["fc1_w"][:, cols].float()
                   + p["fc1_b"][cols].float(), approximate="tanh").to(x.dtype)
        part = h.float() @ p["fc2_w"][cols, :].float()
        if r == drop:
            continue
        acc = part if acc is None else acc + part
    return ((x.float() + acc) + p["fc2_b"].float()).to(x.dtype)


def w8a8_emulated(x, p, eps=1e-6, local_scales=False):
    """Row 7's tensor-core arithmetic in its order on CPU tensors: LN2 cast
    to the dtype and back, q1 per row (every block of the cluster the
    same); on each slice r: acc1_r, h_r = acc1_r * (sx1 s1_r) + b1_r, the
    GELU on the dtype, the slice's row max |h_r|; sx2 from the max over the
    slices (``local_scales``: each slice its own, the broken exchange); q2_r
    and the s32 partial q2_r @ fc2_q[r, :]; acc2 the sum of the partials;
    y = x + acc2 * (sx2 s2) + b2. Returns (y, the integer stages)."""
    dt = x.dtype
    w1, w2 = p["fc1_w"], p["fc2_w"]
    md = w1[tq.AQKEY].shape[-1]
    s = fm.cluster_size(md)
    sl = md // s
    q1, sx1 = tq.quant_rows_mosaic(_ln(x, p, eps).float())
    hs, acc1 = [], []
    for r in range(s):
        cols = slice(r * sl, (r + 1) * sl)
        a1 = tq.int_matmul(q1, w1[tq.AQKEY][:, cols])
        h = a1.float() * (sx1 * w1[tq.ASKEY][cols]) + p["fc1_b"][cols].float()
        hs.append(F.gelu(h.to(dt), approximate="tanh").float())
        acc1.append(a1)
    maxes = [h.abs().amax(dim=-1, keepdim=True) for h in hs]
    m = maxes[0]
    for mr in maxes[1:]:
        m = torch.maximum(m, mr)
    q2, acc2 = [], None
    for r in range(s):
        mr = maxes[r] if local_scales else m
        sx2 = mr / 127.0
        sx2 = torch.where(sx2 == 0, torch.ones_like(sx2), sx2)
        q = torch.clamp(torch.floor(hs[r] / sx2 + 0.5), -127, 127).to(
            torch.int8)
        part = tq.int_matmul(q, w2[tq.AQKEY][r * sl:(r + 1) * sl, :])
        acc2 = part if acc2 is None else acc2 + part
        q2.append(q)
    sx2 = m / 127.0
    sx2 = torch.where(sx2 == 0, torch.ones_like(sx2), sx2)
    y = x.float() + acc2.float() * (sx2 * w2[tq.ASKEY]) + p["fc2_b"].float()
    return y.to(dt), {"q1": q1, "acc1": torch.cat(acc1, -1),
                      "q2": torch.cat(q2, -1), "acc2": acc2}


def _mlp_params(d, md, seed):
    rng = np.random.default_rng(seed)
    jp = {"ln2_s": 1.0 + 0.2 * rng.standard_normal(d),
          "ln2_b": 0.2 * rng.standard_normal(d),
          "fc1_w": rng.standard_normal((d, md)) * d ** -0.5,
          "fc1_b": 0.2 * rng.standard_normal(md),
          "fc2_w": rng.standard_normal((md, d)) * md ** -0.5,
          "fc2_b": 0.2 * rng.standard_normal(d)}
    return {k: v.astype(np.float32) for k, v in jp.items()}


def _w8a8_params(d, md, seed):
    jp = {k: jnp.asarray(v) for k, v in _mlp_params(d, md, seed).items()}
    for name in ("fc1_w", "fc2_w"):
        jp[name] = jq.quantize_weight(jp[name], "w8a8")
    return jp, from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("batch,n", [(1, 9), (3, 7)])
@pytest.mark.parametrize("d,md", WIDTHS)
def test_w8a8_emulation_matches_jax(pallas_interpret, d, md, batch, n):
    """Row 7 in f32: the emulation's integer stages are the plain
    version's exactly, and its y within 1e-5 of the Pallas kernel's."""
    jp, tp = _w8a8_params(d, md, d + md + batch)
    x = np.random.default_rng(n).standard_normal((batch, n, d)).astype(
        np.float32)
    want = np.asarray(jfm.fused_mlp_w8a8_block(jnp.asarray(x), jp, 1e-6,
                                               block_q=8))
    tx = torch.from_numpy(x)
    got, parts = w8a8_emulated(tx, tp)
    _, rparts = fm.fused_mlp_w8a8_parts(tx, tp)
    for k in ("q1", "acc1", "q2", "acc2"):
        assert torch.equal(parts[k], rparts[k]), k
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("d,md", WIDTHS)
def test_w8a8_emulation_needs_the_cluster_max(d, md):
    """Each slice quantized with its own row max (no exchange over the
    cluster) gives other q2 and acc2: the integer check refuses it."""
    _, tp = _w8a8_params(d, md, 5)
    tx = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 9, d)).astype(np.float32))
    _, parts = w8a8_emulated(tx, tp, local_scales=True)
    _, rparts = fm.fused_mlp_w8a8_parts(tx, tp)
    assert torch.equal(parts["q1"], rparts["q1"])
    assert not torch.equal(parts["q2"], rparts["q2"])
    assert not torch.equal(parts["acc2"], rparts["acc2"])


def test_w8a8_emulation_bf16_matches_the_plain_version():
    """bf16 activations: the split leaves every integer stage and y as the
    plain version's, bit for bit (the same ops on the same values)."""
    _, tp = _w8a8_params(256, 1024, 3)
    tp = {k: (v.to(BF16) if isinstance(v, torch.Tensor) else v)
          for k, v in tp.items()}
    tx = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 9, 256)).astype(np.float32)).to(BF16)
    got, parts = w8a8_emulated(tx, tp)
    ref, rparts = fm.fused_mlp_w8a8_parts(tx, tp)
    assert torch.equal(got, ref)
    for k in parts:
        assert torch.equal(parts[k], rparts[k]), k


@pytest.mark.parametrize("batch,n", [(1, 9), (2, 20)])
@pytest.mark.parametrize("d,md", WIDTHS)
def test_mlp_emulation_matches_jax_f32(pallas_interpret, d, md, batch, n):
    """Row 6's arithmetic in f32 against the Pallas kernel: within 1e-5;
    one slice's partial left out is refused."""
    jp = _mlp_params(d, md, d + md + batch)
    x = np.random.default_rng(n).standard_normal((batch, n, d)).astype(
        np.float32)
    want = np.asarray(jfm.fused_mlp_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in jp.items()}, 1e-6))
    tp, tx = from_jax(jp), torch.from_numpy(x)
    np.testing.assert_allclose(mlp_emulated(tx, tp).numpy(), want, atol=ATOL,
                               rtol=0)
    broken = mlp_emulated(tx, tp, drop=fm.cluster_size(md) - 1).numpy()
    assert np.abs(broken - want).max() > ATOL


@pytest.mark.parametrize("d,md", WIDTHS)
def test_mlp_emulation_matches_jax_bf16(pallas_interpret, d, md):
    """Row 6 in bf16 against the Pallas kernel in bf16: within 2^-6 of y's
    scale (both round at the same points; an f32 sum taken in another
    order can flip a bf16 h); one slice's partial left out is refused."""
    jp = _mlp_params(d, md, d + md)
    jp = {k: np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
          for k, v in jp.items()}
    x = np.array(jnp.asarray(np.random.default_rng(d).standard_normal(
        (2, 9, d)).astype(np.float32), jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jfm.fused_mlp_block(
        jnp.asarray(x, jnp.bfloat16),
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in jp.items()},
        1e-6).astype(jnp.float32))
    tp = {k: v.to(BF16) for k, v in from_jax(jp).items()}
    tx = torch.from_numpy(x).to(BF16)
    bound = BF16_Y_REL * max(1.0, float(np.abs(want).max()))
    got = mlp_emulated(tx, tp).float().numpy()
    assert np.abs(got - want).max() <= bound
    broken = mlp_emulated(tx, tp, drop=0).float().numpy()
    assert np.abs(broken - want).max() > bound


# -- the loaders and the wrappers ---------------------------------------------------


def _fake_lib(route, **wrong):
    """An object with a route library's envelope entries, each giving this
    module's numbers unless ``wrong`` overrides it."""
    pre = fm._MMA_SOURCES[route][3]
    smem = {"w8a8": fm.w8a8_mma_smem_bytes, "mma": fm.mma_smem_bytes,
            "tf32": fm.tf32_smem_bytes}[route]
    entries = {"rows": lambda: fm.MMA_ROWS,
               "max_width": lambda: fm.MMA_MAX_WIDTH,
               "chunk": fm.chunk_of, "cluster": fm.cluster_of,
               "smem_bytes": smem}
    entries.update(wrong)
    return types.SimpleNamespace(**{pre + k: v for k, v in entries.items()})


@pytest.mark.parametrize("route", ["mma", "w8a8", "tf32"])
@pytest.mark.parametrize("wrong", [
    {}, {"rows": lambda: 32}, {"max_width": lambda: 1024},
    {"chunk": lambda *a: 64}, {"cluster": lambda *a: 4 if a[-1] else 0},
    {"smem_bytes": lambda *a: 1}])
def test_loader_refuses_a_library_that_disagrees(route, wrong):
    lib = _fake_lib(route, **wrong)
    if not wrong:
        fm.check_mma_library(lib, route)
        return
    with pytest.raises(RuntimeError, match="disagree"):
        fm.check_mma_library(lib, route)


def _counts():
    return (fm.fused_mlp_block.launches, fm.fused_mlp_block_mma.launches,
            fm.fused_mlp_block_tf32x3.launches,
            fm.fused_mlp_w8a8_block.launches,
            fm.fused_mlp_w8a8_block_mma.launches)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_route_wrappers_keep_the_plain_version_on_the_cpu(dtype):
    """CPU tensors run the plain versions whatever the route would be on a
    card; no launch is counted."""
    d, md = 128, 1024
    tp = {k: v.to(dtype) for k, v in from_jax(_mlp_params(d, md, 1)).items()}
    tx = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 5, d)).astype(np.float32)).to(dtype)
    _, wp = _w8a8_params(d, md, 1)
    wp = {k: (v.to(dtype) if isinstance(v, torch.Tensor) else v)
          for k, v in wp.items()}
    before = _counts()
    ref = fm.fused_mlp_block_reference(tx, tp)
    for fn in (fm.fused_mlp_block, fm.fused_mlp_block_mma,
               fm.fused_mlp_block_tf32x3):
        assert torch.equal(fn(tx, tp), ref)
    wref, wparts = fm.fused_mlp_w8a8_parts(tx, wp)
    for fn in (fm.fused_mlp_w8a8_block, fm.fused_mlp_w8a8_block_mma):
        y, parts = fn(tx, wp, want_parts=True)
        assert torch.equal(y, wref)
        assert all(torch.equal(parts[k], wparts[k]) for k in wparts)
        assert torch.equal(fn(tx, wp), wref)
    assert _counts() == before


@pytest.mark.parametrize("fn", ["fused_mlp_block_mma",
                                "fused_mlp_w8a8_block_mma",
                                "fused_mlp_block_tf32x3"])
def test_route_wrappers_refuse_devices_they_have_no_path_for(fn):
    with pytest.raises(ValueError):
        getattr(fm, fn)(torch.zeros((1, 5, 128), device="meta"), {})
