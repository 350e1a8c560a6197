"""The hand-written CUDA kernels -- the fused and headwise attention blocks
(the fused one also in its s8 and ToMe modes), the row-resident and the online flash
attention, the Swin window attention, the fused MLP branch (also its W8A8
variant) and the trainable attention's forward and backward (both
layouts) -- against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (inside a fixture) when no CUDA device is
present. On a machine with the card and the CUDA toolkit, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py

(``--noconftest``: the suite's conftest configures JAX, which such a
machine need not have; this file imports only torch and the port).

Tolerances. f32: the kernel and the plain version differ only in the order
of f32 sums (over D=768 and N=197 terms), ~1e-6 relative; the bound is
1e-4 absolute. bf16: both round at the same points, so they differ where an
f32 sum lands within its rounding error of a bf16 rounding boundary and
rounds to the neighbour -- one bf16 ulp (2^-8 to 2^-7 of the element) in a
qkv, head output or y element, which can move a score and its probs
slightly. y may move by a few ulps at the top of its range: 2^-6 of its
scale. A probs or mean element moves in proportion to itself, so its bound
is per element: 2^-5 of the plain value (four ulps) plus 1e-6, never above
2^-7; a tap that is zero or half the plain one fails at any N. The flash
output is a probs-weighted mean of V rows; its bound is that of y. The
window kernel's branch output and the MLP kernel's y take y's bound, the
window probs the per-element one. The online flash output takes y's bound.
The fused MLP's bf16 tensor-core route (``fused_mlp_block_mma``) takes the
FMA kernel's bound: both round LN2, h and y at the same points; fc2's f32
sum is the sum of a cluster's per-slice partials in rank order, so two
calls give the same bits. The W8A8 MLP's tensor-core route
(``fused_mlp_w8a8_block_mma``) takes the ``__dp4a`` kernel's checks below.

The int8 kernels. Their s32 products are exact, but an int8 is the
rounding of an f32 value, and an f32 (or bf16) value that the kernel and
the plain version compute in another order can fall on the other side of
a .5 boundary. The W8A8 MLP's integer stages are therefore checked
exactly against the kernel's own int8 activations (acc1 = q1 @ fc1_q, acc2
= q2 @ fc2_q), its int8 activations against the plain version's (at most
1% differ: q1 by 1, q2 by 2 in rows whose q1 agrees), and y, in both
dtypes, to 2^-6 of its scale: one
flipped int8 moves y by one quantization step through a product. The s8
block: one flipped int8 of q or k moves a score by at most scale * max|q| *
max|k| / 127 (~0.02 here) and its probability by about that share of
itself, and one flipped int8 of p moves o by at most ps * max|v|; so y
takes 2^-6 of its scale in both dtypes, and probs and mean, per element,
2^-4 of the plain value plus 1e-6, never above 2^-5.

ToMe's mode of the fused block (``key_bias``, ``want_metric``) takes the
same bounds, and its key metric takes y's: in f32 it differs from the
plain version's only by the order of the f32 sums of the QKV product; in
bf16 a key element that rounds to its neighbour (one ulp, 2^-8 of the
element) moves the head-mean by at most that over the head count.

The headwise block's tensor-core routes (``headwise_attn_block_mma``,
bf16; ``headwise_attn_block_tf32x3``, f32 on split TF32) take the FMA
kernel's bounds: they round at the same points, and each split-TF32
product is within ~2^-21 of the f32 one (``tests/test_torch_headwise_tc.py``).

The bf16 tensor-core kernels (``flash_attention_mma``,
``flash_attention_online_mma`` and the tensor-core route of both trainable
attentions) take the same bounds as the FMA kernels they stand beside: they
round at the same points, and only the order of the f32 sums inside the
tensor cores differs. The f32 split-TF32 kernels
(``flash_attention_online_tf32x3``, ``flash_attention_tf32x3`` and the
split-TF32 route of both trainable attentions) take f32's bounds (1e-4;
the gradients 1e-5 of their largest value): each of their products is
three TF32 products of a hi / lo split, within ~2^-21 of the f32 product
(``tests/test_torch_tf32_split.py``).

The trainable attention (``attention_vjp``): o, dq, dk and dv. f32: the
kernel and the plain version differ in the order of f32 sums (scores over
dh, delta over N keys, dq over N keys, dk and dv over N queries), ~1e-6 of
the tensor's largest value; the bound is 1e-5 of it. bf16: both round P
(for dv), ds and the outputs at the same points; where an f32 value lands
within its rounding error of a bf16 boundary it rounds to the neighbour,
one ulp (2^-8 to 2^-7 of the element) of the output, or one ulp of a P or
ds term inside a sum of N, which moves the sum by far less than the sum's
scale. So each element is bound by 2^-6 of its plain value (two ulps) plus
2^-8 of the tensor's largest value; a gradient zeroed or halved fails.
"""

import functools
import glob
import os

import pytest
import torch

from interactive_vit_tpu_torch.ops import attention_vjp as av
from interactive_vit_tpu_torch.ops import flash_attention as fa
from interactive_vit_tpu_torch.ops import fused_block as fb
from interactive_vit_tpu_torch.ops import fused_mlp as fm
from interactive_vit_tpu_torch.ops import fused_window as fw
from interactive_vit_tpu_torch.runtime import cuda_build

pytestmark = pytest.mark.cuda

# (batch, tokens, width, heads): vit_b16 and vit_t16 blocks at 224, and a
# small ragged shape (N=17 leaves a partial query tile and edge tiles)
SHAPES = [(2, 197, 768, 12), (1, 197, 192, 3), (3, 17, 64, 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every source at once, one nvcc each (a no-op once built)
    cuda_build.build_all(sorted(
        os.path.basename(p)[:-3]
        for p in glob.glob(os.path.join(cuda_build.CSRC_DIR, "*.cu"))))
    fb.load_kernel()
    fb.load_mma_kernel()
    fb.load_tf32_kernel()
    fb.load_headwise_kernel()
    fb.load_headwise_mma_kernel()
    fb.load_headwise_tf32_kernel()
    fa.load_kernel()
    fw.load_kernel()
    fw.load_mma_kernel()
    fw.load_tf32_kernel()
    fm.load_kernel()
    fa.load_online_kernel()
    fm.load_w8a8_kernel()
    fm.load_mma_kernel()
    fm.load_w8a8_mma_kernel()
    fm.load_tf32_kernel()
    av.load_kernel()
    fa.load_online_mma_kernel()
    av.load_mma_kernel()
    fa.load_mma_kernel()
    fa.load_online_tf32_kernel()
    av.load_tf32_kernel()
    return torch.device("cuda")


def _block(b, n, d, heads, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g) * std + mean).to(
            device=device, dtype=dtype)

    p = {
        "ln1_s": rnd(d, std=0.1, mean=1.0), "ln1_b": rnd(d, std=0.1),
        "qkv_w": rnd(d, 3 * d, std=d ** -0.5), "qkv_b": rnd(3 * d, std=0.1),
        "proj_w": rnd(d, d, std=d ** -0.5), "proj_b": rnd(d, std=0.1),
    }
    return rnd(b, n, d), p


def _within(got, ref, i, dtype, s8=False):
    """Output ``i`` (0: y, the attention output or ToMe's key metric; else
    probs or mean) within its bound of the plain version's (``s8``: the
    int8 kernels')."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if s8:
        if i == 0:
            return err.max().item() <= 2.0 ** -6 * max(1.0,
                                                      r.abs().max().item())
        return bool((err <= (2.0 ** -4 * r.abs() + 1e-6).clamp(max=2.0 ** -5))
                    .all())
    if dtype == torch.float32:
        return err.max().item() <= 1e-4
    if i == 0:
        return err.max().item() <= 2.0 ** -6 * max(1.0, r.abs().max().item())
    return bool((err <= (2.0 ** -5 * r.abs() + 1e-6).clamp(max=2.0 ** -7))
                .all())


def _check(got, ref, dtype, s8=False, metric=False):
    """Every output of a kernel within its bound, and the bounds of the
    maps, mean and ToMe's metric (the last output when ``metric``, bound
    as y is) strict enough to refuse them zeroed or halved."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            assert g is None
            continue
        kind = 0 if metric and i == len(ref) - 1 else i
        assert g.shape == r.shape and g.dtype == r.dtype
        assert _within(g, r, kind, dtype, s8), i
        if i > 0:
            assert not _within(g * 0.5, r, kind, dtype, s8), i
            assert not _within(torch.zeros_like(g), r, kind, dtype, s8), i


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["maps_off", "maps_mean", "subset",
                                  "exact_softmax"])
def test_kernel_matches_plain(cuda, shape, dtype, mode):
    b, n, d, heads = shape
    x, p = _block(b, n, d, heads, dtype, cuda)
    kw = {
        "maps_off": {},
        "maps_mean": {"want_attn": True, "want_mean": True},
        "subset": {"want_attn": True,
                   "attn_heads": (heads - 1, 0) if heads > 1 else (0,)},
        "exact_softmax": {"want_attn": True, "fast_softmax": False},
    }[mode]
    wrapper = _row1_wrapper(x, p, heads)
    before = wrapper.launches
    got = fb.fused_attn_block(x, p, heads, 1e-6, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = fb.fused_attn_block_reference(x, p, heads, 1e-6, **kw)
    assert got[0].dtype == dtype and got[0].shape == x.shape
    if len(ref) == 3:
        assert got[2].shape == (b, n, n)
    _check(got, ref, dtype)


def _row1_wrapper(x, p, heads, s8=False):
    """The wrapper whose count a block launch on these operands moves:
    the route ``block_route`` gives them."""
    route = fb._block_route_of(x, p, heads)
    return {("fma", False): fb.fused_attn_block,
            ("mma", False): fb.fused_attn_block_mma,
            ("tf32", False): fb.fused_attn_block_tf32x3,
            ("fma", True): fb.fused_attn_block_s8,
            ("mma", True): fb.fused_attn_block_s8_mma,
            ("tf32", True): fb.fused_attn_block_s8_tf32x3}[route, s8]


# row 1's tensor-core routes: vit_b16 and vit_t16 blocks (heads 64 wide),
# heads 80 wide (d=160) at a ragged N, and B=8 (the 64-row QKV tile)
ROW1_TC_SHAPES = [(1, 197, 768, 12), (8, 197, 768, 12), (1, 197, 192, 3),
                  (2, 50, 160, 2), (1, 257, 192, 3)]


@pytest.mark.parametrize("shape", ROW1_TC_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["maps_off", "maps_mean", "subset",
                                  "exact_softmax"])
def test_row1_tensor_core_routes_match_plain(cuda, shape, dtype, mode):
    """bf16 on ``fused_attn_block_mma``, f32 on ``fused_attn_block_tf32x3``
    (one launch each, by the counts), within the FMA kernel's bounds."""
    b, n, d, heads = shape
    x, p = _block(b, n, d, heads, dtype, cuda, seed=n + d)
    kw = {
        "maps_off": {},
        "maps_mean": {"want_attn": True, "want_mean": True},
        "subset": {"want_attn": True, "attn_heads": (heads - 1,)},
        "exact_softmax": {"want_attn": True, "fast_softmax": False},
    }[mode]
    wrapper = (fb.fused_attn_block_mma if dtype == torch.bfloat16
               else fb.fused_attn_block_tf32x3)
    assert _row1_wrapper(x, p, heads) is wrapper
    before = (wrapper.launches, fb.fused_attn_block.launches)
    got = fb.fused_attn_block(x, p, heads, 1e-6, **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches, fb.fused_attn_block.launches) == (
        before[0] + 1, before[1])
    _check(got, fb.fused_attn_block_reference(x, p, heads, 1e-6, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s8", [False, True])
def test_row1_off_the_grid_takes_the_fma_kernel(cuda, dtype, s8):
    """x one element into its storage: the FMA (or __dp4a) kernel, with
    the same results within the bounds; then ToMe's mode there (key bias
    and metric), counted in ``tome_launches`` too."""
    x, p = _block(1, 197, 768, 12, dtype, cuda)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    xo = flat[1:].view(x.shape)
    xo.copy_(x)
    assert fb._block_route_of(xo, p, 12) == "fma"
    wrapper = fb.fused_attn_block_s8 if s8 else fb.fused_attn_block
    kw = {"want_attn": True, "want_mean": True}
    before = wrapper.launches
    got = wrapper(xo, p, 12, 1e-6, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _check(got, fb.fused_attn_block_reference(x, p, 12, 1e-6,
                                              int8_scores=s8, **kw),
           dtype, s8)
    kb = torch.log(torch.randint(1, 17, (1, 197), generator=torch.Generator()
                                 .manual_seed(197)).float()).to(cuda)
    kw = dict(kw, key_bias=kb, want_metric=True)
    before = (wrapper.launches, wrapper.tome_launches)
    got = wrapper(xo, p, 12, 1e-6, **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.tome_launches) == (before[0] + 1,
                                                         before[1] + 1)
    plain = functools.partial(fb.fused_attn_block_reference, x, p, 12, 1e-6,
                              int8_scores=s8, **kw)
    _check(got, plain(), dtype, s8, metric=True)
    no_bias = plain(key_bias=None)
    assert not all(_within(g, r, i, dtype, s8) for i, (g, r)
                   in enumerate(zip(got[:-1], no_bias[:-1])))


@pytest.mark.parametrize("shape", [(1, 197, 768, 12), (2, 50, 160, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8_pv", [True, False])
def test_row1_s8_route_integer_stages_are_exact(cuda, shape, dtype, int8_pv):
    """The s8 tensor-core route's s32 sums equal the exact products of its
    own int8 operands (si = q8 k8^T, oi = p8 v8), and those operands are
    the plain version's but where a value that the two compute in another
    order lands on the other side of a .5 boundary (at most 1% of them)."""
    from interactive_vit_tpu_torch.ops import quant

    b, n, d, heads = shape
    x, p = _block(b, n, d, heads, dtype, cuda, seed=d)
    kw = {"want_attn": True, "want_mean": True}
    out, parts = fb.fused_attn_block_s8_parts(x, p, heads, 1e-6,
                                              int8_pv=int8_pv, **kw)
    torch.cuda.synchronize()

    def exact(a, bt):
        return torch.matmul(a.double(), bt.double()).long()

    assert torch.equal(parts["si"].long(),
                       exact(parts["q8"], parts["k8"].transpose(-1, -2)))
    if int8_pv:
        assert torch.equal(parts["oi"].long(),
                           exact(parts["p8"], parts["v8"]))
    qkv = fb._ln_qkv(x, p, 1e-6)
    q, k = (qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, d // heads)
            .transpose(1, 2).float() for i in range(2))
    for name, ref in (("q8", q), ("k8", k)):
        qq, _ = quant.quant_rows_mosaic(ref)
        share = (parts[name] != qq.to(torch.int8)).float().mean().item()
        assert share <= 0.01, (name, share)
    _check(out, fb.fused_attn_block_reference(
        x, p, heads, 1e-6, int8_scores=True, int8_pv=int8_pv, **kw),
        dtype, s8=True)


@pytest.mark.parametrize("route", ["mma", "tf32"])
def test_row1_route_wrappers_refuse_other_operands(cuda, route):
    dtype = torch.bfloat16 if route == "mma" else torch.float32
    other = torch.float32 if route == "mma" else torch.bfloat16
    x, p = _block(1, 17, 64, 4, dtype, cuda)  # heads 16 wide
    wrappers = ((fb.fused_attn_block_mma, fb.fused_attn_block_s8_mma)
                if route == "mma" else
                (fb.fused_attn_block_tf32x3, fb.fused_attn_block_s8_tf32x3))
    for fn in wrappers:
        with pytest.raises(ValueError):
            fn(x, p, 4)
        x2, p2 = _block(1, 17, 128, 2, other, cuda)
        with pytest.raises(ValueError):
            fn(x2, p2, 2)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, p = _block(2, 17, 64, 4, torch.float32, cuda)
    with pytest.raises(TypeError):
        fb.fused_attn_block(x.half(), {k: v.half() for k, v in p.items()}, 4)
    with pytest.raises(ValueError):
        fb.fused_attn_block(x.transpose(0, 1), p, 4)  # not contiguous
    with pytest.raises(ValueError):
        fb.fused_attn_block(x, {**p, "qkv_w": p["qkv_w"].cpu()}, 4)
    with pytest.raises(ValueError):
        fb.fused_attn_block(x, p, 5)  # width does not split into heads
    with pytest.raises(ValueError):  # ToMe's key bias must be [B, N]
        fb.fused_attn_block(x, p, 4, key_bias=torch.zeros(2, 16, device=cuda))
    with pytest.raises(ValueError):  # on x's device
        fb.fused_attn_block(x, p, 4, key_bias=torch.zeros(2, 17))


# ToMe: vit_b16's ladder at r=8 enters at N=197 and leaves the last block's
# attention at 109; vit_b16_tome16's last block runs at N=21 and leaves 11
TOME_N = [197, 109, 21, 11]


@pytest.mark.parametrize("n", TOME_N)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s8", [False, True])
@pytest.mark.parametrize("mode", ["maps_off", "maps_mean"])
def test_tome_mode_matches_plain(cuda, n, dtype, s8, mode):
    """ToMe's operands (key_bias = log of token sizes, the key metric) at
    every end of the token ladders, dense and s8. A metric zeroed or halved
    fails its bound, and so does the kernel's result against the plain
    version without the bias (on the maps, or on y in dense f32)."""
    x, p = _block(1, n, 768, 12, dtype, cuda, seed=n)
    sizes = torch.randint(1, 17, (1, n), generator=torch.Generator()
                          .manual_seed(n)).float()
    kb = torch.log(sizes).to(cuda)
    maps = mode == "maps_mean"
    kw = {"want_attn": maps, "want_mean": maps, "want_metric": True}
    wrapper = fb.fused_attn_block_s8 if s8 else fb.fused_attn_block
    route = _row1_wrapper(x, p, 12, s8)
    assert route is not wrapper  # heads 64 wide: the tensor cores
    before = (route.launches, route.tome_launches)
    got = wrapper(x, p, 12, 1e-6, key_bias=kb, **kw)
    torch.cuda.synchronize()
    assert (route.launches, route.tome_launches) == (before[0] + 1,
                                                     before[1] + 1)
    plain = functools.partial(fb.fused_attn_block_reference, x, p, 12, 1e-6,
                              int8_scores=s8, **kw)
    ref = plain(key_bias=kb)
    assert len(got) == (4 if maps else 3)
    assert got[-1].shape == (1, n, 64) and got[-1].dtype == torch.float32
    _check(got, ref, dtype, s8, metric=True)
    if maps or (dtype == torch.float32 and not s8):
        no_bias = plain()
        assert not all(_within(g, r, i, dtype, s8) for i, (g, r)
                       in enumerate(zip(got[:-1], no_bias[:-1]))
                       if r is not None)


# headwise: vit_l16 @384 (N=577: 10 key tiles, the last partial), vit_b16
# (N=197), a ragged small block, and dh=24 (column groups that do not
# divide the thread block); heads 64 wide take the tensor-core routes
# (bf16 mma, f32 split TF32), 16 and 24 the FMA kernel
HEADWISE_SHAPES = [(1, 577, 1024, 16), (2, 197, 768, 12), (3, 17, 64, 4),
                   (1, 130, 96, 4)]
HEADWISE_MODES = {
    "maps_off": {},
    "maps_mean": {"want_attn": True, "want_mean": True},
    "subset_mean": {"want_attn": True, "want_mean": True},
    "exact_softmax": {"want_attn": True, "fast_softmax": False},
}


def _headwise_counts():
    return {"fma": fb.headwise_attn_block.launches,
            "mma": fb.headwise_attn_block_mma.launches,
            "tf32": fb.headwise_attn_block_tf32x3.launches}


def _headwise_case(x, p, heads, dtype, mode, route):
    """One launch of ``headwise_attn_block`` on ``route`` (the counts
    show it) against the plain version."""
    kw = dict(HEADWISE_MODES[mode])
    if mode == "subset_mean":
        kw["attn_heads"] = (heads - 1, 0)
    assert fb._route_of(x, p, heads) == route
    before = _headwise_counts()
    got = fb.headwise_attn_block(x, p, heads, 1e-6, **kw)
    torch.cuda.synchronize()
    after = _headwise_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}
    ref = fb.headwise_attn_block_reference(x, p, heads, 1e-6, **kw)
    _check(got, ref, dtype)


@pytest.mark.parametrize("shape", HEADWISE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", list(HEADWISE_MODES))
def test_headwise_kernel_matches_plain(cuda, shape, dtype, mode):
    b, n, d, heads = shape
    x, p = _block(b, n, d, heads, dtype, cuda, seed=n)
    route = ("fma" if d // heads not in fb.HEADWISE_TC_DHS else
             "mma" if dtype == torch.bfloat16 else "tf32")
    _headwise_case(x, p, heads, dtype, mode, route)


# heads 80 wide on the tensor-core routes: vit_h14 @224 (N=257) and a small
# ragged block (N=130, two heads); and vit_l16's block with x off the
# 16-byte grid, which must take the FMA kernel
@pytest.mark.parametrize("shape", [(1, 257, 1280, 16), (2, 130, 160, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", list(HEADWISE_MODES))
def test_headwise_80_wide_on_the_tensor_cores(cuda, shape, dtype, mode):
    b, n, d, heads = shape
    x, p = _block(b, n, d, heads, dtype, cuda, seed=n)
    _headwise_case(x, p, heads, dtype, mode,
                   "mma" if dtype == torch.bfloat16 else "tf32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["maps_off", "maps_mean"])
def test_headwise_off_the_grid_takes_the_fma_kernel(cuda, dtype, mode):
    x, p = _block(1, 577, 1024, 16, dtype, cuda, seed=577)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    xo = flat[1:].view(x.shape)
    xo.copy_(x)
    _headwise_case(xo, p, 16, dtype, mode, "fma")


@pytest.mark.parametrize("route", ["mma", "tf32"])
def test_headwise_route_wrappers_refuse_other_operands(cuda, route):
    """A route's wrapper raises on operands its route does not take (the
    other dtype, or heads 24 wide); nothing falls back."""
    fn = (fb.headwise_attn_block_mma if route == "mma"
          else fb.headwise_attn_block_tf32x3)
    other = torch.float32 if route == "mma" else torch.bfloat16
    for dtype, shape in ((other, (1, 130, 128, 2)),
                         (torch.bfloat16 if route == "mma" else
                          torch.float32, (1, 130, 96, 4))):
        b, n, d, heads = shape
        x, p = _block(b, n, d, heads, dtype, cuda)
        with pytest.raises(ValueError):
            fn(x, p, heads)


# flash: dinov2_s14_reg @518 (N=1374), vit_l16 @384 (N=577), the longest
# row-resident sequence (N=2048: 16-row query tiles), ragged small shapes,
# vit_h14@224 (16 heads 80 wide, N=257)
FLASH_SHAPES = [(1, 6, 1374, 64), (1, 16, 577, 64), (1, 2, 2048, 64),
                (2, 3, 17, 16), (1, 2, 130, 24), (1, 16, 257, 80)]


def _qkv(shape, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(shape, generator=g) * 2).to(device=device,
                                                     dtype=dtype)
            for _ in range(3)]


def _row_counts():
    return (fa.flash_attention.launches, fa.flash_attention_mma.launches,
            fa.flash_attention_tf32x3.launches)


def _off_grid(t, pad):
    """A copy of ``t`` [..., W] whose rows are ``pad`` elements longer (2:
    f32 rows 8 bytes and bf16 rows 4 bytes off the 16-byte grid)."""
    if pad == 0:
        return t
    wide = torch.zeros(t.shape[:-1] + (t.shape[-1] + pad,), dtype=t.dtype,
                       device=t.device)
    wide[..., :t.shape[-1]] = t
    return wide[..., :t.shape[-1]]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("want_attn", [False, True])
@pytest.mark.parametrize("pad", [0, 2])
def test_flash_kernel_matches_plain(cuda, shape, dtype, want_attn, pad):
    q, k, v = (_off_grid(t, pad) for t in _qkv(shape, dtype, cuda,
                                               seed=shape[2]))
    mma = dtype == torch.bfloat16 and shape[3] in fa.MMA_DHS and pad == 0
    tf32 = dtype == torch.float32 and shape[3] in fa.TF32_DHS and pad == 0
    tc = mma or tf32
    before = _row_counts()
    got = fa.flash_attention(q, k, v, want_attn=want_attn)
    torch.cuda.synchronize()
    # heads of 64 or 80 on the 16-byte grid run on the tensor cores (bf16,
    # or f32 on split TF32), the rest on FMA
    assert _row_counts() == (before[0] + (not tc), before[1] + mma,
                             before[2] + tf32)
    ref = fa.flash_attention_reference(q, k, v, want_attn=want_attn)
    _check(got, ref, dtype)


@pytest.mark.parametrize("n,n_real", [(1408, 1374), (130, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_masks_keys_beyond_n_real(cuda, n, n_real, dtype):
    q, k, v = _qkv((1, 6, n, 64), dtype, cuda, seed=n_real)
    got = fa.flash_attention(q, k, v, want_attn=True, n_real=n_real)
    ref = fa.flash_attention_reference(q, k, v, want_attn=True,
                                       n_real=n_real)
    torch.cuda.synchronize()
    _check(got, ref, dtype)
    assert torch.all(got[1][..., n_real:] == 0)


def test_flash_kernel_reads_strided_views(cuda):
    """q, k, v as ``qkv_proj`` makes them: transposed views of one
    [B, N, 3D] tensor, never copied."""
    b, n, heads, dh = 2, 300, 6, 64
    qkv = torch.randn((b, n, 3 * heads * dh), generator=torch.Generator()
                      .manual_seed(1)).to(cuda, torch.bfloat16)
    q, k, v = (qkv.reshape(b, n, 3, heads, dh)[:, :, i].transpose(1, 2)
               for i in range(3))
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v, want_attn=True)
    ref = fa.flash_attention_reference(q, k, v, want_attn=True)
    torch.cuda.synchronize()
    _check(got, ref, torch.bfloat16)


def _online_counts():
    return (fa.flash_attention.launches, fa.flash_attention_online.launches,
            fa.flash_attention_online_mma.launches,
            fa.flash_attention_online_tf32x3.launches)


def test_flash_wrapper_branches_above_rowfull_max(cuda):
    q, k, v = _qkv((1, 1, fa.ROWFULL_MAX_N + 8, 64), torch.bfloat16, cuda)
    before = _online_counts()
    o, probs = fa.flash_attention(q, k, v, want_attn=True)
    assert _online_counts() == before  # the reference
    assert probs.dtype == torch.float32
    # maps off: the online branch, bf16 at dh=64 on the tensor cores
    o, probs = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert probs is None
    assert _online_counts() == (before[0], before[1], before[2] + 1,
                                before[3])
    # f32 at dh=64: the split-TF32 kernel
    o, probs = fa.flash_attention(*(t.float() for t in (q, k, v)))
    torch.cuda.synchronize()
    assert _online_counts() == (before[0], before[1], before[2] + 1,
                                before[3] + 1)


# online flash: dinov2_s14_reg@742 (N=2814: 22 key tiles, the last of 126
# keys; B=1 and 8), just above ROWFULL_MAX_N, ragged small shapes, dh=128
# and dh=16, vit_h14@742 (16 heads 80 wide, N=2810) and heads 80 wide at
# the small shapes (bf16 at dh=64 or 80 runs on the tensor cores, f32 at
# those widths on split TF32, the rest on FMA)
ONLINE_SHAPES = [(1, 6, 2814, 64), (8, 6, 2814, 64), (2, 2, 2049, 64),
                 (3, 3, 17, 64), (3, 3, 17, 16), (1, 2, 300, 128),
                 (1, 16, 2810, 80), (2, 2, 2049, 80), (3, 3, 17, 80)]


@pytest.mark.parametrize("shape", ONLINE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_real", [None, -40])
def test_online_kernel_matches_plain(cuda, shape, dtype, n_real):
    q, k, v = _qkv(shape, dtype, cuda, seed=shape[2] + shape[3])
    n_real = None if n_real is None else max(1, shape[2] + n_real)
    mma = dtype == torch.bfloat16 and shape[3] in fa.MMA_DHS
    tf32 = dtype == torch.float32 and shape[3] in fa.TF32_DHS
    before = _online_counts()
    got = fa.flash_attention_online(q, k, v, n_real)
    torch.cuda.synchronize()
    assert _online_counts() == (before[0], before[1] + (not mma and not tf32),
                                before[2] + mma, before[3] + tf32)
    ref = fa.flash_attention_online_reference(q, k, v, n_real,
                                              block_k=fa.ONLINE_BLOCK_K)
    assert got.shape == q.shape and got.dtype == dtype
    _check((got,), (ref,), dtype)
    assert not _within(got * 0.5, ref, 0, dtype)


def test_online_kernel_reads_strided_views(cuda):
    b, n, heads, dh = 1, 2100, 6, 64
    qkv = torch.randn((b, n, 3 * heads * dh), generator=torch.Generator()
                      .manual_seed(2)).to(cuda, torch.bfloat16)
    q, k, v = (qkv.reshape(b, n, 3, heads, dh)[:, :, i].transpose(1, 2)
               for i in range(3))
    before = _online_counts()
    got = fa.flash_attention_online(q, k, v)
    ref = fa.flash_attention_online_reference(q, k, v)
    torch.cuda.synchronize()
    assert _online_counts() == (before[0], before[1], before[2] + 1,
                                before[3])
    _check((got,), (ref,), torch.bfloat16)


def test_online_fma_kernel_takes_misaligned_bf16(cuda):
    """bf16 heads of 64 whose token stride is not a multiple of 16 bytes:
    ``mma_route`` refuses them, so the FMA kernel runs; the tensor-core
    wrapper called on them raises."""
    b, n, heads, dh = 1, 2100, 2, 64
    x = torch.randn((b, n, 3 * heads * dh + 4), generator=torch.Generator()
                    .manual_seed(3)).to(cuda, torch.bfloat16)
    q, k, v = (x[..., :-4].reshape(b, n, 3, heads, dh)[:, :, i]
               .transpose(1, 2) for i in range(3))
    before = _online_counts()
    got = fa.flash_attention_online(q, k, v)
    ref = fa.flash_attention_online_reference(q, k, v)
    torch.cuda.synchronize()
    assert _online_counts() == (before[0], before[1] + 1, before[2],
                                before[3])
    _check((got,), (ref,), torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_online_mma(q, k, v)


def test_online_mma_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 300, 64), torch.float32, cuda)
    with pytest.raises(ValueError, match="bf16 heads 64 or 80 wide"):
        fa.flash_attention_online_mma(q, k, v)  # f32 stays on FMA
    q, k, v = _qkv((1, 2, 300, 128), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="bf16 heads 64 or 80 wide"):
        fa.flash_attention_online_mma(q, k, v)
    q, k, v = _qkv((1, 2, 300, 72), torch.bfloat16, cuda)
    # a view one element in: pointers 2 bytes off the 16-byte grid
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_online_mma(*(t[..., 1:65] for t in (q, k, v)))


# the row-resident kernel on the tensor cores (bf16): dinov2_s14_reg @518
# (N=1374; B=1 takes each key tile in four parts, B=2 in two), vit_l16 @384
# (N=577, two parts), vit_b16 (N=197, odd: the probs rows sit off the
# 4-byte grid), ragged small N, and the longest row-resident N; heads 80
# wide at vit_h14@224 (N=257; B=1 four parts, B=2 two), @448 (N=1025) and
# a ragged small N
MMA_ROW_SHAPES = [(1, 6, 1374, 64), (2, 6, 1374, 64), (1, 16, 577, 64),
                  (2, 12, 197, 64), (3, 2, 17, 64), (1, 2, 2048, 64),
                  (1, 16, 257, 80), (2, 16, 257, 80), (1, 16, 1025, 80),
                  (3, 2, 17, 80)]


def _qkv_views(b, n, heads, dtype, device, seed, pad=0, dh=64):
    """q, k, v as ``qkv_proj`` makes them: views of one [B, N, 3D] tensor
    of heads ``dh`` wide; ``pad`` extra elements a token put the rows off
    the 16-byte grid."""
    x = torch.randn((b, n, 3 * heads * dh + pad), generator=torch.Generator()
                    .manual_seed(seed)).to(device, dtype) * 2
    x = x[..., :3 * heads * dh]
    return [x.reshape(b, n, 3, heads, dh)[:, :, i].transpose(1, 2)
            for i in range(3)]


@pytest.mark.parametrize("shape", MMA_ROW_SHAPES)
@pytest.mark.parametrize("want_attn", [False, True])
def test_flash_mma_kernel_matches_plain(cuda, shape, want_attn):
    b, h, n, dh = shape
    q, k, v = _qkv_views(b, n, h, torch.bfloat16, cuda, seed=n, dh=dh)
    before = _row_counts()
    got = fa.flash_attention(q, k, v, want_attn=want_attn)
    torch.cuda.synchronize()
    assert _row_counts() == (before[0], before[1] + 1, before[2])
    ref = fa.flash_attention_reference(q, k, v, want_attn=want_attn)
    _check(got, ref, torch.bfloat16)
    assert not _within(got[0] * 0.5, ref[0], 0, torch.bfloat16)


# B=1 at N=1408 is one block an SM (four key parts), B=2 more (two parts)
@pytest.mark.parametrize("b,n,n_real", [(1, 1408, 1374), (2, 1408, 1374),
                                        (1, 208, 197), (1, 130, 100)])
def test_flash_mma_masks_keys_beyond_n_real(cuda, b, n, n_real):
    q, k, v = _qkv_views(b, n, 6, torch.bfloat16, cuda, seed=n_real)
    before = _row_counts()
    got = fa.flash_attention(q, k, v, want_attn=True, n_real=n_real)
    ref = fa.flash_attention_reference(q, k, v, want_attn=True,
                                       n_real=n_real)
    torch.cuda.synchronize()
    assert _row_counts() == (before[0], before[1] + 1, before[2])
    _check(got, ref, torch.bfloat16)
    assert torch.all(got[1][..., n_real:] == 0)


# vit_h14@224's padded form (N=320, 257 real; B=1 four key parts, B=2 two)
@pytest.mark.parametrize("b", [1, 2])
def test_flash_mma_dh80_masks_keys_beyond_n_real(cuda, b):
    q, k, v = _qkv_views(b, 320, 16, torch.bfloat16, cuda, seed=b, dh=80)
    before = _row_counts()
    got = fa.flash_attention(q, k, v, want_attn=True, n_real=257)
    ref = fa.flash_attention_reference(q, k, v, want_attn=True, n_real=257)
    torch.cuda.synchronize()
    assert _row_counts() == (before[0], before[1] + 1, before[2])
    _check(got, ref, torch.bfloat16)
    assert torch.all(got[1][..., 257:] == 0)


@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("n", [257, 2810])
def test_bf16_heads_off_the_grid_take_the_fma_kernels(cuda, dh, n):
    """bf16 heads 64 or 80 wide whose rows sit 8 bytes off the 16-byte
    grid: the FMA kernel of the branch runs (row-resident at N=257, online
    at 2810, maps off), the tensor-core route never."""
    q, k, v = _qkv_views(1, n, 4, torch.bfloat16, cuda, seed=n, pad=4, dh=dh)
    before = _online_counts() + _row_counts()[1:]
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    online = n > fa.ROWFULL_MAX_N
    # (row-resident FMA, online FMA, online mma, online tf32, mma, tf32)
    step = (int(not online), int(online), 0, 0, 0, 0)
    assert _online_counts() + _row_counts()[1:] == tuple(
        x + d for x, d in zip(before, step))
    ref = (fa.flash_attention_online_reference(q, k, v) if online
           else fa.flash_attention_reference(q, k, v)[0])
    _check((got[0],), (ref,), torch.bfloat16)


@pytest.mark.parametrize("n", [1374, 197])
def test_flash_fma_kernel_takes_misaligned_bf16(cuda, n):
    """bf16 heads of 64 off the 16-byte grid: ``mma_route`` refuses them,
    so the FMA kernel runs; the tensor-core wrapper called on them
    raises."""
    q, k, v = _qkv_views(1, n, 6, torch.bfloat16, cuda, seed=n, pad=4)
    before = _row_counts()
    got = fa.flash_attention(q, k, v, want_attn=True)
    ref = fa.flash_attention_reference(q, k, v, want_attn=True)
    torch.cuda.synchronize()
    assert _row_counts() == (before[0] + 1, before[1], before[2])
    _check(got, ref, torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_mma(q, k, v)


def test_flash_mma_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 300, 64), torch.float32, cuda)
    with pytest.raises(ValueError, match="bf16 heads 64 or 80 wide"):
        fa.flash_attention_mma(q, k, v)  # f32 stays on FMA
    q, k, v = _qkv((1, 2, 300, 128), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="bf16 heads 64 or 80 wide"):
        fa.flash_attention_mma(q, k, v)
    q, k, v = _qkv((1, 2, 300, 72), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_mma(*(t[..., 1:65] for t in (q, k, v)))
    q, k, v = _qkv((1, 1, fa.ROWFULL_MAX_N + 8, 64), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="does not take"):
        fa.flash_attention_mma(q, k, v)


# the row-resident kernel in f32 on split TF32: dinov2_s14_reg @518 (N=1374;
# B=1 takes each key tile in two parts, B=2 in one), vit_l16 @384 (N=577),
# vit_b16 (N=197), ragged small N and the longest row-resident N; heads 80
# wide: vit_h14 @224 (N=257, B=1 two parts, B=2 one), @448 (N=1025) and
# ragged small N
TF32_ROW_SHAPES = [(1, 6, 1374, 64), (2, 6, 1374, 64), (1, 16, 577, 64),
                   (2, 12, 197, 64), (3, 2, 17, 64), (1, 2, 2048, 64),
                   (1, 16, 257, 80), (2, 16, 257, 80), (1, 16, 1025, 80),
                   (3, 2, 17, 80)]


@pytest.mark.parametrize("shape", TF32_ROW_SHAPES)
@pytest.mark.parametrize("want_attn", [False, True])
def test_flash_tf32_kernel_matches_plain(cuda, shape, want_attn):
    b, h, n, dh = shape
    q, k, v = _qkv_views(b, n, h, torch.float32, cuda, seed=n + 1, dh=dh)
    before = _row_counts()
    got = fa.flash_attention(q, k, v, want_attn=want_attn)
    torch.cuda.synchronize()
    assert _row_counts() == (before[0], before[1], before[2] + 1)
    ref = fa.flash_attention_reference(q, k, v, want_attn=want_attn)
    _check(got, ref, torch.float32)
    assert not _within(got[0] * 0.5, ref[0], 0, torch.float32)


# B=1 at N=1408 is one block an SM (two key parts), B=2 more (one part)
@pytest.mark.parametrize("dh", fa.TF32_DHS)
@pytest.mark.parametrize("b,n,n_real", [(1, 1408, 1374), (2, 1408, 1374),
                                        (1, 208, 197), (1, 130, 100)])
def test_flash_tf32_masks_keys_beyond_n_real(cuda, b, n, n_real, dh):
    q, k, v = _qkv_views(b, n, 6, torch.float32, cuda, seed=n_real + 1,
                         dh=dh)
    before = _row_counts()
    got = fa.flash_attention(q, k, v, want_attn=True, n_real=n_real)
    ref = fa.flash_attention_reference(q, k, v, want_attn=True,
                                       n_real=n_real)
    torch.cuda.synchronize()
    assert _row_counts() == (before[0], before[1], before[2] + 1)
    _check(got, ref, torch.float32)
    assert torch.all(got[1][..., n_real:] == 0)


@pytest.mark.parametrize("dh", fa.TF32_DHS)
@pytest.mark.parametrize("n", [1374, 197])
def test_flash_fma_kernel_takes_misaligned_f32(cuda, n, dh):
    """f32 heads of 64 or 80 off the 16-byte grid: ``tf32_route`` refuses
    them, so the FMA kernel runs; the split-TF32 wrapper called on them
    raises."""
    q, k, v = _qkv_views(1, n, 6, torch.float32, cuda, seed=n, pad=2, dh=dh)
    before = _row_counts()
    got = fa.flash_attention(q, k, v, want_attn=True)
    ref = fa.flash_attention_reference(q, k, v, want_attn=True)
    torch.cuda.synchronize()
    assert _row_counts() == (before[0] + 1, before[1], before[2])
    _check(got, ref, torch.float32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_tf32x3(q, k, v)


def test_flash_tf32_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 300, 64), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="f32 heads 64 or 80 wide"):
        fa.flash_attention_tf32x3(q, k, v)  # bf16 has its own route
    q, k, v = _qkv((1, 2, 300, 80), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="f32 heads 64 or 80 wide"):
        fa.flash_attention_tf32x3(q, k, v)  # bf16 at 80: the FMA kernel
    q, k, v = _qkv((1, 2, 300, 128), torch.float32, cuda)
    with pytest.raises(ValueError, match="f32 heads 64 or 80 wide"):
        fa.flash_attention_tf32x3(q, k, v)
    q, k, v = _qkv((1, 2, 300, 72), torch.float32, cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_tf32x3(*(t[..., 1:65] for t in (q, k, v)))
    q, k, v = _qkv((1, 1, fa.ROWFULL_MAX_N + 8, 64), torch.float32, cuda)
    with pytest.raises(ValueError, match="does not take"):
        fa.flash_attention_tf32x3(q, k, v)


# the online kernel in f32 on split TF32: dinov2_s14_reg@742 (B=1 and 2),
# just above ROWFULL_MAX_N, ragged small N; heads 80 wide: vit_h14@742
# (N=2810), just above ROWFULL_MAX_N, ragged small N
TF32_SHAPES = [(1, 6, 2814, 64), (2, 6, 2814, 64), (2, 2, 2049, 64),
               (3, 3, 17, 64), (1, 2, 197, 64), (1, 16, 2810, 80),
               (2, 2, 2049, 80), (3, 3, 17, 80)]


@pytest.mark.parametrize("shape", TF32_SHAPES)
@pytest.mark.parametrize("n_real", [None, -40])
def test_online_tf32_kernel_matches_plain(cuda, shape, n_real):
    b, h, n, dh = shape
    q, k, v = _qkv_views(b, n, h, torch.float32, cuda, seed=n + h, dh=dh)
    n_real = None if n_real is None else max(1, n + n_real)
    before = _online_counts()
    got = fa.flash_attention_online(q, k, v, n_real)
    torch.cuda.synchronize()
    assert _online_counts() == (before[0], before[1], before[2],
                                before[3] + 1)
    for block_k in (fa.ONLINE_TF32_BLOCK_K[dh], fa.ONLINE_BLOCK_K):
        ref = fa.flash_attention_online_reference(q, k, v, n_real,
                                                  block_k=block_k)
        _check((got,), (ref,), torch.float32)
    assert not _within(got * 0.5, ref, 0, torch.float32)


@pytest.mark.parametrize("dh", fa.TF32_DHS)
def test_online_fma_kernel_takes_misaligned_f32(cuda, dh):
    """f32 heads of 64 or 80 whose token stride is off the 16-byte grid:
    ``tf32_route`` refuses them, so the FMA kernel runs; the split-TF32
    wrapper called on them raises."""
    q, k, v = _qkv_views(1, 2100, 2, torch.float32, cuda, seed=4, pad=2,
                         dh=dh)
    before = _online_counts()
    got = fa.flash_attention_online(q, k, v)
    ref = fa.flash_attention_online_reference(q, k, v)
    torch.cuda.synchronize()
    assert _online_counts() == (before[0], before[1] + 1, before[2],
                                before[3])
    _check((got,), (ref,), torch.float32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_online_tf32x3(q, k, v)


def test_online_tf32_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 300, 64), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="f32 heads 64 or 80 wide"):
        fa.flash_attention_online_tf32x3(q, k, v)  # bf16 has its own route
    q, k, v = _qkv((1, 2, 300, 80), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="f32 heads 64 or 80 wide"):
        fa.flash_attention_online_tf32x3(q, k, v)
    q, k, v = _qkv((1, 2, 300, 128), torch.float32, cuda)
    with pytest.raises(ValueError, match="f32 heads 64 or 80 wide"):
        fa.flash_attention_online_tf32x3(q, k, v)
    q, k, v = _qkv((1, 2, 300, 72), torch.float32, cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_online_tf32x3(*(t[..., 1:65] for t in (q, k, v)))


# s8 block: vit_b16 (B=1 and 8), vit_t16@256 (N=257, near the s8 envelope)
# and a ragged small block
S8_SHAPES = [(1, 197, 768, 12), (8, 197, 768, 12), (1, 257, 192, 3),
             (3, 17, 64, 4)]


@pytest.mark.parametrize("shape", S8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["maps_off", "maps_mean", "subset",
                                  "exact_softmax"])
@pytest.mark.parametrize("int8_pv", [True, False])
def test_s8_block_matches_plain(cuda, shape, dtype, mode, int8_pv):
    b, n, d, heads = shape
    x, p = _block(b, n, d, heads, dtype, cuda)
    kw = {
        "maps_off": {},
        "maps_mean": {"want_attn": True, "want_mean": True},
        "subset": {"want_attn": True,
                   "attn_heads": (heads - 1, 0) if heads > 1 else (0,)},
        "exact_softmax": {"want_attn": True, "fast_softmax": False},
    }[mode]
    wrapper = _row1_wrapper(x, p, heads, s8=True)
    before = (fb.fused_attn_block.launches, wrapper.launches)
    got = fb.fused_attn_block_s8(x, p, heads, 1e-6, int8_pv=int8_pv, **kw)
    torch.cuda.synchronize()
    assert (fb.fused_attn_block.launches,
            wrapper.launches) == (before[0], before[1] + 1)
    ref = fb.fused_attn_block_reference(x, p, heads, 1e-6, int8_scores=True,
                                        int8_pv=int8_pv, **kw)
    _check(got, ref, dtype, s8=True)


def _w8a8_case(shape, dtype, device, md=None):
    from interactive_vit_tpu_torch.ops import quant

    x, p = _mlp_case(shape, dtype, device, md)
    for name in ("fc1_w", "fc2_w"):
        p[name] = quant.quantize_weight(p[name], "w8a8")
    return x, p


def _check_w8a8(x, p, got, parts, dtype):
    from interactive_vit_tpu_torch.ops import quant

    ref, rparts = fm.fused_mlp_w8a8_parts(x, p)
    q1_rows = (parts["q1"] == rparts["q1"]).all(dim=-1, keepdim=True)
    for acc, q, w, most in (("acc1", "q1", "fc1_w", 1),
                            ("acc2", "q2", "fc2_w", 2)):
        exact = quant.int_matmul(parts[q], p[w][quant.AQKEY])
        assert torch.equal(parts[acc], exact), acc
        assert not torch.equal(parts[acc] // 2, exact)
        diff = (parts[q].int() - rparts[q].int()).abs()
        assert (diff * q1_rows).max().item() <= most, q
        assert (diff > 0).float().mean().item() <= 0.01, q
    _check((got,), (ref,), dtype, s8=True)
    assert not _within(x, ref, 0, dtype, s8=True)
    assert not _within(got * 0.5, ref, 0, dtype, s8=True)


@pytest.mark.parametrize("shape", [(1, 197, 768), (8, 197, 768),
                                   (1, 17, 100), (2, 50, 1280), (1, 3, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_mlp_kernel_matches_plain(cuda, shape, dtype):
    x, p = _w8a8_case(shape, dtype, cuda)
    route = fm._w8a8_route_of(x, p)
    before = _w8a8_counts()
    got, parts = fm.fused_mlp_w8a8_block(x, p, want_parts=True)
    torch.cuda.synchronize()
    after = _w8a8_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}
    assert torch.equal(got, fm.fused_mlp_w8a8_block(x, p))
    _check_w8a8(x, p, got, parts, dtype)


def _w8a8_counts():
    return {"dp4a": fm.fused_mlp_w8a8_block.launches,
            "mma": fm.fused_mlp_w8a8_block_mma.launches}


def _shifted_copy(t):
    """A contiguous copy of ``t`` one element into its storage: its base off
    the 16-byte grid, the same values."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


# the W8A8 MLP on the int8 tensor cores: vit_b16 (B=1 and 8, a cluster of
# 8 blocks) and a small ragged block (d=384, a cluster of 4)
@pytest.mark.parametrize("shape", [(1, 197, 768), (8, 197, 768),
                                   (2, 17, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_mma_kernel_matches_plain(cuda, shape, dtype):
    """Exact integer stages, y within its bound, two calls the same bits;
    the same values off the 16-byte grid go to the __dp4a kernel."""
    x, p = _w8a8_case(shape, dtype, cuda)
    assert fm._w8a8_route_of(x, p) == "mma"
    for xr, route in ((x, "mma"), (_shifted_copy(x), "dp4a")):
        before = _w8a8_counts()
        got, parts = fm.fused_mlp_w8a8_block(xr, p, want_parts=True)
        again = fm.fused_mlp_w8a8_block(xr, p)
        torch.cuda.synchronize()
        after = _w8a8_counts()
        assert {k: after[k] - before[k] for k in after} == {
            k: 2 * int(k == route) for k in after}
        assert torch.equal(got, again)
        _check_w8a8(xr, p, got, parts, dtype)


# the W8A8 MLP at chunks of 96 columns: swin_t's stages 0 (3136 x 96,
# hidden 384, a cluster of 4) and 1 (784 x 192, hidden 768, a cluster of 8),
# fc2's k one slice of 96 in both; a short block of each width too
@pytest.mark.parametrize("shape", [(1, 3136, 96), (2, 784, 192),
                                   (1, 17, 96), (3, 5, 192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_mma96_kernel_matches_plain(cuda, shape, dtype):
    """The narrow chunk's tensor-core route: exact integer stages, y within
    its bound, two calls the same bits; off the 16-byte grid the __dp4a
    kernel."""
    x, p = _w8a8_case(shape, dtype, cuda)
    d = shape[-1]
    assert fm.chunk_of(d) == fm.MMA_NARROW_CHUNK
    assert fm.cluster_of(d, 4 * d) == {96: 4, 192: 8}[d]
    for xr, route in ((x, "mma"), (_shifted_copy(x), "dp4a")):
        assert fm._w8a8_route_of(xr, p) == route
        before = _w8a8_counts()
        narrow = fm.fused_mlp_w8a8_block_mma.narrow_launches
        got, parts = fm.fused_mlp_w8a8_block(xr, p, want_parts=True)
        again = fm.fused_mlp_w8a8_block(xr, p)
        torch.cuda.synchronize()
        after = _w8a8_counts()
        assert {k: after[k] - before[k] for k in after} == {
            k: 2 * int(k == route) for k in after}
        assert (fm.fused_mlp_w8a8_block_mma.narrow_launches - narrow
                == 2 * int(route == "mma"))
        assert torch.equal(got, again)
        _check_w8a8(xr, p, got, parts, dtype)


def test_w8a8_mma_wrapper_refuses_other_operands(cuda):
    """The tensor-core wrapper raises on operands its route does not take;
    nothing falls back."""
    x, p = _w8a8_case((1, 17, 768), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="fused_mlp_w8a8_block_mma takes"):
        fm.fused_mlp_w8a8_block_mma(_shifted_copy(x), p)
    narrow, pn = _w8a8_case((1, 17, 100), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="fused_mlp_w8a8_block_mma takes"):
        fm.fused_mlp_w8a8_block_mma(narrow, pn)
    wide, pw = _w8a8_case((1, 5, 1280), torch.float32, cuda)
    with pytest.raises(ValueError, match="fused_mlp_w8a8_block_mma takes"):
        fm.fused_mlp_w8a8_block_mma(wide, pw)  # f32 h over 227 KB


@pytest.mark.parametrize("route,dtype", [("mma", torch.bfloat16),
                                         ("w8a8", torch.bfloat16),
                                         ("w8a8", torch.float32)])
def test_mma_clusters_fit_the_card(cuda, route, dtype):
    """At vit_b16 the card holds at least one cluster of 8 blocks of each
    tensor-core MLP kernel (one block an SM)."""
    assert fm.max_active_clusters(route, 768, 3072, dtype) >= 1


def test_w8a8_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, p = _w8a8_case((2, 17, 64), torch.bfloat16, cuda)
    with pytest.raises(TypeError):
        fm.fused_mlp_w8a8_block(x.half(), p)
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_mlp_w8a8_block(x.transpose(0, 1), p)
    with pytest.raises(ValueError, match="W8A8 leaf-dict"):
        fm.fused_mlp_w8a8_block(x, {**p, "fc1_w": p["fc1_w"]["int8a8_q"]})
    with pytest.raises(ValueError):
        fm.fused_mlp_w8a8_block(x, {**p, "fc2_b": p["fc2_b"].float()})


# window attention: (batch, map side, width, heads, window) -- swin_t's
# four stages, a swin_b stage, window 12 (T=144, the 384 px models), and
# a tiny ragged geometry (T=16 is less than a warp)
WINDOW_SHAPES = [(2, 56, 96, 3, 7), (1, 28, 192, 6, 7), (1, 14, 384, 12, 7),
                 (2, 7, 768, 24, 7), (1, 14, 512, 16, 7), (1, 24, 128, 4, 12),
                 (3, 8, 16, 2, 4)]


def _window_case(shape, dtype, device, shifted):
    from interactive_vit_tpu_torch.models import swin

    b, res, c, heads, win = shape
    g = torch.Generator().manual_seed(res + c)

    def rnd(*s, std=1.0):
        return (torch.randn(s, generator=g) * std).to(device=device,
                                                      dtype=dtype)

    p = {"qkv_w": rnd(c, 3 * c, std=c ** -0.5), "qkv_b": rnd(3 * c, std=0.1),
         "proj_w": rnd(c, c, std=c ** -0.5), "proj_b": rnd(c, std=0.1)}
    t = win * win
    mask = swin.shift_attn_mask(res, win, win // 2) if shifted else None
    return rnd(b, res, res, c), p, rnd(heads, t, t, std=0.5), mask


@pytest.mark.parametrize("shape", WINDOW_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["maps_off", "maps_on", "shifted_off",
                                  "shifted_on", "exact_softmax"])
def test_window_kernel_matches_plain(cuda, shape, dtype, mode):
    b, res, c, heads, win = shape
    shifted = mode.startswith("shifted")
    if shifted and res == win:
        pytest.skip("one window per map: the shift clamps to 0, no mask")
    y, p, bias, mask = _window_case(shape, dtype, cuda, shifted)
    kw = {"want_attn": mode in ("maps_on", "shifted_on", "exact_softmax"),
          "fast_softmax": mode != "exact_softmax"}
    # heads 32 wide in windows of up to 64 tokens on the tensor cores
    route = "fma" if c // heads != 32 or win > 8 else (
        "mma" if dtype == torch.bfloat16 else "tf32")
    assert fw._window_route_of(y, p, heads, win) == route
    before = _window_counts()
    got = fw.fused_window_attn(y, p, heads, win, bias, mask, **kw)
    torch.cuda.synchronize()
    want = dict(before, **{route: before[route] + 1})
    assert _window_counts() == want
    ref = fw.fused_window_attn_reference(y, p, heads, win, bias, mask, **kw)
    assert got[0].shape == y.shape and got[0].dtype == dtype
    _check(got, ref, dtype)
    if kw["want_attn"]:
        t = win * win
        assert got[1].shape == (b, (res // win) ** 2, heads, t, t)
        if shifted:  # seam pairs: exp(-100) is 0 in bf16, a denormal in f32
            blocked = torch.as_tensor(mask, device=cuda)[None, :, None] < 0
            seam = got[1].float()[blocked.expand_as(got[1])]
            assert seam.numel() > 0 and bool((seam < 1e-37).all())
            if dtype == torch.bfloat16:
                assert bool((seam == 0).all())


def _window_counts():
    return {route: w.launches for route, w in fw._WINDOW_WRAPPERS.items()}


def _check_window(got, ref, dtype, mask, shape):
    """The branch output and the tap within their bounds, and the seam
    pairs of a shifted block at exactly 0 in bf16 (a denormal in f32)."""
    b, res, c, heads, win = shape
    _check(got, ref, dtype)
    t = win * win
    assert got[1].shape == (b, (res // win) ** 2, heads, t, t)
    if mask is not None:
        blocked = torch.as_tensor(mask, device=got[1].device)[None, :, None] < 0
        seam = got[1].float()[blocked.expand_as(got[1])]
        assert seam.numel() > 0 and bool((seam < 1e-37).all())
        if dtype == torch.bfloat16:
            assert bool((seam == 0).all())


@pytest.mark.parametrize("shape", WINDOW_SHAPES[:4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [True, False])
def test_window_tc_routes_match_plain(cuda, shape, dtype, fast):
    """Each tensor-core route's own wrapper at swin_t's four stages, shifted
    (the seam mask) where the stage has more than one window, maps on;
    only that route's count moves."""
    b, res, c, heads, win = shape
    y, p, bias, mask = _window_case(shape, dtype, cuda, res > win)
    route = "mma" if dtype == torch.bfloat16 else "tf32"
    wrapper = fw._WINDOW_WRAPPERS[route]
    kw = {"want_attn": True, "fast_softmax": fast}
    before = _window_counts()
    got = wrapper(y, p, heads, win, bias, mask, **kw)
    torch.cuda.synchronize()
    assert _window_counts() == dict(before, **{route: before[route] + 1})
    _check_window(got, fw.fused_window_attn_reference(y, p, heads, win, bias,
                                                      mask, **kw),
                  dtype, mask, shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_off_the_grid_takes_the_fma_kernel(cuda, dtype):
    """y one element into its storage (2 or 4 bytes off the 16-byte grid):
    the FMA kernel, with the plain version's results within the bounds;
    each tensor-core wrapper refuses it."""
    shape = WINDOW_SHAPES[2]
    b, res, c, heads, win = shape
    y, p, bias, mask = _window_case(shape, dtype, cuda, True)
    flat = torch.empty(y.numel() + 1, dtype=dtype, device=cuda)
    yo = flat[1:].view(y.shape)
    yo.copy_(y)
    assert fw._window_route_of(yo, p, heads, win) == "fma"
    before = _window_counts()
    got = fw.fused_window_attn(yo, p, heads, win, bias, mask, want_attn=True)
    torch.cuda.synchronize()
    assert _window_counts() == dict(before, fma=before["fma"] + 1)
    _check_window(got, fw.fused_window_attn_reference(
        y, p, heads, win, bias, mask, want_attn=True), dtype, mask, shape)
    for route in ("mma", "tf32"):
        with pytest.raises(ValueError, match="16-byte"):
            fw._WINDOW_WRAPPERS[route](yo, p, heads, win, bias, mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("want_attn", [False, True])
def test_window_tc_routes_give_the_same_bits_twice(cuda, dtype, want_attn):
    shape = WINDOW_SHAPES[1]
    b, res, c, heads, win = shape
    y, p, bias, mask = _window_case(shape, dtype, cuda, True)
    first = fw.fused_window_attn(y, p, heads, win, bias, mask,
                                 want_attn=want_attn)
    second = fw.fused_window_attn(y, p, heads, win, bias, mask,
                                  want_attn=want_attn)
    torch.cuda.synchronize()
    for f, s in zip(first, second):
        assert (f is None and s is None) or torch.equal(f, s)


def test_window_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    y, p, bias, _ = _window_case((2, 8, 16, 2, 4), torch.float32, cuda,
                                 False)
    with pytest.raises(TypeError):
        fw.fused_window_attn(y.half(), {k: v.half() for k, v in p.items()},
                             2, 4, bias)
    with pytest.raises(ValueError, match="contiguous"):
        fw.fused_window_attn(y.transpose(1, 2), p, 2, 4, bias)
    with pytest.raises(ValueError):
        fw.fused_window_attn(y, {**p, "qkv_w": p["qkv_w"].cpu()}, 2, 4, bias)
    with pytest.raises(ValueError, match="does not take"):
        fw.fused_window_attn(y, p, 3, 4, bias)  # width does not split
    with pytest.raises(ValueError, match="bias must be"):
        fw.fused_window_attn(y, p, 2, 4, bias[:1])
    with pytest.raises(ValueError, match="mask must be"):
        fw.fused_window_attn(y, p, 2, 4, bias, torch.zeros((3, 16, 16)))


# fused MLP: (batch, tokens, width) -- vit_b16, swin_t's stages 0 and 3,
# the widest row the kernel takes, and widths that are no multiple of 32
# or of the thread block
MLP_SHAPES = [(2, 197, 768), (1, 3136, 96), (1, 49, 768), (1, 196, 384),
              (2, 50, 1280), (1, 17, 100), (3, 5, 300)]


def _mlp_case(shape, dtype, device, md=None):
    b, n, d = shape
    md = md or 4 * d
    g = torch.Generator().manual_seed(n + d)

    def rnd(*s, std=1.0, mean=0.0):
        return (torch.randn(s, generator=g) * std + mean).to(device=device,
                                                             dtype=dtype)

    p = {"ln2_s": rnd(d, std=0.1, mean=1.0), "ln2_b": rnd(d, std=0.1),
         "fc1_w": rnd(d, md, std=d ** -0.5), "fc1_b": rnd(md, std=0.1),
         "fc2_w": rnd(md, d, std=md ** -0.5), "fc2_b": rnd(d, std=0.1)}
    return rnd(b, n, d), p


@pytest.mark.parametrize("shape", MLP_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_mlp_kernel_matches_plain(cuda, shape, dtype, eps):
    x, p = _mlp_case(shape, dtype, cuda)
    route = fm._mlp_route_of(x, p)
    before = _mlp_counts()
    got = fm.fused_mlp_block(x, p, eps)
    torch.cuda.synchronize()
    after = _mlp_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}
    ref = fm.fused_mlp_block_reference(x, p, eps)
    assert got.shape == x.shape and got.dtype == dtype
    _check((got,), (ref,), dtype)
    # the bound must refuse a kernel that returned the residual alone
    assert not _within(x, ref, 0, dtype)


def _mlp_counts():
    return {"fma": fm.fused_mlp_block.launches,
            "mma": fm.fused_mlp_block_mma.launches,
            "tf32": fm.fused_mlp_block_tf32x3.launches}


# the bf16 MLP on the tensor cores: vit_b16 (B=1 and 8), swin_t's stage 2
# (a cluster of 4) and stage 3, and a small ragged block
@pytest.mark.parametrize("shape", [(1, 197, 768), (8, 197, 768),
                                   (1, 196, 384), (2, 49, 768), (3, 17, 256)])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_mlp_mma_kernel_matches_plain(cuda, shape, eps):
    """y within the bf16 bound, two calls the same bits (fc2's partials
    are added in rank order); the same values off the 16-byte grid go to
    the FMA kernel."""
    x, p = _mlp_case(shape, torch.bfloat16, cuda)
    ref = fm.fused_mlp_block_reference(x, p, eps)
    assert fm._mlp_route_of(x, p) == "mma"
    for xr, route in ((x, "mma"), (_shifted_copy(x), "fma")):
        before = _mlp_counts()
        got = fm.fused_mlp_block(xr, p, eps)
        again = fm.fused_mlp_block(xr, p, eps)
        torch.cuda.synchronize()
        after = _mlp_counts()
        assert {k: after[k] - before[k] for k in after} == {
            k: 2 * int(k == route) for k in after}
        assert torch.equal(got, again)
        _check((got,), (ref,), torch.bfloat16)
        assert not _within(xr, ref, 0, torch.bfloat16)


# rows over 1024 wide on the tensor-core routes (72 16-column units of
# LayerNorm: lanes 0-7 own three), and ln2_s / ln2_b off the 16-byte grid
# (read 16 bytes at a time there), which go to the FMA and __dp4a kernels
@pytest.mark.parametrize("shape,md", [((1, 197, 1152), 1024),
                                      ((2, 17, 1152), 512)])
@pytest.mark.parametrize("w8a8", [False, True])
def test_mma_routes_take_rows_over_1024_wide(cuda, shape, md, w8a8):
    case, plain, fn, counts = (
        (_w8a8_case, fm.fused_mlp_w8a8_reference, fm.fused_mlp_w8a8_block,
         _w8a8_counts) if w8a8 else
        (_mlp_case, fm.fused_mlp_block_reference, fm.fused_mlp_block,
         _mlp_counts))
    x, p = case(shape, torch.bfloat16, cuda, md)
    old = "dp4a" if w8a8 else "fma"
    assert (fm._w8a8_route_of if w8a8 else fm._mlp_route_of)(x, p) == "mma"
    ref = plain(x, p)
    for pr, route in ((p, "mma"), ({**p, "ln2_s": _shifted_copy(p["ln2_s"])},
                                   old),
                      ({**p, "ln2_b": _shifted_copy(p["ln2_b"])}, old)):
        before = counts()
        got = fn(x, pr)
        again = fn(x, pr)
        torch.cuda.synchronize()
        after = counts()
        assert {k: after[k] - before[k] for k in after} == {
            k: 2 * int(k == route) for k in after}
        assert torch.equal(got, again)
        _check((got,), (ref,), torch.bfloat16, s8=w8a8)
    if w8a8:
        got, parts = fn(x, p, want_parts=True)
        _check_w8a8(x, p, got, parts, torch.bfloat16)


def test_mlp_mma_wrapper_refuses_other_operands(cuda):
    """The tensor-core wrapper raises on f32, on rows that are whole chunks
    of neither 128 nor 96 columns and on operands off the grid; nothing
    falls back."""
    x, p = _mlp_case((1, 17, 768), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="fused_mlp_block_mma takes"):
        fm.fused_mlp_block_mma(_shifted_copy(x), p)
    xf, pf = _mlp_case((1, 17, 768), torch.float32, cuda)
    with pytest.raises(ValueError, match="fused_mlp_block_mma takes"):
        fm.fused_mlp_block_mma(xf, pf)
    narrow, pn = _mlp_case((1, 17, 160), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="fused_mlp_block_mma takes"):
        fm.fused_mlp_block_mma(narrow, pn)


# row 6 at chunks of 96 (bf16) and on split TF32 (f32): swin_t's four
# stages (stages 0 and 1 on chunks of 96), vit_b16 at B=1 and 8, and small
# ragged blocks at both chunks
TC_MLP_SHAPES = [(1, 3136, 96), (1, 784, 192), (8, 784, 192), (1, 196, 384),
                 (1, 49, 768), (1, 197, 768), (8, 197, 768), (2, 17, 96),
                 (3, 9, 192), (3, 17, 256)]


@pytest.mark.parametrize("shape", TC_MLP_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_tc_routes_match_plain(cuda, shape, dtype):
    """bf16 on the tensor cores (chunks of 128 or 96), f32 on split TF32:
    y within its dtype's bound (f32 1e-4), two calls the same bits (fc2's
    partials added in rank order), only the route's count moving; the
    same values off the 16-byte grid go to the FMA kernel."""
    x, p = _mlp_case(shape, dtype, cuda)
    eps = 1e-5
    ref = fm.fused_mlp_block_reference(x, p, eps)
    route = "tf32" if dtype == torch.float32 else "mma"
    assert fm._mlp_route_of(x, p) == route
    for xr, rt in ((x, route), (_shifted_copy(x), "fma")):
        before = _mlp_counts()
        got = fm.fused_mlp_block(xr, p, eps)
        again = fm.fused_mlp_block(xr, p, eps)
        torch.cuda.synchronize()
        after = _mlp_counts()
        assert {k: after[k] - before[k] for k in after} == {
            k: 2 * int(k == rt) for k in after}
        if rt != "fma":
            assert torch.equal(got, again)
        _check((got,), (ref,), dtype)
        assert not _within(xr, ref, 0, dtype)


def test_mlp_tf32_wrapper_counts_and_refuses(cuda):
    """The split-TF32 wrapper counts its own launches and raises on bf16,
    on operands off the grid, on rows of neither chunk and on a block over
    the card's shared memory (vit_h14's rows, which the FMA kernel keeps);
    nothing falls back."""
    x, p = _mlp_case((1, 17, 768), torch.float32, cuda)
    before = _mlp_counts()
    got = fm.fused_mlp_block_tf32x3(x, p)
    torch.cuda.synchronize()
    assert {k: _mlp_counts()[k] - before[k] for k in before} == {
        "fma": 0, "mma": 0, "tf32": 1}
    _check((got,), (fm.fused_mlp_block_reference(x, p),), torch.float32)
    with pytest.raises(ValueError, match="fused_mlp_block_tf32x3 takes"):
        fm.fused_mlp_block_tf32x3(_shifted_copy(x), p)
    xb, pb = _mlp_case((1, 17, 768), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="fused_mlp_block_tf32x3 takes"):
        fm.fused_mlp_block_tf32x3(xb, pb)
    xn, pn = _mlp_case((1, 17, 160), torch.float32, cuda)
    with pytest.raises(ValueError, match="fused_mlp_block_tf32x3 takes"):
        fm.fused_mlp_block_tf32x3(xn, pn)
    xh, ph = _mlp_case((1, 5, 1280), torch.float32, cuda)
    with pytest.raises(ValueError, match="fused_mlp_block_tf32x3 takes"):
        fm.fused_mlp_block_tf32x3(xh, ph)
    before = _mlp_counts()
    got = fm.fused_mlp_block(xh, ph)
    torch.cuda.synchronize()
    assert {k: _mlp_counts()[k] - before[k] for k in before} == {
        "fma": 1, "mma": 0, "tf32": 0}
    _check((got,), (fm.fused_mlp_block_reference(xh, ph),), torch.float32)


def test_mlp_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, p = _mlp_case((2, 17, 64), torch.float32, cuda)
    with pytest.raises(TypeError):
        fm.fused_mlp_block(x.half(), {k: v.half() for k, v in p.items()})
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_mlp_block(x.transpose(0, 1), p)
    with pytest.raises(ValueError):
        fm.fused_mlp_block(x, {**p, "fc1_w": p["fc1_w"].cpu()})
    with pytest.raises(ValueError, match="must be"):
        fm.fused_mlp_block(x, {**p, "fc2_b": p["fc2_b"][:8]})
    wide, pw = _mlp_case((1, 2, 1284), torch.float32, cuda)
    with pytest.raises(ValueError, match="does not take"):
        fm.fused_mlp_block(wide, pw)


# -- the trainable attention: forward and backward, both layouts ---------------


def _grad_within(got, ref, dtype):
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    scale = r.abs().max().item()
    if dtype == torch.float32:
        return err.max().item() <= 1e-5 * scale
    return bool((err <= 2.0 ** -6 * r.abs() + 2.0 ** -8 * scale).all())


def _check_grads(got, ref, dtype):
    """o and the gradients within their bounds; each bound refuses the
    tensor zeroed or halved."""
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.dtype == r.dtype, i
        assert _grad_within(g, r, dtype), i
        assert not _grad_within(g * 0.5, r, dtype), i
        assert not _grad_within(torch.zeros_like(g), r, dtype), i


# (B, H, N, dh, n_real): vit_b16's and vit_t16's train shapes, keys masked
# beyond 197 of 208, vit_l16@384's N=577, ragged small shapes, dh=128,
# TRAIN_MAX_N, B=1 and 8, vit_h14's heads (80 wide, N=257, and keys masked
# beyond 257 of 272: the tensor cores in both dtypes on the grid) (dh=64
# and 80 run on the tensor cores)
TRAIN_SHAPES = [(4, 12, 197, 64, None), (4, 3, 197, 64, None),
                (8, 3, 197, 64, None), (1, 3, 197, 64, None),
                (2, 2, 208, 64, 197), (2, 4, 577, 64, None),
                (3, 2, 17, 64, None), (3, 2, 17, 16, None),
                (1, 2, 300, 128, None), (1, 1, 1024, 64, None),
                (2, 4, 257, 80, None), (2, 2, 272, 80, 257),
                (3, 2, 17, 80, None)]


def _train_counts(fn):
    return (fn.fwd_launches, fn.bwd_launches, fn.mma_fwd_launches,
            fn.mma_bwd_launches, fn.tf32_fwd_launches, fn.tf32_bwd_launches)


def _route(dtype, dh, pad=0):
    """The trainable attention's route: heads of its tensor-core kernels'
    widths (64 and 80: ``TRAIN_MMA_DHS`` in bf16, ``TRAIN_TF32_DHS`` in
    f32) on the 16-byte grid run on the tensor cores (bf16, or f32 on split
    TF32), the rest on FMA."""
    tc_dhs = (av.TRAIN_MMA_DHS if dtype == torch.bfloat16
              else av.TRAIN_TF32_DHS)
    if dh not in tc_dhs or pad:
        return "fma"
    return "mma" if dtype == torch.bfloat16 else "tf32"


def _after_one(before, route):
    """The counts after one forward + backward on the route "fma", "mma"
    or "tf32"."""
    step = {"fma": (1, 1, 0, 0, 0, 0), "mma": (0, 0, 1, 1, 0, 0),
            "tf32": (0, 0, 0, 0, 1, 1)}[route]
    return tuple(x + d for x, d in zip(before, step))


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", [0, 2])
def test_train_kernels_match_plain(cuda, shape, dtype, pad):
    """q, k, v as ``qkv_proj`` makes them (transposed views of one
    [B, N, 3D] tensor, its rows ``pad`` elements longer: 2 puts them off
    the 16-byte grid); o and its gradients against the plain versions."""
    b, h, n, dh, n_real = shape
    g = torch.Generator().manual_seed(n + dh)
    qkv = _off_grid(torch.randn((b, n, 3 * h * dh), generator=g).to(
        cuda, dtype), pad)
    do = torch.randn((b, h, n, dh), generator=g).to(cuda, dtype)
    q, k, v = (qkv.reshape(b, n, 3, h, dh)[:, :, i].transpose(1, 2)
               .detach().requires_grad_(True) for i in range(3))
    before = _train_counts(av.attention_train)
    o = av.attention_train(q, k, v, n_real)
    o.backward(do)
    torch.cuda.synchronize()
    assert _train_counts(av.attention_train) == _after_one(
        before, _route(dtype, dh, pad))
    ref_o = av.attention_train_reference(q.detach(), k.detach(), v.detach(),
                                         n_real)
    ref = av.head_grads_reference(q.detach(), k.detach(), v.detach(), do,
                                  n_real)
    _check_grads((o.detach(), q.grad, k.grad, v.grad), (ref_o, *ref), dtype)
    if n_real is not None:
        assert torch.all(k.grad[:, :, n_real:] == 0)
        assert torch.all(v.grad[:, :, n_real:] == 0)


# (B, N, H, n_real): vit_b16's train shape at B=4, 8 and 1, masked keys,
# N=577, a ragged one
PACKED_SHAPES = [(4, 197, 12, None), (8, 197, 12, None), (1, 197, 12, None),
                 (2, 208, 2, 197), (2, 577, 4, None), (3, 17, 4, None)]


@pytest.mark.parametrize("shape", PACKED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", [0, 2])
def test_packed_train_kernels_match_plain(cuda, shape, dtype, pad):
    b, n, h, n_real = shape
    d = h * av.PACKED_DH
    g = torch.Generator().manual_seed(n + h)
    qkv = _off_grid(torch.randn((b, n, 3 * d), generator=g).to(cuda, dtype),
                    pad).detach()
    do = torch.randn((b, n, d), generator=g).to(cuda, dtype)
    qkv.requires_grad_(True)
    before = _train_counts(av.attention_train_packed)
    o = av.attention_train_packed(qkv, n_real)
    o.backward(do)
    torch.cuda.synchronize()
    assert _train_counts(av.attention_train_packed) == _after_one(
        before, _route(dtype, av.PACKED_DH, pad))
    ref_o = av.attention_train_packed_reference(qkv.detach(), n_real)
    ref_g = av.packed_head_grads_reference(qkv.detach(), do, n_real)
    _check_grads((o.detach(), qkv.grad), (ref_o, ref_g), dtype)
    if n_real is not None:
        # the k and v columns of masked keys
        dk_dv = qkv.grad[:, n_real:].reshape(b, n - n_real, h, 3, -1)[:, :,
                                                                       :, 1:]
        assert torch.all(dk_dv == 0)


def test_train_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        av.attention_train(q, q, q)
    q = torch.zeros((1, 2, 8, 130), device=cuda)
    with pytest.raises(ValueError, match="do not take"):
        av.attention_train(q, q, q)


def test_trainable_mhsa_falls_back_by_shape(cuda):
    """Maps asked for, or N above TRAIN_MAX_N: the plain attention, no
    launch, as the JAX function chooses."""
    before = _train_counts(av.attention_train)
    q, k, v = _qkv((1, 2, av.TRAIN_MAX_N + 8, 64), torch.bfloat16, cuda)
    o, probs = av.trainable_flash_mhsa(q, k, v)
    assert probs is None
    q, k, v = _qkv((1, 2, 197, 64), torch.bfloat16, cuda)
    o, probs = av.trainable_flash_mhsa(q, k, v, want_attn=True)
    assert probs is not None
    torch.cuda.synchronize()
    assert _train_counts(av.attention_train) == before


# the tensor-core forwards' (m, l): only the order of the f32 sums differs
# from the plain statistics (scores over dh; l over N as a running sum), so
# m within 1e-5 of 1 + |m| and l within 1e-4 of itself; a halved l fails
STATS_M_REL = 1e-5
STATS_L_REL = 1e-4


def _stats_within(got, ref):
    m, l = got
    m_ref, l_ref = ref
    return bool(((m - m_ref).abs() <= STATS_M_REL * (1 + m_ref.abs())).all()
                and ((l - l_ref).abs() <= STATS_L_REL * l_ref).all())


@pytest.mark.parametrize("shape", [(4, 12, 197, 64, None),
                                   (2, 2, 208, 64, 197),
                                   (2, 4, 577, 64, None),
                                   (3, 2, 17, 64, None),
                                   (2, 16, 257, 80, None),
                                   (2, 2, 272, 80, 257)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_train_mma_forward_saves_the_row_statistics(cuda, shape, dtype):
    """Both tensor-core forwards (bf16 and split TF32) save (m, l), at
    heads 64 and 80 wide; the packed layout (heads 64 wide) the same."""
    b, h, n, dh, n_real = shape
    g = torch.Generator().manual_seed(n + 1)
    qkv = torch.randn((b, n, 3 * h * dh), generator=g).to(cuda, dtype)
    q, k, v = (qkv.reshape(b, n, 3, h, dh)[:, :, i].transpose(1, 2)
               for i in range(3))
    o, stats = av._fwd(q, k, v, n if n_real is None else n_real)
    torch.cuda.synchronize()
    assert stats is not None and stats.shape == (2, b, h, n)
    assert stats.dtype == torch.float32
    ref = av.row_stats_reference(q, k, n_real)
    assert _stats_within((stats[0], stats[1]), ref)
    assert not _stats_within((stats[0], stats[1] * 0.5), ref)
    if dh != av.PACKED_DH:
        return
    # the packed layout gives the same rows
    o_p, stats_p = av._packed_fwd(
        qkv.reshape(b, n, 3, h, dh).transpose(2, 3).reshape(b, n, 3 * h * dh),
        n if n_real is None else n_real)
    torch.cuda.synchronize()
    assert _stats_within((stats_p[0], stats_p[1]), ref)
    assert torch.equal(o_p, o.transpose(1, 2).reshape(b, n, h * dh))


def test_train_mma_routes_by_dtype_width_and_alignment(cuda):
    """bf16 at dh=64 or 80 on aligned views: the tensor cores; f32 at
    dh=64 or 80 on aligned views: split TF32; dh=128 and misaligned bf16 or
    f32 views: FMA; every route agrees with the plain version."""
    g = torch.Generator().manual_seed(5)
    cases = [((2, 3, 100, 64), torch.bfloat16, 0, "mma"),
             ((2, 3, 100, 64), torch.float32, 0, "tf32"),
             ((2, 3, 100, 128), torch.bfloat16, 0, "fma"),
             ((2, 3, 100, 64), torch.bfloat16, 4, "fma"),
             ((2, 3, 100, 64), torch.float32, 2, "fma"),
             # heads 80 wide (vit_h14's): each dtype's tensor cores on
             # the grid, the FMA pair off it
             ((2, 3, 100, 80), torch.float32, 0, "tf32"),
             ((2, 3, 100, 80), torch.bfloat16, 0, "mma"),
             ((2, 3, 100, 80), torch.float32, 2, "fma"),
             ((2, 3, 100, 80), torch.bfloat16, 4, "fma")]
    for (b, h, n, dh), dtype, pad, route in cases:
        x = torch.randn((b, n, 3 * h * dh + pad), generator=g).to(cuda, dtype)
        q, k, v = (x[..., :3 * h * dh].reshape(b, n, 3, h, dh)[:, :, i]
                   .transpose(1, 2).detach().requires_grad_(True)
                   for i in range(3))
        do = torch.randn((b, h, n, dh), generator=g).to(cuda, dtype)
        before = _train_counts(av.attention_train)
        o = av.attention_train(q, k, v)
        o.backward(do)
        torch.cuda.synchronize()
        assert _train_counts(av.attention_train) == _after_one(before, route)
        ref = av.head_grads_reference(q.detach(), k.detach(), v.detach(), do)
        _check_grads((o.detach(), q.grad, k.grad, v.grad),
                     (av.attention_train_reference(q.detach(), k.detach(),
                                                   v.detach()), *ref), dtype)
