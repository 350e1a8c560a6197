"""The hand-written CUDA kernels -- the fused and headwise attention blocks
(the fused one also in its s8 mode), the row-resident and the online flash
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

import pytest
import torch

from interactive_vit_tpu_torch.ops import attention_vjp as av
from interactive_vit_tpu_torch.ops import flash_attention as fa
from interactive_vit_tpu_torch.ops import fused_block as fb
from interactive_vit_tpu_torch.ops import fused_mlp as fm
from interactive_vit_tpu_torch.ops import fused_window as fw

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
    fb.load_kernel()
    fb.load_headwise_kernel()
    fa.load_kernel()
    fw.load_kernel()
    fm.load_kernel()
    fa.load_online_kernel()
    fm.load_w8a8_kernel()
    av.load_kernel()
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
    """Output ``i`` (0: y or the attention output; else probs or mean)
    within its bound of the plain version's (``s8``: the int8 kernels')."""
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


def _check(got, ref, dtype, s8=False):
    """Every output of a kernel within its bound, and the bounds of the
    maps and mean strict enough to refuse them zeroed or halved."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            assert g is None
            continue
        assert g.shape == r.shape and g.dtype == r.dtype
        assert _within(g, r, i, dtype, s8), i
        if i > 0:
            assert not _within(g * 0.5, r, i, dtype, s8), i
            assert not _within(torch.zeros_like(g), r, i, dtype, s8), i


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
    before = fb.fused_attn_block.launches
    got = fb.fused_attn_block(x, p, heads, 1e-6, **kw)
    torch.cuda.synchronize()
    assert fb.fused_attn_block.launches == before + 1
    ref = fb.fused_attn_block_reference(x, p, heads, 1e-6, **kw)
    assert got[0].dtype == dtype and got[0].shape == x.shape
    if len(ref) == 3:
        assert got[2].shape == (b, n, n)
    _check(got, ref, dtype)


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
    with pytest.raises(NotImplementedError):
        fb.fused_attn_block(x, p, 4, want_metric=True)


# headwise: vit_l16 @384 (N=577: 10 key tiles, the last partial), vit_b16
# (N=197), a ragged small block, and dh=24 (column groups that do not
# divide the thread block)
HEADWISE_SHAPES = [(1, 577, 1024, 16), (2, 197, 768, 12), (3, 17, 64, 4),
                   (1, 130, 96, 4)]


@pytest.mark.parametrize("shape", HEADWISE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["maps_off", "maps_mean", "subset_mean",
                                  "exact_softmax"])
def test_headwise_kernel_matches_plain(cuda, shape, dtype, mode):
    b, n, d, heads = shape
    x, p = _block(b, n, d, heads, dtype, cuda, seed=n)
    kw = {
        "maps_off": {},
        "maps_mean": {"want_attn": True, "want_mean": True},
        "subset_mean": {"want_attn": True, "want_mean": True,
                        "attn_heads": (heads - 1, 0)},
        "exact_softmax": {"want_attn": True, "fast_softmax": False},
    }[mode]
    before = fb.headwise_attn_block.launches
    got = fb.headwise_attn_block(x, p, heads, 1e-6, **kw)
    torch.cuda.synchronize()
    assert fb.headwise_attn_block.launches == before + 1
    ref = fb.headwise_attn_block_reference(x, p, heads, 1e-6, **kw)
    _check(got, ref, dtype)


# flash: dinov2_s14_reg @518 (N=1374), vit_l16 @384 (N=577), the longest
# row-resident sequence (N=2048: 16-row query tiles), ragged small shapes
FLASH_SHAPES = [(1, 6, 1374, 64), (1, 16, 577, 64), (1, 2, 2048, 64),
                (2, 3, 17, 16), (1, 2, 130, 24)]


def _qkv(shape, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(shape, generator=g) * 2).to(device=device,
                                                     dtype=dtype)
            for _ in range(3)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("want_attn", [False, True])
def test_flash_kernel_matches_plain(cuda, shape, dtype, want_attn):
    q, k, v = _qkv(shape, dtype, cuda, seed=shape[2])
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, want_attn=want_attn)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
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


def test_flash_wrapper_branches_above_rowfull_max(cuda):
    q, k, v = _qkv((1, 1, fa.ROWFULL_MAX_N + 8, 64), torch.bfloat16, cuda)
    before = (fa.flash_attention.launches, fa.flash_attention_online.launches)
    o, probs = fa.flash_attention(q, k, v, want_attn=True)
    assert (fa.flash_attention.launches,
            fa.flash_attention_online.launches) == before  # the reference
    assert probs.dtype == torch.float32
    o, probs = fa.flash_attention(q, k, v)  # maps off: the online kernel
    torch.cuda.synchronize()
    assert probs is None
    assert (fa.flash_attention.launches,
            fa.flash_attention_online.launches) == (before[0], before[1] + 1)


# online flash: dinov2_s14_reg@742 (N=2814: 22 key tiles, the last of 126
# keys), just above ROWFULL_MAX_N, a ragged small shape, dh=128 and dh=16
ONLINE_SHAPES = [(1, 6, 2814, 64), (2, 2, 2049, 64), (3, 3, 17, 16),
                 (1, 2, 300, 128)]


@pytest.mark.parametrize("shape", ONLINE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_real", [None, -40])
def test_online_kernel_matches_plain(cuda, shape, dtype, n_real):
    q, k, v = _qkv(shape, dtype, cuda, seed=shape[2] + shape[3])
    n_real = None if n_real is None else max(1, shape[2] + n_real)
    before = fa.flash_attention_online.launches
    got = fa.flash_attention_online(q, k, v, n_real)
    torch.cuda.synchronize()
    assert fa.flash_attention_online.launches == before + 1
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
    got = fa.flash_attention_online(q, k, v)
    ref = fa.flash_attention_online_reference(q, k, v)
    torch.cuda.synchronize()
    _check((got,), (ref,), torch.bfloat16)


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
    before = (fb.fused_attn_block.launches, fb.fused_attn_block_s8.launches)
    got = fb.fused_attn_block_s8(x, p, heads, 1e-6, int8_pv=int8_pv, **kw)
    torch.cuda.synchronize()
    assert (fb.fused_attn_block.launches,
            fb.fused_attn_block_s8.launches) == (before[0], before[1] + 1)
    ref = fb.fused_attn_block_reference(x, p, heads, 1e-6, int8_scores=True,
                                        int8_pv=int8_pv, **kw)
    _check(got, ref, dtype, s8=True)


def _w8a8_case(shape, dtype, device):
    from interactive_vit_tpu_torch.ops import quant

    x, p = _mlp_case(shape, dtype, device)
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
    before = fm.fused_mlp_w8a8_block.launches
    got, parts = fm.fused_mlp_w8a8_block(x, p, want_parts=True)
    torch.cuda.synchronize()
    assert fm.fused_mlp_w8a8_block.launches == before + 1
    assert torch.equal(got, fm.fused_mlp_w8a8_block(x, p))
    _check_w8a8(x, p, got, parts, dtype)


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
    before = fw.fused_window_attn.launches
    got = fw.fused_window_attn(y, p, heads, win, bias, mask, **kw)
    torch.cuda.synchronize()
    assert fw.fused_window_attn.launches == before + 1
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


def _mlp_case(shape, dtype, device):
    b, n, d = shape
    md = 4 * d
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
    before = fm.fused_mlp_block.launches
    got = fm.fused_mlp_block(x, p, eps)
    torch.cuda.synchronize()
    assert fm.fused_mlp_block.launches == before + 1
    ref = fm.fused_mlp_block_reference(x, p, eps)
    assert got.shape == x.shape and got.dtype == dtype
    _check((got,), (ref,), dtype)
    # the bound must refuse a kernel that returned the residual alone
    assert not _within(x, ref, 0, dtype)


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
# beyond 197 of 208, a ragged small shape, dh=128, TRAIN_MAX_N
TRAIN_SHAPES = [(4, 12, 197, 64, None), (4, 3, 197, 64, None),
                (2, 2, 208, 64, 197), (3, 2, 17, 16, None),
                (1, 2, 300, 128, None), (1, 1, 1024, 64, None)]


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_kernels_match_plain(cuda, shape, dtype):
    """q, k, v as ``qkv_proj`` makes them (transposed views of one
    [B, N, 3D] tensor); o and its gradients against the plain versions."""
    b, h, n, dh, n_real = shape
    g = torch.Generator().manual_seed(n + dh)
    qkv = torch.randn((b, n, 3 * h * dh), generator=g).to(cuda, dtype)
    do = torch.randn((b, h, n, dh), generator=g).to(cuda, dtype)
    q, k, v = (qkv.reshape(b, n, 3, h, dh)[:, :, i].transpose(1, 2)
               .detach().requires_grad_(True) for i in range(3))
    before = (av.attention_train.fwd_launches,
              av.attention_train.bwd_launches)
    o = av.attention_train(q, k, v, n_real)
    o.backward(do)
    torch.cuda.synchronize()
    assert (av.attention_train.fwd_launches,
            av.attention_train.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref_o = av.attention_train_reference(q.detach(), k.detach(), v.detach(),
                                         n_real)
    ref = av.head_grads_reference(q.detach(), k.detach(), v.detach(), do,
                                  n_real)
    _check_grads((o.detach(), q.grad, k.grad, v.grad), (ref_o, *ref), dtype)
    if n_real is not None:
        assert torch.all(k.grad[:, :, n_real:] == 0)
        assert torch.all(v.grad[:, :, n_real:] == 0)


# (B, N, H, n_real): vit_b16's train shape, masked keys, a ragged one
PACKED_SHAPES = [(4, 197, 12, None), (2, 208, 2, 197), (3, 17, 4, None)]


@pytest.mark.parametrize("shape", PACKED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_train_kernels_match_plain(cuda, shape, dtype):
    b, n, h, n_real = shape
    d = h * av.PACKED_DH
    g = torch.Generator().manual_seed(n + h)
    qkv = torch.randn((b, n, 3 * d), generator=g).to(cuda, dtype)
    do = torch.randn((b, n, d), generator=g).to(cuda, dtype)
    qkv.requires_grad_(True)
    before = (av.attention_train_packed.fwd_launches,
              av.attention_train_packed.bwd_launches)
    o = av.attention_train_packed(qkv, n_real)
    o.backward(do)
    torch.cuda.synchronize()
    assert (av.attention_train_packed.fwd_launches,
            av.attention_train_packed.bwd_launches) == (before[0] + 1,
                                                        before[1] + 1)
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
    before = (av.attention_train.fwd_launches,
              av.attention_train.bwd_launches)
    q, k, v = _qkv((1, 2, av.TRAIN_MAX_N + 8, 64), torch.bfloat16, cuda)
    o, probs = av.trainable_flash_mhsa(q, k, v)
    assert probs is None
    q, k, v = _qkv((1, 2, 197, 64), torch.bfloat16, cuda)
    o, probs = av.trainable_flash_mhsa(q, k, v, want_attn=True)
    assert probs is not None
    torch.cuda.synchronize()
    assert (av.attention_train.fwd_launches,
            av.attention_train.bwd_launches) == before
