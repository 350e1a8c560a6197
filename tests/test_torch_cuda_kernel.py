"""The hand-written CUDA kernels -- the fused and headwise attention blocks,
the row-resident flash attention, the Swin window attention and the fused
MLP branch -- against their plain PyTorch versions, on the card.

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
window probs the per-element one.
"""

import pytest
import torch

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


def _within(got, ref, i, dtype):
    """Output ``i`` (0: y or the attention output; else probs or mean)
    within its bound of the plain version's."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if dtype == torch.float32:
        return err.max().item() <= 1e-4
    if i == 0:
        return err.max().item() <= 2.0 ** -6 * max(1.0, r.abs().max().item())
    return bool((err <= (2.0 ** -5 * r.abs() + 1e-6).clamp(max=2.0 ** -7))
                .all())


def _check(got, ref, dtype):
    """Every output of a kernel within its bound, and the bounds of the
    maps and mean strict enough to refuse them zeroed or halved."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            assert g is None
            continue
        assert g.shape == r.shape and g.dtype == r.dtype
        assert _within(g, r, i, dtype), i
        if i > 0:
            assert not _within(g * 0.5, r, i, dtype), i
            assert not _within(torch.zeros_like(g), r, i, dtype), i


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
    before = fa.flash_attention.launches
    o, probs = fa.flash_attention(q, k, v, want_attn=True)
    assert fa.flash_attention.launches == before  # attention_reference
    assert probs.dtype == torch.float32
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, k, v)


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
