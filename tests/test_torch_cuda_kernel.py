"""The hand-written CUDA kernels -- the fused and headwise attention blocks
and the row-resident flash attention -- against their plain PyTorch
versions, on the card.

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
output is a probs-weighted mean of V rows; its bound is that of y.
"""

import pytest
import torch

from interactive_vit_tpu_torch.ops import flash_attention as fa
from interactive_vit_tpu_torch.ops import fused_block as fb

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
