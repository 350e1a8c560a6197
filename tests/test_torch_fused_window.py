"""The port's fused window-attention module against the JAX package's.

On the CPU the port's wrapper ``fused_window_attn`` runs its plain version
(the CUDA kernel runs only on the card; ``tests/test_torch_cuda_kernel.py``
holds the two against each other there). Here the same numpy inputs go
through that wrapper and through the JAX Pallas kernel in interpret mode
(the fixture of ``tests/test_fused_window.py``), and through both packages'
``swin.block``, at the tiny geometry of the JAX test (8x8 maps, window 4,
shift 2). f32, atol 2e-5: the JAX test's own bound between its kernel and
its jnp path; the two sides differ only in the order of f32 sums.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import swin as jswin
from interactive_vit_tpu.ops import fused_window as jfw
from interactive_vit_tpu_torch.models import swin as tswin
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import dispatch
from interactive_vit_tpu_torch.ops import fused_window as fw

torch.set_num_threads(2)

ATOL = 2e-5
GEOM = dict(img_size=32, patch=4, embed_dim=16, depths=(2, 2), heads=(2, 4),
            window=4, num_classes=10)
JCFG = jswin.SwinConfig("swin_fw", **GEOM)
TCFG = tswin.SwinConfig("swin_fw", **GEOM)
STAGE_SHIFT = [(0, 0), (0, 2), (1, 0)]


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        jfw.pl, "pallas_call", functools.partial(pl.pallas_call,
                                                 interpret=True))


def _block_params(seed, stage):
    """One block's parameters from the JAX initializer, with a non-trivial
    bias table and biases, for both packages."""
    jp = dict(jswin.init_params(jax.random.key(seed), JCFG)
              ["stages"][stage][0])
    rng = np.random.default_rng(seed)
    for name in ("qkv_b", "proj_b", "bias_table"):
        jp[name] = jnp.asarray(
            rng.standard_normal(jp[name].shape).astype(np.float32) * 0.3)
    return jp, from_jax(jax.tree.map(np.asarray, jp))


def _map(seed, stage, batch=2):
    res, c = JCFG.stage_res(stage), JCFG.stage_dim(stage)
    return np.random.default_rng(seed).standard_normal(
        (batch, res, res, c)).astype(np.float32)


@pytest.mark.parametrize("stage,shift", STAGE_SHIFT)
@pytest.mark.parametrize("want_attn", [False, True])
@pytest.mark.parametrize("fast", [True, False])
def test_wrapper_matches_pallas_kernel(stage, shift, want_attn, fast):
    jp, tp = _block_params(stage * 7 + shift, stage)
    y = _map(stage + shift, stage)
    heads, win = JCFG.heads[stage], JCFG.window
    t = win * win
    idx = jswin.relative_position_index(win)
    mask = jswin.shift_attn_mask(JCFG.stage_res(stage), win, shift)
    ja, jprobs = jfw.fused_window_attn(
        jnp.asarray(y), jp, heads, win, jswin.gather_bias(jp, idx, t, heads),
        mask, want_attn=want_attn, fast_softmax=fast)
    before = fw.fused_window_attn.launches
    a, probs = fw.fused_window_attn(
        torch.from_numpy(y), tp, heads, win,
        tswin.gather_bias(tp, idx, t, heads), mask, want_attn=want_attn,
        fast_softmax=fast)
    assert fw.fused_window_attn.launches == before  # no kernel on the CPU
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=ATOL)
    if want_attn:
        nw = (JCFG.stage_res(stage) // win) ** 2
        assert probs.shape == (2, nw, heads, t, t)
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                                   atol=ATOL)
        np.testing.assert_allclose(probs.numpy().sum(-1), 1.0, atol=1e-5)
        if mask is not None:
            # seam pairs get no attention: exp(-100) is an f32 denormal
            # (and rounds to exactly 0 in bf16)
            blocked = np.broadcast_to(mask[None, :, None] < 0, probs.shape)
            assert blocked.any() and (probs.numpy()[blocked] < 1e-40).all()
    else:
        assert probs is None and jprobs is None


@pytest.mark.parametrize("stage,shift", STAGE_SHIFT)
@pytest.mark.parametrize("window_impl", [None, fw.fused_window_attn],
                         ids=["unfused", "fused"])
def test_block_matches_jax_jnp_block(stage, shift, window_impl):
    """The port's ``swin.block``, unfused and through the wrapper, against
    the JAX ``swin.block`` on its jnp path."""
    jp, tp = _block_params(stage * 7 + shift + 1, stage)
    x = _map(stage + shift + 1, stage)
    jy, jprobs = jswin.block(jp, jnp.asarray(x), JCFG, stage, shift,
                             want_attn=True)
    y, probs = tswin.block(tp, torch.from_numpy(x), TCFG, stage, shift,
                           want_attn=True, window_impl=window_impl)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=ATOL)
    y_off, none = tswin.block(tp, torch.from_numpy(x), TCFG, stage, shift,
                              window_impl=window_impl)
    assert none is None
    np.testing.assert_allclose(y_off.numpy(), np.asarray(jy), atol=ATOL)


def test_wrapper_refuses_what_it_does_not_take():
    _, tp = _block_params(3, 0)
    y = torch.from_numpy(_map(3, 0))
    bias = tswin.gather_bias(tp, tswin.relative_position_index(4), 16, 2)
    with pytest.raises(ValueError, match="not divisible"):
        fw.fused_window_attn(y[:, :7], tp, 2, 4, bias)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fw.fused_window_attn(y.to("meta"), tp, 2, 4, bias)


@pytest.mark.parametrize("args,ok", [
    ((56, 7, 96, 3), True),      # swin_t stage 0
    ((7, 7, 768, 24), True),     # swin_t stage 3
    ((7, 7, 1024, 32), True),    # swin_b stage 3
    ((24, 12, 128, 4), True),    # window 12 (384 px): T=144 fits
    ((56, 7, 96, 5), False),     # width does not split into heads
    ((50, 7, 96, 3), False),     # map does not split into windows
    ((56, 7, 90, 3), False),     # heads of 30 columns: no float4 rows
    ((64, 32, 128, 4), False),   # T=1024: 4 MB of scores
])
def test_fits(args, ok):
    assert fw.fits(*args) is ok


def test_smem_formula_covers_the_published_windows():
    assert fw.window_smem_bytes(49, 32) == 4 * (49 * 32 * 3 + 49 * 4
                                                + 49 * 49 + 49)
    assert fw.window_smem_bytes(144, 32) < 232448


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_default_window_impl(dtype):
    cfg = tswin.VARIANTS["swin_t"]
    assert dispatch.default_window_impl("reference") is None
    assert dispatch.default_window_impl("none") is None
    assert dispatch.default_window_impl("fused") is fw.fused_window_attn
    auto = functools.partial(dispatch.default_window_impl, "auto",
                             dtype=dtype)
    assert auto(cfg=cfg, device="cuda") is fw.fused_window_attn
    assert auto(cfg=tswin.VARIANTS["swin_b"],
                device="cuda:0") is fw.fused_window_attn
    assert auto(cfg=cfg, device="cpu") is None
    assert auto(cfg=cfg) is None
    assert auto(cfg=None, device="cuda") is None
    # a stage outside the envelope sends the whole model to the unfused path
    odd = tswin.SwinConfig("odd", embed_dim=90)
    assert auto(cfg=odd, device="cuda") is None
    assert dispatch.default_window_impl(
        "auto", dtype=torch.float16, cfg=cfg, device="cuda") is None
    with pytest.raises(ValueError, match="unknown window impl"):
        dispatch.default_window_impl("pallas")
