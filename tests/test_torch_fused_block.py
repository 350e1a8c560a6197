"""The port's fused attention block (its plain version, on the CPU) against
the JAX package's Pallas kernel in interpret mode, on shared inputs.

Inputs and parameters are made with numpy / the JAX initializer from a
seed and handed to both packages (``models/weights.from_jax``). Tolerance:
f32 atol 1e-5, as the JAX package's own fused-block tests.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.ops import fused_block as jfb
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import dispatch
from interactive_vit_tpu_torch.ops import fused_block as tfb

torch.set_num_threads(2)

ATOL = 1e-5
JCFG = jvit.ViTConfig("vit_fbt", img_size=32, patch=16, width=64, depth=2,
                      heads=4, num_classes=10)
TCFG = tvit.ViTConfig("vit_fbt", img_size=32, patch=16, width=64, depth=2,
                      heads=4, num_classes=10)


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        jfb.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


@pytest.fixture(scope="module")
def shared():
    """One JAX-initialised block and one input batch, as numpy."""
    params = jvit.init_params(jax.random.key(3), JCFG)
    blk = jax.tree.map(np.asarray, params["blocks"][0])
    x = np.random.default_rng(3).standard_normal(
        (2, JCFG.tokens, JCFG.width)).astype(np.float32)
    return blk, x


def _close(got, want, atol=ATOL):
    if want is None:
        assert got is None
        return
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


# (want_attn, want_mean, attn_heads, fast_softmax)
MODES = [
    (False, False, None, True),
    (True, False, None, True),
    (True, True, None, True),
    (False, True, None, True),
    (True, False, (3, 1), True),
    (True, True, (2,), True),
    (True, True, None, False),
    (False, False, None, False),
]


@pytest.mark.parametrize("want_attn,want_mean,attn_heads,fast", MODES)
def test_fused_block_matches_pallas(shared, want_attn, want_mean, attn_heads,
                                    fast):
    blk, x = shared
    kw = dict(want_attn=want_attn, want_mean=want_mean, fast_softmax=fast,
              attn_heads=attn_heads)
    want = jfb.fused_attn_block(jnp.asarray(x),
                                jax.tree.map(jnp.asarray, blk),
                                JCFG.heads, JCFG.ln_eps, **kw)
    got = tfb.fused_attn_block(torch.from_numpy(x), from_jax(blk),
                               TCFG.heads, TCFG.ln_eps, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("want_attn,want_mean,attn_heads,extra", [
    (True, True, None, {}), (False, False, None, {}),
    (True, False, (0, 2), {}),
    (True, True, None, {"qkv_head_major": True}),  # [H][3][dh] columns
    (True, True, None, {"n_real": 3}),             # padded keys masked
])
def test_plain_block_matches_jax_reference_block(shared, want_attn, want_mean,
                                                 attn_heads, extra):
    """The port's unfused ``vit.block`` against JAX ``vit.block`` with no
    block kernel (both packages' reference path), MLP included."""
    blk, x = shared
    want = jvit.block(jax.tree.map(jnp.asarray, blk), jnp.asarray(x), JCFG,
                      want_attn=want_attn, want_mean=want_mean,
                      attn_heads=attn_heads, **extra)
    got = tvit.block(from_jax(blk), torch.from_numpy(x), TCFG,
                     want_attn=want_attn, want_mean=want_mean,
                     attn_heads=attn_heads, **extra)
    for g, w in zip(got, want):
        _close(g, w)


def test_fused_vit_block_matches_jax_fused_vit_block(shared):
    """``vit.block`` with the fused kernel in both packages, MLP included."""
    blk, x = shared
    want = jvit.block(jax.tree.map(jnp.asarray, blk), jnp.asarray(x), JCFG,
                      want_attn=True, want_mean=True,
                      block_impl=jfb.fused_attn_block)
    got = tvit.block(from_jax(blk), torch.from_numpy(x), TCFG,
                     want_attn=True, want_mean=True,
                     block_impl=tfb.fused_attn_block)
    for g, w in zip(got, want):
        _close(g, w)


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch(shared):
    blk, x = shared
    before = tfb.fused_attn_block.launches
    got = tfb.fused_attn_block(torch.from_numpy(x), from_jax(blk), 4,
                               want_attn=True, want_mean=True)
    ref = tfb.fused_attn_block_reference(torch.from_numpy(x), from_jax(blk),
                                         4, want_attn=True, want_mean=True)
    assert tfb.fused_attn_block.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# ToMe's operands (key_bias, want_metric) with the maps' modes:
# (key_bias, want_metric, want_attn, want_mean, attn_heads, fast_softmax)
TOME_MODES = [
    (True, False, False, False, None, True),
    (False, True, False, False, None, True),
    (True, True, False, False, None, True),
    (True, True, True, True, None, True),
    (True, True, True, False, (3, 0), True),
    (True, True, False, True, None, True),
    (True, True, True, True, None, False),
]


@pytest.mark.parametrize("n", [9, 12])  # odd and even token counts
@pytest.mark.parametrize("int8_scores", [False, True])
@pytest.mark.parametrize("bias,metric,want_attn,want_mean,attn_heads,fast",
                         TOME_MODES)
def test_tome_operands_match_pallas(shared, n, int8_scores, bias, metric,
                                    want_attn, want_mean, attn_heads, fast):
    """key_bias (log of token sizes) and the key metric, dense and s8,
    against the interpreted Pallas kernel: results in the JAX order (y,
    probs[, mean][, metric])."""
    blk, _ = shared
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n, JCFG.width)).astype(np.float32)
    kb = (np.log(rng.integers(1, 6, size=(2, n))).astype(np.float32)
          if bias else None)
    kw = dict(want_attn=want_attn, want_mean=want_mean, fast_softmax=fast,
              attn_heads=attn_heads, want_metric=metric,
              int8_scores=int8_scores)
    want = jfb.fused_attn_block(
        jnp.asarray(x), jax.tree.map(jnp.asarray, blk), JCFG.heads,
        JCFG.ln_eps, key_bias=None if kb is None else jnp.asarray(kb), **kw)
    got = tfb.fused_attn_block(
        torch.from_numpy(x), from_jax(blk), TCFG.heads, TCFG.ln_eps,
        key_bias=None if kb is None else torch.from_numpy(kb), **kw)
    assert len(got) == len(want)
    if metric:
        assert got[-1].dtype == torch.float32
        assert tuple(got[-1].shape) == (2, n, JCFG.width // JCFG.heads)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("kw,exc", [
    ({"want_attn": True, "attn_heads": ()}, ValueError),
    ({"want_attn": True, "attn_heads": (4,)}, ValueError),
    ({"key_bias": torch.zeros(2, 4)}, ValueError),   # not [B, N]
    ({"key_bias": torch.zeros(2, 5, 1)}, ValueError),
    ({"key_bias": torch.zeros(2, 5, device="meta")}, ValueError),
    ({"int8_scores": True, "key_bias": torch.zeros(5)}, ValueError),
])
def test_wrapper_rejects(shared, kw, exc):
    blk, x = shared
    with pytest.raises(exc):
        tfb.fused_attn_block(torch.from_numpy(x), from_jax(blk), 4, **kw)


def test_metric_is_the_head_mean_of_the_keys(shared):
    """The metric is sum_h k_h in f32, heads in ascending order, times
    1/heads, over the keys of the block's own LN1 + QKV."""
    blk, x = shared
    p = from_jax(blk)
    xt = torch.from_numpy(x)
    _, _, metric = tfb.fused_attn_block(xt, p, 4, want_metric=True)
    ln = tvit.L.layer_norm(xt, p["ln1_s"], p["ln1_b"], 1e-6)
    k = (torch.matmul(ln, p["qkv_w"]) + p["qkv_b"])[..., 64:128]
    k = k.reshape(2, -1, 4, 16)
    want = ((k[:, :, 0] + k[:, :, 1]) + k[:, :, 2] + k[:, :, 3]) * 0.25
    torch.testing.assert_close(metric, want, atol=1e-6, rtol=0)


def test_wrapper_refuses_devices_it_has_no_path_for(shared):
    blk, x = shared
    with pytest.raises(ValueError):
        tfb.fused_attn_block(torch.from_numpy(x).to("meta"), from_jax(blk), 4)


@pytest.mark.parametrize("n,d,heads,ok", [
    (197, 768, 12, True),    # vit_b16 @224
    (197, 192, 3, True),     # vit_t16 @224
    (50, 768, 12, True),     # vit_b32 @224
    (257, 1280, 16, True),   # vit_h14 @224, dh=80
    (577, 1024, 16, False),  # vit_l16 @384: K and V exceed shared memory
    (197, 768, 7, False),    # width does not split into heads
    (197, 198, 3, False),    # dh=66: rows are not whole float4s
    (197, 6400, 100, False),  # more heads than the emit mask holds
])
def test_fits_envelope(n, d, heads, ok):
    assert tfb.fits(n, d, heads) is ok


@pytest.mark.parametrize("name,dtype,device,n,d,heads,want", [
    ("auto", torch.bfloat16, "cuda", 197, 768, 12, "kernel"),
    ("auto", torch.float32, "cuda", 197, 768, 12, "kernel"),
    ("auto", torch.float32, "cuda:0", 197, 192, 3, "kernel"),
    ("auto", torch.bfloat16, "cpu", 197, 768, 12, None),
    ("auto", torch.float16, "cuda", 197, 768, 12, None),
    ("auto", torch.bfloat16, "cuda", 577, 1024, 16, "headwise"),
    ("fused", torch.float32, "cpu", 197, 768, 12, "kernel"),
    ("reference", torch.bfloat16, "cuda", 197, 768, 12, None),
])
def test_dispatch_policy(name, dtype, device, n, d, heads, want):
    impl = dispatch.default_block_impl(name, dtype=dtype, n=n, d=d,
                                       heads=heads, device=device)
    assert impl is {"kernel": tfb.fused_attn_block,
                    "headwise": tfb.headwise_attn_block, None: None}[want]


def test_dispatch_unknown_name():
    with pytest.raises(ValueError):
        dispatch.default_block_impl("flash")
