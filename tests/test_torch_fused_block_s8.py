"""The s8 mode of the port's fused attention block (its plain version, on
the CPU) against the JAX Pallas kernel's ``int8_scores`` in interpret mode.

The JAX initializer's block and a numpy input go to both packages
(``models/weights.from_jax``). Tolerance f32 atol 1e-5, as the dense
block's: the score and PV products are exact integer sums on both sides,
so only the order of the f32 sums around them differs (an int8 flipped by
that difference would show far above the bound).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.ops import dispatch as jdispatch
from interactive_vit_tpu.ops import fused_block as jfb
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import dispatch
from interactive_vit_tpu_torch.ops import fused_block as tfb

torch.set_num_threads(2)

ATOL = 1e-5
JCFG = jvit.ViTConfig("vit_s8t", img_size=32, patch=16, width=64, depth=1,
                      heads=4, num_classes=10)


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        jfb.pl, "pallas_call", functools.partial(pl.pallas_call,
                                                 interpret=True))


@pytest.fixture(scope="module")
def shared():
    params = jvit.init_params(jax.random.key(4), JCFG)
    blk = jax.tree.map(np.asarray, params["blocks"][0])
    rng = np.random.default_rng(4)
    blk["qkv_b"] = (0.3 * rng.standard_normal(blk["qkv_b"].shape)).astype(
        np.float32)
    x = rng.standard_normal((2, 9, JCFG.width)).astype(np.float32)
    return blk, x


# (want_attn, want_mean, attn_heads, fast_softmax)
MODES = [
    (False, False, None, True),
    (True, False, None, True),
    (True, True, None, True),
    (False, True, None, True),
    (True, False, (3, 1), True),
    (False, False, None, False),
    (True, True, None, False),
]


@pytest.mark.parametrize("int8_pv", [True, False])
@pytest.mark.parametrize("want_attn,want_mean,attn_heads,fast", MODES)
def test_s8_block_matches_pallas(shared, int8_pv, want_attn, want_mean,
                                 attn_heads, fast):
    blk, x = shared
    kw = dict(want_attn=want_attn, want_mean=want_mean, fast_softmax=fast,
              attn_heads=attn_heads, int8_scores=True, int8_pv=int8_pv)
    want = jfb.fused_attn_block(jnp.asarray(x), blk, 4, **kw)
    before = (tfb.fused_attn_block.launches, tfb.fused_attn_block_s8.launches)
    got = tfb.fused_attn_block(torch.from_numpy(x), from_jax(blk), 4, **kw)
    assert (tfb.fused_attn_block.launches,
            tfb.fused_attn_block_s8.launches) == before  # CPU: no kernel
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_s8_wrapper_is_the_plain_version_on_cpu(shared):
    blk, x = shared
    tx, tp = torch.from_numpy(x), from_jax(blk)
    got = tfb.fused_attn_block_s8(tx, tp, 4, want_attn=True, want_mean=True,
                                  int8_pv=False)
    ref = tfb.fused_attn_block_reference(tx, tp, 4, want_attn=True,
                                         want_mean=True, int8_scores=True,
                                         int8_pv=False)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    dense = tfb.fused_attn_block(tx, tp, 4, want_attn=True)
    assert (got[1] - dense[1]).abs().max() > 0  # the quantization shows


def test_s8_block_bf16_near_pallas(shared):
    """bf16: the same cast points; XLA and torch may round an f32 sum of
    the qkv GEMM to the neighbouring bf16 value, which can move one int8
    of q or k. Bound: 2^-6 of y's scale, probs 2^-7."""
    blk, x = shared
    jblk = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), blk)
    kw = dict(want_attn=True, int8_scores=True)
    wy, wp = jfb.fused_attn_block(jnp.asarray(x, jnp.bfloat16), jblk, 4, **kw)
    tblk = from_jax(blk, dtype=torch.bfloat16)
    gy, gp = tfb.fused_attn_block(torch.from_numpy(x).to(torch.bfloat16),
                                  tblk, 4, **kw)
    wy, wp = (np.asarray(a.astype(jnp.float32)) for a in (wy, wp))
    assert np.abs(gy.float().numpy() - wy).max() <= 2.0 ** -6 * np.abs(wy).max()
    assert np.abs(gp.float().numpy() - wp).max() <= 2.0 ** -7


@pytest.mark.parametrize("n,d,heads,ok", [
    (197, 768, 12, True),    # vit_b16 @224
    (257, 192, 3, True),     # vit_t16 @256
    (268, 768, 12, True),
    (269, 768, 12, False),   # the s8 copies no longer fit shared memory
    (300, 768, 12, False),   # fits the dense mode, not the s8 one
    (197, 198, 3, False),    # dh=66: not whole words
])
def test_s8_envelope(n, d, heads, ok):
    assert tfb.fits(n, d, heads, int8_scores=True) is ok
    if n == 300:
        assert tfb.fits(n, d, heads)


@pytest.mark.parametrize("name,pv", [("int8-scores", True),
                                     ("int8-scores-qk", False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dispatch_int8_scores(name, pv, dtype):
    """Both names resolve to the s8 wrapper; f32 is not excluded (the JAX
    policy raises for f32, where Mosaic's HIGHEST-precision dots compile
    slowly)."""
    impl = dispatch.default_block_impl(name, dtype=dtype, n=197, d=768,
                                       heads=12, device="cuda")
    assert impl.func is tfb.fused_attn_block_s8
    assert impl.keywords == {"int8_pv": pv}
    jimpl = jdispatch.default_block_impl(name, dtype=jnp.bfloat16, n=197,
                                         d=768, heads=12)
    assert jimpl.keywords == {"int8_scores": True, "int8_pv": pv}
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="bf16"):
            jdispatch.default_block_impl(name, dtype=jnp.float32, n=197,
                                         d=768, heads=12)


def test_dispatch_int8_scores_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="headwise kernel has no s8 mode"):
        dispatch.default_block_impl("int8-scores", dtype=torch.bfloat16,
                                    n=577, d=1024, heads=16, device="cuda")
