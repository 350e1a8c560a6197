"""The port's headwise attention block (its plain version, on the CPU)
against the JAX package's Pallas ``headwise_attn_block`` in interpret mode,
on shared inputs.

Two head widths: dh=64 (D=256, 4 heads), which the JAX function packs two
heads to a 128-lane column block, and dh=24 (D=96, 4 heads), which it runs
through its per-head transposed fallback. Inputs and parameters are made
with numpy from a seed and handed to both packages. Tolerance: f32 atol
1e-5, as the JAX package's own fused-block tests.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.ops import fused_block as jfb
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import fused_block as tfb

torch.set_num_threads(2)

ATOL = 1e-5

# (want_attn, want_mean, attn_heads, fast_softmax), as test_torch_fused_block
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


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        jfb.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _block(d, n, seed):
    """A block's attention parameters (non-trivial LN and biases) and an
    input batch, as numpy."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (rng.standard_normal(shape) * std + mean).astype(np.float32)

    p = {"ln1_s": rnd(d, std=0.1, mean=1.0), "ln1_b": rnd(d, std=0.1),
         "qkv_w": rnd(d, 3 * d, std=d ** -0.5), "qkv_b": rnd(3 * d, std=0.1),
         "proj_w": rnd(d, d, std=d ** -0.5), "proj_b": rnd(d, std=0.1)}
    return p, rnd(2, n, d)


@pytest.mark.parametrize("want_attn,want_mean,attn_heads,fast", MODES)
@pytest.mark.parametrize("n", [17, 50])
@pytest.mark.parametrize("d", [256, 96])  # dh 64 (packed), 24 (unpacked)
def test_headwise_matches_pallas(d, n, want_attn, want_mean, attn_heads,
                                 fast):
    p, x = _block(d, n, seed=d + n)
    kw = dict(want_attn=want_attn, want_mean=want_mean, fast_softmax=fast,
              attn_heads=attn_heads)
    want = jfb.headwise_attn_block(jnp.asarray(x),
                                   jax.tree.map(jnp.asarray, p), 4, 1e-6,
                                   **kw)
    got = tfb.headwise_attn_block(torch.from_numpy(x), from_jax(p), 4, 1e-6,
                                  **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=0)


def test_subset_maps_use_the_exact_softmax():
    """An ``attn_heads`` subset is recomputed with the max-subtracted
    softmax while the all-heads tap uses the kernel's fast form: the two
    agree on these inputs to f32 rounding, and the subset rows are exactly
    the recomputation."""
    p, x = _block(96, 17, seed=5)
    tp, tx = from_jax(p), torch.from_numpy(x)
    _, sub = tfb.headwise_attn_block(tx, tp, 4, want_attn=True,
                                     attn_heads=(2, 0))
    _, full = tfb.headwise_attn_block(tx, tp, 4, want_attn=True)
    assert sub.shape == (2, 2, 17, 17)
    torch.testing.assert_close(sub, full[:, [0, 2]], atol=1e-6, rtol=0)
    qkv = tfb._ln_qkv(tx, tp, 1e-6)
    assert torch.equal(sub, tfb._subset_maps(qkv, 4, (0, 2)))


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    p, x = _block(256, 17, seed=1)
    before = tfb.headwise_attn_block.launches
    kw = dict(want_attn=True, want_mean=True)
    got = tfb.headwise_attn_block(torch.from_numpy(x), from_jax(p), 4, **kw)
    ref = tfb.headwise_attn_block_reference(torch.from_numpy(x), from_jax(p),
                                            4, **kw)
    assert tfb.headwise_attn_block.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("kw", [{"attn_heads": ()}, {"attn_heads": (4,)}])
def test_headwise_rejects_bad_head_subsets(kw):
    p, x = _block(96, 17, seed=2)
    with pytest.raises(ValueError):
        tfb.headwise_attn_block(torch.from_numpy(x), from_jax(p), 4,
                                want_attn=True, **kw)


def test_headwise_refuses_devices_it_has_no_path_for():
    p, x = _block(96, 17, seed=3)
    with pytest.raises(ValueError):
        tfb.headwise_attn_block(torch.from_numpy(x).to("meta"), from_jax(p), 4)


@pytest.mark.parametrize("n,d,heads,ok", [
    (577, 1024, 16, True),   # vit_l16 @384: 32-row query tiles
    (1374, 384, 6, True),    # dinov2 @518
    (3000, 768, 12, True),   # 16-row query tiles
    (4000, 768, 12, False),  # 16 rows of scores exceed shared memory
    (197, 1280, 5, False),   # dh=256 > 128
    (197, 198, 3, False),    # dh=66: rows are not whole float4s
    (197, 768, 7, False),    # width does not split into heads
])
def test_fits_headwise_envelope(n, d, heads, ok):
    assert tfb.fits_headwise(n, d, heads) is ok
