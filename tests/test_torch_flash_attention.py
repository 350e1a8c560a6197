"""The port's flash attention (its plain version, on the CPU) against the
JAX package's Pallas ``flash_attention`` in interpret mode, on shared
inputs; and the port's attention dispatch.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: f32 atol 1e-5, as the JAX package's own kernel tests. bf16: the
probs come back in bf16 in both packages; each agrees within one bf16 ulp
of its own value (2^-7 of it, plus 1e-6), the output within 2^-6 of its
scale.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interactive_vit_tpu.ops import flash_attention as jfa
from interactive_vit_tpu_torch.ops import attention as tattn
from interactive_vit_tpu_torch.ops import dispatch
from interactive_vit_tpu_torch.ops import flash_attention as tfa
from interactive_vit_tpu_torch.ops import fused_block as tfb
from interactive_vit_tpu_torch.ops import tiled_attention as tiled

torch.set_num_threads(2)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        jfa.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _qkv(b, h, n, dh, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, n, dh)) * scale).astype(np.float32)
            for _ in range(3)]


def _both(q, k, v, **kw):
    want = jfa.flash_attention(*(jnp.asarray(t) for t in (q, k, v)), **kw)
    got = tfa.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), **kw)
    return got, want


@pytest.mark.parametrize("want_attn", [False, True])
@pytest.mark.parametrize("n", [17, 130, 300])
def test_rowfull_matches_pallas(n, want_attn):
    q, k, v = _qkv(2, 3, n, 16, seed=n, scale=2.0)
    (o, probs), (jo, jprobs) = _both(q, k, v, want_attn=want_attn)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    if want_attn:
        assert probs.dtype == torch.float32 and probs.shape == (2, 3, n, n)
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                                   atol=ATOL, rtol=0)
    else:
        assert probs is None and jprobs is None


@pytest.mark.parametrize("want_attn", [False, True])
@pytest.mark.parametrize("n,n_real", [(130, 100), (300, 257)])
def test_n_real_masks_padded_keys(n, n_real, want_attn):
    q, k, v = _qkv(1, 2, n, 8, seed=n_real)
    (o, probs), (jo, jprobs) = _both(q, k, v, want_attn=want_attn,
                                     n_real=n_real)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    # real query rows: the same as attention over the real keys alone
    (o_real, p_real) = tfa.flash_attention(
        *(torch.from_numpy(t[:, :, :n_real]) for t in (q, k, v)),
        want_attn=True)
    torch.testing.assert_close(o[:, :, :n_real], o_real, atol=ATOL, rtol=0)
    if want_attn:
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                                   atol=ATOL, rtol=0)
        assert torch.all(probs[..., n_real:] == 0)
        torch.testing.assert_close(probs[:, :, :n_real, :n_real], p_real,
                                   atol=ATOL, rtol=0)


def test_bf16_probs_come_back_in_the_query_dtype():
    q, k, v = _qkv(1, 2, 130, 16, seed=7, scale=2.0)
    as_bf16 = [jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)]
    jo, jprobs = jfa.flash_attention(*as_bf16, want_attn=True)
    tq, tk, tv = (torch.from_numpy(np.array(t.astype(jnp.float32)))
                  .to(torch.bfloat16) for t in as_bf16)
    o, probs = tfa.flash_attention(tq, tk, tv, want_attn=True)
    assert probs.dtype == o.dtype == torch.bfloat16
    assert jprobs.dtype == jnp.bfloat16
    np.testing.assert_allclose(probs.float().numpy(),
                               np.asarray(jprobs.astype(jnp.float32)),
                               atol=1e-6, rtol=2.0 ** -7)
    scale = float(np.abs(np.asarray(jo.astype(jnp.float32))).max())
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               atol=2.0 ** -6 * scale, rtol=0)
    # the plain reference path keeps f32 probs; the flash contract does not
    _, ref_probs = tattn.attention_reference(tq, tk, tv, want_attn=True)
    assert ref_probs.dtype == torch.float32


def test_maps_above_rowfull_max_return_attention_reference():
    n = tfa.ROWFULL_MAX_N + 8
    q, k, v = _qkv(1, 1, n, 4, seed=11)
    (o, probs), (jo, jprobs) = _both(q, k, v, want_attn=True, n_real=n - 3)
    ro, rprobs = tattn.attention_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), want_attn=True,
        n_real=n - 3)
    assert torch.equal(o, ro) and torch.equal(probs, rprobs)
    assert probs.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=ATOL,
                               rtol=0)


def test_flash_mhsa_in_mhsa_matches_jax():
    """``mhsa`` with the flash attention in both packages, on the
    transposed q/k/v views ``qkv_proj`` makes."""
    from interactive_vit_tpu.ops import attention as jattn

    rng = np.random.default_rng(4)
    d = 32
    x = rng.standard_normal((2, 130, d)).astype(np.float32)
    p = {"qkv_w": (rng.standard_normal((d, 3 * d)) * d ** -0.5)
         .astype(np.float32),
         "qkv_b": rng.standard_normal(3 * d).astype(np.float32) * 0.1,
         "proj_w": (rng.standard_normal((d, d)) * d ** -0.5)
         .astype(np.float32),
         "proj_b": rng.standard_normal(d).astype(np.float32) * 0.1}
    jy, jprobs = jattn.mhsa(jnp.asarray(x), {k: jnp.asarray(a) for k, a
                                             in p.items()}, 4, want_attn=True,
                            attn_impl=jfa.flash_mhsa)
    y, probs = tattn.mhsa(torch.from_numpy(x), {k: torch.from_numpy(a) for
                                                k, a in p.items()}, 4,
                          want_attn=True, attn_impl=tfa.flash_mhsa)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=ATOL,
                               rtol=0)


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, 40, 8, seed=3))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, want_attn=True)
    ref = tfa.flash_attention_reference(q, k, v, want_attn=True)
    assert tfa.flash_attention.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_flash_refuses_devices_it_has_no_path_for():
    q = torch.zeros(1, 1, 8, 4, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)


@pytest.mark.parametrize("n,dh,ok", [
    (1374, 64, True), (577, 64, True), (2048, 64, True), (17, 16, True),
    (2049, 64, False),  # above ROWFULL_MAX_N: the online kernel's range
    (300, 256, False),  # head wider than 128
    (300, 30, False),   # not whole float4s
])
def test_fits_envelope(n, dh, ok):
    assert tfa.fits(n, dh) is ok


def test_smem_formula_check_refuses_a_library_that_disagrees():
    def lib_formula(n, dh):
        qt = tiled.query_tile(n, dh)
        return tiled.smem_bytes(n, dh, qt) if qt else 0

    tiled.check_smem_formula(lib_formula)
    with pytest.raises(RuntimeError, match="disagree"):
        tiled.check_smem_formula(lambda n, dh: tiled.smem_bytes(n, dh, 32))
    with pytest.raises(RuntimeError, match="disagree"):  # "never runs"
        tiled.check_smem_formula(lambda n, dh: 0)


@pytest.mark.parametrize("name,dtype,device,n,d,heads,want", [
    ("auto", torch.bfloat16, "cuda", 197, 768, 12, "fused"),     # vit_b16
    ("auto", torch.bfloat16, "cuda", 577, 1024, 16, "headwise"),  # vit_l16
    ("auto", torch.float32, "cuda:0", 577, 1024, 16, "headwise"),
    ("auto", torch.bfloat16, "cuda", 1374, 384, 6, "headwise"),
    ("auto", torch.bfloat16, "cpu", 577, 1024, 16, None),
    ("auto", torch.bfloat16, None, 577, 1024, 16, None),
    ("auto", torch.float16, "cuda", 577, 1024, 16, None),
    ("auto", torch.bfloat16, "cuda", 5000, 1024, 16, None),  # fits neither
    ("headwise", torch.float32, "cpu", 197, 768, 12, "headwise"),
    ("reference", torch.bfloat16, "cuda", 577, 1024, 16, None),
])
def test_block_dispatch_by_shape_and_device(name, dtype, device, n, d, heads,
                                            want):
    impl = dispatch.default_block_impl(name, dtype=dtype, n=n, d=d,
                                       heads=heads, device=device)
    assert impl is {"fused": tfb.fused_attn_block,
                    "headwise": tfb.headwise_attn_block, None: None}[want]


def test_attn_dispatch_names():
    assert dispatch.default_attn_impl("reference") is None
    assert dispatch.default_attn_impl("flash") is tfa.flash_mhsa
    assert dispatch.default_attn_impl("auto") is dispatch.auto_attention
    with pytest.raises(ValueError):
        dispatch.default_attn_impl("int8-scores")


class _CudaLike:
    """Stands in for a CUDA tensor: auto_attention reads only its device
    and shape before handing it on."""

    def __init__(self, n):
        self.device = torch.device("cuda")
        self.shape = (1, 2, n, 8)


@pytest.mark.parametrize("device,n,want", [
    ("cuda", 256, "flash"), ("cuda", 1374, "flash"),
    ("cuda", 255, "reference"), ("cpu", 1374, "reference"),
])
def test_auto_attention_routes_by_device_and_length(monkeypatch, device, n,
                                                    want):
    calls = []
    monkeypatch.setattr(tfa, "flash_mhsa",
                        lambda *a, **kw: calls.append("flash") or "flash")
    monkeypatch.setattr(tattn, "attention_reference",
                        lambda *a, **kw: calls.append("reference")
                        or "reference")
    q = _CudaLike(n) if device == "cuda" else torch.zeros(1, 2, n, 8)
    assert dispatch.auto_attention(q, q, q, want_attn=True) == want
    assert calls == [want]
