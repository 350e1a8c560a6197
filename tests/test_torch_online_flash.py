"""The port's online-softmax flash attention (its plain version, on the
CPU) against the JAX package's ``_online_call`` in interpret mode.

The JAX function takes its online branch for N above ``ROWFULL_MAX_N``
with maps off; the tests lower that threshold on the JAX module inside
each test (the module itself is not edited), as
``tests/test_flash_attention.py`` does, and run N in {300, 2049}, with
keys masked beyond ``n_real`` and a last key tile that is partly filled.
The port's plain version runs at JAX's ``block_k=128``.

Tolerances: f32 atol 1e-5 (only the order of f32 sums differs). bf16: the
two packages cast p to bf16 at the same points against the same running
maxima, so an output moves only where an f32 sum rounds to the other
bf16 neighbour: 2^-6 of the output's scale.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interactive_vit_tpu.ops import flash_attention as jfa
from interactive_vit_tpu_torch.ops import dispatch
from interactive_vit_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        jfa.pl, "pallas_call", functools.partial(pl.pallas_call,
                                                 interpret=True))


def _qkv(b, h, n, dh, seed):
    rng = np.random.default_rng(seed)
    return [(2 * rng.standard_normal((b, h, n, dh))).astype(np.float32)
            for _ in range(3)]


def _jax_online(q, k, v, n_real, monkeypatch, dtype=jnp.float32):
    monkeypatch.setattr(jfa, "ROWFULL_MAX_N", 64)
    o, probs = jfa.flash_attention(*(jnp.asarray(t, dtype) for t in (q, k, v)),
                                   n_real=n_real, block_k=128)
    assert probs is None
    return np.asarray(o.astype(jnp.float32))


@pytest.mark.parametrize("b,h,n,dh,n_real", [
    (1, 2, 300, 64, None),    # three key tiles, the last one of 44 keys
    (2, 1, 300, 16, 257),     # keys masked beyond n_real inside a tile
    (1, 1, 2049, 32, None),   # just above ROWFULL_MAX_N: one key past 16 tiles
    (1, 1, 2049, 32, 1999),
])
def test_online_plain_version_matches_jax(monkeypatch, b, h, n, dh, n_real):
    q, k, v = _qkv(b, h, n, dh, seed=n + dh)
    want = _jax_online(q, k, v, n_real, monkeypatch)
    got = tfa.flash_attention_online_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), n_real=n_real,
        block_k=128)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_online_plain_version_bf16_near_jax(monkeypatch):
    q, k, v = _qkv(1, 2, 300, 64, seed=5)
    want = _jax_online(q, k, v, 280, monkeypatch, jnp.bfloat16)
    got = tfa.flash_attention_online_reference(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)),
        n_real=280).float().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()


def test_online_and_row_resident_forms_agree():
    """In f32 the two algorithms compute the same softmax: the online one
    at any key tile width matches the row-resident plain version."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, 300, 32, seed=2))
    ref, _ = tfa.flash_attention_reference(q, k, v, n_real=290)
    for block_k in (64, 128, 512):
        got = tfa.flash_attention_online_reference(q, k, v, n_real=290,
                                                   block_k=block_k)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL,
                                   rtol=0)


def test_wrapper_takes_the_online_branch_above_rowfull_max(monkeypatch):
    """Maps off above ROWFULL_MAX_N: ``flash_attention`` hands q, k, v to
    ``flash_attention_online`` (on the CPU its plain version; the launch
    counts stay), whose result equals JAX's online branch."""
    n = tfa.ROWFULL_MAX_N + 1
    q, k, v = _qkv(1, 1, n, 8, seed=9)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    before = (tfa.flash_attention.launches,
              tfa.flash_attention_online.launches)
    o, probs = tfa.flash_attention(tq, tk, tv, n_real=n - 2)
    assert probs is None
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_online.launches) == before
    assert torch.equal(o, tfa.flash_attention_online_reference(
        tq, tk, tv, n_real=n - 2))
    monkeypatch.setattr(jfa, "ROWFULL_MAX_N", 2048)  # JAX's own threshold
    jo, _ = jfa.flash_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                n_real=n - 2)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, rtol=0)


def test_auto_attention_reaches_the_online_branch(monkeypatch):
    calls = []
    monkeypatch.setattr(tfa, "flash_attention_online",
                        lambda q, k, v, n_real=None: calls.append(n_real)
                        or "online")
    q = torch.zeros(1, 1, tfa.ROWFULL_MAX_N + 8, 4)
    assert tfa.flash_mhsa(q, q, q) == ("online", None)
    assert calls == [tfa.ROWFULL_MAX_N + 8]
    assert dispatch.default_attn_impl("flash") is tfa.flash_mhsa


@pytest.mark.parametrize("n,dh,ok", [
    (2814, 64, True),   # dinov2_s14_reg@742
    (1, 64, True), (100000, 128, True),  # shared memory does not grow with N
    (2814, 256, False), (2814, 30, False), (0, 64, False),
])
def test_fits_online(n, dh, ok):
    assert tfa.fits_online(n, dh) is ok


def test_online_smem_is_independent_of_n():
    assert tfa.online_smem_bytes(64) == 4 * (32 * 64 + 2 * 128 * 68
                                             + 32 * 128 + 64)
    assert tfa.online_smem_bytes(128) <= 232448


def test_online_wrapper_refuses_other_devices():
    q = torch.zeros(1, 1, 8, 4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_online(q, q, q)
