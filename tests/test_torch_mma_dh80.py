"""The tensor-core routes at heads 80 wide (vit_h14's heads), on the CPU:
rows 3 and 4 in bf16, and the trainable attention (row 8) in bf16 and f32.
The routes' widths (the trainable attention's are its own; the packed
layout stays 64 wide; the route predicate's 80-wide cases of rows 3-4 are
in ``tests/test_torch_mma_attention.py``), the train routes on and off the
16-byte grid, the plain versions against the JAX package's Pallas kernels
in interpret mode at dh=80 on shared inputs, an emulation of the
row-resident kernel's key parts against the JAX kernel, the wrappers' CPU
path, and the libraries' width entries and the loaders' check of them.

The kernels themselves (``csrc/flash_attention_mma.cu``,
``csrc/flash_attention_online_mma.cu``, ``csrc/attention_train_mma.cu``,
``csrc/attention_train_tf32.cu``, one instantiation a width) run only on
the card: their ``cuda``-marked tests are in
``tests/test_torch_cuda_kernel.py``.

Tolerances, as ``tests/test_torch_online_flash.py`` and
``tests/test_torch_flash_attention.py``: f32 atol 1e-5 (only the order of
f32 sums differs). bf16: both packages cast p (or the normalised probs) to
bf16 at the same points, so an output moves only where an f32 sum rounds
to the other bf16 neighbour: 2^-6 of the output's scale; a probs element
within one bf16 ulp of its own value (2^-7 of it, plus 1e-6).
"""

import ctypes
import functools
import os
import re
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interactive_vit_tpu.ops import flash_attention as jfa
from interactive_vit_tpu_torch.ops import attention_vjp as av
from interactive_vit_tpu_torch.ops import flash_attention as fa
from interactive_vit_tpu_torch.runtime import cuda_build

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32
ATOL = 1e-5
DH = 80


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        jfa.pl, "pallas_call", functools.partial(pl.pallas_call,
                                                 interpret=True))


# -- the route predicate ----------------------------------------------------------

def test_mma_widths():
    """The route's widths, in increasing order, and the train routes' own
    widths: 64 and 80 in both dtypes, each of them a width of the
    forward's row-3 kernels; the packed layout's heads stay 64 wide."""
    assert fa.MMA_DHS == (64, 80)
    assert av.TRAIN_MMA_DHS == av.TRAIN_TF32_DHS == (64, 80)
    assert set(av.TRAIN_TF32_DHS) <= set(fa.TF32_DHS)
    assert av.PACKED_DH == 64


def _layout(layout, dtype, dh, pad=0):
    """(ptrs, stride triples, views) the trainable attention's wrappers
    hand the predicate: [B, H, N, dh] views of one qkv tensor, or the
    head-major packed slabs (views None); rows ``pad`` elements longer."""
    b, n, h = 2, 197, 4
    qkv = torch.zeros((b, n, 3 * h * dh + pad), dtype=dtype)[..., :3 * h * dh]
    if layout == "bhnd":
        views = [qkv.reshape(b, n, 3, h, dh)[:, :, i].transpose(1, 2)
                 for i in range(3)]
        return ([av._ptr(t) for t in views],
                [av._strides(t, None) for t in views], views)
    return ([av._ptr(qkv, i * dh) for i in range(3)],
            [av._strides(qkv, 3 * dh)] * 3, None)


@pytest.mark.parametrize("layout", ["bhnd", "packed"])
def test_train_route_stays_64_wide(layout):
    """bf16 heads 80 wide on the 16-byte grid: rows 3-4 and the trainable
    attention both take the tensor cores, in both of its layouts' pointer
    and stride shapes; the packed layout itself stays 64 wide (its
    kernels are chosen by ``packed_ok``, which asks for ``PACKED_DH``), and
    64 wide takes the tensor cores as before."""
    ptrs, strides, views = _layout(layout, BF16, 80)
    flat = [s for st in strides for s in st]
    assert fa.mma_route(BF16, 80, ptrs, flat)
    assert av._mma_ok(BF16, 80, ptrs, strides) is True
    assert av._tc_ok(BF16, 80, ptrs, strides) is True
    assert av._tf32_ok(BF16, 80, ptrs, strides) is False
    if views is not None:
        assert fa._mma_operands(*views)
    assert av.packed_ok(16, 80, 257) is False
    assert av.packed_ok(16, 64, 257) is True
    ptrs, strides, _ = _layout(layout, BF16, 64)
    assert av._mma_ok(BF16, 64, ptrs, strides) is True


@pytest.mark.parametrize("layout", ["bhnd", "packed"])
@pytest.mark.parametrize("dtype,pad", [
    (BF16, 4), (F32, 0), (F32, 2),
    (BF16, 0), (BF16, 8),   # a token 16 bytes longer: still on the grid
    (BF16, 2), (F32, 4), (F32, 1),
])
def test_train_route_at_80_wide_is_the_fma_pair(layout, dtype, pad):
    """Heads 80 wide: the FMA pair only off the 16-byte grid; on it,
    ``_mma_ok`` (bf16) or ``_tf32_ok`` (f32) takes them, never the other
    dtype's; other widths are neither route's."""
    ptrs, strides, _ = _layout(layout, dtype, 80, pad)
    on_grid = pad * (2 if dtype == BF16 else 4) % 16 == 0
    assert av._tc_ok(dtype, 80, ptrs, strides) is on_grid
    assert av._mma_ok(dtype, 80, ptrs, strides) is (on_grid and dtype == BF16)
    assert av._tf32_ok(dtype, 80, ptrs, strides) is (on_grid and dtype == F32)
    for dh in (48, 96, 128):
        ptrs, strides, _ = _layout(layout, dtype, dh, pad)
        assert av._tc_ok(dtype, dh, ptrs, strides) is False


# -- the plain versions against JAX at 80 wide ---------------------------------------


def _qkv(b, h, n, dh, seed):
    rng = np.random.default_rng(seed)
    return [(2 * rng.standard_normal((b, h, n, dh))).astype(np.float32)
            for _ in range(3)]


def _as(t, dtype):
    """numpy f32 -> (jax array, torch tensor) of the same values in
    ``dtype`` (bf16 rounded once, by JAX)."""
    j = jnp.asarray(t, jnp.bfloat16 if dtype == BF16 else jnp.float32)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(dtype)


def _close(got, want, dtype):
    """o within f32's ATOL or 2^-6 of bf16's scale."""
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == F32:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("n_real", [None, 280])
def test_online_plain_version_at_80_wide_matches_jax(monkeypatch, dtype,
                                                     n_real):
    """Row 4's plain version (key tiles of 128, JAX's ``block_k``) against
    JAX's online kernel at (1, 2, 300, 80): three key tiles, the last of
    44 keys, keys masked beyond 280 inside it."""
    monkeypatch.setattr(jfa, "ROWFULL_MAX_N", 64)
    (jq, tq), (jk, tk), (jv, tv) = (_as(t, dtype)
                                    for t in _qkv(1, 2, 300, DH, seed=11))
    want, probs = jfa.flash_attention(jq, jk, jv, n_real=n_real, block_k=128)
    assert probs is None
    got = fa.flash_attention_online_reference(tq, tk, tv, n_real=n_real)
    assert got.dtype == dtype and got.shape == (1, 2, 300, DH)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("want_attn", [False, True])
@pytest.mark.parametrize("n,n_real", [(257, None), (320, 257)])
def test_rowfull_plain_version_at_80_wide_matches_jax(dtype, want_attn, n,
                                                      n_real):
    """Row 3's plain version against JAX's row-resident kernel at
    vit_h14@224's N=257 and its padded form, maps on and off; the probs
    come back in the query dtype."""
    (jq, tq), (jk, tk), (jv, tv) = (_as(t, dtype)
                                    for t in _qkv(1, 2, n, DH, seed=n))
    jo, jprobs = jfa.flash_attention(jq, jk, jv, want_attn=want_attn,
                                     n_real=n_real)
    o, probs = fa.flash_attention_reference(tq, tk, tv, want_attn, n_real)
    _close(o, jo, dtype)
    if not want_attn:
        assert probs is None and jprobs is None
        return
    assert probs.dtype == dtype and probs.shape == (1, 2, n, n)
    jp = np.asarray(jprobs.astype(jnp.float32))
    if dtype == F32:
        np.testing.assert_allclose(probs.numpy(), jp, atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(probs.float().numpy(), jp, atol=1e-6,
                                   rtol=2.0 ** -7)
    if n_real is not None:
        assert not probs[..., n_real:].any() and not jp[..., n_real:].any()


def rowfull_mma_emulated(q, k, v, n_real, parts, kw=64):
    """Row 3's bf16 tensor-core kernel's arithmetic on bf16 [B, H, N, dh]:
    f32 scores of the bf16 values, tiles of ``parts`` x ``kw`` keys (keys
    past N and at or beyond ``n_real`` at MASK_VALUE), each part's (m, l)
    by the online update over its ``kw`` keys of every tile, the parts
    combined (m the max, l = sum l_j exp(m_j - m), in part order), probs =
    exp(s - m) / l cast to bf16 (the tap and PV's operand), and o = the
    parts' partial f32 PV sums added in part order, cast. Returns (o,
    probs)."""
    n = q.shape[-2]
    kt = kw * parts
    n_pad = -(-n // kt) * kt
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        q.shape[-1] ** -0.5)
    s[..., n_real:] = fa.MASK_VALUE
    s = torch.cat([s, torch.full(s.shape[:-1] + (n_pad - n,), fa.MASK_VALUE)],
                  dim=-1)
    vp = torch.cat([v.float(),
                    torch.zeros(v.shape[:-2] + (n_pad - n, v.shape[-1]))],
                   dim=-2)
    stats = []
    for j in range(parts):
        m = torch.full(s.shape[:-1], float("-inf"))
        l = torch.zeros_like(m)
        for j0 in range(j * kw, n_pad, kt):
            st = s[..., j0:j0 + kw]
            m_next = torch.maximum(m, st.amax(dim=-1))
            l = torch.exp(m - m_next) * l + torch.exp(
                st - m_next[..., None]).sum(dim=-1)
            m = m_next
        stats.append((m, l))
    m = functools.reduce(torch.maximum, [mj for mj, _ in stats])
    l = torch.zeros_like(m)
    for mj, lj in stats:
        l = l + lj * torch.exp(mj - m)
    probs = (torch.exp(s - m[..., None]) / l[..., None]).to(BF16)
    o = torch.zeros(q.shape, dtype=F32)
    for j in range(parts):
        oj = torch.zeros(q.shape, dtype=F32)
        for j0 in range(j * kw, n_pad, kt):
            oj = oj + torch.matmul(probs[..., j0:j0 + kw].float(),
                                   vp[..., j0:j0 + kw, :])
        o = o + oj
    return o.to(BF16), probs[..., :n]


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("n,n_real", [(257, 257), (320, 257)])
def test_rowfull_key_parts_at_80_wide_match_jax(parts, n, n_real):
    """The kernel's key parts (two for a grid above one block an SM, four
    at vit_h14@224's 80 blocks) keep JAX's cast points: o and the tap
    within the bf16 bounds of the JAX row-resident kernel's."""
    (jq, tq), (jk, tk), (jv, tv) = (_as(t, BF16)
                                    for t in _qkv(1, 2, n, DH, seed=n + parts))
    jo, jprobs = jfa.flash_attention(jq, jk, jv, want_attn=True,
                                     n_real=None if n_real == n else n_real)
    o, probs = rowfull_mma_emulated(tq, tk, tv, n_real, parts)
    _close(o, jo, BF16)
    jp = np.asarray(jprobs.astype(jnp.float32))
    np.testing.assert_allclose(probs.float().numpy(), jp, atol=1e-6,
                               rtol=2.0 ** -7)
    assert not probs[..., n_real:].any()


# -- the wrappers on the CPU ---------------------------------------------------------


def _counts():
    return (fa.flash_attention.launches, fa.flash_attention_mma.launches,
            fa.flash_attention_online.launches,
            fa.flash_attention_online_mma.launches)


@pytest.mark.parametrize("n_real", [None, 250])
def test_wrappers_at_80_wide_keep_the_plain_versions_on_the_cpu(n_real):
    """bf16 heads 80 wide on CPU tensors: the tensor-core wrappers and the
    dispatching ones return the plain versions and count no launch."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 2, 257, DH), generator=g).to(BF16)
               for _ in range(3))
    before = _counts()
    for want_attn in (False, True):
        ref = fa.flash_attention_reference(q, k, v, want_attn, n_real)
        for fn in (fa.flash_attention, fa.flash_attention_mma):
            got = fn(q, k, v, want_attn=want_attn, n_real=n_real)
            assert torch.equal(got[0], ref[0])
            assert (got[1] is None) == (ref[1] is None)
            if want_attn:
                assert torch.equal(got[1], ref[1])
    ref = fa.flash_attention_online_reference(q, k, v, n_real)
    assert torch.equal(fa.flash_attention_online(q, k, v, n_real), ref)
    assert torch.equal(fa.flash_attention_online_mma(q, k, v, n_real), ref)
    assert _counts() == before


# -- the libraries' widths -----------------------------------------------------------


def _source(name):
    with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
        return f.read()


@pytest.mark.parametrize("source,entry", [
    ("flash_attention_mma.cu", "ivt_flash_mma_dh"),
    ("flash_attention_online_mma.cu", "ivt_online_mma_dh"),
    ("attention_train_mma.cu", "ivt_train_mma_dh"),
    ("attention_train_tf32.cu", "ivt_train_tf32_dh"),
])
def test_width_entries_take_one_int(source, entry):
    """The i-th width: one int parameter, as the loader binds it."""
    params = re.search(r"int " + entry + r"\(([^)]*)\)",
                       _source(source)).group(1)
    assert params.split() == ["int", "i"]


@pytest.mark.parametrize("source,array", [
    ("flash_attention_mma.cu", "FM_DHS"),
    ("flash_attention_online_mma.cu", "OM_DHS"),
])
def test_sources_are_built_for_the_route_widths(source, array):
    """Each source's list of instantiated widths, and its entry's refusal
    of any other, are ``MMA_DHS``."""
    src = _source(source)
    listed = re.search(r"constexpr int " + array + r"\[\] = \{([^}]*)\}",
                       src).group(1)
    assert tuple(int(x) for x in listed.split(",")) == fa.MMA_DHS
    assert "(dh != 64 && dh != 80)" in src
    for dh in fa.MMA_DHS:
        assert f"<{dh}>" in src or f"<{dh}," in src


@pytest.mark.parametrize("source,array,dhs", [
    ("attention_train_mma.cu", "TM_DHS", av.TRAIN_MMA_DHS),
    ("attention_train_tf32.cu", "TT_DHS", av.TRAIN_TF32_DHS),
])
def test_train_sources_are_built_for_the_route_widths(source, array, dhs):
    """Each train source's list of instantiated widths is its route's, its
    entries refuse any other width, and both kernels of the backward (and
    the bf16 forward) are instantiated at each."""
    src = _source(source)
    listed = re.search(r"constexpr int " + array + r"\[\] = \{([^}]*)\}",
                       src).group(1)
    assert tuple(int(x) for x in listed.split(",")) == dhs
    assert ("(dh == 64 || dh == 80)" in src
            or "(dh != 64 && dh != 80)" in src)
    for dh in dhs:
        assert f"launch_bwd<{dh}>" in src
    if source == "attention_train_mma.cu":
        for dh in dhs:
            assert f"train_fwd_mma_kernel<{dh}>" in src


def _widths(dhs):
    """A library's ``ivt_*_dh(i)``: the i-th of ``dhs``, 0 past the last."""
    return lambda i: dhs[i] if 0 <= i < len(dhs) else 0


@pytest.mark.parametrize("dhs,ok", [
    ((64, 80), True),
    ((64,), False),       # a library built before heads 80 wide
    ((80,), False),
    ((80, 64), False),    # the order is part of the contract
    ((64, 80, 96), False),
    ((), False),
])
@pytest.mark.parametrize("source", ["csrc/flash_attention_mma.cu",
                                    "csrc/flash_attention_online_mma.cu"])
def test_mma_dh_check_refuses_a_library_that_disagrees(source, dhs, ok):
    if ok:
        fa.check_mma_dhs(_widths(dhs), source)
        return
    with pytest.raises(RuntimeError, match="MMA_DHS disagree"):
        fa.check_mma_dhs(_widths(dhs), source)



class _Entry:
    """A C entry's stand-in: takes ctypes' argtypes / restype, and calls
    ``fn``."""

    def __init__(self, fn=None):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


def _fake_library(entries, dhs):
    """A stand-in for a loaded kernel library whose width entry (the last
    of ``entries``) reports ``dhs``."""
    lib = types.SimpleNamespace(**{name: _Entry() for name in entries})
    lib.__dict__[entries[-1]] = _Entry(_widths(dhs))
    return lib


TRAIN_LIBS = {
    "attention_train_mma": ("_mma_lib", "load_mma_kernel", "TRAIN_MMA_DHS",
                            ["ivt_attention_train_fwd_mma",
                             "ivt_attention_train_bwd_mma",
                             "ivt_train_mma_dh"]),
    "attention_train_tf32": ("_tf32_lib", "load_tf32_kernel",
                             "TRAIN_TF32_DHS",
                             ["ivt_attention_train_bwd_tf32",
                              "ivt_train_tf32_dh"]),
}


@pytest.mark.parametrize("dhs,ok", [
    ((64, 80), True),
    ((64,), False),       # a library built before heads 80 wide
    ((80,), False),
    ((80, 64), False),    # the order is part of the contract
    ((64, 80, 96), False),
    ((), False),
])
@pytest.mark.parametrize("name", sorted(TRAIN_LIBS))
def test_train_loaders_refuse_a_library_that_disagrees(monkeypatch, name,
                                                       dhs, ok):
    """``load_mma_kernel`` / ``load_tf32_kernel`` bind the width entry as
    one int parameter, read the library's widths through it and raise
    unless they are the route's: a train step must never reach a library
    without its width's instantiation."""
    binder, loader, route, entries = TRAIN_LIBS[name]
    lib = _fake_library(entries, dhs)
    built = []
    monkeypatch.setattr(cuda_build, "load",
                        lambda source: built.append(source) or lib)
    # the f32 loader builds and checks row 3's forward first
    monkeypatch.setattr(fa, "load_tf32_kernel", lambda: None)
    load = getattr(av, loader)
    if ok:
        assert load() is lib
    else:
        with pytest.raises(RuntimeError, match=route + " disagree"):
            load()
    assert built[0] == name
    width = getattr(lib, entries[-1])
    assert width.argtypes == [ctypes.c_int]
    assert width.restype is ctypes.c_int
    assert getattr(av, binder)() is lib
