"""The port's trainable attention (``ops/attention_vjp``: its plain versions,
on the CPU) against the JAX package's custom-VJP Pallas kernels in
interpret mode and ``jax.grad`` of ``attention_reference``, on shared
inputs; plus the packed layout, ``mhsa``'s packed path and the train
attention dispatch.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: f32 values 1e-5 and gradients 1e-4 absolute, as the JAX
package's own tests of these kernels (``tests/test_attention_vjp.py``).
bf16: both packages round P (for dv), ds and the outputs at the same
points; an f32 sum that lands within its rounding error of a bf16 boundary
rounds to the neighbour, one ulp of the element, so each element is held
to 2^-6 of its JAX value plus 2^-8 of the tensor's largest value.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl

from interactive_vit_tpu.ops import attention_vjp as jav
from interactive_vit_tpu.ops import flash_attention as jfa
from interactive_vit_tpu.ops.attention import attention_reference as jref
from interactive_vit_tpu_torch.ops import attention as tattn
from interactive_vit_tpu_torch.ops import attention_vjp as av
from interactive_vit_tpu_torch.ops import dispatch

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    interp = functools.partial(pl.pallas_call, interpret=True)
    # the forward rides flash_attention's _rowfull_call; the backward and
    # the packed kernels are attention_vjp's own calls
    monkeypatch.setattr(jfa.pl, "pallas_call", interp)
    monkeypatch.setattr(jav.pl, "pallas_call", interp)


def _arrays(shape, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(count)]


def _jax_value_and_grads(fn, arrays, ct, dtype=jnp.float32):
    """fn's value and the grads of sum(fn(*arrays) * ct) w.r.t. arrays."""
    xs = [jnp.asarray(a, dtype) for a in arrays]

    def loss(*xs):
        return jnp.sum(fn(*xs).astype(jnp.float32)
                       * jnp.asarray(ct, jnp.float32))

    grads = jax.grad(loss, argnums=tuple(range(len(xs))))(*xs)
    return (np.asarray(fn(*xs).astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _torch_value_and_grads(fn, arrays, ct, dtype=torch.float32):
    xs = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays]
    out = fn(*xs)
    out.backward(torch.from_numpy(ct).to(dtype))
    return out.detach().float().numpy(), [x.grad.float().numpy() for x in xs]


def _jax_reference(n_real):
    return lambda q, k, v: jref(q, k, v, n_real=n_real)[0]


@pytest.mark.parametrize("against", ["pallas", "grad_of_reference"])
@pytest.mark.parametrize("n,n_real", [(64, None), (197, None), (208, 197)])
def test_attention_train_matches_jax(n, n_real, against):
    q, k, v, ct = _arrays((1, 2, n, 32), 4, seed=n)
    jfn = (functools.partial(jav.attention_train, n_real=n_real)
           if against == "pallas" else _jax_reference(n_real))
    jo, jgrads = _jax_value_and_grads(jfn, (q, k, v), ct)
    o, grads = _torch_value_and_grads(
        functools.partial(av.attention_train, n_real=n_real), (q, k, v), ct)
    np.testing.assert_allclose(o, jo, atol=1e-5, rtol=0)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, atol=1e-4, rtol=0)
    if n_real is not None:
        assert np.all(grads[1][:, :, n_real:] == 0)
        assert np.all(grads[2][:, :, n_real:] == 0)


def _within_bf16(got, want):
    bound = 2.0 ** -6 * np.abs(want) + 2.0 ** -8 * np.abs(want).max()
    return bool(np.all(np.abs(got - want) <= bound))


@pytest.mark.parametrize("dh,n,n_real", [
    (64, 197, None), (64, 208, 197),
    # vit_h14's heads, 80 wide (the bf16 tensor-core route on a card)
    (80, 33, None), (80, 130, 100)])
def test_attention_train_bf16_grads_match_pallas(dh, n, n_real):
    q, k, v, ct = _arrays((2, 2, n, dh), 4, seed=n + 1)
    jo, jgrads = _jax_value_and_grads(
        functools.partial(jav.attention_train, n_real=n_real), (q, k, v), ct,
        jnp.bfloat16)
    o, grads = _torch_value_and_grads(
        functools.partial(av.attention_train, n_real=n_real), (q, k, v), ct,
        torch.bfloat16)
    assert _within_bf16(o, jo)
    for g, jg in zip(grads, jgrads):
        assert _within_bf16(g, jg)
        # the bound refuses a gradient zeroed or halved
        assert not _within_bf16(g * 0.5, jg)
        assert not _within_bf16(np.zeros_like(g), jg)
    if n_real is not None:  # masked keys' dk and dv exactly 0
        assert not grads[1][:, :, n_real:].any()
        assert not grads[2][:, :, n_real:].any()


@pytest.mark.parametrize("n_real", [None, 4])
def test_attention_train_gradcheck_float64(n_real):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 2, 6, 4), generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q, k, v: av.attention_train(q, k, v, n_real), (q, k, v))


def test_attention_train_packed_gradcheck_float64():
    g = torch.Generator().manual_seed(4)
    qkv = torch.randn((1, 3, 3 * 2 * av.PACKED_DH), generator=g,
                      dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: av.attention_train_packed(x, 2), (qkv,))


def _pack_head_major(q, k, v):
    """[B, H, N, dh] x3 -> the head-major qkv activation [B, N, 3HD]."""
    b, h, n, d = q.shape
    qkv = np.stack([q, k, v], axis=2)  # [B, H, 3, N, dh]
    return np.ascontiguousarray(qkv.transpose(0, 3, 1, 2, 4)
                                .reshape(b, n, 3 * h * d))


@pytest.mark.parametrize("n,n_real", [(197, None), (208, 197)])
def test_attention_train_packed_matches_jax(n, n_real):
    q, k, v = _arrays((2, 2, n, av.PACKED_DH), 3, seed=n + 2)
    (ct,) = _arrays((2, n, 2 * av.PACKED_DH), 1, seed=n + 3)
    qkv = _pack_head_major(q, k, v)
    jo, (jg,) = _jax_value_and_grads(
        functools.partial(jav.attention_train_packed, n_real=n_real), (qkv,),
        ct)
    o, (g,) = _torch_value_and_grads(
        functools.partial(av.attention_train_packed, n_real=n_real), (qkv,),
        ct)
    assert o.shape == (2, n, 2 * av.PACKED_DH) and g.shape == qkv.shape
    np.testing.assert_allclose(o, jo, atol=1e-5, rtol=0)
    np.testing.assert_allclose(g, jg, atol=1e-4, rtol=0)


def test_packed_reference_is_the_headwise_one_in_another_layout():
    q, k, v, dot = _arrays((2, 4, 17, av.PACKED_DH), 4, seed=9)
    qkv = torch.from_numpy(_pack_head_major(q, k, v))
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, dot))
    o = av.attention_train_reference(tq, tk, tv, 11)
    po = av.attention_train_packed_reference(qkv, 11)
    torch.testing.assert_close(po, o.transpose(1, 2).reshape(2, 17, -1),
                               atol=0, rtol=0)
    grads = av.head_grads_reference(tq, tk, tv, tdo, 11)
    pg = av.packed_head_grads_reference(
        qkv, tdo.transpose(1, 2).reshape(2, 17, -1), 11)
    want = torch.from_numpy(_pack_head_major(*(g.numpy() for g in grads)))
    torch.testing.assert_close(pg, want, atol=0, rtol=0)


@pytest.mark.parametrize("heads,dh,n", [(12, 64, 197), (3, 64, 197),
                                        (2, 32, 197), (2, 64, 1025),
                                        (4, 64, 1024)])
def test_packed_ok_matches_jax(heads, dh, n):
    assert av.packed_ok(heads, dh, n) == jav.packed_ok(heads, dh, n)


def _mhsa_params(d, seed):
    rng = np.random.default_rng(seed)
    p = {"qkv_w": rng.standard_normal((d, 3 * d)) * d ** -0.5,
         "qkv_b": rng.standard_normal(3 * d) * 0.1,
         "proj_w": rng.standard_normal((d, d)) * d ** -0.5,
         "proj_b": rng.standard_normal(d) * 0.1}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}


def test_mhsa_packed_path_matches_the_unpacked_one(monkeypatch):
    """Head-major weights through the packed path give the canonical
    layout's output and input gradient; the packed Function is what ran."""
    from interactive_vit_tpu_torch.parallel import mesh

    heads, d = 2, 2 * av.PACKED_DH
    p = _mhsa_params(d, 0)
    p_hm = mesh.permute_qkv_head_major({"blocks": [p]}, heads)["blocks"][0]
    calls = []

    def spy(qkv, n_real=None):
        calls.append(tuple(qkv.shape))
        return av.attention_train_packed(qkv, n_real)

    monkeypatch.setattr(av.trainable_flash_mhsa, "packed", spy)
    x = torch.randn((2, 9, d), generator=torch.Generator().manual_seed(1))
    outs = []
    for params, hm in ((p_hm, True), (p, False)):
        xi = x.clone().requires_grad_(True)
        y, probs = tattn.mhsa(xi, params, heads, head_major=hm,
                              attn_impl=av.trainable_flash_mhsa)
        assert probs is None
        y.sum().backward()
        outs.append((y.detach(), xi.grad))
    assert calls == [(2, 9, 3 * d)]
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=1e-5, rtol=0)
    torch.testing.assert_close(outs[0][1], outs[1][1], atol=1e-5, rtol=0)
    # maps asked for: no packed path, the plain attention's probs
    y, probs = tattn.mhsa(x, p_hm, heads, want_attn=True, head_major=True,
                          attn_impl=av.trainable_flash_mhsa)
    assert probs is not None and calls == [(2, 9, 3 * d)]


def test_trainable_flash_mhsa_falls_back_by_shape():
    q, k, v = (torch.from_numpy(a) for a in
               _arrays((1, 1, av.TRAIN_MAX_N + 1, 8), 3, seed=5))
    o, probs = av.trainable_flash_mhsa(q, k, v)
    want, _ = tattn.attention_reference(q, k, v)
    assert probs is None and not o.requires_grad
    torch.testing.assert_close(o, want, atol=0, rtol=0)
    q, k, v = (torch.from_numpy(a) for a in _arrays((1, 2, 10, 8), 3, 6))
    _, probs = av.trainable_flash_mhsa(q, k, v, want_attn=True)
    assert probs.shape == (1, 2, 10, 10)


@pytest.mark.parametrize("name,dtype,device,expect", [
    ("reference", torch.bfloat16, "cuda", None),
    ("none", torch.bfloat16, "cuda", None),
    ("flash_vjp", torch.float32, "cpu", "kernel"),
    ("auto", torch.bfloat16, "cpu", None),
    ("auto", torch.bfloat16, "cuda", "kernel"),
    ("auto", torch.float32, "cuda", "kernel"),
    ("auto", torch.float16, "cuda", None),
    ("auto", torch.bfloat16, None, None),
])
def test_default_train_attn_impl(name, dtype, device, expect):
    got = dispatch.default_train_attn_impl(name, dtype=dtype, device=device)
    assert got is (av.trainable_flash_mhsa if expect == "kernel" else None)


def test_default_train_attn_impl_matches_jax_off_the_tpu():
    """Off a TPU the JAX policy's "auto" is None, as the port's on the CPU;
    the explicit names agree."""
    from interactive_vit_tpu.ops import dispatch as jdispatch

    for name in ("auto", "reference", "none", "flash_vjp"):
        j = jdispatch.default_train_attn_impl(name, dtype=jnp.bfloat16)
        t = dispatch.default_train_attn_impl(name, dtype=torch.bfloat16,
                                             device="cpu")
        assert (j is None) == (t is None), name


def test_default_train_attn_impl_swin_and_errors():
    from interactive_vit_tpu_torch.models import swin

    cfg = swin.VARIANTS["swin_t"]
    assert dispatch.default_train_attn_impl(
        "auto", dtype=torch.bfloat16, cfg=cfg, device="cuda") is None
    with pytest.raises(ValueError, match="shifted-window"):
        dispatch.default_train_attn_impl("flash_vjp", cfg=cfg)
    with pytest.raises(ValueError, match="unknown train attention"):
        dispatch.default_train_attn_impl("flash")
