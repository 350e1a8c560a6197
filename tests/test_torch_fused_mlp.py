"""The port's fused MLP module against the JAX package's.

On the CPU the port's wrapper ``fused_mlp_block`` runs its plain version
(the CUDA kernel runs only on the card; ``tests/test_torch_cuda_kernel.py``
holds the two against each other there). The same numpy inputs go through
that wrapper and through the JAX Pallas kernel in interpret mode, alone
and inside both packages' ``vit.block`` and ``swin.block``. f32, atol 1e-5
(the JAX test's own bound): both sides use the tanh GELU and differ only
in the order of f32 sums.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import swin as jswin
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.ops import fused_mlp as jfm
from interactive_vit_tpu_torch.models import swin as tswin
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import dispatch
from interactive_vit_tpu_torch.ops import fused_mlp as fm
from interactive_vit_tpu_torch.ops import layers as L

torch.set_num_threads(2)

ATOL = 1e-5
VIT = dict(img_size=32, patch=16, width=64, depth=1, heads=4, num_classes=10)
SWIN = dict(img_size=32, patch=4, embed_dim=16, depths=(2, 2), heads=(2, 4),
            window=4, num_classes=10)


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        jfm.pl, "pallas_call", functools.partial(pl.pallas_call,
                                                 interpret=True))


def _perturbed(jp, seed):
    """A block's JAX parameters with non-trivial LN and biases, and their
    torch counterparts."""
    jp = dict(jp)
    rng = np.random.default_rng(seed)
    for name in ("ln2_s", "ln2_b", "fc1_b", "fc2_b"):
        base = 1.0 if name == "ln2_s" else 0.0
        jp[name] = jnp.asarray(base + 0.2 * rng.standard_normal(
            jp[name].shape).astype(np.float32))
    return jp, from_jax(jax.tree.map(np.asarray, jp))


def _vit_block(seed):
    cfg = jvit.ViTConfig("vit_fm", **VIT)
    return _perturbed(
        jvit.init_params(jax.random.key(seed), cfg)["blocks"][0], seed)


@pytest.mark.parametrize("batch,eps", [(1, 1e-6), (3, 1e-5)])
def test_wrapper_matches_pallas_kernel(batch, eps):
    jp, tp = _vit_block(batch)
    x = np.random.default_rng(batch).standard_normal(
        (batch, 5, 64)).astype(np.float32)
    want = jfm.fused_mlp_block(jnp.asarray(x), jp, eps)
    before = fm.fused_mlp_block.launches
    got = fm.fused_mlp_block(torch.from_numpy(x), tp, eps)
    assert fm.fused_mlp_block.launches == before  # no kernel on the CPU
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_plain_version_uses_the_tanh_gelu_in_f32():
    """Unlike ``layers.gelu`` (erf in f32): against the unfused f32 MLP the
    kernel's function differs by the tanh approximation's error, a few
    1e-4, and matches it once that MLP's GELU is the tanh form."""
    _, tp = _vit_block(5)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 5, 64)).astype(np.float32))
    got = fm.fused_mlp_block_reference(x, tp, 1e-6)
    ln = L.layer_norm(x, tp["ln2_s"], tp["ln2_b"], 1e-6)
    erf = x + L.mlp(ln, tp)
    h = torch.nn.functional.gelu(L.linear(ln, tp["fc1_w"], tp["fc1_b"]),
                                 approximate="tanh")
    tanh = x + L.linear(h, tp["fc2_w"], tp["fc2_b"])
    np.testing.assert_allclose(got.numpy(), tanh.numpy(), atol=ATOL)
    assert 1e-6 < (got - erf).abs().max().item() < 5e-3


def test_vit_block_with_mlp_impl_matches_jax():
    cfg, tcfg = jvit.ViTConfig("vit_fm", **VIT), tvit.ViTConfig("vit_fm",
                                                                **VIT)
    jp, tp = _vit_block(1)
    x = np.random.default_rng(1).random((1, cfg.tokens, cfg.width),
                                        np.float32)
    want, _, _ = jvit.block(jp, jnp.asarray(x), cfg,
                            mlp_impl=jfm.fused_mlp_block)
    got, probs, mean = tvit.block(tp, torch.from_numpy(x), tcfg,
                                  mlp_impl=fm.fused_mlp_block)
    assert probs is None and mean is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_vit_forward_and_layer_fns_thread_mlp_impl():
    cfg, tcfg = jvit.ViTConfig("vit_fm", **VIT), tvit.ViTConfig("vit_fm",
                                                                **VIT)
    jparams = jvit.init_params(jax.random.key(2), cfg)
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    imgs = np.random.default_rng(2).random((2, 3, 32, 32), np.float32)
    want = jvit.forward(jparams, jnp.asarray(imgs), cfg, want_attn=True,
                        mlp_impl=jfm.fused_mlp_block)
    calls = []

    def counted(x, p, eps):
        calls.append(eps)
        return fm.fused_mlp_block(x, p, eps)

    got = tvit.forward(tparams, torch.from_numpy(imgs), tcfg, want_attn=True,
                       mlp_impl=counted)
    assert calls == [cfg.ln_eps] * cfg.depth
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4)
    np.testing.assert_allclose(got["rollout"].numpy(),
                               np.asarray(want["rollout"]), atol=1e-4)
    # the node chain takes the same kernel
    x = torch.from_numpy(imgs)
    for name, extra, fn in tvit.layer_fns(tcfg, mlp_impl=counted)[1:]:
        x = fn(tvit.layer_params(tparams, name), {"o": x})["o"]
    assert len(calls) == 2 * cfg.depth
    np.testing.assert_allclose(x.numpy(), got["logits"].numpy(), atol=1e-6)


@pytest.mark.parametrize("stage,shift", [(0, 0), (0, 2), (1, 0)])
def test_swin_block_with_mlp_impl_matches_jax(stage, shift):
    jcfg, tcfg = jswin.SwinConfig("swin_fm", **SWIN), tswin.SwinConfig(
        "swin_fm", **SWIN)
    jp, tp = _perturbed(jswin.init_params(jax.random.key(stage), jcfg)
                        ["stages"][stage][0], stage + shift)
    res, c = jcfg.stage_res(stage), jcfg.stage_dim(stage)
    x = np.random.default_rng(stage).standard_normal(
        (2, res, res, c)).astype(np.float32)
    want, _ = jswin.block(jp, jnp.asarray(x), jcfg, stage, shift,
                          mlp_impl=jfm.fused_mlp_block)
    seen = []

    def counted(x, p, eps):
        seen.append((tuple(x.shape), eps))
        return fm.fused_mlp_block(x, p, eps=eps)

    got, _ = tswin.block(tp, torch.from_numpy(x), tcfg, stage, shift,
                         mlp_impl=counted)
    assert seen == [((2, res * res, c), 1e-5)]  # flattened map, swin's eps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_layer_scale_block_refuses_mlp_impl():
    cfg = tvit.ViTConfig("ls", **{**VIT, "layer_scale": 1e-5})
    p = tvit.init_params(cfg, torch.Generator().manual_seed(0))["blocks"][0]
    x = torch.zeros((1, cfg.tokens, cfg.width))
    with pytest.raises(ValueError, match="LayerScale"):
        tvit.block(p, x, cfg, mlp_impl=fm.fused_mlp_block)


@pytest.mark.parametrize("args,ok", [
    ((768, 3072), True), ((96, 384), True), ((1280, 5120), True),
    ((1024, 4096), True), ((100, 400), True),
    ((1281, 5124), False), ((4096, 16384), False), ((0, 0), False),
])
def test_fits(args, ok):
    assert fm.fits(*args) is ok


def test_wrapper_refuses_other_devices():
    _, tp = _vit_block(0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fm.fused_mlp_block(torch.zeros((1, 5, 64), device="meta"), tp)


@pytest.mark.parametrize("name,want", [
    ("fused", fm.fused_mlp_block), ("reference", None), ("none", None),
    ("auto", None),
])
def test_default_mlp_impl_names(name, want):
    got = dispatch.default_mlp_impl(name, dtype=torch.bfloat16, d=768,
                                    mlp_dim=3072, device="cuda")
    assert got is want


def test_default_mlp_impl_refusals():
    """The W8A8 names resolve (to the W8A8 wrapper, or None off the card)
    and refuse only a shape the W8A8 kernel does not take."""
    assert (dispatch.default_mlp_impl("w8a8", d=768, mlp_dim=3072)
            is fm.fused_mlp_w8a8_block)
    assert dispatch.default_mlp_impl("auto", d=768, mlp_dim=3072,
                                     quant="w8a8") is None
    with pytest.raises(ValueError, match="W8A8 MLP kernel does not take"):
        dispatch.default_mlp_impl("w8a8", dtype=torch.float32, d=768,
                                  mlp_dim=16384)
    with pytest.raises(ValueError, match="does not take"):
        dispatch.default_mlp_impl("fused", d=4096, mlp_dim=16384)
    with pytest.raises(ValueError, match="unknown mlp impl"):
        dispatch.default_mlp_impl("pallas")
    assert dispatch.default_mlp_impl("reference", quant="w8a8") is None
