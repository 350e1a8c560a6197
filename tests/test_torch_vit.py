"""The port's ViT (``interactive_vit_tpu_torch.models.vit``) against the JAX
package's ``vit`` on shared parameters, and against the committed torch
oracle fixtures.

Parameters come from the JAX initializer (or the JAX checkpoint converter)
and reach the port through ``models/weights.from_jax``. Tolerance: atol
1e-4 at f32, the BASELINE parity contract.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.ops import fused_block as jfb
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import fused_block as tfb

torch.set_num_threads(2)

ATOL = 1e-4
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SMALL = dict(img_size=32, patch=16, width=64, depth=2, heads=4,
             num_classes=10)
JCFG = jvit.ViTConfig("vit_tt", **SMALL)
TCFG = tvit.ViTConfig("vit_tt", **SMALL)


@pytest.fixture(scope="module")
def shared():
    params = jax.tree.map(np.asarray,
                          jvit.init_params(jax.random.key(11), JCFG))
    images = np.random.default_rng(11).random((2, 3, 32, 32),
                                               dtype=np.float32)
    return params, images


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("extra", [
    {"distilled": True},                      # DeiT: CLS + DIST, two heads
    {"registers": 2, "layer_scale": 1e-5},    # DINOv2-reg: pos-free tokens
    {"num_classes": 0},                       # feature extractor: CLS out
])
def test_variant_forward_matches_jax(extra):
    """The config variants that change embed, block or head."""
    cfg_kw = dict(SMALL, **extra)
    jcfg = jvit.ViTConfig("vit_var", **cfg_kw)
    params = jax.tree.map(np.asarray,
                          jvit.init_params(jax.random.key(13), jcfg))
    if extra.get("layer_scale"):  # non-trivial gammas
        rng = np.random.default_rng(13)
        for blk in params["blocks"]:
            blk["ls1"] = rng.standard_normal(blk["ls1"].shape, np.float32)
            blk["ls2"] = rng.standard_normal(blk["ls2"].shape, np.float32)
    images = np.random.default_rng(14).random((2, 3, 32, 32),
                                               dtype=np.float32)
    want = jvit.forward(jax.tree.map(jnp.asarray, params),
                        jnp.asarray(images), jcfg, want_attn=True)
    got = tvit.forward(from_jax(params), torch.from_numpy(images),
                       tvit.ViTConfig("vit_var", **cfg_kw), want_attn=True)
    np.testing.assert_allclose(_np(got["logits"]), want["logits"], atol=ATOL)
    np.testing.assert_allclose(_np(got["rollout"]), want["rollout"],
                               atol=ATOL)


@pytest.mark.parametrize("attn_heads", [None, (1, 3), ()])
def test_forward_matches_jax(shared, attn_heads):
    params, images = shared
    want = jvit.forward(jax.tree.map(jnp.asarray, params),
                        jnp.asarray(images), JCFG, want_attn=True,
                        want_cls_trajectory=True, attn_heads=attn_heads)
    got = tvit.forward(from_jax(params), torch.from_numpy(images), TCFG,
                       want_attn=True, want_cls_trajectory=True,
                       attn_heads=attn_heads)
    assert set(got) == set(want)
    np.testing.assert_allclose(_np(got["logits"]), want["logits"], atol=ATOL)
    np.testing.assert_allclose(_np(got["rollout"]), want["rollout"],
                               atol=ATOL)
    np.testing.assert_allclose(_np(got["cls"]), want["cls"], atol=ATOL)
    if "attn" in want:
        assert len(got["attn"]) == len(want["attn"]) == JCFG.depth
        for g, w in zip(got["attn"], want["attn"]):
            np.testing.assert_allclose(_np(g), w, atol=ATOL)


def test_forward_with_fused_blocks_matches_jax_pallas(shared, monkeypatch):
    """Both packages through their fused block: the port's plain version on
    the CPU against the Pallas kernel in interpret mode."""
    import jax.experimental.pallas as pl

    monkeypatch.setattr(jfb.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    params, images = shared
    want = jvit.forward(jax.tree.map(jnp.asarray, params),
                        jnp.asarray(images), JCFG, want_attn=True,
                        block_impl=jfb.fused_attn_block)
    got = tvit.forward(from_jax(params), torch.from_numpy(images), TCFG,
                       want_attn=True, block_impl=tfb.fused_attn_block)
    np.testing.assert_allclose(_np(got["logits"]), want["logits"], atol=ATOL)
    np.testing.assert_allclose(_np(got["rollout"]), want["rollout"],
                               atol=ATOL)
    for g, w in zip(got["attn"], want["attn"]):
        np.testing.assert_allclose(_np(g), w, atol=ATOL)


def test_layer_fns_match_jax_node_by_node(shared):
    """Chain every ``layer_fns`` node (transform included, on a non-square
    image so the resize and crop matter) and compare each output."""
    params, _ = shared
    img = np.random.default_rng(12).random((3, 40, 52), dtype=np.float32)
    jlayers = jvit.layer_fns(JCFG)
    tlayers = tvit.layer_fns(TCFG)
    assert [n for n, _, _ in jlayers] == [n for n, _, _ in tlayers]
    assert [e for _, e, _ in jlayers] == [e for _, e, _ in tlayers]
    jp = jax.tree.map(jnp.asarray, params)
    tp = from_jax(params)
    jx, tx = jnp.asarray(img), torch.from_numpy(img)
    jr = tr = None
    want = frozenset({"attn", "r", "cls"})
    for (name, extra, jf), (_, _, tf) in zip(jlayers, tlayers):
        jins, tins = {"o": jx}, {"o": tx}
        kw = {}
        if extra:
            kw = {"want": want, "node_params": {"attn_heads": "[0, 2]"}}
            if jr is not None:  # the rollout flows along the chain
                jins["r"], tins["r"] = jr, tr
        jout = jf(jvit.layer_params(jp, name), jins, **kw)
        tout = tf(tvit.layer_params(tp, name), tins, **kw)
        assert set(tout) == set(jout), name
        for ch in jout:
            np.testing.assert_allclose(_np(tout[ch]), np.asarray(jout[ch]),
                                       atol=ATOL, err_msg=f"{name}:{ch}")
        jx, tx = jout["o"], tout["o"]
        if extra:
            jr, tr = jout["r"], tout["r"]


def test_golden_checkpoint_through_jax_converter():
    """The independent torch-made oracle: the committed torchvision-layout
    checkpoint, converted by the JAX package's converter, then ``from_jax``
    and the port's forward, against the oracle's logits and maps."""
    from interactive_vit_tpu.models import weights as jweights
    from interactive_vit_tpu.utils.safetensors_io import load_file

    golden = np.load(os.path.join(FIXTURES, "vit_golden.npz"))
    cfg = jvit.ViTConfig("vit_golden", **SMALL)
    sd = load_file(os.path.join(FIXTURES, "vit_golden_tv.safetensors"))
    params = jax.tree.map(np.asarray, jweights.from_torchvision(sd, cfg))
    out = tvit.forward(from_jax(params), torch.from_numpy(golden["input"]),
                       tvit.ViTConfig("vit_golden", **SMALL), want_attn=True)
    np.testing.assert_allclose(_np(out["logits"]), golden["logits"],
                               atol=ATOL)
    attn = np.stack([_np(a) for a in out["attn"]])
    np.testing.assert_allclose(attn, golden["attn"], atol=ATOL)


def test_init_params_layout_matches_jax():
    """Same tree structure and shapes as the JAX initializer, deterministic
    per seed, and in the requested dtype."""
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jvit.init_params(jax.random.key(0), JCFG))
    a = tvit.init_params(TCFG, torch.Generator().manual_seed(5))
    b = tvit.init_params(TCFG, torch.Generator().manual_seed(5),
                         dtype=torch.bfloat16)
    tshapes = jax.tree.map(lambda t: tuple(t.shape), a)
    assert tshapes == jshapes
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(b))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x.to(torch.bfloat16), y)


def test_bf16_forward_is_finite_and_close(shared):
    params, images = shared
    ref = tvit.forward(from_jax(params), torch.from_numpy(images), TCFG,
                       want_attn=True)
    got = tvit.forward(from_jax(params, dtype=torch.bfloat16),
                       torch.from_numpy(images), TCFG, want_attn=True,
                       block_impl=tfb.fused_attn_block)
    assert got["logits"].dtype == torch.bfloat16
    assert torch.isfinite(got["logits"].float()).all()
    # bf16 keeps ~3 significant digits; two blocks of rounding stay well
    # inside 5% of the logits' scale
    scale = ref["logits"].abs().max().item()
    assert (got["logits"].float() - ref["logits"]).abs().max() <= 0.05 * scale


@pytest.mark.parametrize("name,ok", [
    ("vit_b16", True), ("vit_t16", True), ("vit_b16@384", True),
    ("vit_b16@38x", False), ("nope", False),
])
def test_resolve_variant(name, ok):
    if ok:
        if "@" not in name:
            assert tvit.resolve_variant(name) is tvit.VARIANTS[name]
        j = jvit.resolve_variant(name)
        t = tvit.resolve_variant(name)
        assert (t.name, t.img_size, t.patch, t.tokens, t.width, t.heads,
                t.depth) == (j.name, j.img_size, j.patch, j.tokens, j.width,
                             j.heads, j.depth)
    else:
        with pytest.raises(ValueError):
            tvit.resolve_variant(name)


@pytest.mark.parametrize("kw,msg", [
    ({"qkv_head_major": True}, "head_major"),
    ({"n_real": 3}, "n_real"),
    ({"attn_heads": (9,)}, "out of range"),
])
def test_block_guards(shared, kw, msg):
    params, _ = shared
    p = from_jax(params)["blocks"][0]
    x = torch.zeros(1, TCFG.tokens, TCFG.width)
    with pytest.raises(ValueError, match=msg):
        tvit.block(p, x, TCFG, block_impl=tfb.fused_attn_block, **kw)


def test_layer_scale_block_refuses_fused_kernel(shared):
    params, _ = shared
    p = dict(from_jax(params)["blocks"][0], ls1=torch.ones(TCFG.width),
             ls2=torch.ones(TCFG.width))
    with pytest.raises(ValueError, match="LayerScale"):
        tvit.block(p, torch.zeros(1, TCFG.tokens, TCFG.width), TCFG,
                   block_impl=tfb.fused_attn_block)
