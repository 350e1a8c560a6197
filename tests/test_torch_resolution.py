"""The ``@<pixels>p<patch>`` geometries in the port against the JAX package.

* ``resolve_variant``: the grammar, the errors, and the identity case (the
  very ``VARIANTS`` entry) as the JAX function's;
* ``adapt_pos_embed`` / ``adapt_patch_embed`` on the same numpy checkpoint:
  f32 atol 1e-6 (the same resampling matrices; only sum orders differ);
* a micro config patched into both packages' ``VARIANTS`` in the test:
  ``make_vit_model("vit_micro@p4")`` and ``("vit_micro@48")`` built from
  the same native checkpoint, logits at f32 atol 1e-4;
* the repository's own ``static/graphs/vit_t16@256.json`` served by the
  port's app and by the JAX app on the same weights: the same route
  entries and descriptions, tensors at f32 atol 1e-4.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.vit_plugin import make_vit_model as jmake
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.serving.app import App as JApp
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.autoregister import make_model
from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.serving.app import App
from interactive_vit_tpu_torch.wire import schema
from interactive_vit_tpu_torch.wire.codec import (
    REQUEST_MAGIC, RESPONSE_MAGIC, Request, Response, decode_message,
    encode_message,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = dict(img_size=32, patch=8, width=48, depth=2, heads=4,
             num_classes=10)


@pytest.mark.parametrize("name", [
    "vit_b16@384", "vit_b16@p8", "vit_b16@384p32", "dino_s16@448",
    "dinov2_s14_reg@742", "vit_t16@256", "deit_s16@288", "vit_l16@224",
])
def test_resolve_variant_derived_geometries(name):
    j, t = jvit.resolve_variant(name), tvit.resolve_variant(name)
    assert t.name == j.name == name
    for field in ("img_size", "patch", "width", "depth", "heads",
                  "num_classes", "registers", "layer_scale", "distilled"):
        assert getattr(t, field) == getattr(j, field), field
    assert (t.tokens, t.pos_tokens) == (j.tokens, j.pos_tokens)


def test_resolve_variant_dinov2_at_742_has_2814_tokens():
    cfg = tvit.resolve_variant("dinov2_s14_reg@742")
    assert (cfg.img_size // cfg.patch, cfg.tokens, cfg.width, cfg.heads,
            cfg.depth) == (53, 2814, 384, 6, 12)


@pytest.mark.parametrize("name", ["vit_b16", "vit_b16@224", "vit_b16@p16",
                                  "vit_b16@224p16"])
def test_resolve_variant_identity_is_the_variants_entry(name):
    assert tvit.resolve_variant(name) is tvit.VARIANTS["vit_b16"]
    assert jvit.resolve_variant(name) is jvit.VARIANTS["vit_b16"]


@pytest.mark.parametrize("name", [
    "nope", "nope@384", "vit_b16@", "vit_b16@38x", "vit_b16@p", "vit_b16@384p",
    "vit_b16@x384", "vit_b16@385", "vit_b16@384p7", "vit_b16@p8p4",
])
def test_resolve_variant_errors_match_jax(name):
    with pytest.raises(ValueError) as jerr:
        jvit.resolve_variant(name)
    with pytest.raises(ValueError) as terr:
        tvit.resolve_variant(name)
    assert str(terr.value) == str(jerr.value)


def _checkpoint(cfg, seed):
    params = jax.tree.map(np.asarray, jvit.init_params(jax.random.key(seed),
                                                       cfg))
    rng = np.random.default_rng(seed)
    params["pos_emb"] = rng.standard_normal(
        params["pos_emb"].shape).astype(np.float32)
    return params


@pytest.mark.parametrize("base,target", [
    (dict(MICRO), "@48"), (dict(MICRO), "@16"),
    (dict(MICRO, distilled=True), "@64"),
    (dict(MICRO, registers=4, num_classes=0, layer_scale=1e-5), "@40"),
])
def test_adapt_pos_embed_matches_jax(base, target):
    native = jvit.ViTConfig("vit_micro", **base)
    params = _checkpoint(native, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VARIANTS, "vit_micro", native)
        mp.setitem(tvit.VARIANTS, "vit_micro", tvit.ViTConfig("vit_micro",
                                                              **base))
        jcfg = jvit.resolve_variant("vit_micro" + target)
        tcfg = tvit.resolve_variant("vit_micro" + target)
    want = jvit.adapt_pos_embed(params, jcfg)["pos_emb"]
    got = tvit.adapt_pos_embed(from_jax(params), tcfg)["pos_emb"]
    assert tuple(got.shape) == want.shape == (1, tcfg.pos_tokens, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("patch", [4, 16, 8])
def test_adapt_patch_embed_matches_jax(patch):
    native = jvit.ViTConfig("vit_micro", **MICRO)
    params = _checkpoint(native, 2)
    jcfg = jvit.ViTConfig("vit_micro@p", **dict(MICRO, patch=patch))
    tcfg = tvit.ViTConfig("vit_micro@p", **dict(MICRO, patch=patch))
    want = jvit.adapt_patch_embed(params, jcfg)["patch_embed"]
    tparams = from_jax(params)
    got = tvit.adapt_patch_embed(tparams, tcfg)["patch_embed"]
    assert tuple(got["w"].shape) == want["w"].shape == (3 * patch * patch, 48)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               atol=1e-6, rtol=0)
    if patch == 8:  # identity: the very params come back
        assert tvit.adapt_checkpoint(tparams, tcfg) is tparams


def test_adapt_patch_embed_refuses_a_quantized_kernel():
    from interactive_vit_tpu_torch.ops.quant import quantize_weight

    params = from_jax(_checkpoint(jvit.ViTConfig("vit_micro", **MICRO), 3))
    params["patch_embed"]["w"] = quantize_weight(params["patch_embed"]["w"])
    cfg = tvit.ViTConfig("vit_micro@p4", **dict(MICRO, patch=4))
    with pytest.raises(ValueError, match="before quantizing"):
        tvit.adapt_patch_embed(params, cfg)


@pytest.fixture()
def micro_variants(monkeypatch):
    monkeypatch.setitem(jvit.VARIANTS, "vit_micro",
                        jvit.ViTConfig("vit_micro", **MICRO))
    monkeypatch.setitem(tvit.VARIANTS, "vit_micro",
                        tvit.ViTConfig("vit_micro", **MICRO))
    return _checkpoint(jvit.VARIANTS["vit_micro"], 4)


def _chain(model, x):
    for name, _, fn in model.layers:
        x = fn(model.layer_params(name), {"o": x})["o"]
    return x


@pytest.mark.parametrize("variant,tokens", [("vit_micro@p4", 65),
                                            ("vit_micro@48", 37)])
def test_derived_geometry_model_logits_match_jax(micro_variants, variant,
                                                 tokens):
    params = micro_variants
    jm = jmake(variant, params=jax.tree.map(jnp.asarray, params),
               with_categories=False)
    tm = make_vit_model(variant, params=from_jax(params), device="cpu")
    assert tuple(tm.params["pos_emb"].shape) == (1, tokens, 48)
    img = np.random.default_rng(5).random((1, 3, 40, 52), np.float32)
    want = _chain(jm, jnp.asarray(img))
    got = _chain(tm, torch.from_numpy(img))
    assert tuple(got.shape) == (1, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_autoregister_takes_at_geometries_and_refuses_swin(micro_variants):
    model = make_model("vit_micro@p4", device="cpu", quantize="w8a8")
    assert model.name == "vit_micro@p4"
    assert "vit_micro@p4:blocks.1" in [f"{model.name}:{n}"
                                       for n, _, _ in model.layers]
    with pytest.raises(ValueError, match="plain-ViT"):
        make_model("swin_t@384", device="cpu")
    with pytest.raises(ValueError, match="plain-ViT family only"):
        make_model("swin_t", device="cpu", block_kernel="int8-scores")
    # Swin takes the quantized modes: weight-only int8 in every block linear
    swin_q = make_model("swin_t", device="cpu", quantize="w8")
    blk = swin_q.params["stages"][2][5]
    assert {k for k, v in blk.items() if isinstance(v, dict)} == {
        "qkv_w", "proj_w", "fc1_w", "fc2_w"}
    assert blk["qkv_w"]["int8_q"].dtype == torch.int8


def test_vit_t16_at_256_saved_graph_served_like_jax(tmp_path):
    """The repository's saved graph for vit_t16@256 (N=257): the port's
    app and the JAX app on the same weights give the same route entries,
    descriptions and tensors."""
    name = "vit_t16@256"
    graph_file = os.path.join(ROOT, "static", "graphs", name + ".json")
    jparams = jvit.init_params(jax.random.key(6), jvit.resolve_variant(name))
    apps = []
    try:
        jreg = JRegistry()
        jbuiltin(jreg)
        jdir, tdir = tmp_path / "jax", tmp_path / "torch"
        for d in (jdir, tdir):
            d.mkdir()
            shutil.copy(graph_file, d)
        japp = JApp(reg=jreg, graphs_dir=str(jdir), speculate=False,
                    max_wait_ms=1.0)
        apps.append(lambda: japp.batcher.stop())
        jmake(name, params=jparams).register(jreg, japp.graphs)
        reg = Registry()
        register_builtin(reg)
        app = App(reg=reg, graphs_dir=str(tdir), device="cpu",
                  max_wait_ms=1.0)
        apps.append(app.close)
        make_vit_model(name, params=from_jax(jax.tree.map(np.asarray,
                                                          jparams)),
                       device="cpu").register(reg, app.graphs)

        graph = app.graphs.load(name + ".json")
        with open(graph_file) as f:
            assert graph == json.load(f)
        for node in (name + ":embed", name + ":blocks.11", name + ":head"):
            assert app.description(node, {}) == japp.description(node, {})
        g = schema.graph_from_json(graph)
        img = np.random.default_rng(6).random((3, 260, 300), np.float32)
        g.add_input(img, g.nodes[0], "o")
        obj, tensors = decode_message(Request.encode(g),
                                      expect_magic=REQUEST_MAGIC)
        obj["taps"] = ([{"node": 2, "channel": ch} for ch in ("attn", "r")]
                       + [{"node": 13, "channel": "r"},
                          {"node": 15, "channel": "o"}])
        body = encode_message(REQUEST_MAGIC, obj, tensors)
        raw, jraw = app.compute(body), japp.compute(body)
        assert (decode_message(raw, expect_magic=RESPONSE_MAGIC)[0]
                == decode_message(jraw, expect_magic=RESPONSE_MAGIC)[0])
        got, want = Response.decode(raw), Response.decode(jraw)
        assert got[2]["attn"].shape == (1, 3, 257, 257)
        assert got[15]["o"].shape == (1, 1000)
        for i in want:
            for ch in want[i]:
                np.testing.assert_allclose(got[i][ch], want[i][ch],
                                           atol=1e-4, rtol=0,
                                           err_msg=f"node {i} {ch}")
    finally:
        for close in apps:
            close()
