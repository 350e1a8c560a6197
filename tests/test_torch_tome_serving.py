"""The ToMe family served by the port's ``build_app`` against the JAX app.

The repository's saved graph ``static/graphs/vit_b16_tome.json`` (17
nodes; ``o``, ``s`` and ``a`` wired along the chain) is served by both
apps on the same weights. ``vit_b16_tome`` is narrowed to width 64 and 4
heads in both packages for the CPU; its depth (12 blocks), image size,
patch and merge rate stay, so the token ladder is the served one (197 ->
109 entering the last block). Tolerance 1e-4, the parity contract; the
assignment channel ``a`` is compared exactly.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import autoregister as jauto
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models import tome as jtome
from interactive_vit_tpu.models.tome_plugin import make_tome_model as jmake
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.serving.app import App as JApp
from interactive_vit_tpu.serving.server import build_app as jbuild_app
from interactive_vit_tpu_torch.models import tome as ttome
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models import vit_plugin as tvp
from interactive_vit_tpu_torch.models.autoregister import (
    known_variants, make_model,
)
from interactive_vit_tpu_torch.models.tome_plugin import make_tome_model
from interactive_vit_tpu_torch.ops import fused_block as tfb
from interactive_vit_tpu_torch.serving import server as tserver
from interactive_vit_tpu_torch.serving.server import build_app
from interactive_vit_tpu_torch.wire import schema
from interactive_vit_tpu_torch.wire.codec import (
    REQUEST_MAGIC, RESPONSE_MAGIC, Request, Response, decode_message,
    encode_message,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "vit_b16_tome"
GRAPH = os.path.join(ROOT, "static", "graphs", NAME + ".json")
NARROW = dict(img_size=224, patch=16, width=64, depth=12, heads=4,
              num_classes=1000, r=8)
ATOL = 1e-4


@pytest.fixture(scope="module")
def narrow():
    """``vit_b16_tome`` at width 64 in both packages, for this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jtome.VARIANTS, NAME, jtome.ToMeViTConfig(NAME, **NARROW))
        mp.setitem(ttome.VARIANTS, NAME, ttome.ToMeViTConfig(NAME, **NARROW))
        yield


@pytest.fixture(scope="module")
def apps(narrow, tmp_path_factory):
    """(port app from ``build_app``, JAX app), the port's seeded weights in
    both."""
    tdir = tmp_path_factory.mktemp("torch")
    jdir = tmp_path_factory.mktemp("jax")
    for d in (tdir, jdir):
        shutil.copy(GRAPH, d)
    app = build_app(models=[NAME], graphs_dir=str(tdir), device="cpu",
                    seed=3, max_wait_ms=1.0)
    japp = None
    try:
        params = app.reg.get_node(NAME + ":head").model.params
        jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
        jreg = JRegistry()
        jbuiltin(jreg)
        japp = JApp(reg=jreg, graphs_dir=str(jdir), speculate=False,
                    max_wait_ms=1.0)
        jmake(NAME, params=jparams).register(jreg, japp.graphs)
        yield app, japp
    finally:
        app.close()
        if japp is not None:
            japp.batcher.stop()


def _request(graph_obj, taps, seed=0):
    g = schema.graph_from_json(graph_obj)
    img = np.random.default_rng(seed).random((3, 240, 260), np.float32)
    g.add_input(img, g.nodes[0], "o")
    obj, tensors = decode_message(Request.encode(g),
                                  expect_magic=REQUEST_MAGIC)
    obj["taps"] = [{"node": i, "channel": ch} for i, ch in taps]
    return encode_message(REQUEST_MAGIC, obj, tensors)


def test_saved_graph_is_the_generated_one(narrow):
    """The port's generated chain (s and a wired along the blocks) is the
    JAX package's and the repository's saved graph."""
    with open(GRAPH) as f:
        saved = json.load(f)
    tmodel = make_tome_model(NAME, device="cpu")
    jmodel = jmake(NAME)
    assert tmodel.generate_graph_json() == jmodel.generate_graph_json()
    assert tmodel.generate_graph_json() == saved
    assert len(saved["nodes"]) == 17 and len(saved["edges"]) == 38


def test_descriptions_match_jax(apps):
    app, japp = apps
    for layer in ("transform", "embed", "blocks.0", "blocks.11", "norm",
                  "head"):
        node = f"{NAME}:{layer}"
        assert app.description(node, {}) == japp.description(node, {})
        assert app.reg.get_node(node).contents({}) == \
            japp.reg.get_node(node).contents({})
    assert app.description(NAME + ":blocks.3", {}) == {
        "ins": ["o", "s", "a", "r"],
        "outs": ["o", "s", "a", "attn", "r", "cls", "merge"]}


@pytest.mark.parametrize("resp", ["f32", "bf16"])
def test_saved_graph_served_like_jax(apps, resp):
    """Blocks 0, 5 and 11 (nodes 2, 7, 13) tap ``attn``, ``r``, ``merge``,
    ``a`` and ``s`` (block 5 only heads 1 and 3), plus the logits: the same
    route entries and tensors from both apps."""
    app, japp = apps
    graph = app.graphs.load(NAME + ".json")
    graph["nodes"][7]["instance"]["params"] = {"attn_heads": "[3,1]"}
    taps = [(i, ch) for i in (2, 7, 13)
            for ch in ("attn", "r", "merge", "a", "s")] + [(15, "o")]
    body = _request(graph, taps)
    if resp == "bf16":
        obj, tensors = decode_message(body, expect_magic=REQUEST_MAGIC)
        obj["resp_dtype"] = "bf16"
        body = encode_message(REQUEST_MAGIC, obj, tensors)
    raw, jraw = app.compute(body), japp.compute(body)
    assert (decode_message(raw, expect_magic=RESPONSE_MAGIC)[0]
            == decode_message(jraw, expect_magic=RESPONSE_MAGIC)[0])
    got, want = Response.decode(raw), Response.decode(jraw)
    assert got[2]["attn"].shape == (1, 4, 197, 197)
    assert got[7]["attn"].shape == (1, 2, 157, 157)
    assert got[13]["attn"].shape == (1, 4, 109, 109)
    assert got[13]["r"].shape == (1, 101, 109)
    assert got[13]["merge"].shape == (1, 3, 14, 14)
    assert got[13]["a"].shape == (1, 197) and got[13]["s"].shape == (1, 101)
    assert got[13]["s"].sum() == 197
    assert got[15]["o"].shape == (1, 1000)
    for i in want:
        for ch in want[i]:
            if ch == "a":
                np.testing.assert_array_equal(got[i][ch], want[i][ch])
            atol = ATOL if resp == "f32" else 2.0 ** -8 * max(
                1.0, float(np.abs(want[i][ch]).max()))
            np.testing.assert_allclose(got[i][ch], want[i][ch], atol=atol,
                                       rtol=0, err_msg=f"node {i} {ch}")


def test_ragged_rollout_chain_when_r_is_wired(apps):
    """With ``r`` wired along the chain too, the rollout carry spans the
    original tokens: [1, N_{i+1}, 197], as in the JAX app."""
    app, japp = apps
    graph = app.graphs.load(NAME + ".json")
    blocks = list(range(2, 14))
    graph["edges"] += [{"in_port": {"node": a, "channel": "r"},
                        "out_port": {"node": b, "channel": "r"}}
                       for a, b in zip(blocks, blocks[1:])]
    body = _request(graph, [(13, "r"), (15, "o")], seed=1)
    got = Response.decode(app.compute(body))
    want = Response.decode(japp.compute(body))
    assert got[13]["r"].shape == (1, 101, 197)
    for i, ch in ((13, "r"), (15, "o")):
        np.testing.assert_allclose(got[i][ch], want[i][ch], atol=ATOL, rtol=0)


def test_autoregister_names_and_refusals(narrow, caplog):
    assert {"vit_b16_tome", "vit_b16_tome16", "vit_s16_tome"} <= set(
        known_variants())
    with pytest.raises(ValueError, match="plain-ViT"):
        make_model(NAME + "@384", device="cpu")
    with pytest.raises(ValueError, match="plain-ViT family only"):
        make_model(NAME, device="cpu", block_kernel="int8-scores")
    # the server passes --attn int8-scores to plain ViTs only: ToMe
    # serves on its auto block kernel, as in the JAX server
    app = build_app(models=[NAME], device="cpu", attn_impl_name="int8-scores")
    app.close()
    with pytest.raises(ValueError, match="unknown model variant"):
        make_model("vit_x16_tome", device="cpu")
    with caplog.at_level(logging.WARNING):
        model = make_model(NAME, device="cpu", dtype=torch.bfloat16,
                           quantize="w8")
    assert "int8 not wired for vit_b16_tome" in caplog.text
    leaves = jax.tree.leaves(model.params)
    assert all(t.dtype == torch.bfloat16 for t in leaves)


# vit_b16 narrowed for the CPU as vit_b16_tome is (depth cut to 2)
NARROW_B16 = dict(img_size=224, patch=16, width=64, depth=2, heads=4,
                  num_classes=1000)


def test_int8_scores_serves_a_plain_vit_and_tome_side_by_side(
        narrow, tmp_path, monkeypatch):
    """``--models vit_b16,vit_b16_tome --attn int8-scores``: both apps
    boot; each gives vit_b16 the s8 block policy and the ToMe model its
    auto block kernel (JAX: ``_family_maker`` decides; the port:
    ``plain_vit_family``). The port's vit_b16 blocks resolve to the s8
    mode with an s8 PV product, and both models answer a request."""
    for mod in (jvit, tvit):
        monkeypatch.setitem(mod.VARIANTS, "vit_b16",
                            mod.ViTConfig("vit_b16", **NARROW_B16))
    kinds = {"torch": {}, "jax": {}}

    def recording(pkg, maker):
        def make(variant, **kw):
            kinds[pkg][variant] = kw["block_kernel"]
            return maker(variant, **kw)
        return make

    monkeypatch.setattr(tserver, "make_model",
                        recording("torch", tserver.make_model))
    monkeypatch.setattr(jauto, "make_model",
                        recording("jax", jauto.make_model))
    impls = []
    real_impl = tvp.default_block_impl
    monkeypatch.setattr(tvp, "default_block_impl",
                        lambda name, **kw: impls.append(
                            real_impl(name, **kw)) or impls[-1])
    models = ("vit_b16", NAME)
    for d in ("torch", "jax"):
        (tmp_path / d).mkdir()
        shutil.copy(GRAPH, tmp_path / d)
    app = build_app(models=models, attn_impl_name="int8-scores",
                    dtype_name="bfloat16", device="cpu",
                    graphs_dir=str(tmp_path / "torch"), max_wait_ms=1.0)
    japp = jbuild_app(models=models, attn_impl_name="int8-scores",
                      dtype_name="bfloat16", speculate=False,
                      graphs_dir=str(tmp_path / "jax"), max_wait_ms=1.0)
    try:
        want = {"vit_b16": "int8-scores", NAME: "auto"}
        assert kinds["torch"] == kinds["jax"] == want
        (s8,) = impls
        assert s8.func is tfb.fused_attn_block_s8
        assert s8.keywords == {"int8_pv": True}
        for variant in models:
            graph = app.graphs.load(variant + ".json")
            head = [n["instance"].get("endpoint") for n in
                    graph["nodes"]].index(variant + ":head")
            out = Response.decode(app.compute(_request(graph, [(head, "o")])))
            assert out[head]["o"].shape == (1, 1000)
            assert np.isfinite(out[head]["o"]).all()
    finally:
        app.close()
        japp.batcher.stop()


def test_maker_resolves_no_kernel_on_the_cpu(monkeypatch):
    """On the CPU the blocks run the unfused path (the JAX XLA path), at
    the variant's own rate (vit_b16_tome16: r=16, narrowed as above)."""
    name = "vit_b16_tome16"
    monkeypatch.setitem(ttome.VARIANTS, name, ttome.ToMeViTConfig(
        name, **dict(NARROW, r=16)))
    model = make_tome_model(name, device="cpu")
    assert model.describe("blocks.11") == (
        "ToMe block d=64 h=4: 21 -> 11 tokens (tap 'merge' for the "
        "patch-merge map)")
    assert model.describe("head") == \
        "Linear(64 -> 1000) on 11 surviving tokens"
