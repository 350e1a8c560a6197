"""The repository's saved graphs of ResNet-50, ConvNeXt-T, the MoE ViT and
MAE served by the port's ``build_app(device="cpu")`` against the JAX app.

Each family's weights (the port's seeded init) are written by the JAX
package as a native ``.safetensors`` file (``to_native_flat`` +
``save_file``) that the port's server loads with ``--ckpt``; the JAX app
gets the tree itself. The widths are narrowed in both packages and the
published depths kept, so the saved graphs serve as they are:
convnext_t at dims (8, 16, 24, 32), vit_moe_s16 at width 32 with 2 heads
(12 blocks, 8 experts, 197 tokens, capacity 31), mae_t16's encoder at
width 32 with 2 blocks (224 px, 196 patches) and a decoder 16 wide.
ResNet-50's widths are fixed: its graph is cut short to the first block
of each stage (the others keep their input's shape). The saliency graphs
are cut the same way, dream at 2 steps and occlusion at a 56 px patch and
stride. Tolerance: f32 within 1e-4 of max(1, |JAX|) (ResNet-50's seeded
He init grows its activations to hundreds), the MAE mask exactly.
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
from interactive_vit_tpu.models import convnext as jconvnext
from interactive_vit_tpu.models import mae as jmae
from interactive_vit_tpu.models import moe as jmoe
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.convnext_plugin import (
    make_convnext_model as jconvnext_make,
)
from interactive_vit_tpu.models.mae_plugin import make_mae_model as jmae_make
from interactive_vit_tpu.models.moe_plugin import make_moe_model as jmoe_make
from interactive_vit_tpu.models.resnet_plugin import (
    make_resnet50_model as jresnet_make,
)
from interactive_vit_tpu.models.weights import to_native_flat as jto_native
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.serving.app import App as JApp
from interactive_vit_tpu.utils.safetensors_io import save_file as jsave
from interactive_vit_tpu_torch.models import convnext, mae, moe, vit
from interactive_vit_tpu_torch.models.autoregister import (
    known_variants, make_model, plain_vit_family,
)
from interactive_vit_tpu_torch.serving.server import build_app
from interactive_vit_tpu_torch.wire import schema
from interactive_vit_tpu_torch.wire.codec import (
    REQUEST_MAGIC, RESPONSE_MAGIC, Request, Response, decode_message,
    encode_message,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = os.path.join(ROOT, "static", "graphs")
FAMILIES = ("resnet50", "convnext_t", "vit_moe_s16", "mae_t16")

CONVNEXT = dict(dims=(8, 16, 24, 32))
MOE = dict(img_size=224, patch=16, width=32, depth=12, heads=2,
           n_experts=8)
MAE_ENC = dict(img_size=224, patch=16, width=32, depth=2, heads=2)
MAE_DEC = dict(dec_width=16, dec_depth=1, dec_heads=2)


def _narrow_tables(mp):
    mp.setitem(jconvnext.VARIANTS, "convnext_t",
               jconvnext.ConvNeXtConfig("convnext_t", **CONVNEXT))
    mp.setitem(convnext.VARIANTS, "convnext_t",
               convnext.ConvNeXtConfig("convnext_t", **CONVNEXT))
    mp.setitem(jmoe.VARIANTS, "vit_moe_s16",
               jmoe.MoEViTConfig("vit_moe_s16", **MOE))
    mp.setitem(moe.VARIANTS, "vit_moe_s16",
               moe.MoEViTConfig("vit_moe_s16", **MOE))
    mp.setitem(jmae.VARIANTS, "mae_t16", jmae.MAEConfig(
        "mae_t16", "vit_t16", enc_override=jvit.ViTConfig("e", **MAE_ENC),
        **MAE_DEC))
    mp.setitem(mae.VARIANTS, "mae_t16", mae.MAEConfig(
        "mae_t16", "vit_t16", enc_override=vit.ViTConfig("e", **MAE_ENC),
        **MAE_DEC))


def _jax_params(variant):
    """The port's seeded init of the narrowed family as a JAX tree."""
    tree = make_model(variant, device="cpu",
                      seed=FAMILIES.index(variant) + 1).params
    if variant == "convnext_t":
        # layer scales of 0.5, not 1e-6, so that the blocks' branches show
        for st in tree["stages"]:
            for b in st:
                b["gamma"] = torch.full_like(b["gamma"], 0.5)
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _jax_model(variant, params):
    if variant == "resnet50":
        return jresnet_make(params=params)
    if variant == "convnext_t":
        return jconvnext_make(variant, params=params)
    if variant == "vit_moe_s16":
        return jmoe_make(variant, params=params)
    return jmae_make(variant, params=params)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """{variant: (port app, JAX app)}: the port's server loads the JAX
    package's native file of each family with ``--ckpt``."""
    tdir = tmp_path_factory.mktemp("torch")
    jdir = tmp_path_factory.mktemp("jax")
    wdir = tmp_path_factory.mktemp("weights")
    for name in os.listdir(GRAPHS):
        if name.split(".")[0].split("_saliency")[0] in FAMILIES:
            shutil.copy(os.path.join(GRAPHS, name), tdir)
            shutil.copy(os.path.join(GRAPHS, name), jdir)
    with pytest.MonkeyPatch.context() as mp:
        _narrow_tables(mp)
        jreg = JRegistry()
        jbuiltin(jreg)
        japp = JApp(reg=jreg, graphs_dir=str(jdir), speculate=False,
                    max_wait_ms=1.0)
        ckpts = {}
        for variant in FAMILIES:
            jp = _jax_params(variant)
            path = str(wdir / f"{variant}.safetensors")
            jsave({k: np.asarray(v) for k, v in jto_native(jp).items()},
                  path)
            ckpts[variant] = path
            _jax_model(variant, jp).register(jreg, japp.graphs)
        app = build_app(models=FAMILIES, graphs_dir=str(tdir), device="cpu",
                        max_wait_ms=1.0, ckpts=ckpts)
        try:
            yield app, japp
        finally:
            app.close()
            japp.batcher.stop()


def _cut(obj, drop):
    """The graph without the nodes whose endpoint ends in one of ``drop``,
    each kept node wired from its nearest kept ancestor on the chain."""
    nodes = obj["nodes"]
    gone = {i for i, n in enumerate(nodes)
            if n["instance"].get("endpoint", "").split(":")[-1] in drop}
    pred = {e["out_port"]["node"]: e["in_port"]["node"]
            for e in obj["edges"] if e["out_port"]["channel"] == "o"}
    keep = [i for i in range(len(nodes)) if i not in gone]
    new = {old: k for k, old in enumerate(keep)}
    edges = []
    for e in obj["edges"]:
        a, b = e["in_port"]["node"], e["out_port"]["node"]
        if b in gone:
            continue
        while a in gone:
            a = pred[a]
        edges.append({"in_port": {**e["in_port"], "node": new[a]},
                      "out_port": {**e["out_port"], "node": new[b]}})
    return {"nodes": [nodes[i] for i in keep], "edges": edges}


RESNET_DROP = {f"layer{s}.{b}" for s, n in ((1, 3), (2, 4), (3, 6), (4, 3))
               for b in range(1, n)}
CONVNEXT_DROP = {f"stages.{s}.{b}" for s, n in enumerate((3, 3, 9, 3))
                 for b in range(1, n)}
MOE_DROP = {f"blocks.{i}" for i in range(4, 12)}


def _graph(app, name, drop=(), params=None):
    obj = _cut(app.graphs.load(name), set(drop))
    for i, p in (params or {}).items():
        obj["nodes"][i]["instance"]["params"].update(p)
    return obj


def _request(obj, taps, seed=0, dtype=None):
    g = schema.graph_from_json(obj)
    img = np.random.default_rng(seed).random((3, 240, 260), np.float32)
    g.add_input(img, g.nodes[0], "o")
    req, tensors = decode_message(Request.encode(g),
                                  expect_magic=REQUEST_MAGIC)
    req["taps"] = [{"node": i, "channel": ch} for i, ch in taps]
    if dtype:
        req["resp_dtype"] = dtype
    return encode_message(REQUEST_MAGIC, req, tensors)


def _serve_both(app, japp, obj, taps):
    body = _request(obj, taps)
    raw, jraw = app.compute(body), japp.compute(body)
    assert (decode_message(raw, expect_magic=RESPONSE_MAGIC)[0]
            == decode_message(jraw, expect_magic=RESPONSE_MAGIC)[0])
    return Response.decode(raw), Response.decode(jraw)


def _close(got, want, what=""):
    assert got.shape == want.shape, what
    tol = 1e-4 * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol, f"{what}: {err} > {tol}"


# graph -> (nodes dropped, node params, taps by node index after the cut)
CASES = {
    "resnet50": (RESNET_DROP, {}, [(1, "o"), (2, "o"), (3, "o"), (6, "o"),
                                   (8, "o")]),
    "convnext_t": (CONVNEXT_DROP, {}, [(1, "o"), (2, "o"), (3, "o"),
                                       (7, "o"), (9, "o"), (10, "o")]),
    "vit_moe_s16": (MOE_DROP, {3: {"attn_heads": "[1]"}},
                    [(2, "attn"), (3, "attn"), (3, "r"), (3, "experts"),
                     (5, "experts"), (7, "o")]),
    "mae_t16": ((), {1: {"seed": "17"}},
                [(1, "o"), (1, "masked"), (1, "err"), (1, "mask")]),
}


@pytest.mark.parametrize("variant", sorted(CASES))
def test_saved_graph_served_like_jax(apps, variant):
    app, japp = apps
    drop, params, taps = CASES[variant]
    obj = _graph(app, variant + ".json", drop, params)
    got, want = _serve_both(app, japp, obj, taps)
    assert sorted(got) == sorted(want)
    for i in want:
        assert sorted(got[i]) == sorted(want[i])
        for ch in want[i]:
            if ch == "mask":
                np.testing.assert_array_equal(got[i][ch], want[i][ch])
            if ch == "experts":
                # a bf16 tap of gates in [0, 1]: one bf16 step apart at most
                np.testing.assert_allclose(got[i][ch], want[i][ch],
                                           atol=2.0 ** -8, rtol=0)
            else:
                _close(got[i][ch], want[i][ch], f"{variant} {i} {ch}")
    if variant == "vit_moe_s16":
        assert got[5]["experts"].shape == (1, 8, 14, 14)
        assert got[3]["attn"].shape == (1, 1, 197, 197)
    if variant == "convnext_t":
        assert got[2]["o"].shape == (56, 56, 8)
        assert got[3]["o"].shape == (28, 28, 16)
    if variant == "mae_t16":
        assert got[1]["mask"].sum() == 196 - 49


@pytest.mark.parametrize("variant", ["convnext_t", "vit_moe_s16"])
def test_saliency_graph_served_like_jax(apps, variant):
    """The saved saliency graph (saliency, dream, occlusion off the head),
    cut short: every view within the tolerance of the JAX app's."""
    app, japp = apps
    drop = CONVNEXT_DROP if variant == "convnext_t" else MOE_DROP
    obj = _cut(app.graphs.load(variant + "_saliency.json"), drop)
    for n in obj["nodes"]:
        ep = n["instance"].get("endpoint")
        if ep == "dream":
            n["instance"]["params"]["steps"] = "2"
        if ep == "occlusion":
            n["instance"]["params"].update(patch="56", stride="56")
    grad = [i for i, n in enumerate(obj["nodes"]) if n["instance"].get(
        "endpoint") in ("saliency", "dream", "occlusion")]
    assert len(grad) == 3
    got, want = _serve_both(app, japp, obj, [(i, "o") for i in grad])
    for i in grad:
        _close(got[i]["o"], want[i]["o"], f"{variant} {i}")
        assert np.abs(got[i]["o"]).max() > 0


def test_bf16_request_within_bound(tmp_path):
    """convnext_t served in bf16 (seeded): the logits within 4 % of the
    f32 server's range on the same weights."""
    with pytest.MonkeyPatch.context() as mp:
        _narrow_tables(mp)
        shutil.copy(os.path.join(GRAPHS, "convnext_t.json"), tmp_path)
        f32 = build_app(models=["convnext_t"], graphs_dir=str(tmp_path),
                        device="cpu", max_wait_ms=1.0)
        bf16 = build_app(models=["convnext_t"], graphs_dir=str(tmp_path),
                         device="cpu", max_wait_ms=1.0,
                         dtype_name="bfloat16")
        try:
            obj = _graph(f32, "convnext_t.json", CONVNEXT_DROP)
            body = _request(obj, [(10, "o")])
            want = Response.decode(f32.compute(body))[10]["o"]
            got = Response.decode(bf16.compute(body))[10]["o"]
        finally:
            f32.close()
            bf16.close()
    assert np.abs(got - want).max() <= 0.04 * float(np.ptp(want))


def test_server_writes_the_saved_graphs(tmp_path):
    """Into an empty library the server writes each family's chain and,
    for the classifiers with a head (convnext_t, vit_moe_s16), the
    saliency graph: the repository's saved files (MAE's saved graph
    carries its views and is not generated)."""
    with pytest.MonkeyPatch.context() as mp:
        _narrow_tables(mp)
        app = build_app(models=FAMILIES, graphs_dir=str(tmp_path),
                        device="cpu")
        app.close()
    assert sorted(os.listdir(tmp_path)) == [
        "convnext_t.json", "convnext_t_saliency.json", "mae_t16.json",
        "resnet50.json", "vit_moe_s16.json", "vit_moe_s16_saliency.json"]
    for name in ("convnext_t", "convnext_t_saliency", "resnet50",
                 "vit_moe_s16", "vit_moe_s16_saliency"):
        with open(os.path.join(tmp_path, name + ".json")) as f, \
                open(os.path.join(GRAPHS, name + ".json")) as g:
            assert json.load(f) == json.load(g), name


def test_known_variants_are_jax_s():
    """Every family's published names are known to both packages, and the
    two lists differ by no name of this slice's families (other test
    modules may leave a narrow variant of their own in either table)."""
    ours, theirs = set(known_variants()), set(jauto.known_variants())
    published = {"resnet50", "convnext_t", "convnext_s", "convnext_b",
                 "vit_moe_s16", "mae_t16", "mae_s16", "mae_b16", "vgg16",
                 "clip_b32", "clip_text_b32", "swin_t", "vit_b16_tome",
                 "vit_b16", "dinov2_s14_reg"}
    assert published <= ours and published <= theirs
    assert not {v for v in ours ^ theirs
                if v.startswith(("resnet", "convnext_", "vit_moe", "mae_"))}
    for variant in ("resnet50", "convnext_s", "vit_moe_s16", "mae_b16",
                    "mae_t16@64"):
        assert not plain_vit_family(variant)
    assert plain_vit_family("vit_b16@384")


@pytest.mark.parametrize("variant", ["resnet50@256", "convnext_t@p8",
                                     "vit_moe_s16@384"])
def test_at_suffix_refused_outside_mae(variant):
    with pytest.raises(ValueError, match="plain-ViT"):
        make_model(variant, device="cpu")
    with pytest.raises(ValueError, match="plain-ViT"):
        jauto.make_model(variant)


@pytest.mark.parametrize("variant", FAMILIES)
def test_block_kernel_refused_and_quantize_warns(variant, caplog):
    with pytest.MonkeyPatch.context() as mp:
        _narrow_tables(mp)
        with pytest.raises(ValueError, match="plain-ViT family only"):
            make_model(variant, device="cpu", block_kernel="int8-scores")
        with caplog.at_level(logging.WARNING):
            model = make_model(variant, device="cpu", dtype=torch.bfloat16,
                               quantize="w8")
    assert f"int8 not wired for {variant}" in caplog.text
    dtypes = {t.dtype for t in jax.tree.leaves(model.params)}
    assert torch.bfloat16 in dtypes and torch.int8 not in dtypes


def test_attn_impl_reaches_moe_and_the_server_flag():
    """``--attn flash`` gives every MoE block the flash attention on the
    card (on the CPU it is asked for and refuses nothing: the wrapper runs
    its plain version), with plain gradient twins."""
    from interactive_vit_tpu_torch.ops.dispatch import default_attn_impl

    with pytest.MonkeyPatch.context() as mp:
        _narrow_tables(mp)
        model = make_model("vit_moe_s16", device="cpu",
                           attn_impl=default_attn_impl("flash"))
        app = build_app(models=["vit_moe_s16"], device="cpu",
                        attn_impl_name="flash")
        served = app.reg.get_node("vit_moe_s16:blocks.0").model
        app.close()
    assert sorted(model.grad_layers) == sorted(n for n, _, _ in model.layers)
    assert sorted(served.grad_layers) == sorted(model.grad_layers)


def test_unknown_family_member_refused():
    with pytest.raises(ValueError, match="unknown model variant"):
        make_model("convnext_x", device="cpu")
    with pytest.raises(ValueError, match="unknown model variant"):
        make_model("mae_x16@64", device="cpu")


@pytest.mark.parametrize("variant,node,shape", [
    ("mae_t16", "mae_t16:reconstruct", (3, 224, 224)),
    ("resnet50", "resnet50:fc", (1000,))])
def test_saved_graph_runs_through_run_graph(tmp_path, variant, node, shape):
    """The saved graph unchanged through the headless runner on the CPU
    at the published widths (its own seeded weights): ``tools/run_graph``
    needs nothing beyond ``autoregister``."""
    from interactive_vit_tpu_torch.tools.run_graph import main

    np.save(tmp_path / "x.npy", np.random.default_rng(0).random(
        (3, 64, 64), dtype=np.float32))
    assert main([variant, "--device", "cpu", "--image",
                 str(tmp_path / "x.npy"), "--out", str(tmp_path)]) == 0
    with open(tmp_path / "manifest.json") as f:
        manifest = json.load(f)
    stem = next(k for k, m in manifest.items()
                if m["name"] == node and m["channel"] == "o")
    out = np.load(tmp_path / (stem + ".npy"))
    assert out.shape[-len(shape):] == shape and np.isfinite(out).all()
