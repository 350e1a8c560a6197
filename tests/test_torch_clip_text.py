"""The port's CLIP text tower, tokenizer and zero-shot graph
(``models/clip_text.py``, ``clip_bpe.py``, ``clip_text_plugin.py``)
against the JAX package on the CPU, on shared inputs.

A small text config (width 64 in 2 heads, depth 2, the 77-token context)
is initialised by JAX and carried across (``weights.from_jax``). The
causal attention's probabilities are held to JAX's within 1e-6 with every
entry above the diagonal exactly 0 in both; the forward within 1e-5; the
text chain and the zero-shot graph through both executors within 1e-4;
token ids and graph JSON equal.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.executor import Executor as JExecutor
from interactive_vit_tpu.graph.ir import GraphError as JGraphError
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import clip as jclip
from interactive_vit_tpu.models import clip_bpe as jbpe
from interactive_vit_tpu.models import clip_text as jtext
from interactive_vit_tpu.models import clip_text_plugin as jctp
from interactive_vit_tpu.models.clip_plugin import (
    make_clip_model as jmake_clip,
)
from interactive_vit_tpu.ops import attention as jattn
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph.executor import Executor, NodeError
from interactive_vit_tpu_torch.graph.ir import GraphError
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import clip, clip_bpe, clip_text
from interactive_vit_tpu_torch.models import clip_text_plugin as ctp
from interactive_vit_tpu_torch.models.clip_plugin import make_clip_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import attention as tattn
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.wire import schema

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBS_ATOL = 1e-6
FWD_ATOL = 1e-5
CHAIN_ATOL = 1e-4
SMALL = dict(name="clip_text_small", vocab_size=600, width=64, depth=2,
             heads=2, embed_dim=32)
JCFG = jtext.CLIPTextConfig(**SMALL)
TCFG = clip_text.CLIPTextConfig(**SMALL)
# unicode, punctuation and contractions, html entities, an overlong
# prompt, the empty one, a special token written in the text
PROMPTS = ["a photo of a cat", "", "Café déjà-vu: naïve façade — 北京 123 ½",
           "It's the dog's toy, isn't it? I'LL go!!!", "x!<|endoftext|>y",
           "word " * 100, "tab\tsep\nnew  line &amp; &lt;b&gt;",
           "emoji 🐱🐶 ok", "ǅ ǈ ͅx ß Σ ς", "a1b22c333"]


@pytest.fixture(scope="module")
def shared():
    params = jax.tree.map(np.asarray, jtext.init_params(jax.random.key(5),
                                                        JCFG))
    tokens = jbpe.default_tokenizer().batch(PROMPTS[:4], JCFG.context)
    return params, tokens


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, dtype=np.float32),
                               atol=atol, rtol=0)


# -- the tokenizer --------------------------------------------------------------


def test_tokenizer_ids_equal_jax():
    want = jbpe.ClipTokenizer()
    got = clip_bpe.ClipTokenizer()
    for p in PROMPTS:
        assert got.encode(p) == want.encode(p), p
    np.testing.assert_array_equal(got.batch(PROMPTS), want.batch(PROMPTS))
    assert got.batch(PROMPTS).dtype == np.int32
    assert got.vocab_size == want.vocab_size == 514
    assert (got.sot_id, got.eot_id) == (want.sot_id, want.eot_id)
    assert clip_bpe.bytes_to_unicode() == jbpe.bytes_to_unicode()
    # the overlong prompt is cut with eot kept in the last slot
    row = got.batch(["word " * 100])[0]
    assert row[-1] == got.eot_id and row.argmax() == 76
    assert got.decode(got.encode("A Photo, of a CAT!")) == want.decode(
        want.encode("A Photo, of a CAT!"))


def test_tokenizer_merges_equal_jax(tmp_path):
    merges = [("a", "b"), ("ab</w>", "c"), ("c", "a"), ("h", "e"),
              ("he", "l</w>"), ("c", "at</w>"), ("a", "t</w>")]
    path = tmp_path / "merges.txt"
    path.write_text("#version: 0.2\n" + "\n".join(" ".join(m)
                                                  for m in merges) + "\n")
    assert clip_bpe.load_merges(str(path)) == jbpe.load_merges(str(path))
    got = clip_bpe.ClipTokenizer(clip_bpe.load_merges(str(path)))
    want = jbpe.ClipTokenizer(jbpe.load_merges(str(path)))
    for p in ("abc ab cab hel help the cat", "cabab", *PROMPTS):
        assert got.encode(p) == want.encode(p), p


# -- the tower ------------------------------------------------------------------


@pytest.mark.parametrize("n_real", [None, 60])
def test_causal_attention_matches_jax(n_real):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 2, 77, 32)).astype(np.float32)
               for _ in range(3))
    wo, wp = jattn.attention_reference(*map(jnp.asarray, (q, k, v)),
                                       want_attn=True, causal=True,
                                       n_real=n_real)
    go, gp = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                       want_attn=True, causal=True,
                                       n_real=n_real)
    _close(gp, wp, PROBS_ATOL)
    _close(go, wo, FWD_ATOL)
    upper = np.triu(np.ones((77, 77), bool), 1)
    if n_real is not None:
        upper[:, n_real:] = True
    assert (gp.numpy()[..., upper] == 0).all()
    assert (np.asarray(wp)[..., upper] == 0).all()
    np.testing.assert_allclose(gp.sum(-1).numpy(), 1.0, atol=1e-6)


def test_forward_matches_jax(shared):
    params, tokens = shared
    want = jtext.forward(jax.tree.map(jnp.asarray, params),
                         jnp.asarray(tokens), JCFG, want_attn=True)
    got = clip_text.forward(from_jax(params), torch.from_numpy(tokens), TCFG,
                            want_attn=True)
    assert got["embedding"].shape == (4, 32)
    _close(got["embedding"], want["embedding"], FWD_ATOL)
    for g, w in zip(got["attn"], want["attn"]):
        _close(g, w, FWD_ATOL)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(got["embedding"], dim=-1).numpy(), 1.0,
        atol=1e-6)


def test_from_openai_matches_jax_converter():
    rng = np.random.default_rng(4)
    d, n = TCFG.width, TCFG.context
    sd = {"token_embedding.weight": rng.standard_normal((TCFG.vocab_size,
                                                         d)),
          "positional_embedding": rng.standard_normal((n, d)),
          "ln_final.weight": rng.standard_normal(d),
          "ln_final.bias": rng.standard_normal(d),
          "text_projection": rng.standard_normal((d, TCFG.embed_dim))}
    for i in range(TCFG.depth):
        pre = f"transformer.resblocks.{i}."
        for name, shape in (("ln_1.weight", (d,)), ("ln_1.bias", (d,)),
                            ("attn.in_proj_weight", (3 * d, d)),
                            ("attn.in_proj_bias", (3 * d,)),
                            ("attn.out_proj.weight", (d, d)),
                            ("attn.out_proj.bias", (d,)),
                            ("ln_2.weight", (d,)), ("ln_2.bias", (d,)),
                            ("mlp.c_fc.weight", (4 * d, d)),
                            ("mlp.c_fc.bias", (4 * d,)),
                            ("mlp.c_proj.weight", (d, 4 * d)),
                            ("mlp.c_proj.bias", (d,))):
            sd[pre + name] = rng.standard_normal(shape)
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jtext.from_openai(sd, JCFG)))[0]
    got = dict((jax.tree_util.keystr(k), v) for k, v in
               jax.tree_util.tree_flatten_with_path(jax.tree.map(
                   lambda t: t.numpy(), clip_text.from_openai(sd, TCFG)))[0])
    assert sorted(got) == sorted(jax.tree_util.keystr(k) for k, _ in want)
    for k, v in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(k)], v)


# -- the plugin and the graphs ----------------------------------------------------


def test_parse_prompts_and_dynamic_sig_match_jax():
    for raw in ('["a", "b c"]', "a bare string", "", '"one"', "[]"):
        assert ctp._parse_prompts({"prompts": raw}) == \
            jctp._parse_prompts({"prompts": raw})
    assert ctp.DEFAULT_PROMPTS == jctp.DEFAULT_PROMPTS
    for raw in ('[1, 2]', '{"a": 1}', '["a", 3]'):
        with pytest.raises(GraphError) as got:
            ctp._parse_prompts({"prompts": raw})
        with pytest.raises(JGraphError) as want:
            jctp._parse_prompts({"prompts": raw})
        assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def text(shared):
    """Both packages' small text towers registered beside their
    built-ins."""
    params, _ = shared
    reg, jreg = Registry(), JRegistry()
    register_builtin(reg)
    jbuiltin(jreg)
    jctp.make_clip_text_model(params=jax.tree.map(jnp.asarray, params),
                              cfg=JCFG).register(jreg)
    model = ctp.make_clip_text_model(params=from_jax(params), cfg=TCFG,
                                     device="cpu")
    model.register(reg)
    return reg, jreg, model


def _graph(mod, obj, prompts=None):
    if prompts is not None:
        obj = json.loads(json.dumps(obj))
        obj["nodes"][0]["instance"]["params"]["prompts"] = json.dumps(prompts)
    return mod.graph_from_json(obj)


def test_text_node_kinds_match_jax(text):
    reg, jreg, model = text
    jmodel = jreg.get_node("clip_text_small:embed").model
    assert model.generate_graph_json() == jmodel.generate_graph_json()
    assert model.descriptions == jmodel.descriptions
    for name in model.list_node_names():
        kind, jkind = reg.get_node(name), jreg.get_node(name)
        assert kind.io({}) == jkind.io({})
        assert kind.dynamic_params() == jkind.dynamic_params()
        assert kind.dynamic_capture_keys() == jkind.dynamic_capture_keys()
    embed = reg.get_node("clip_text_small:embed")
    jembed = jreg.get_node("clip_text_small:embed")
    for raw in ("", '["a", "b", "c"]', "one"):
        assert embed.dynamic_sig({"prompts": raw}) == \
            jembed.dynamic_sig({"prompts": raw})
        assert embed.contents({"prompts": raw}) == \
            jembed.contents({"prompts": raw})
    caps, jcaps = embed.captures({}), jembed.captures({})
    np.testing.assert_array_equal(caps["tokens"], jcaps["tokens"])
    np.testing.assert_array_equal(caps["eot"], jcaps["eot"])
    assert caps["eot"].dtype == np.int32


def test_text_chain_matches_jax(text):
    reg, jreg, model = text
    obj = model.generate_graph_json()
    last = len(obj["nodes"]) - 1
    taps = {(0, "eot"), (1, "attn"), (2, "o"), (last, "o")}
    prompts = PROMPTS[2:5]
    got = Executor(reg, device="cpu").run(_graph(schema, obj, prompts), taps)
    want = JExecutor(jreg).run(_graph(jschema, obj, prompts), taps)
    assert got[last]["o"].shape == (3, 32)
    assert got[1]["attn"].shape == (3, 2, 77, 77)
    for i, ch in taps:
        _close(torch.from_numpy(got[i][ch]), want[i][ch], CHAIN_ATOL)


def test_bad_prompts_is_attributed_to_the_node(text):
    reg, _, model = text
    g = _graph(schema, model.generate_graph_json(), [1, 2])
    with pytest.raises(NodeError, match="prompts must be a JSON list"):
        Executor(reg, device="cpu").run(g)


def test_rewording_replays_and_count_restages(text):
    reg, _, model = text
    obj = model.generate_graph_json()
    last = len(obj["nodes"]) - 1
    ex = Executor(reg, device="cpu")
    taps = {(last, "o")}
    a = ex.run(_graph(schema, obj, ["a photo of a cat", "a dog"]), taps)
    assert not ex.last_stats.cache_hit
    b = ex.run(_graph(schema, obj, ["a photo of a bird", "a dog"]), taps)
    assert ex.last_stats.cache_hit, "rewording a prompt staged again"
    assert not np.allclose(a[last]["o"][0], b[last]["o"][0])
    np.testing.assert_array_equal(a[last]["o"][1], b[last]["o"][1])
    fresh = Executor(reg, device="cpu").run(
        _graph(schema, obj, ["a photo of a bird", "a dog"]), taps)
    np.testing.assert_array_equal(b[last]["o"], fresh[last]["o"])
    c = ex.run(_graph(schema, obj, ["one", "two", "three"]), taps)
    assert not ex.last_stats.cache_hit
    assert c[last]["o"].shape == (3, 32)
    assert ex.cache_info()["entries"] == 2


def test_rewordings_in_one_group_get_their_own_rows(text):
    """Two requests that differ only in wording: one group, one stacked
    pass (the embed node folds the group's prompts into one batch), each
    row its own single run's; the token table is passed once."""
    reg, _, model = text
    obj = model.generate_graph_json()
    last = len(obj["nodes"]) - 1
    ex = Executor(reg, device="cpu")
    words = (["a red square", "a blue circle"],
             ["a green triangle", "a blue circle"])
    graphs = [_graph(schema, obj, w) for w in words]
    assert ex.group_sig(graphs[0]) == ex.group_sig(graphs[1])
    taps = {(0, "eot"), (1, "attn"), (last, "o")}
    group = ex.run_stacked(graphs, taps)
    for w, res in zip(words, group):
        single = Executor(reg, device="cpu").run(_graph(schema, obj, w), taps)
        for i, ch in taps:
            np.testing.assert_allclose(res[i][ch], single[i][ch], atol=1e-6,
                                       rtol=0)
    assert not np.allclose(group[0][last]["o"][0], group[1][last]["o"][0])
    np.testing.assert_array_equal(group[0][last]["o"][1],
                                  group[1][last]["o"][1])


def test_zeroshot_graph_json_equals_jax_and_the_saved_graph():
    got = ctp.generate_zeroshot_graph_json()
    assert got == jctp.generate_zeroshot_graph_json()
    with open(os.path.join(ROOT, "static", "graphs",
                           "clip_zeroshot.json")) as f:
        saved = json.load(f)
    assert got["nodes"] == saved["nodes"]
    assert got["edges"] == saved["edges"]
    prompts = ["a", "b c"]
    assert ctp.generate_zeroshot_graph_json(prompts) == \
        jctp.generate_zeroshot_graph_json(prompts)


def test_zeroshot_graph_matches_jax(shared, text, monkeypatch):
    """The zero-shot graph at small widths (the towers renamed to the
    graph's endpoints): similarity logits within 1e-4 of JAX's."""
    params, _ = shared
    vsmall = dict(name="clip_b32", img_size=64, patch=32, width=64, depth=2,
                  heads=2, embed_dim=32)
    jv = jclip.CLIPVisionConfig(**vsmall)
    vparams = jax.tree.map(np.asarray, jclip.init_params(jax.random.key(8),
                                                         jv))
    tsmall = dict(SMALL, name="clip_text_b32")
    reg, jreg = Registry(), JRegistry()
    register_builtin(reg)
    jbuiltin(jreg)
    jmake_clip(params=jax.tree.map(jnp.asarray, vparams), cfg=jv,
               kernels=False).register(jreg)
    jctp.make_clip_text_model(params=jax.tree.map(jnp.asarray, params),
                              cfg=jtext.CLIPTextConfig(**tsmall)
                              ).register(jreg)
    make_clip_model(params=from_jax(vparams),
                    cfg=clip.CLIPVisionConfig(**vsmall),
                    device="cpu").register(reg)
    ctp.make_clip_text_model(params=from_jax(params),
                             cfg=clip_text.CLIPTextConfig(**tsmall),
                             device="cpu").register(reg)
    vcls, tcls = clip.CLIPVisionConfig, clip_text.CLIPTextConfig
    monkeypatch.setattr(ctp.clip, "CLIPVisionConfig",
                        lambda: vcls(**vsmall))
    monkeypatch.setattr(ctp.clip_text, "CLIPTextConfig",
                        lambda: tcls(**tsmall))
    obj = ctp.generate_zeroshot_graph_json()
    at = {n["instance"].get("endpoint"): i for i, n in enumerate(obj["nodes"])}
    outs = (at["similarity"], at["clip_b32:embedding"],
            at["clip_text_b32:embedding"])
    image = np.random.default_rng(6).random((3, 80, 64), dtype=np.float32)
    out = {}
    for name, mod, ex in (("port", schema, Executor(reg, device="cpu")),
                          ("jax", jschema, JExecutor(jreg))):
        g = mod.graph_from_json(obj)
        g.add_input(image, g.nodes[0], "o")
        out[name] = ex.run(g, taps={(i, "o") for i in outs})
    assert out["port"][outs[0]]["o"].shape == (1, 4)
    for i in outs:
        _close(torch.from_numpy(out["port"][i]["o"]), out["jax"][i]["o"],
               CHAIN_ATOL)


@pytest.mark.parametrize("graph,image", [("clip_zeroshot", True),
                                         ("clip_text_b32", False),
                                         ("clip_b32", True)])
def test_saved_graphs_run_through_run_graph(tmp_path, graph, image):
    """The repository's saved CLIP graphs, unchanged, through the headless
    runner at full width on the CPU: the zero-shot logits [1, 4], the
    text tower's four embeddings and the image tower's one, unit norm."""
    from interactive_vit_tpu_torch.tools.run_graph import main

    argv = [graph, "--device", "cpu", "--dtype", "bfloat16", "--taps",
            "primary", "--out", str(tmp_path)]
    if image:
        np.save(tmp_path / "x.npy", np.random.default_rng(0).random(
            (3, 240, 200), dtype=np.float32))
        argv += ["--image", str(tmp_path / "x.npy")]
    assert main(argv) == 0
    with open(tmp_path / "manifest.json") as f:
        manifest = json.load(f)
    shapes = {m["name"]: m["shape"] for m in manifest.values()}
    want = {"clip_zeroshot": {"similarity": [1, 4]},
            "clip_text_b32": {"clip_text_b32:embedding": [4, 512]},
            "clip_b32": {"clip_b32:embedding": [1, 512]}}[graph]
    assert {k: shapes.get(k) for k in want} == want
    if graph != "clip_zeroshot":
        stem = next(k for k, m in manifest.items() if m["name"] in want)
        emb = np.load(tmp_path / (stem + ".npy"))
        np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0,
                                   atol=2.0 ** -7)


def test_server_writes_the_zeroshot_graph(tmp_path):
    """``--models clip_b32,clip_text_b32,vgg16`` on the CPU: each model's
    chain graph and, with both towers, ``clip_zeroshot.json`` (the JAX
    function's JSON) are written into a graphs dir that lacks them; one
    that has it keeps its own."""
    from interactive_vit_tpu_torch.serving.server import build_app

    app = build_app(models=("clip_b32", "clip_text_b32", "vgg16"),
                    graphs_dir=str(tmp_path), device="cpu")
    try:
        assert sorted(app.graphs.list()) == [
            "clip_b32.json", "clip_text_b32.json", "clip_zeroshot.json",
            "vgg16.json"]
        assert app.graphs.load("clip_zeroshot.json") == \
            jctp.generate_zeroshot_graph_json()
        assert "vgg16:classifier.6" in app.reg.names()
    finally:
        app.close()
    mine = {"nodes": [], "edges": []}
    (tmp_path / "clip_zeroshot.json").write_text(json.dumps(mine))
    build_app(models=("clip_b32", "clip_text_b32"), graphs_dir=str(tmp_path),
              device="cpu").close()
    assert json.loads((tmp_path / "clip_zeroshot.json").read_text()) == mine
