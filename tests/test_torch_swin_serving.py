"""Swin end to end on the CPU: the port's server against the JAX package's
server, over HTTP, on the same weights.

A tiny Swin config is registered in both packages with weights from the
JAX initializer (handed to the port through ``models/weights.from_jax``);
each app serves its own graph library in ``tmp_path``. The same wire bytes
-- the generated chain graph with ``attn`` taps, ``attn_heads`` and
``attn_win`` node params -- go to both; the decoded responses must carry
the same route entries and agree at f32 atol 1e-4.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import swin as jswin
from interactive_vit_tpu.models.swin_plugin import make_swin_model as jmake
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.serving.app import App as JApp
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import swin as tswin
from interactive_vit_tpu_torch.models.swin_plugin import make_swin_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.serving.app import App
from interactive_vit_tpu_torch.serving.server import build_app
from interactive_vit_tpu_torch.wire import schema
from interactive_vit_tpu_torch.wire.codec import (
    REQUEST_MAGIC, RESPONSE_MAGIC, Request, Response, decode_message,
    encode_message,
)

torch.set_num_threads(2)

NAME = "swin_srv_port"
GEOM = dict(img_size=32, patch=4, embed_dim=16, depths=(2, 2), heads=(2, 4),
            window=4, num_classes=10)
ATOL = 1e-4
# nodes: 0 transform, 1 patch_embed, 2-3 stages.0.*, 4 merge.0,
# 5-6 stages.1.*, 7 norm, 8 pool, 9 head, 10 category
BLOCK_NODES = (2, 3, 5, 6)
HEAD_NODE = 9


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(port app, port url, jax app, jax url), same weights."""
    jcfg, tcfg = jswin.SwinConfig(NAME, **GEOM), tswin.SwinConfig(NAME,
                                                                  **GEOM)
    jparams = jswin.init_params(jax.random.key(5), jcfg)
    jreg = JRegistry()
    jbuiltin(jreg)
    japp = JApp(reg=jreg, graphs_dir=str(tmp_path_factory.mktemp("jax")),
                speculate=False, max_wait_ms=20.0)
    jmake(NAME, params=jparams, cfg=jcfg).register(jreg, japp.graphs)

    reg = Registry()
    register_builtin(reg)
    app = App(reg=reg, graphs_dir=str(tmp_path_factory.mktemp("torch")),
              device="cpu", max_wait_ms=20.0)
    make_swin_model(NAME, params=from_jax(jax.tree.map(np.asarray, jparams)),
                    cfg=tcfg, device="cpu").register(reg, app.graphs)

    jhttpd = japp.serve("127.0.0.1", 0, background=True)
    httpd = app.serve("127.0.0.1", 0, background=True)
    yield (app, f"http://127.0.0.1:{httpd.server_address[1]}",
           japp, f"http://127.0.0.1:{jhttpd.server_address[1]}")
    httpd.shutdown()
    jhttpd.shutdown()
    app.close()
    japp.batcher.stop()


def _request(app, seed=0, taps=None, node_params=None, shape=(3, 40, 48)):
    """The generated chain graph with an image input, as request bytes."""
    g = schema.graph_from_json(app.graphs.load(NAME + ".json"))
    for i, params in (node_params or {}).items():
        g.nodes[i].params.update(params)
    img = np.random.default_rng(seed).random(shape, dtype=np.float32)
    g.add_input(img, g.nodes[0], "o")
    raw = Request.encode(g)
    if taps is not None:
        obj, tensors = decode_message(raw, expect_magic=REQUEST_MAGIC)
        obj["taps"] = [{"node": i, "channel": ch} for i, ch in taps]
        raw = encode_message(REQUEST_MAGIC, obj, tensors)
    return raw


def _compare(raw, jraw):
    jobj, _ = decode_message(jraw, expect_magic=RESPONSE_MAGIC)
    obj, _ = decode_message(raw, expect_magic=RESPONSE_MAGIC)
    assert obj == jobj  # the same route entries, in the same order
    got, want = Response.decode(raw), Response.decode(jraw)
    for i in want:
        for ch in want[i]:
            assert got[i][ch].shape == want[i][ch].shape, (i, ch)
            np.testing.assert_allclose(got[i][ch], want[i][ch], atol=ATOL,
                                       err_msg=f"node {i} channel {ch}")
    return got


def test_generated_graph_json_matches_jax(servers):
    app, _, japp, _ = servers
    obj = app.graphs.load(NAME + ".json")
    assert obj == japp.graphs.load(NAME + ".json")
    assert len(obj["nodes"]) == 11
    assert obj["nodes"][3]["instance"]["endpoint"] == NAME + ":stages.0.1"


def test_compute_window_maps_match_jax(servers):
    app, url, _, jurl = servers
    raw = _request(app, taps=[(i, "attn") for i in BLOCK_NODES]
                   + [(HEAD_NODE, "o")])
    got = _compare(_post(url + "/compute", raw), _post(jurl + "/compute", raw))
    assert got[HEAD_NODE]["o"].shape == (1, GEOM["num_classes"])
    assert got[2]["attn"].shape == (1, 4, 2, 16, 16)   # stage 0: 4 windows
    assert got[5]["attn"].shape == (1, 1, 4, 16, 16)   # stage 1: 1 window
    for i in BLOCK_NODES:
        np.testing.assert_allclose(got[i]["attn"].sum(-1), 1.0, atol=1e-5)


def test_compute_primary_policy_matches_jax(servers):
    app, url, _, jurl = servers
    raw = _request(app, seed=1)
    got = _compare(_post(url + "/compute", raw), _post(jurl + "/compute", raw))
    assert all(set(chs) == {"o"} for chs in got.values())


def test_compute_selected_heads_and_window_match_jax(servers):
    app, url, _, jurl = servers
    raw = _request(app, seed=2, taps=[(3, "attn"), (6, "attn")],
                   node_params={3: {"attn_win": "2"},
                                6: {"attn_heads": "[3, 1]"}})
    got = _compare(_post(url + "/compute", raw), _post(jurl + "/compute", raw))
    assert got[3]["attn"].shape == (1, 2, 16, 16)      # one window, 2 heads
    assert got[6]["attn"].shape == (1, 1, 2, 16, 16)   # heads 3 and 1


def test_out_of_range_window_is_an_attributed_error(servers):
    app, url, _, jurl = servers
    raw = _request(app, taps=[(2, "attn")],
                   node_params={2: {"attn_win": "9"}})
    for base in (url, jurl):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/compute", raw)
        assert err.value.code >= 400
        assert b"attn_win 9 out of range" in err.value.read()


def test_block_node_description_and_controls(servers):
    _, url, _, jurl = servers
    ep = f"/description/{NAME}:stages.0.1"
    assert json.loads(_get(url + ep)) == json.loads(_get(jurl + ep)) == {
        "ins": ["o"], "outs": ["o", "attn"]}
    kind = servers[0].reg.get_node(NAME + ":stages.0.1")
    html = kind.contents({"attn_win": "3"})
    assert 'data-param="attn_win"' in html and 'value="3"' in html
    assert 'data-param="attn_heads"' in html
    assert 'data-param="attn_win"' not in servers[0].reg.get_node(
        NAME + ":merge.0").contents({})


def test_build_app_serves_swin_beside_vit(tmp_path):
    """``--models swin_t,vit_t16`` registers both families through
    ``models/autoregister``; so does ``convnext_t``, which the port once
    refused, with its chain and saliency graphs written."""
    app = build_app(models=("swin_t", "vit_t16"), graphs_dir=str(tmp_path),
                    device="cpu")
    try:
        names = app.reg.names()
        assert "swin_t:stages.2.5" in names and "vit_t16:blocks.11" in names
        assert sorted(app.graphs.list()) == [
            "swin_t.json", "swin_t_saliency.json", "vit_t16.json",
            "vit_t16_saliency.json"]
        assert len(app.graphs.load("swin_t.json")["nodes"]) == 21
    finally:
        app.close()
    app = build_app(models=("convnext_t",), graphs_dir=str(tmp_path),
                    device="cpu")
    try:
        assert "convnext_t:stages.2.8" in app.reg.names()
        assert {"convnext_t.json", "convnext_t_saliency.json"} <= set(
            app.graphs.list())
    finally:
        app.close()
