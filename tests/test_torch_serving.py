"""The slice end to end on the CPU: the port's server against the JAX
package's server, over HTTP, on the same model weights.

A small ViT config is registered in both packages with weights from the
JAX initializer (handed to the port through ``models/weights.from_jax``);
each app serves its own graph library in ``tmp_path``. The same wire bytes
-- the generated chain graph with ``attn`` and ``r`` taps -- go to both;
the decoded responses must carry the same route entries and agree at f32
atol 1e-4.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from interactive_vit_tpu.graph import executor as jexec
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.vit_plugin import make_vit_model as jmake
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.serving.app import App as JApp
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph.executor import NodeError, resolve_taps
from interactive_vit_tpu_torch.graph.ir import Graph
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import vit as tvit
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

NAME = "vit_srv_port"
SMALL = dict(img_size=32, patch=16, width=64, depth=3, heads=4,
             num_classes=10)
ATOL = 1e-4


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
    jvit.VARIANTS[NAME] = jvit.ViTConfig(NAME, **SMALL)
    tvit.VARIANTS[NAME] = tvit.ViTConfig(NAME, **SMALL)
    jparams = jvit.init_params(jax.random.key(7), jvit.VARIANTS[NAME])
    try:
        jreg = JRegistry()
        jbuiltin(jreg)
        japp = JApp(reg=jreg, graphs_dir=str(tmp_path_factory.mktemp("jax")),
                    speculate=False, max_wait_ms=20.0)
        jmake(NAME, params=jparams).register(jreg, japp.graphs)

        reg = Registry()
        register_builtin(reg)
        app = App(reg=reg, graphs_dir=str(tmp_path_factory.mktemp("torch")),
                  device="cpu", max_wait_ms=20.0)
        make_vit_model(NAME, params=from_jax(jax.tree.map(np.asarray,
                                                          jparams)),
                       device="cpu").register(reg, app.graphs)

        jhttpd = japp.serve("127.0.0.1", 0, background=True)
        httpd = app.serve("127.0.0.1", 0, background=True)
        yield (app, f"http://127.0.0.1:{httpd.server_address[1]}",
               japp, f"http://127.0.0.1:{jhttpd.server_address[1]}")
        httpd.shutdown()
        jhttpd.shutdown()
        app.close()
        japp.batcher.stop()
    finally:
        del jvit.VARIANTS[NAME]
        del tvit.VARIANTS[NAME]


def _chain_request(app, seed=0, taps=None, shape=(3, 40, 48)):
    """The generated chain graph with an image input, as request bytes."""
    g = schema.graph_from_json(app.graphs.load(NAME + ".json"))
    img = np.random.default_rng(seed).random(shape, dtype=np.float32)
    g.add_input(img, g.nodes[0], "o")
    raw = Request.encode(g)
    if taps is not None:
        obj, tensors = decode_message(raw, expect_magic=REQUEST_MAGIC)
        obj["taps"] = [{"node": i, "channel": ch} for i, ch in taps]
        raw = encode_message(REQUEST_MAGIC, obj, tensors)
    return g, raw


def _block_taps(depth=SMALL["depth"]):
    # nodes: 0 transform, 1 embed, 2.. blocks, then norm, head, category
    taps = [(2 + i, ch) for i in range(depth) for ch in ("attn", "r")]
    return taps + [(2 + depth + 1, "o")]


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
    assert app.graphs.load(NAME + ".json") == japp.graphs.load(NAME + ".json")


def test_compute_attn_and_rollout_taps_match_jax(servers):
    app, url, _, jurl = servers
    _, raw = _chain_request(app, taps=_block_taps())
    got = _compare(_post(url + "/compute", raw), _post(jurl + "/compute", raw))
    head = got[2 + SMALL["depth"] + 1]["o"]
    assert head.shape == (1, SMALL["num_classes"])
    attn = got[2]["attn"]
    assert attn.shape == (1, 4, 5, 5)
    np.testing.assert_allclose(attn.sum(-1), 1.0, atol=1e-5)


def test_compute_primary_policy_matches_jax(servers):
    app, url, _, jurl = servers
    _, raw = _chain_request(app, seed=1)
    got = _compare(_post(url + "/compute", raw), _post(jurl + "/compute", raw))
    assert all(set(chs) == {"o"} for chs in got.values())


def test_compute_selected_heads_and_bf16_response_match_jax(servers):
    app, url, _, jurl = servers
    g, _ = _chain_request(app, seed=2)
    g.nodes[3].params["attn_heads"] = "[3, 1]"
    obj, tensors = decode_message(Request.encode(g),
                                  expect_magic=REQUEST_MAGIC)
    obj["taps"] = [{"node": 3, "channel": "attn"}]
    obj["resp_dtype"] = "bf16"
    raw = encode_message(REQUEST_MAGIC, obj, tensors)
    got = _compare(_post(url + "/compute", raw), _post(jurl + "/compute", raw))
    assert got[3]["attn"].shape == (1, 2, 5, 5)


@pytest.mark.parametrize("taps", ["all", "primary", "sinks"])
def test_resolve_taps_matches_jax(servers, taps):
    app, _, japp, _ = servers
    obj = app.graphs.load(NAME + ".json")
    assert resolve_taps(schema.graph_from_json(obj), taps, app.reg) == \
        jexec.resolve_taps(jschema.graph_from_json(obj), taps, japp.reg)


def test_explicit_taps_validated(servers):
    app, _, _, _ = servers
    g = schema.graph_from_json(app.graphs.load(NAME + ".json"))
    with pytest.raises(NodeError) as ei:
        resolve_taps(g, [(2, "nope")], app.reg)
    assert ei.value.node_index == 2


def test_unknown_kind_raises_node_error(servers):
    app, url, _, _ = servers
    g = Graph()
    emb = g.add_node(NAME + ":embed")
    bad = g.add_node("no_such_kind")
    g.connect(emb, "o", bad, "o")
    g.add_input(np.zeros((3, 32, 32), np.float32), emb, "o")
    with pytest.raises(NodeError) as ei:
        app.executor.run(g)
    assert ei.value.node_index == 1
    with pytest.raises(urllib.error.HTTPError) as he:
        _post(url + "/compute", Request.encode(g))
    assert he.value.code == 400
    assert "node 1 (no_such_kind)" in he.value.read().decode()


def test_failing_node_is_attributed_and_isolated(servers):
    """A node that fails while computing: ``run`` names it, ``run_eager``
    keeps going and marks its descendants."""
    app, _, _, _ = servers
    g = Graph()
    emb = g.add_node(NAME + ":embed")
    blk = g.add_node(NAME + ":blocks.0")
    src = g.add_node("img_src")
    g.connect(emb, "o", blk, "o")
    g.add_input(np.zeros((3, 48, 48), np.float32), emb, "o")  # wrong grid
    g.add_input(np.ones((2, 2), np.float32), src, "o")
    with pytest.raises(NodeError) as ei:
        app.executor.run(g)
    assert ei.value.node_index in (0, 1)
    outs, errors = app.executor.run_eager(g)
    assert 2 in outs and 2 not in errors
    failed = min(errors)
    assert all(errors[i] == "eval error upstream"
               for i in errors if i != failed)


def test_run_stacked_equals_separate_runs(servers):
    app, _, _, _ = servers
    graphs = [_chain_request(app, seed=s)[0] for s in (3, 4, 5)]
    taps = _block_taps()
    stacked = app.executor.run_stacked(graphs, taps)
    for g, res in zip(graphs, stacked):
        single = app.executor.run(g, taps)
        assert res.keys() == single.keys()
        for i in res:
            for ch in res[i]:
                np.testing.assert_array_equal(res[i][ch], single[i][ch])
    other = _chain_request(app, seed=6, shape=(3, 32, 32))[0]
    with pytest.raises(ValueError):
        app.executor.run_stacked([graphs[0], other], taps)


def test_concurrent_requests_batch_and_match_single(servers):
    app, url, _, _ = servers
    before = app.metrics.snapshot()["counters"].get("batched_requests", 0)
    reqs = [_chain_request(app, seed=10 + i, taps=_block_taps())
            for i in range(4)]
    results = [None] * 4

    def worker(i):
        results[i] = Response.decode(_post(url + "/compute", reqs[i][1]))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for (g, _), res in zip(reqs, results):
        single = app.executor.run(g, _block_taps())
        for i in single:
            for ch in single[i]:
                np.testing.assert_allclose(res[i][ch], single[i][ch],
                                           atol=1e-6)
    after = app.metrics.snapshot()["counters"]["batched_requests"]
    assert after - before == 4


def test_registry_and_graph_endpoints(servers):
    app, url, japp, jurl = servers
    assert json.loads(_get(url + "/list_graphs")) == [NAME + ".json"]
    assert json.loads(_get(url + f"/load_graph/{NAME}.json")) == \
        app.graphs.load(NAME + ".json")
    for path in (f"/description/{NAME}:blocks.0", "/description/img_view",
                 f"/descriptions?names={NAME}:head,category,nope"):
        assert json.loads(_get(url + path)) == json.loads(_get(jurl + path))
    html = _get(url + f"/contents/{NAME}:blocks.1?attn_heads=[1]").decode()
    assert "attn_heads" in html and NAME in html
    assert b"<html>" in _get(url + "/") or b"<!DOCTYPE" in _get(url + "/")


@pytest.mark.parametrize("path", ["/load_graph/..%2F..%2Fpyproject.toml",
                                  "/description/nope"])
def test_bad_gets_are_400(servers, path):
    _, url, _, _ = servers
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(url + path)
    assert ei.value.code == 400


def test_frontend_assets_and_traversal_guard(tmp_path):
    front = tmp_path / "front"
    front.mkdir()
    (front / "index.html").write_text("<html>hi</html>")
    (tmp_path / "secret.txt").write_text("no")
    app = App(reg=Registry(), graphs_dir=str(tmp_path / "g"),
              frontend_dir=str(front), device="cpu")
    httpd = app.serve("127.0.0.1", 0, background=True)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert _get(url + "/") == b"<html>hi</html>"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(url + "/static/..%2Fsecret.txt")
        assert ei.value.code == 400
    finally:
        httpd.shutdown()
        app.close()


def test_build_app_never_writes_the_repo_graph_library(servers, tmp_path):
    """A variant with no saved graph: the default library (the repo's
    static/graphs) is left alone; an explicit one gets the chain graph."""
    from interactive_vit_tpu_torch.serving import server

    repo_lib = os.path.join(server._REPO_ROOT, "static", "graphs")
    before = sorted(os.listdir(repo_lib))
    app = server.build_app(models=[NAME], device="cpu")
    try:
        assert sorted(os.listdir(repo_lib)) == before
        assert NAME + ":head" in app.reg
    finally:
        app.close()
    app = server.build_app(models=[NAME], graphs_dir=str(tmp_path),
                           device="cpu")
    try:
        assert app.list_graphs() == [NAME + ".json"]
    finally:
        app.close()


def test_metrics_and_health(servers):
    _, url, _, _ = servers
    m = json.loads(_get(url + "/metrics"))
    assert m["counters"].get("compute_requests", 0) >= 1
    assert "request_p50_ms" in m and m["device"] == "cpu"
    h = json.loads(_get(url + "/health"))
    assert h["ok"] is True and h["device"] == "cpu"
