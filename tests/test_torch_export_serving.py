"""Serve-from-artifact in the port (``serving/export_app.py``, the server's
``--from-export`` / ``--export-selftest``), held against the JAX package's
``tests/test_export_serving.py``: one counterpart of each of its tests, on
the CPU.

Each request goes to the port's ``ExportApp`` and to the JAX package's,
serving artifacts exported from the same graph by each package: the same
status codes, the same ``node <i> (...)`` error texts the client parses,
and tensors within the f32 bound (1e-6 relative) of the JAX app's.
"""

import concurrent.futures
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from interactive_vit_tpu.graph.executor import Executor as JExecutor
from interactive_vit_tpu.graph.export import export_graph as jexport_graph
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.serving.export_app import (
    ExportApp as JExportApp, MultiExportApp as JMultiExportApp,
)
from interactive_vit_tpu.wire.schema import graph_from_json as jgraph_from_json
from interactive_vit_tpu_torch.graph.executor import Executor
from interactive_vit_tpu_torch.graph.export import export_graph
from interactive_vit_tpu_torch.graph.ir import Graph
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.serving.export_app import (
    ExportApp, MultiExportApp,
)
from interactive_vit_tpu_torch.wire.codec import (
    REQUEST_MAGIC, Response, encode_message,
)
from interactive_vit_tpu_torch.wire.schema import graph_from_json

F32_RTOL = 1e-6

SAVED = {
    "nodes": [
        {"instance": {"kind": "img_src"}, "pos": {"x": 0, "y": 0}},
        {"instance": {"kind": "net_node", "endpoint": "cos",
                      "params": {"A": "2.0", "b": "0.5"}},
         "pos": {"x": 200, "y": 0}},
        {"instance": {"kind": "slice",
                      "fixed": [{"dim": 0, "val": 1}],
                      "free": [{"in_dim": 1, "out_dim": 0}]},
         "pos": {"x": 400, "y": 0}},
        {"instance": {"kind": "img_view"}, "pos": {"x": 600, "y": 0}},
    ],
    "edges": [
        {"in_port": {"node": 0, "channel": "o"},
         "out_port": {"node": 1, "channel": "o"}},
        {"in_port": {"node": 1, "channel": "o"},
         "out_port": {"node": 2, "channel": "o"}},
        {"in_port": {"node": 2, "channel": "o"},
         "out_port": {"node": 3, "channel": "o"}},
    ],
}

NOISE_SAVED = {
    "nodes": [
        {"instance": {"kind": "noise", "dims": [2, 5, 5], "seed": 7},
         "pos": {"x": 0, "y": 0}},
        {"instance": {"kind": "multi_view"}, "pos": {"x": 200, "y": 0}},
    ],
    "edges": [
        {"in_port": {"node": 0, "channel": "o"},
         "out_port": {"node": 1, "channel": "o"}},
    ],
}


def _regs():
    reg, jreg = Registry(), JRegistry()
    register_builtin(reg)
    jbuiltin(jreg)
    return reg, jreg


def _export_pair(saved, shape, tmp_path_factory, name, provenance=None):
    """(port dir, JAX dir) of ``saved`` exported by both packages."""
    reg, jreg = _regs()
    d = str(tmp_path_factory.mktemp(name + "_port"))
    jd = str(tmp_path_factory.mktemp(name + "_jax"))
    g, jg = graph_from_json(saved), jgraph_from_json(saved)
    if shape is not None:
        g.add_input(np.zeros(shape, np.float32), g.nodes[0], "o")
        jg.add_input(np.zeros(shape, np.float32), jg.nodes[0], "o")
    export_graph(g, d, taps="primary", executor=Executor(reg, device="cpu"),
                 client_graph=saved, provenance=provenance)
    jexport_graph(jg, jd, taps="primary", executor=JExecutor(jreg),
                  client_graph=saved, provenance=provenance)
    return d, jd


def _serve(app):
    httpd = app.serve("127.0.0.1", 0, background=True)
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d, jd = _export_pair(SAVED, (2, 4), tmp_path_factory, "cos")
    app, japp = ExportApp(d, frontend_dir=None), JExportApp(
        jd, frontend_dir=None)
    (h1, base), (h2, jbase) = _serve(app), _serve(japp)
    yield app, base, jbase
    h1.shutdown()
    h2.shutdown()


@pytest.fixture(scope="module")
def multi_served(tmp_path_factory):
    """Two artifacts (the cos-slice workflow and a nullary noise demo)
    behind ONE server, in each package."""
    d1, jd1 = _export_pair(SAVED, (2, 4), tmp_path_factory, "mcos",
                           {"graph": "cos_slice.json"})
    d2, jd2 = _export_pair(NOISE_SAVED, None, tmp_path_factory, "mnoise",
                           {"graph": "noise_demo.json"})
    app = MultiExportApp([d1, d2], frontend_dir=None)
    japp = JMultiExportApp([jd1, jd2], frontend_dir=None)
    (h1, base), (h2, jbase) = _serve(app), _serve(japp)
    yield app, base, jbase
    h1.shutdown()
    h2.shutdown()


def _post(base, req_json, tensors):
    body = bytes(encode_message(REQUEST_MAGIC, req_json, tensors))
    r = urllib.request.Request(base + "/compute", data=body, method="POST")
    return Response.decode(urllib.request.urlopen(r).read())


def _both(base, jbase, req_json, tensors):
    """The port's and the JAX app's answers: decoded outputs, each checked
    against the other within the f32 bound, or (code, text) of an error,
    checked equal."""
    res = []
    for b in (base, jbase):
        try:
            res.append(_post(b, req_json, tensors))
        except urllib.error.HTTPError as e:
            res.append((e.code, e.read().decode()))
    got, want = res
    if isinstance(want, tuple):
        assert got == want
        return got
    assert sorted(got) == sorted(want)
    for i in want:
        for ch in want[i]:
            np.testing.assert_allclose(got[i][ch], want[i][ch],
                                       rtol=F32_RTOL, atol=1e-7)
    return got


def _get(base, path):
    return urllib.request.urlopen(base + path).read()


def client_request(a="2.0", fixed=None, taps=((0, "o"), (1, "o"))):
    """The request the browser ships for SAVED: sources / viewers
    stripped, a tensor ref on cos, the viewer edge as a tap."""
    return {
        "nodes": [
            {"endpoint": "cos", "params": {"A": a, "b": "0.5"}},
            {"endpoint": "slice", "params": {
                "fixed": json.dumps(fixed or [{"dim": 0, "val": 1}],
                                    separators=(",", ":")),
                "free": json.dumps([{"in_dim": 1, "out_dim": 0}],
                                   separators=(",", ":"))}},
        ],
        "edges": [
            {"out_port": {"node": 0, "channel": "o"}, "tensor": 0},
            {"out_port": {"node": 1, "channel": "o"},
             "in_port": {"node": 0, "channel": "o"}},
        ],
        "taps": [{"node": n, "channel": c} for n, c in taps],
    }


IMG = np.arange(8, dtype=np.float32).reshape(2, 4) / 8


def test_client_shape_computes(served):
    _, base, jbase = served
    outs = _both(base, jbase, client_request(), [IMG])
    np.testing.assert_allclose(outs[0]["o"], np.cos(2.0 * IMG + 0.5),
                               rtol=1e-6)
    np.testing.assert_allclose(outs[1]["o"], np.cos(2.0 * IMG + 0.5)[1, :],
                               rtol=1e-6)


def test_dynamic_param_edit_no_recompile(served):
    """An edit of cos A serves new values from the SAME loaded program (a
    per-call overlay), and leaves the artifact's captures as they were."""
    app, base, jbase = served
    module = app.art._module
    before = {k: v.clone() for k, v in app.art.caps["1"].items()}
    outs = _both(base, jbase, client_request(a="5.0"), [IMG])
    np.testing.assert_allclose(outs[0]["o"], np.cos(5.0 * IMG + 0.5),
                               rtol=1e-6)
    assert app.art._module is module
    for k, v in app.art.caps["1"].items():
        assert bool((v == before[k]).all())


def test_static_param_change_is_rejected(served):
    _, base, jbase = served
    code, msg = _both(base, jbase,
                      client_request(fixed=[{"dim": 0, "val": 0}]),
                      [np.zeros((2, 4), np.float32)])
    assert code == 400
    assert "static param" in msg and "node 1" in msg


def test_exported_shape_also_computes(served):
    _, base, jbase = served
    req = {
        "nodes": [
            {"endpoint": "img_src", "params": {}},
            {"endpoint": "cos", "params": {"A": "2.0", "b": "0.5"}},
            {"endpoint": "slice", "params": {
                "fixed": json.dumps([{"dim": 0, "val": 1}],
                                    separators=(",", ":")),
                "free": json.dumps([{"in_dim": 1, "out_dim": 0}],
                                   separators=(",", ":"))}},
            {"endpoint": "img_view", "params": {}},
        ],
        "edges": [
            {"out_port": {"node": 0, "channel": "o"}, "tensor": 0},
            {"out_port": {"node": 1, "channel": "o"},
             "in_port": {"node": 0, "channel": "o"}},
            {"out_port": {"node": 2, "channel": "o"},
             "in_port": {"node": 1, "channel": "o"}},
            {"out_port": {"node": 3, "channel": "o"},
             "in_port": {"node": 2, "channel": "o"}},
        ],
        "taps": [{"node": 1, "channel": "o"}],
    }
    outs = _both(base, jbase, req, [IMG])
    np.testing.assert_allclose(outs[1]["o"], np.cos(2.0 * IMG + 0.5),
                               rtol=1e-6)


def test_wrong_topology_rejected(served):
    _, base, jbase = served
    req = client_request()
    req["nodes"].append({"endpoint": "cos", "params": {}})
    code, msg = _both(base, jbase, req, [np.zeros((2, 4), np.float32)])
    assert code == 400 and "fixed program" in msg


def test_unexported_tap_rejected(served):
    _, base, jbase = served
    code, msg = _both(base, jbase, client_request(taps=((0, "nope"),)),
                      [np.zeros((2, 4), np.float32)])
    assert code == 400 and "not exported" in msg


def test_metadata_endpoints(served):
    _, base, jbase = served
    for path in ("/description/cos", "/list_graphs",
                 "/descriptions?names=cos,slice"):
        assert json.loads(_get(base, path)) == json.loads(_get(jbase, path))
    assert json.loads(_get(base, "/description/cos")) == {
        "ins": ["o"], "outs": ["o"]}
    html = _get(base, "/contents/cos").decode()
    assert "cos" in html and html == _get(jbase, "/contents/cos").decode()
    graphs = json.loads(_get(base, "/list_graphs"))
    assert graphs
    assert json.loads(_get(base, "/load_graph/" + graphs[0])) == SAVED
    h = json.loads(_get(base, "/health"))
    assert h["ok"] and h["mode"] == "from-export"


def test_parity_with_live_executor(served):
    """The artifact's /compute matches the live port executor on the same
    request (the deployment gate)."""
    _, base, jbase = served
    img = np.random.default_rng(3).random((2, 4)).astype(np.float32)
    outs = _both(base, jbase, client_request(a="3.25"), [img])
    reg, _ = _regs()
    g = Graph()
    n = g.add_node("cos", {"A": "3.25", "b": "0.5"})
    g.add_input(img, n, "o")
    live = Executor(reg, device="cpu").run(g, taps="all")
    np.testing.assert_allclose(outs[0]["o"], live[0]["o"], rtol=1e-6)


def test_concurrent_edits_do_not_race(served):
    """Concurrent requests with different A values each get their own
    answer (per-call overlays under the artifact's lock)."""
    _, base, _ = served

    def one(a):
        return _post(base, client_request(a=str(a)), [IMG])[0]["o"]

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        futs = {pool.submit(one, a): a for a in [1.0, 2.0, 3.0, 4.0] * 4}
        for f, a in futs.items():
            np.testing.assert_allclose(f.result(), np.cos(a * IMG + 0.5),
                                       rtol=1e-6)


def test_multi_artifact_routes_by_shape(multi_served):
    _, base, jbase = multi_served
    outs = _both(base, jbase, client_request(a="1.5"), [IMG])
    np.testing.assert_allclose(outs[0]["o"], np.cos(1.5 * IMG + 0.5),
                               rtol=1e-6)
    req = {"nodes": [{"endpoint": "noise",
                      "params": {"dims": "[2,5,5]", "seed": "7"}}],
           "edges": [], "taps": [{"node": 0, "channel": "o"}]}
    outs = _both(base, jbase, req, [])
    assert outs[0]["o"].shape == (2, 5, 5)
    assert np.isfinite(outs[0]["o"]).all()


def test_multi_artifact_metadata_union(multi_served):
    _, base, jbase = multi_served
    graphs = json.loads(_get(base, "/list_graphs"))
    assert graphs == json.loads(_get(jbase, "/list_graphs"))
    assert len(graphs) == 2
    for g in graphs:
        assert "nodes" in json.loads(_get(base, "/load_graph/" + g))
    for path in ("/description/noise", "/description/cos"):
        assert json.loads(_get(base, path)) == json.loads(_get(jbase, path))
    assert json.loads(_get(base, "/description/noise"))["outs"] == ["o"]
    h = json.loads(_get(base, "/health"))
    assert h["ok"] and len(h["artifacts"]) == 2


def test_multi_artifact_no_match_is_400(multi_served):
    _, base, jbase = multi_served
    req = {"nodes": [{"endpoint": "resize", "params": {}}],
           "edges": [{"out_port": {"node": 0, "channel": "o"},
                      "tensor": 0}],
           "taps": [{"node": 0, "channel": "o"}]}
    code, msg = _both(base, jbase, req, [np.zeros((3, 4, 4), np.float32)])
    assert code == 400 and "no artifact matches" in msg


def test_multi_artifact_same_names_different_shapes(tmp_path):
    """Routing is by FULL match, not by node names: the same workflow
    exported at two input shapes both stay reachable."""
    reg, _ = _regs()
    dirs = []
    for i, n in enumerate((4, 8)):
        g = Graph()
        node = g.add_node("cos", {"A": "2.0", "b": "0.0"})
        g.add_input(np.zeros((n,), np.float32), node, "o")
        d = str(tmp_path / f"a{i}")
        export_graph(g, d, taps="primary",
                     executor=Executor(reg, device="cpu"))
        dirs.append(d)
    app = MultiExportApp(dirs, frontend_dir=None)
    for n in (4, 8):
        x = np.linspace(0, 1, n, dtype=np.float32)
        req = {"nodes": [{"endpoint": "cos",
                          "params": {"A": "2.0", "b": "0.0"}}],
               "edges": [{"out_port": {"node": 0, "channel": "o"},
                          "tensor": 0}],
               "taps": [{"node": 0, "channel": "o"}]}
        body = bytes(encode_message(REQUEST_MAGIC, req, [x]))
        outs = Response.decode(app.compute(body))
        np.testing.assert_allclose(outs[0]["o"], np.cos(2.0 * x), rtol=1e-6)


def test_params_aware_contents(tmp_path):
    reg, _ = _regs()
    g = Graph()
    a = g.add_node("cos", {"A": "2.0", "b": "0.5"})
    bnode = g.add_node("cos", {"A": "7.0", "b": "0.25"})
    g.connect(a, "o", bnode, "o")
    g.add_input(np.zeros((4,), np.float32), a, "o")
    d = str(tmp_path / "art")
    export_graph(g, d, taps="primary", executor=Executor(reg, device="cpu"))
    app = ExportApp(d, frontend_dir=None)
    c1 = app.contents("cos", {"A": "2.0", "b": "0.5"})
    c2 = app.contents("cos", {"A": "7.0", "b": "0.25"})
    assert "2.0" in c1 and "7.0" in c2 and c1 != c2
    assert app.contents("cos", {"A": "99"}) == c1
    assert app.description("cos", None) == {"ins": ["o"], "outs": ["o"]}


def test_save_graph_rejected_read_only(served):
    _, base, jbase = served
    got = []
    for b in (base, jbase):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                b + "/save_graph/x.json", data=b"{}", method="POST"))
        got.append((ei.value.code, ei.value.read().decode()))
    assert got[0] == got[1]
    assert got[0][0] == 400 and "read-only" in got[0][1]


def test_preview_only_source_boots_identity_view(tmp_path):
    """A saved graph whose source feeds ONLY viewer nodes has no client
    view: the artifact still boots and serves the identity view."""
    reg, _ = _regs()
    saved = {
        "nodes": [
            {"instance": {"kind": "img_src"}, "pos": {"x": 0, "y": 0}},
            {"instance": {"kind": "img_view"}, "pos": {"x": 1, "y": 0}},
            {"instance": {"kind": "img_src"}, "pos": {"x": 0, "y": 1}},
            {"instance": {"kind": "net_node", "endpoint": "cos",
                          "params": {"A": "2.0", "b": "0.5"}},
             "pos": {"x": 1, "y": 1}},
            {"instance": {"kind": "img_view"}, "pos": {"x": 2, "y": 1}},
        ],
        "edges": [
            {"in_port": {"node": 0, "channel": "o"},
             "out_port": {"node": 1, "channel": "o"}},
            {"in_port": {"node": 2, "channel": "o"},
             "out_port": {"node": 3, "channel": "o"}},
            {"in_port": {"node": 3, "channel": "o"},
             "out_port": {"node": 4, "channel": "o"}},
        ],
    }
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32).reshape(2, 4)
    g = graph_from_json(saved)
    g.add_input(x, g.nodes[0], "o")
    g.add_input(x, g.nodes[2], "o")
    out_dir = str(tmp_path / "preview_artifact")
    export_graph(g, out_dir, taps="primary",
                 executor=Executor(reg, device="cpu"), client_graph=saved)
    app = ExportApp(out_dir, frontend_dir=None)  # must not raise
    assert len(app.views) == 1  # identity only
    req = {"nodes": [{"endpoint": "img_src"}, {"endpoint": "img_view"},
                     {"endpoint": "img_src"},
                     {"endpoint": "cos",
                      "params": {"A": "2.0", "b": "0.5"}},
                     {"endpoint": "img_view"}],
           "edges": [
               {"out_port": {"node": 0, "channel": "o"}, "tensor": 0},
               {"out_port": {"node": 2, "channel": "o"}, "tensor": 1},
               {"in_port": {"node": 0, "channel": "o"},
                "out_port": {"node": 1, "channel": "o"}},
               {"in_port": {"node": 2, "channel": "o"},
                "out_port": {"node": 3, "channel": "o"}},
               {"in_port": {"node": 3, "channel": "o"},
                "out_port": {"node": 4, "channel": "o"}}],
           "taps": [{"node": 3, "channel": "o"}]}
    raw = app.compute(bytes(encode_message(REQUEST_MAGIC, req, [x, x])))
    np.testing.assert_allclose(Response.decode(raw)[3]["o"],
                               np.cos(2.0 * x + 0.5), atol=1e-5)


def test_export_timing_header(served):
    _, base, _ = served
    body = bytes(encode_message(REQUEST_MAGIC, client_request(), [IMG]))
    r = urllib.request.urlopen(urllib.request.Request(
        base + "/compute", data=body, method="POST"), timeout=60)
    r.read()
    assert r.headers.get("X-IVT-Request-Id")
    parts = dict(kv.split("=") for kv in r.headers["X-IVT-Timing"].split(";"))
    assert {"decode", "compute", "encode", "wall"} <= set(parts)
    r2 = urllib.request.urlopen(base + "/metrics", timeout=30)
    r2.read()
    assert r2.headers.get("X-IVT-Timing") is None


def test_server_from_export_flags(served, tmp_path):
    """``--from-export`` / ``--export-selftest`` parse, the app boots with
    a passing selftest, and a corrupt artifact refuses to boot."""
    import shutil

    from interactive_vit_tpu_torch.serving.server import (
        build_export_app, make_parser,
    )

    app, _, _ = served
    args = make_parser().parse_args(["--from-export", app.artifact_dir,
                                     "--export-selftest"])
    assert args.from_export == app.artifact_dir and args.export_selftest
    ok = build_export_app([app.artifact_dir], selftest=True)
    assert isinstance(ok, ExportApp)
    bad = str(tmp_path / "bad")
    shutil.copytree(app.artifact_dir, bad)
    caps = os.path.join(bad, "captures.safetensors")
    raw = bytearray(open(caps, "rb").read())
    raw[-4:] = b"\x7f\x7f\x7f\x7f"
    open(caps, "wb").write(raw)
    with pytest.raises(SystemExit, match="failed selftest"):
        build_export_app([bad], selftest=True)
    both = build_export_app([app.artifact_dir, bad], selftest=False)
    assert isinstance(both, MultiExportApp)
