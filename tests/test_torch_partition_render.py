"""The port's ``wire/partition.py``, ``wire/render.py`` and ``config.py``
against the committed fixtures and the JAX package's modules.

``tests/fixtures/partition_fixtures.json`` and ``render_fixtures.json``
pin the client's partition rule and render math with hand-authored
expectations (``tests/test_partition_fixtures.py`` and
``tests/test_render_fixtures.py`` replay them through the JAX package's
copies); here the same files replay through the port's, the partitioned
requests are rebuilt byte for byte with the port's codec on both of its
tiers and served by the port's executor on the CPU.
"""

import base64
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from interactive_vit_tpu import config as jconfig
from interactive_vit_tpu.wire import partition as JP
from interactive_vit_tpu.wire import render as JR
from interactive_vit_tpu_torch import config
from interactive_vit_tpu_torch.graph.executor import Executor, NodeError
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.wire import codec
from interactive_vit_tpu_torch.wire import partition as P
from interactive_vit_tpu_torch.wire import render

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")

with open(os.path.join(FIXTURES, "partition_fixtures.json")) as f:
    PARTITION = json.load(f)
with open(os.path.join(FIXTURES, "render_fixtures.json")) as f:
    RENDER = json.load(f)["cases"]

ALL = sorted(PARTITION)


def _sources(fx):
    return {int(i): np.frombuffer(
        base64.b64decode(s["b64"]), "<f4").reshape(s["shape"])
        for i, s in fx["sources_b64"].items()}


def _wire_spec():
    sys.path.insert(0, FIXTURES)
    try:
        from make_node_fixtures import wire_spec
    finally:
        sys.path.pop(0)
    return wire_spec


def _request(instances, plan, sources):
    """The fixtures' ``build_request`` with the port's encoder."""
    wire_spec = _wire_spec()
    req_json = {"nodes": [wire_spec(instances[i]) for i in plan["req"]],
                "edges": plan["edges"], "taps": plan["taps"]}
    tensors = [sources[i] for i in plan["tensors"]]
    return req_json, bytes(codec.encode_message(
        codec.REQUEST_MAGIC, req_json, tensors, compact=True))


@pytest.fixture(params=["native", "python"])
def tier(request, monkeypatch):
    if request.param == "native":
        import shutil

        if shutil.which("g++") is None:
            pytest.skip("no g++ to build the host library")
        codec.native_tier()
    monkeypatch.setattr(codec, "_tier", request.param)
    return request.param


@pytest.mark.parametrize("name", ALL)
def test_partition_decision_matches_fixture_and_jax(name):
    fx = PARTITION[name]
    g = fx["graph"]
    ready, local, plan = P.partition(g["nodes"], g["edges"])
    assert ready == fx["expected_ready"]
    assert sorted(local) == fx["expected_local"]
    assert plan == fx["plan"]
    assert (ready, local, plan) == JP.partition(g["nodes"], g["edges"])


@pytest.mark.parametrize("name", ALL)
def test_request_bytes_match_fixture(name, tier):
    """The plan's request, encoded by the port on each tier, is the
    committed message byte for byte (the LocalFallback re-plan too)."""
    fx = PARTITION[name]
    srcs = _sources(fx)
    if "request_b64" in fx:
        req_json, raw = _request(fx["instances"], fx["plan"], srcs)
        assert req_json == fx["request_json"]
        assert raw == base64.b64decode(fx["request_b64"])
    if "fallback_request_b64" in fx:
        g = fx["graph"]
        fplan = P.plan_request(g["nodes"], g["edges"], fx["expected_ready"],
                               set())
        assert fplan == fx["fallback_plan"]
        req_json, raw = _request(fx["instances"], fplan, srcs)
        assert req_json == fx["fallback_request_json"]
        assert raw == base64.b64decode(fx["fallback_request_b64"])


@pytest.fixture(scope="module")
def ex():
    reg = Registry()
    register_builtin(reg)
    return Executor(reg, device="cpu")


@pytest.mark.parametrize("name", [n for n in ALL if PARTITION[n].get("eval")])
def test_port_serves_partitioned_request(ex, name, tier):
    """The pinned request bytes decode (on each tier) and run on the port's
    executor; the failing-server scenario names the wire index the client
    parses."""
    fx = PARTITION[name]
    req = codec.Request()
    req.decode(base64.b64decode(fx["request_b64"]))
    taps = req.taps if req.taps else "primary"
    if "expect_error_req_node" in fx:
        want = f"node {fx['expect_error_req_node']} "
        with pytest.raises(NodeError, match=want):
            ex.run(req.graph, taps=taps)
        return
    outs = ex.run(req.graph, taps=taps)
    for tap in fx["plan"]["taps"]:
        assert tap["channel"] in outs[tap["node"]]


def _u8(b):
    return np.frombuffer(base64.b64decode(b), np.uint8)


def _f32(b):
    return np.frombuffer(base64.b64decode(b), np.float32)


def _render_case(mod, c):
    """One fixture case through ``mod`` (the port's or JAX's render):
    a list of the u8 buffers (and dims) it produces, None where the
    function refuses."""
    fn = c["fn"]
    if fn == "normToU8":
        return [mod.norm_to_u8(_f32(c["data"]), c["lo"], c["hi"])]
    if fn == "tensorRGBA":
        return [mod.tensor_rgba(c["dims"], _f32(c["data"]))]
    if fn == "channelsRGBA":
        return [mod.channels_rgba([None if t is None else
                                   (t["dims"], _f32(t["data"]))
                                   for t in c["chans"]])]
    if fn == "overlayRGBA":
        return [mod.overlay_rgba(c["img"]["dims"], _f32(c["img"]["data"]),
                                 c["map"]["dims"], _f32(c["map"]["data"]),
                                 c["query"], c["alpha"])]
    m = mod.attn_maps(c["dims"], _f32(c["data"]))
    out = [m[0], mod.head_grid_cols(m[0][0])]
    for hi in range(len(c["expected"]["thumbs"])):
        out.append(mod.tensor_rgba(*mod.head_map(m[0], m[1], hi)))
    hm = mod.head_map(m[0], m[1], c["head"])
    out.append(mod.tensor_rgba(*hm))
    grid = mod.query_row_grid(hm[1], m[0][1], c["query"])
    out += [grid[0], mod.tensor_rgba(*grid)]
    return out


def _expected(c):
    exp = c["expected"]
    fn = c["fn"]
    if fn == "normToU8":
        return [_u8(exp)]
    if fn != "attnPipeline":
        return [None if exp is None else
                (exp["w"], exp["h"], _u8(exp["rgba"]))]
    return ([exp["maps_dims"], exp["grid_cols"]]
            + [(t["w"], t["h"], _u8(t["rgba"])) for t in exp["thumbs"]]
            + [(exp["full"]["w"], exp["full"]["h"], _u8(exp["full"]["rgba"])),
               exp["query_grid_dims"],
               (exp["query_grid"]["w"], exp["query_grid"]["h"],
                _u8(exp["query_grid"]["rgba"]))])


def _same(a, b):
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("case", [c["name"] for c in RENDER])
def test_render_fixture_replays_through_the_port(case):
    """Each committed render case, byte for byte through the port's
    render math, and the same as the JAX package's."""
    c = next(x for x in RENDER if x["name"] == case)
    got = _render_case(render, c)
    assert len(got) == len(_expected(c))
    for g, e in zip(got, _expected(c)):
        assert _same(g, e), case
    for g, j in zip(got, _render_case(JR, c)):
        assert _same(g, j), case


def test_render_hand_computed_semantics():
    """Independent probes of the port's render math (hand-computed, as in
    the JAX package's fixture test)."""
    np.testing.assert_array_equal(
        render.norm_to_u8(np.array([0, 1, 2, 4], np.float32)),
        [0, 64, 128, 255])
    np.testing.assert_array_equal(
        render.norm_to_u8(np.array([0.5, 1.5, 2.5], np.float32), 0.0,
                          255.0), [0, 2, 2])
    w, h, rgba = render.tensor_rgba([3, 1, 2], np.array(
        [0, 6, 1, 2, 3, 5], np.float32))
    assert (w, h) == (2, 1)
    np.testing.assert_array_equal(rgba, [0, 42, 128, 255, 255, 85, 212, 255])
    assert render.overlay_rgba([3, 2, 2], np.zeros(12, np.float32), [3, 3],
                               np.zeros(9, np.float32), 0, 0.5) is None


ENV = {"IVT_HOST": "0.0.0.0", "IVT_PORT": "9123", "IVT_MAX_BATCH": "4",
       "IVT_MAX_WAIT_MS": "1.5", "IVT_MODELS": "vit_b16,swin_t",
       "IVT_GRAPHS_DIR": "/srv/graphs", "IVT_COMPUTE_TIMEOUT_S": "30",
       "IVT_ATTN_IMPL": "flash", "IVT_USE_JIT": "no",
       "IVT_DEBUG_NANS": "TRUE", "IVT_NATIVE": "0",
       "IVT_LOG_LEVEL": "DEBUG", "IVT_PROFILER_PORT": "9012"}


@pytest.mark.parametrize("env", ["defaults", "overrides"])
def test_config_from_env_matches_jax(env, monkeypatch):
    """The same fields, defaults and ``IVT_<NAME>`` overrides (types
    cast, booleans from 1/true/yes) as the JAX package's ``Config``."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    if env == "overrides":
        for name, value in ENV.items():
            monkeypatch.setenv(name, value)
    assert ([f.name for f in dataclasses.fields(config.Config)]
            == [f.name for f in dataclasses.fields(jconfig.Config)])
    got = dataclasses.asdict(config.Config.from_env())
    assert got == dataclasses.asdict(jconfig.Config.from_env())
    if env == "overrides":
        assert got["port"] == 9123 and got["max_wait_ms"] == 1.5
        assert got["use_jit"] is False and got["debug_nans"] is True
        assert got["native"] is False
        assert got["graphs_dir"] == "/srv/graphs"
    else:
        assert got == dataclasses.asdict(config.Config())
