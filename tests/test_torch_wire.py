"""The port's wire codec and graph schema against the committed fixtures
and the JAX package's codec.

The wire fixtures are the byte-exact contract shared with the frontend
(``tests/fixtures/make_wire_fixtures.py``); the port rebuilds the same
messages with its own ``Graph``/``Request``/``Response`` and must produce
the same bytes.
"""

import json
import os
import struct

import numpy as np
import pytest

from interactive_vit_tpu.wire import codec as jcodec
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph.ir import Graph, GraphError
from interactive_vit_tpu_torch.wire import codec, schema
from interactive_vit_tpu_torch.wire.codec import (
    REQUEST_MAGIC, RESPONSE_MAGIC, Request, Response, WireError,
    decode_message, encode_message,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _fixture_request() -> bytes:
    g = Graph()
    a = g.add_node("cos", {"A": "2.0", "b": "0.5"})
    b = g.add_node("binop", {"op": "+"})
    g.connect(a, "o", b, "a")
    g.add_input(np.arange(12, dtype=np.float32).reshape(3, 4), a, "o")
    g.add_input(np.float32([7.0]), b, "b")
    obj, tensors = decode_message(Request.encode(g), expect_magic=REQUEST_MAGIC)
    obj["taps"] = [{"node": 1, "channel": "c"}]
    return encode_message(REQUEST_MAGIC, obj, tensors)


def _fixture_response() -> bytes:
    return Response({
        0: {"o": np.cos(2.0 * np.arange(12, dtype=np.float32) + 0.5)
            .reshape(3, 4)},
        1: {"c": np.float32([1.5, -2.25]),
            "attn": np.linspace(0, 1, 8, dtype=np.float32).reshape(2, 2, 2)},
    }).encode()


def _fixture_response_bf16() -> bytes:
    return Response({
        0: {"o": np.float32([1.0, 2.5, -3.25])},
        1: {"attn": np.linspace(0, 1, 5, dtype=np.float32)},
    }).encode(dtype="bf16")


@pytest.mark.parametrize("name,build", [
    ("wire_request.bin", _fixture_request),
    ("wire_response.bin", _fixture_response),
    ("wire_response_bf16.bin", _fixture_response_bf16),
])
def test_fixture_bytes_reproduced(name, build):
    assert build() == _read(name)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_response_bytes_equal_jax_codec(seed, dtype):
    rng = np.random.default_rng(seed)
    outs = {i: {ch: rng.standard_normal(
                tuple(rng.integers(1, 5, size=rng.integers(0, 4))))
                .astype(np.float32)
                for ch in ("o", "attn")[: 1 + i % 2]}
            for i in range(1 + seed)}
    assert Response(outs).encode(dtype) == jcodec.Response(outs).encode(dtype)


def test_request_roundtrip():
    g = Graph()
    a = g.add_node("vit_t16:embed", {"x": "1"})
    b = g.add_node("vit_t16:blocks.0", {"attn_heads": "[0]"})
    g.connect(a, "o", b, "o")
    img = np.random.default_rng(0).random((3, 8, 8), dtype=np.float32)
    g.add_input(img, a, "o")
    raw = Request.encode(g)
    assert raw == jcodec.Request.encode(g)
    req = Request()
    req.decode(raw)
    assert [(n.name, n.params) for n in req.graph.nodes] == \
        [(n.name, n.params) for n in g.nodes]
    assert req.taps is None and req.resp_dtype == "f32"
    np.testing.assert_array_equal(req.graph.nodes[0].inputs["o"].tensor, img)
    assert req.graph.nodes[1].inputs["o"].src.node.index == 0


def test_response_roundtrip_and_bf16_decode():
    outs = {3: {"o": np.arange(6, dtype=np.float32).reshape(2, 3)},
            7: {"attn": np.float32([0.25, 0.5, 1.0])}}
    back = Response.decode(Response(outs).encode())
    for i in outs:
        for ch in outs[i]:
            np.testing.assert_array_equal(back[i][ch], outs[i][ch])
    back16 = Response.decode(Response(outs).encode("bf16"))
    np.testing.assert_array_equal(back16[7]["attn"], outs[7]["attn"])


def test_fixture_request_decodes():
    req = Request()
    req.decode(_read("wire_request.bin"))
    assert [n.name for n in req.graph.nodes] == ["cos", "binop"]
    assert req.taps == [(1, "c")]
    np.testing.assert_array_equal(req.graph.nodes[0].inputs["o"].tensor,
                                  np.arange(12, dtype=np.float32).reshape(3, 4))


def _good() -> bytes:
    return _read("wire_request.bin")


@pytest.mark.parametrize("garbage", [
    b"",
    b"\x00" * 7,
    b"garbage!" * 4,
    struct.pack("<IIII", 16, 0x12345678, 0, 0),            # bad magic
    _good()[:-4],                                          # truncated
    struct.pack("<IIII", 999, REQUEST_MAGIC, 0, 0),        # size beyond end
    struct.pack("<IIII", 20, REQUEST_MAGIC, 0, 4) + b"{{{{",  # bad json
    # one block claiming 65536^4 elements
    (lambda body: struct.pack("<IIII", 16 + len(body), REQUEST_MAGIC, 1, 0)
     + body)(struct.pack("<II", 8 + 16, 4) + struct.pack("<4I", *[65536] * 4)),
])
def test_garbage_raises_wire_error(garbage):
    with pytest.raises(WireError):
        Request().decode(garbage)


def test_response_magic_checked():
    with pytest.raises(WireError):
        Response.decode(_good())
    with pytest.raises(WireError):
        decode_message(_fixture_response(), expect_magic=REQUEST_MAGIC)
    assert RESPONSE_MAGIC == jcodec.RESPONSE_MAGIC
    assert REQUEST_MAGIC == jcodec.REQUEST_MAGIC


def test_unsupported_resp_dtype():
    obj, tensors = decode_message(_good(), expect_magic=REQUEST_MAGIC)
    obj["resp_dtype"] = "f16"
    with pytest.raises(WireError):
        Request().decode(encode_message(REQUEST_MAGIC, obj, tensors))
    with pytest.raises(WireError):
        codec.encode_message(RESPONSE_MAGIC, [], [np.zeros(2)], dtypes=["f8"])


@pytest.mark.parametrize("name", ["vit_t16.json", "vit_b16.json"])
def test_saved_graph_matches_jax_schema(name):
    with open(os.path.join(ROOT, "static", "graphs", name)) as f:
        obj = json.load(f)
    g = schema.graph_from_json(obj)
    jg = jschema.graph_from_json(obj)
    assert [(n.name, n.params) for n in g.nodes] == \
        [(n.name, n.params) for n in jg.nodes]
    assert g.signature() == jg.signature()
    assert [n.index for n in g.order()] == [n.index for n in jg.order()]


def test_generated_chain_json_matches_jax():
    names = [f"m:{i}" for i in range(7)]
    assert schema.generate_model_graph_json(names) == \
        jschema.generate_model_graph_json(names)


def test_graph_library(tmp_path):
    lib = schema.GraphLibrary(str(tmp_path))
    lib.save("a.json", {"nodes": [], "edges": []})
    assert lib.list() == ["a.json"] and lib.exists("a.json")
    assert json.loads(lib.load_bytes("a.json")) == {"nodes": [], "edges": []}
    with pytest.raises(ValueError):
        lib.load("../escape.json")
    assert not lib.exists("../escape.json")


def test_bad_edge_index_is_graph_error():
    obj = {"nodes": [{"instance": {"kind": "img_src"}}],
           "edges": [{"in_port": {"node": -1, "channel": "o"},
                      "out_port": {"node": 0, "channel": "o"}}]}
    with pytest.raises(GraphError):
        schema.graph_from_json(obj)


def test_cycle_is_graph_error():
    g = Graph()
    a, b = g.add_node("x"), g.add_node("y")
    g.connect(a, "o", b, "o")
    g.connect(b, "o", a, "o")
    with pytest.raises(GraphError):
        g.order()
