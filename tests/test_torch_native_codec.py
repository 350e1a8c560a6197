"""The host library (``runtime/build.py``, ``runtime/native.py``) and the
wire codec's two tiers against each other and the JAX package's codec.

The native tier's ``pack`` and ``scan`` must give the Python tier's bytes
and tensors, decode the committed ``tests/fixtures/wire_*.bin`` and raise
the same ``WireError`` on malformed messages; the library builds at first
use into ``build/torch_native/`` under a name keyed by its sources, flags
and CPU model, and a build that fails raises, naming ``IVT_NATIVE=0``.
"""

import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest

from interactive_vit_tpu.wire import codec as jcodec
from interactive_vit_tpu_torch.runtime import build, native
from interactive_vit_tpu_torch.wire import codec
from interactive_vit_tpu_torch.wire.codec import (
    REQUEST_MAGIC, RESPONSE_MAGIC, Request, Response, WireError,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build the host library")
TIERS = [pytest.param("native", marks=needs_gxx), "python"]


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.fixture
def tier(request, monkeypatch):
    """Run the codec on ``request.param``'s tier."""
    if request.param == "native":
        native.get_lib()
    monkeypatch.setattr(codec, "_tier", request.param)
    return request.param


def _tensors(seed):
    """Tensors of every awkward kind: 0-d, empty, strided, f64, big."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((3, 4)).astype(np.float32),
            np.float32(2.5),
            np.zeros((0, 5), np.float32),
            rng.standard_normal((4, 6, 6))[:, ::2, 1::2],
            rng.standard_normal((2, 197, 197)).astype(np.float32).T,
            np.arange(7, dtype=np.int64)]


@needs_gxx
def test_native_tier_is_the_default_and_builds_keyed():
    assert codec.native_tier() == "native"
    path = build.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "build",
                                                 "torch_native")
    assert os.path.exists(path)
    assert native.get_lib()._name == path


def test_library_name_keys_the_cpu_model_and_flags(monkeypatch):
    """Another CPU model (-march=native) or another flag set never loads
    this machine's library."""
    here = build.library_path()
    monkeypatch.setattr(build, "cpu_model", lambda: "another CPU")
    assert build.library_path() != here
    monkeypatch.undo()
    monkeypatch.setattr(build, "FLAGS", build.FLAGS + ("-g",))
    assert build.library_path() != here


def test_import_builds_nothing():
    """Importing the codec and the loader picks no tier and builds
    nothing: the tier is chosen at first use."""
    check = ("import interactive_vit_tpu_torch.wire.codec as c, "
             "interactive_vit_tpu_torch.data.loader, "
             "interactive_vit_tpu_torch.runtime.native as n; "
             "print(c._tier, n._lib)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", check], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["None", "None"]


def test_failed_build_raises_naming_the_python_tier(monkeypatch, tmp_path):
    """No quiet fallback: a library that cannot be built raises with the
    compiler's message and the way to ask for the Python tier; the codec's
    tier resolution raises too."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "FLAGS", build.FLAGS + ("-fno-such-flag",))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(codec, "_tier", None)
    monkeypatch.delenv("IVT_NATIVE", raising=False)
    for fn in (native.get_lib, codec.native_tier):
        with pytest.raises(RuntimeError, match="IVT_NATIVE=0") as exc:
            fn()
        assert "no-such-flag" in str(exc.value)
    assert os.listdir(tmp_path) == []  # no half-written library left


def test_ivt_native_0_asks_for_the_python_tier(monkeypatch):
    monkeypatch.setattr(codec, "_tier", None)
    monkeypatch.setenv("IVT_NATIVE", "0")
    assert codec.native_tier() == "python"


@pytest.mark.parametrize("tier", TIERS, indirect=True)
@pytest.mark.parametrize("name", ["wire_request.bin", "wire_response.bin",
                                  "wire_response_bf16.bin"])
def test_fixtures_decode_and_reencode(tier, name):
    raw = _read(name)
    magic = REQUEST_MAGIC if "request" in name else RESPONSE_MAGIC
    obj, tensors = codec.decode_message(raw, expect_magic=magic)
    jobj, jtensors = jcodec.decode_message(raw, expect_magic=magic)
    assert obj == jobj
    for a, b in zip(tensors, jtensors):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    if "bf16" not in name:
        assert bytes(codec.encode_message(magic, obj, tensors)) == raw


@pytest.mark.parametrize("tier", TIERS, indirect=True)
@pytest.mark.parametrize("seed", range(3))
def test_pack_equals_python_and_jax_bytes(tier, seed, monkeypatch):
    ts = _tensors(seed)
    obj = [{"node": i, "channel": "o"} for i in range(len(ts))]
    got = codec.encode_message(RESPONSE_MAGIC, obj, ts)
    monkeypatch.setattr(codec, "_tier", "python")
    want = codec.encode_message(RESPONSE_MAGIC, obj, ts)
    assert bytes(got) == want
    assert want == bytes(jcodec.encode_message(RESPONSE_MAGIC, obj, ts))
    # and back, on the tier under test
    monkeypatch.setattr(codec, "_tier", tier)
    _, back = codec.decode_message(got, expect_magic=RESPONSE_MAGIC)
    for a, b in zip(back, ts):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


@needs_gxx
@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview"])
def test_scan_takes_any_buffer(kind):
    raw = _read("wire_request.bin")
    buf = {"bytes": raw, "bytearray": bytearray(raw),
           "memoryview": memoryview(raw)}[kind]
    (json_off, json_size), blocks = native.scan(buf, REQUEST_MAGIC)
    assert json_off == 16 and len(blocks) == 2
    assert [(b[1], b[3]) for b in blocks] == [(2, 12), (1, 1)]


@pytest.mark.parametrize("tier", TIERS, indirect=True)
def test_bf16_responses_stay_on_the_python_encoder(tier, monkeypatch):
    """A negotiated bf16 response is Python's on either tier; native.pack
    is never called for it."""
    calls = []
    monkeypatch.setattr(native, "pack", lambda *a: calls.append(a))
    outs = {0: {"o": np.float32([1.0, 2.5, -3.25])},
            1: {"attn": np.linspace(0, 1, 5, dtype=np.float32)}}
    assert Response(outs).encode("bf16") == _read("wire_response_bf16.bin")
    assert calls == []


def _good() -> bytes:
    return _read("wire_request.bin")


GARBAGE = {
    "empty": b"",
    "short": b"\x00" * 7,
    "bad_magic": struct.pack("<IIII", 16, 0x12345678, 0, 0),
    "truncated": _good()[:-4],
    "size_beyond_end": struct.pack("<IIII", 999, REQUEST_MAGIC, 0, 0),
    "json_beyond_end": struct.pack("<IIII", 16, REQUEST_MAGIC, 0, 40),
    "bad_json": struct.pack("<IIII", 20, REQUEST_MAGIC, 0, 4) + b"{{{{",
    "huge_dims": (lambda body: struct.pack("<IIII", 16 + len(body),
                                           REQUEST_MAGIC, 1, 2) + b"{}\0\0"
                  + body)(struct.pack("<II", 8 + 16, 4)
                          + struct.pack("<4I", *[65536] * 4)),
    "wrapping_dims": (lambda body: struct.pack("<IIII", 16 + len(body),
                                               REQUEST_MAGIC, 1, 2)
                      + b"{}\0\0" + body)(
        struct.pack("<II", 16, 2)
        + struct.pack("<2I", 0x80000002, 0x7FFFFFFE)),
    # one block of 2 floats (20 bytes) declaring 24
    "block_size_mismatch": struct.pack("<IIII", 40, REQUEST_MAGIC, 1, 2)
    + b"{}\0\0" + struct.pack("<III2f", 24, 1, 2, 1.0, 2.0),
    "too_many_blocks": struct.pack("<IIII", 20, REQUEST_MAGIC, 70000, 2)
    + b"{}\0\0",
}


@pytest.mark.parametrize("tier", TIERS, indirect=True)
@pytest.mark.parametrize("name", sorted(GARBAGE))
def test_malformed_messages_raise_wire_error(tier, name):
    """The same error class on both tiers and in the JAX codec."""
    raw = GARBAGE[name]
    with pytest.raises(WireError):
        codec.decode_message(raw, expect_magic=REQUEST_MAGIC)
    with pytest.raises(jcodec.WireError):
        jcodec.decode_message(raw, expect_magic=REQUEST_MAGIC)


@pytest.mark.parametrize("tier", TIERS, indirect=True)
def test_request_roundtrip_through_the_server_objects(tier):
    from interactive_vit_tpu_torch.graph.ir import Graph

    g = Graph()
    a = g.add_node("vit_t16:embed", {"x": "1"})
    b = g.add_node("vit_t16:blocks.0", {"attn_heads": "[0]"})
    g.connect(a, "o", b, "o")
    img = np.random.default_rng(0).random((3, 8, 8), dtype=np.float32)
    g.add_input(img, a, "o")
    raw = Request.encode(g)
    assert bytes(raw) == jcodec.Request.encode(g)
    req = Request()
    req.decode(raw)
    np.testing.assert_array_equal(req.graph.nodes[0].inputs["o"].tensor, img)
    outs = {0: {"o": img}, 1: {"attn": img[:1]}}
    back = Response.decode(Response(outs).encode())
    np.testing.assert_array_equal(back[1]["attn"], img[:1])
