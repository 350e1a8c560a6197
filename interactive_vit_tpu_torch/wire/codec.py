"""Binary tensor wire protocol, byte-compatible with the JAX package.

Pure-Python port of ``interactive_vit_tpu/wire/codec.py`` (its native C++
block scanner is not ported yet); the bytes are identical, pinned by the
committed fixtures ``tests/fixtures/wire_*.bin``.

    header  : u32 byte_size | u32 magic | u32 block_cnt | u32 json_size
    json    : utf-8 bytes, padded with zero bytes to the next 4-byte boundary
    blocks  : per tensor: u32 block_size | u32 dim_cnt | u32 dims[dim_cnt]
              | f32 data[prod(dims)]

All integers and floats little-endian. Request magic ``0x69babe69``; response
magic ``0xdeadbeef``. Tensors are float32 on the wire, or bf16 bits when the
client negotiated ``resp_dtype``. Request JSON:
``{"nodes": [{"endpoint", "params"}...], "edges": [{"out_port": {node,
channel}, "in_port"|"tensor": ...}...]}``; response JSON: ``[{"node": i,
"channel": ch}, ...]`` aligned with the blocks. Tensors here are numpy
arrays; the executor hands over its outputs as f32 numpy.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Dict, List, Optional

import numpy as np

from interactive_vit_tpu_torch.graph.ir import Graph

REQUEST_MAGIC = 0x69BABE69
RESPONSE_MAGIC = 0xDEADBEEF
_HEADER = struct.Struct("<IIII")


class WireError(Exception):
    """Malformed wire message."""


def _align4(n: int) -> int:
    """Next multiple of 4 (``message.py:13-16``)."""
    return (n + 3) & ~3


def _bf16_payload(arr: np.ndarray) -> bytes:
    """f32 array -> bf16 bits (u16 LE), zero-padded to a 4-byte boundary.

    bf16 is the top half of f32, so the conversion is a round-to-nearest
    truncation; the pad keeps the next block's u32 header aligned."""
    f32 = np.ascontiguousarray(arr, dtype=np.float32)
    # round-to-nearest-even like hardware bf16 casts (plain >>16 truncates)
    bits = f32.view(np.uint32)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype("<u2")
    raw = rounded.tobytes()
    return raw + b"\x00" * (_align4(len(raw)) - len(raw))


def _bf16_to_f32(chunk: bytes, elem_cnt: int) -> np.ndarray:
    bits = np.frombuffer(chunk, dtype="<u2", count=elem_cnt)
    return (bits.astype(np.uint32) << 16).view(np.float32)


def encode_message(
    magic: int, json_obj, tensors: List[np.ndarray],
    dtypes: Optional[List[str]] = None,
    compact: bool = False,
) -> bytes:
    """Encode a JSON header + tensors into one wire message.

    ``dtypes`` (extension, default all-"f32"): per-tensor wire dtype. "bf16"
    halves a block's bytes; it is only emitted when the peer opted in via
    the request's ``resp_dtype`` field, and the response JSON tags each
    non-f32 entry with ``"dtype"`` so decoders stay self-describing. f32 is
    the reference-compatible default (``message.py:89-127``).

    ``compact=True`` emits the JSON with JS ``JSON.stringify`` separators
    (no spaces) — byte-identical to what ``frontend/js/wire.js:23``
    produces. Decoders on both sides accept either form; the per-node
    contract fixtures pin the client layout with this flag."""
    seps = (",", ":") if compact else None
    json_utf8 = json.dumps(json_obj, separators=seps).encode("utf-8")
    parts: List[bytes] = []
    offset = _HEADER.size + len(json_utf8)
    pad = _align4(offset) - offset
    parts.append(json_utf8)
    parts.append(b"\x00" * pad)

    block_bytes = 0
    for i, t in enumerate(tensors):
        dt = "f32" if dtypes is None else dtypes[i]
        arr = np.asarray(t)
        dims = np.asarray(arr.shape, dtype=np.uint32)
        if dt == "bf16":
            data = _bf16_payload(arr)
        elif dt == "f32":
            arr = np.ascontiguousarray(arr, dtype=np.float32)
            data = arr.tobytes()
        else:
            raise WireError(f"unsupported wire dtype {dt!r}")
        block_size = 8 + dims.nbytes + len(data)
        parts.append(struct.pack("<II", block_size, dims.size))
        parts.append(dims.tobytes())
        parts.append(data)
        block_bytes += block_size

    byte_size = _HEADER.size + len(json_utf8) + pad + block_bytes
    header = _HEADER.pack(byte_size, magic, len(tensors), len(json_utf8))
    return header + b"".join(parts)


def _block_dtypes(json_obj) -> Optional[List[str]]:
    """Per-block wire dtypes from a response-style JSON (a list of route
    entries, each optionally tagged ``"dtype"``). None = all f32 (the
    reference format and every request)."""
    if not isinstance(json_obj, list):
        return None
    tags = [
        e.get("dtype", "f32") if isinstance(e, dict) else "f32"
        for e in json_obj
    ]
    return tags if any(t != "f32" for t in tags) else None


def decode_message(b: bytes, expect_magic: Optional[int] = None):
    """Decode a wire message into (json_obj, [np.ndarray]).

    Non-f32 blocks (the negotiated ``dtype`` extension) are upcast to f32
    on decode — callers always see f32, exactly like the reference format.
    """
    if len(b) < _HEADER.size:
        raise WireError(f"message too short: {len(b)} bytes")
    byte_size, magic, block_cnt, json_size = _HEADER.unpack_from(b, 0)
    if expect_magic is not None and magic != expect_magic:
        raise WireError(f"bad magic: 0x{magic:08x} (expected 0x{expect_magic:08x})")
    if byte_size > len(b):
        raise WireError(f"truncated message: header says {byte_size}, got {len(b)}")

    off = _HEADER.size
    if off + json_size > len(b):
        raise WireError(
            f"json extent out of range: {json_size} bytes at {off}, "
            f"message is {len(b)}"
        )
    try:
        json_obj = json.loads(b[off : off + json_size].decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as err:
        raise WireError(f"bad message json: {err}") from err
    off = _align4(off + json_size)

    dtypes = _block_dtypes(json_obj)
    tensors: List[np.ndarray] = []
    for i in range(block_cnt):
        # bounds-check each extent before reading so a truncated block table
        # raises WireError, matching the JAX package native scanner's -3 ("truncated
        # message") instead of leaking struct.error / ValueError
        start = off
        if off + 8 > len(b):
            raise WireError(f"truncated message: block {i} header at {off}")
        block_size, dim_cnt = struct.unpack_from("<II", b, off)
        off += 8
        if off + 4 * dim_cnt > len(b):
            raise WireError(f"truncated message: block {i} dims at {off}")
        dims = np.frombuffer(b, dtype="<u4", count=dim_cnt, offset=off)
        off += 4 * dim_cnt
        # exact product in Python ints: np.prod over u32 wraps mod 2^64,
        # so a crafted dims list (e.g. 65536^4) could pass the extent
        # check with a forged block_size and leak a reshape ValueError
        # instead of WireError (the JAX package native scanner guards this as -4)
        elem_cnt = math.prod(int(d) for d in dims) if dim_cnt > 0 else 1
        if elem_cnt > len(b):
            raise WireError(
                f"bad block {i}: {elem_cnt} elements exceeds message size")
        dt = "f32" if dtypes is None or i >= len(dtypes) else dtypes[i]
        data_bytes = (
            _align4(2 * elem_cnt) if dt == "bf16" else 4 * elem_cnt
        )
        if off + data_bytes > len(b):
            raise WireError(f"truncated message: block {i} data at {off}")
        if dt == "bf16":
            data = _bf16_to_f32(b[off : off + data_bytes], elem_cnt)
        elif dt == "f32":
            data = np.frombuffer(b, dtype="<f4", count=elem_cnt, offset=off)
        else:
            raise WireError(f"block {i}: unsupported wire dtype {dt!r}")
        off += data_bytes
        if start + block_size != off:
            raise WireError(
                f"tensor block {i}: size mismatch "
                f"(declared {block_size}, consumed {off - start})"
            )
        tensors.append(data.reshape(tuple(int(d) for d in dims)))
    return json_obj, tensors


# -- request / response objects (server side) ------------------------------------


class Request:
    """A decoded ``/compute`` request: a Graph with input tensors attached.

    Parity with ``message.py:18-73``, plus a compatible extension: the
    request JSON may carry ``"taps": [{"node": i, "channel": ch}, ...]`` —
    an explicit tap set (the interactive fast path: only what the UI renders
    is computed and shipped). Absent -> the server's default policy.
    """

    def __init__(self) -> None:
        self.graph = Graph()
        self.taps = None  # None | list[(node_index, channel)]
        self.resp_dtype = "f32"  # negotiated response block dtype

    def decode(self, b: bytes) -> None:
        json_obj, tensors = decode_message(b, expect_magic=REQUEST_MAGIC)
        if "taps" in json_obj:
            self.taps = [
                (int(t["node"]), str(t["channel"])) for t in json_obj["taps"]
            ]
        # opt-in extension: the client asks for halved response bytes;
        # absent -> f32, the reference-compatible default
        self.resp_dtype = str(json_obj.get("resp_dtype", "f32"))
        if self.resp_dtype not in ("f32", "bf16"):
            raise WireError(f"unsupported resp_dtype {self.resp_dtype!r}")

        for node_json in json_obj["nodes"]:
            self.graph.add_node(node_json["endpoint"], node_json.get("params", {}))

        for edge_json in json_obj["edges"]:
            tgt = self.graph.nodes[edge_json["out_port"]["node"]]
            tgt_ch = edge_json["out_port"]["channel"]
            if "tensor" in edge_json:
                self.graph.add_input(tensors[edge_json["tensor"]], tgt, tgt_ch)
            else:
                src = self.graph.nodes[edge_json["in_port"]["node"]]
                src_ch = edge_json["in_port"]["channel"]
                self.graph.connect(src, src_ch, tgt, tgt_ch)

    @staticmethod
    def encode(graph: Graph) -> bytes:
        """Encode a graph (with input tensors) into request bytes.

        The reference only had the *client* encode requests
        (``net_node.js:81-197``); having it server-side too gives us
        round-trip tests and a synthetic-client load generator.
        """
        nodes_json = [{"endpoint": n.name, "params": n.params} for n in graph.nodes]
        edges_json: List[Dict] = []
        tensors: List[np.ndarray] = []
        for n in graph.nodes:
            for ch, e in n.inputs.items():
                if e.src is None:
                    edges_json.append(
                        {
                            "out_port": {"node": n.index, "channel": ch},
                            "tensor": len(tensors),
                        }
                    )
                    tensors.append(np.asarray(e.tensor))
                else:
                    edges_json.append(
                        {
                            "out_port": {"node": n.index, "channel": ch},
                            "in_port": {
                                "node": e.src.node.index,
                                "channel": e.src.channel,
                            },
                        }
                    )
        obj = {"nodes": nodes_json, "edges": edges_json}
        return encode_message(REQUEST_MAGIC, obj, tensors)


class Response:
    """Node outputs -> response bytes. Parity with ``message.py:76-127``.

    Unlike the reference (which harvested every node's pinout eagerly,
    ``message.py:80-83``), this is constructed from the executor's tap
    results directly — the executor decides what was computed.
    """

    def __init__(self, outputs: Dict[int, Dict[str, np.ndarray]]):
        self.outputs = outputs

    def encode(self, dtype: str = "f32") -> bytes:
        """``dtype="bf16"``: the negotiated extension — every block ships
        as bf16 bits (half the bytes; taps are viewer data where bf16's
        ~3 decimal digits are invisible), each entry tagged ``"dtype"``
        so decoders stay self-describing. Default f32 = reference format."""
        json_obj = []
        tensors: List[np.ndarray] = []
        for node in self.outputs:
            for channel, t in self.outputs[node].items():
                entry = {"node": node, "channel": channel}
                if dtype != "f32":
                    entry["dtype"] = dtype
                json_obj.append(entry)
                tensors.append(np.asarray(t))
        dtypes = None if dtype == "f32" else [dtype] * len(tensors)
        return encode_message(RESPONSE_MAGIC, json_obj, tensors,
                              dtypes=dtypes)

    @staticmethod
    def decode(b: bytes) -> Dict[int, Dict[str, np.ndarray]]:
        json_obj, tensors = decode_message(b, expect_magic=RESPONSE_MAGIC)
        out: Dict[int, Dict[str, np.ndarray]] = {}
        for meta, t in zip(json_obj, tensors):
            out.setdefault(meta["node"], {})[meta["channel"]] = t
        return out
