"""The port's safetensors reader/writer (``utils/safetensors_io.py``)
against the JAX package's copy: the committed fixtures read bit for bit
alike, a file either package writes reads back bit for bit in the other
(F32, BF16, I8, I64), and malformed files raise ``SafetensorsError``."""

import json
import os
import struct

import numpy as np
import pytest

import jax.numpy as jnp

from interactive_vit_tpu.utils import safetensors_io as jst
from interactive_vit_tpu_torch.utils import safetensors_io as tst

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _write(path, header_obj, buf=b""):
    hdr = json.dumps(header_obj).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)) + hdr + buf)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["vit_golden_tv.safetensors",
                                  "vit_golden_timm.safetensors"])
def test_fixtures_read_as_jax_reads_them(name):
    path = os.path.join(FIXTURES, name)
    got, want = tst.load_file(path), jst.load_file(path)
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k])


def _tensors():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "f32": f32,
        "bf16": np.asarray(jnp.asarray(f32, jnp.bfloat16)),
        "i8": rng.integers(-128, 128, size=(7,)).astype(np.int8),
        "i64": np.array([-(2 ** 40), 0, 2 ** 50], dtype=np.int64),
        "scalar": np.asarray(np.int64(9)),
    }


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_files_cross_read(tmp_path, writer, reader):
    """BF16 reads as its exact f32 upcast in both packages; the other
    dtypes as written. The two writers produce the same bytes."""
    mods = {"port": tst, "jax": jst}
    tensors = _tensors()
    path = str(tmp_path / "t.safetensors")
    mods[writer].save_file(tensors, path, metadata={"format": "pt"})
    back = mods[reader].load_file(path)
    assert list(back) == list(tensors)
    for k, v in tensors.items():
        want = np.asarray(v, np.float32) if k == "bf16" else v
        _same(back[k], want)
    with open(path, "rb") as f:
        raw = f.read()
    other = str(tmp_path / "u.safetensors")
    mods["jax" if writer == "port" else "port"].save_file(
        tensors, other, metadata={"format": "pt"})
    with open(other, "rb") as f:
        assert f.read() == raw


def test_every_dtype_round_trips(tmp_path):
    p = str(tmp_path / "t.safetensors")
    tensors = {
        "f64": np.arange(3, dtype=np.float64),
        "f16": np.arange(3, dtype=np.float16),
        "i32": np.arange(3, dtype=np.int32),
        "i16": np.arange(3, dtype=np.int16),
        "u32": np.arange(3, dtype=np.uint32),
        "u16": np.arange(3, dtype=np.uint16),
        "u64": np.arange(2, dtype=np.uint64),
        "u8": np.arange(4, dtype=np.uint8),
        "bool": np.array([True, False]),
    }
    tst.save_file(tensors, p)
    back = tst.load_file(p)
    for k, v in tensors.items():
        _same(back[k], v)


def test_unsupported_dtype_refused_on_write(tmp_path):
    with pytest.raises(tst.SafetensorsError):
        tst.save_file({"c": np.zeros(2, np.complex64)},
                      str(tmp_path / "c.safetensors"))


@pytest.mark.parametrize("case", [
    "short", "header_past_end", "bad_json", "negative_offsets",
    "not_multiple", "missing_key", "negative_dims", "not_a_dict",
    "unknown_dtype", "past_buffer"])
def test_malformed_files_raise(tmp_path, case):
    """Each malformed file raises ``SafetensorsError`` in the port, as in
    the JAX package."""
    p = str(tmp_path / "bad.safetensors")
    metas = {
        "negative_offsets": ({"dtype": "F32", "shape": [2],
                              "data_offsets": [-8, 0]}, 8),
        "not_multiple": ({"dtype": "F32", "shape": [2],
                          "data_offsets": [0, 3]}, 32),
        "missing_key": ({"dtype": "F32", "shape": [2]}, 32),
        "negative_dims": ({"dtype": "F32", "shape": [-2, -3],
                           "data_offsets": [0, 24]}, 32),
        "not_a_dict": ("not-a-dict", 32),
        "unknown_dtype": ({"dtype": "Q4", "shape": [2],
                           "data_offsets": [0, 8]}, 8),
        "past_buffer": ({"dtype": "F32", "shape": [4],
                         "data_offsets": [0, 16]}, 8),
    }
    if case == "short":
        with open(p, "wb") as f:
            f.write(b"\x01\x02")
    elif case == "header_past_end":
        with open(p, "wb") as f:
            f.write(struct.pack("<Q", 1000) + b"{}")
    elif case == "bad_json":
        with open(p, "wb") as f:
            f.write(struct.pack("<Q", 5) + b"{nope")
    else:
        meta, n = metas[case]
        _write(p, {"x": meta}, b"\x00" * n)
    for mod in (tst, jst):
        with pytest.raises(mod.SafetensorsError):
            mod.load_file(p)


def test_bf16_torch_tree_writes_the_jax_writers_file(tmp_path):
    """A ``torch.bfloat16`` tree flattened with ``keep_bf16`` is written
    with BF16 tags and its raw bits: the same header dtypes and tensor
    bytes as the JAX writer's file for the same values."""
    import torch

    from interactive_vit_tpu.models.weights import (
        to_native_flat as jto_native_flat,
    )
    from interactive_vit_tpu_torch.models.weights import to_native_flat

    rng = np.random.default_rng(3)
    vals = {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "b": rng.standard_normal((6,)).astype(np.float32),
            "s": np.float32(0.1)}
    ttree = {"blocks": [{k: torch.tensor(v).to(torch.bfloat16)
                         for k, v in vals.items()}],
             "step": torch.tensor(3, dtype=torch.int32)}
    jtree = {"blocks": [{k: jnp.asarray(v, jnp.bfloat16)
                         for k, v in vals.items()}],
             "step": jnp.asarray(np.int32(3))}
    tst.save_file(to_native_flat(ttree, keep_bf16=True),
                  str(tmp_path / "port.safetensors"))
    jst.save_file(jto_native_flat(jtree), str(tmp_path / "jax.safetensors"))

    def header_and_bytes(path):
        raw = open(path, "rb").read()
        n = struct.unpack("<Q", raw[:8])[0]
        header = json.loads(raw[8:8 + n])
        return ({k: (v["dtype"], v["shape"]) for k, v in header.items()},
                {k: raw[8 + n + v["data_offsets"][0]:
                        8 + n + v["data_offsets"][1]]
                 for k, v in header.items()})

    got = header_and_bytes(str(tmp_path / "port.safetensors"))
    want = header_and_bytes(str(tmp_path / "jax.safetensors"))
    assert got[0] == want[0]
    assert {got[0][k][0] for k in got[0] if k.startswith("blocks")} == {
        "BF16"}
    assert got[1] == want[1]
