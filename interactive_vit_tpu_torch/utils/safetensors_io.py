"""Dependency-free safetensors reader/writer (numpy only).

The port's own copy of ``interactive_vit_tpu/utils/safetensors_io.py``
(same functions, same errors, same bytes). The format:

    u64 LE header_size | header_size bytes of JSON | raw tensor buffer

The JSON maps ``name -> {"dtype": "F32", "shape": [...],
"data_offsets": [start, end]}`` (offsets relative to the buffer start),
plus an optional ``"__metadata__"`` string map. Tensors are row-major,
little-endian, unpadded.

This is the checkpoint path of ``tools/convert.py``, the server's
``--ckpt`` and the trainer's ``--export-safetensors``; the checkpoint
directories of ``utils/checkpoint.py`` keep their leaves in one such file.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import numpy as np
import torch

# safetensors dtype tag <-> numpy. BF16 has no numpy dtype: it is read as
# its raw uint16 bits and upcast to float32 (exact — bf16 is the top half
# of f32), and written as its raw bits from a ``torch.bfloat16`` tensor or
# from an array whose dtype is named "bfloat16" (``ml_dtypes``, where
# installed).
_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U64": np.uint64,
    "U32": np.uint32,
    "U16": np.uint16,
    "U8": np.uint8,
    "BOOL": np.bool_,
}
_TAGS = {np.dtype(v): k for k, v in _DTYPES.items()}


class SafetensorsError(Exception):
    """Malformed .safetensors file."""


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Read every tensor from a .safetensors file.

    BF16 tensors are returned as float32 (exact upcast). The whole file is
    read once; tensors are zero-copy views into that buffer where dtypes
    allow.
    """
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise SafetensorsError(f"{path}: too short for a header")
    (hdr_size,) = struct.unpack_from("<Q", raw, 0)
    if 8 + hdr_size > len(raw):
        raise SafetensorsError(f"{path}: header extends past the file")
    try:
        header = json.loads(raw[8 : 8 + hdr_size].decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as err:
        raise SafetensorsError(f"{path}: bad header json: {err}") from err

    buf_off = 8 + hdr_size
    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        # every malformed-metadata shape (missing keys, non-int offsets,
        # chunk not a multiple of itemsize, negative dims) must surface as
        # SafetensorsError — callers catch it to report "malformed file"
        try:
            tag, shape = meta["dtype"], tuple(meta["shape"])
            start, end = (int(meta["data_offsets"][0]),
                          int(meta["data_offsets"][1]))
            if (start < 0 or end < start or buf_off + end > len(raw)
                    or any(int(d) < 0 for d in shape)):
                raise SafetensorsError(
                    f"{path}: tensor {name!r} out of range")
            chunk = raw[buf_off + start : buf_off + end]
            if tag == "BF16":
                bits = np.frombuffer(chunk, dtype="<u2")
                arr = _bf16_bits_to_f32(bits)
            elif tag in _DTYPES:
                arr = np.frombuffer(
                    chunk, dtype=np.dtype(_DTYPES[tag]).newbyteorder("<"))
            else:
                raise SafetensorsError(
                    f"{path}: unsupported dtype {tag!r}")
            n = int(np.prod(shape)) if shape else 1
            if arr.size != n:
                raise SafetensorsError(
                    f"{path}: tensor {name!r} has {arr.size} elems, "
                    f"shape {shape} needs {n}"
                )
            out[name] = arr.reshape(shape)
        except SafetensorsError:
            raise
        except Exception as err:  # noqa: BLE001 — contract: one error type
            raise SafetensorsError(
                f"{path}: malformed entry {name!r}: {err}") from err
    return out


def save_file(tensors: Dict[str, np.ndarray], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write tensors to a .safetensors file (row-major, little-endian).
    Values are numpy arrays or host torch tensors; a ``torch.bfloat16``
    tensor is written as its 16-bit patterns under the BF16 tag."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    chunks = []
    off = 0
    for name, t in tensors.items():
        bf16_bits = isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().contiguous()
            # numpy has no bfloat16: the bits, through int16, as <u2
            t = (t.view(torch.int16).numpy().view("<u2") if bf16_bits
                 else t.numpy())
        # np.asarray(order="C") keeps 0-d shapes (ascontiguousarray
        # promotes scalars to 1-d)
        arr = np.asarray(t, order="C")
        if bf16_bits:
            data = arr.tobytes()
            tag = "BF16"
        elif str(arr.dtype) == "bfloat16":  # an ml_dtypes array
            bits = arr.view(np.uint16)
            data = bits.astype("<u2").tobytes()
            tag = "BF16"
        else:
            if arr.dtype not in _TAGS:
                raise SafetensorsError(f"unsupported dtype {arr.dtype}")
            tag = _TAGS[arr.dtype]
            data = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {
            "dtype": tag,
            "shape": list(arr.shape),
            "data_offsets": [off, off + len(data)],
        }
        chunks.append(data)
        off += len(data)
    hdr = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for c in chunks:
            f.write(c)
