"""Parameter and train-state checkpoints: the port's checkpoint directory.

Counterpart of ``interactive_vit_tpu/utils/checkpoint.py`` (``save_params``,
``load_params``, ``state_keys``, ``AsyncSaver``). The JAX package writes
orbax directories; orbax is a JAX library, so this package writes a
directory of its own that needs neither orbax nor pickle:

    <dir>/tree.json           the tree's shape: dicts (key order kept),
                              lists, tuples, and each leaf's kind and dtype
    <dir>/leaves.safetensors  the leaves, named as ``models/weights.
                              to_native_flat`` names them ("blocks/0/qkv_w")

A tree of tensors and Python scalars round-trips bit for bit: tensors of
any dtype (bf16 through exact f32, since numpy has no bfloat16; int8
leaves of ``ops/quant.py`` as int8), 0-d leaves, Python ints, floats and
bools (an optimizer's ``count``) and empty containers (a headless ViT's ``head: {}``, an empty list).
``state_keys`` reads ``tree.json`` alone. A directory without
``tree.json`` (an orbax directory of the JAX package) is refused.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from interactive_vit_tpu_torch.models.weights import to_native_flat
from interactive_vit_tpu_torch.utils.safetensors_io import (
    load_file, save_file,
)

FORMAT = "interactive_vit_tpu_torch.checkpoint/1"
TREE_FILE = "tree.json"
LEAVES_FILE = "leaves.safetensors"

_PY_KINDS = {"int": int, "float": float, "bool": bool}


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A leaf's shape, dtype and device without its data: a ``like`` leaf
    that allocates nothing (``jax.ShapeDtypeStruct``'s counterpart)."""
    shape: tuple
    dtype: torch.dtype
    device: torch.device


def _spec(node, prefix: str = ""):
    """The JSON shape of a tree (``to_native_flat``'s keys at the
    leaves)."""
    if isinstance(node, dict):
        for k in node:
            if not isinstance(k, str) or "/" in k or not k:
                raise ValueError(f"checkpoint keys must be non-empty strings "
                                 f"without '/': {k!r} at {prefix or '/'}")
        return {"dict": [[k, _spec(v, f"{prefix}/{k}" if prefix else k)]
                         for k, v in node.items()]}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_spec(v, f"{prefix}/{i}" if prefix else str(i))
                       for i, v in enumerate(node)]}
    if isinstance(node, torch.Tensor):
        return {"leaf": prefix, "dtype": str(node.dtype).replace("torch.", ""),
                "shape": list(node.shape)}
    if isinstance(node, (bool, int, float)):
        return {"leaf": prefix, "py": type(node).__name__}
    raise TypeError(f"cannot checkpoint a {type(node).__name__} at "
                    f"{prefix or '/'}")


def _host_snapshot(tree):
    """(tree.json's object, the leaves as numpy): everything a write needs,
    copied off the device in the calling thread."""
    return ({"format": FORMAT, "tree": _spec(tree)}, to_native_flat(tree))


def _write(path: str, spec, flat) -> None:
    """Write into a sibling directory, then swap it in: a reader never
    sees a half-written checkpoint under ``path``."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    save_file(flat, os.path.join(tmp, LEAVES_FILE))
    with open(os.path.join(tmp, TREE_FILE), "w") as f:
        json.dump(spec, f)
    old = None
    if os.path.exists(path):
        old = f"{tmp}.old"
        os.rename(path, old)
    os.rename(tmp, path)
    if old is not None:
        shutil.rmtree(old)


def save_params(path: str, params: Any) -> None:
    """Save a tree to ``path`` (a checkpoint directory; replaced if it
    exists)."""
    _write(path, *_host_snapshot(params))


def _read_spec(path: str):
    tree_file = os.path.join(path, TREE_FILE)
    if not os.path.isfile(tree_file):
        orbax = any(os.path.exists(os.path.join(path, m)) for m in (
            "_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "d"))
        raise ValueError(
            f"{path} is not a checkpoint directory of this package (no "
            f"{TREE_FILE})"
            + ("; it is an orbax checkpoint of the JAX package" if orbax
               else "")
            + ". The port reads .safetensors / .pth files or its own "
              "checkpoint directories; the JAX trainer's "
              "--export-safetensors writes a file the port serves.")
    with open(tree_file) as f:
        obj = json.load(f)
    if obj.get("format") != FORMAT:
        raise ValueError(f"{path}: unknown checkpoint format "
                         f"{obj.get('format')!r} (expected {FORMAT!r})")
    return obj["tree"]


def state_keys(path: str) -> set:
    """Top-level keys of a saved tree, from ``tree.json`` alone (no leaf
    data is read)."""
    spec = _read_spec(os.path.abspath(path))
    if "dict" not in spec:
        raise ValueError(f"{path}: the saved tree is not a dict")
    return {k for k, _ in spec["dict"]}


def _mismatch(path, where, what):
    return ValueError(f"{path}: the saved tree does not match `like` at "
                      f"{where or '/'}: {what}")


def load_params(path: str, like: Optional[Any] = None, device="cuda") -> Any:
    """Restore a tree saved by ``save_params``.

    Without ``like``: the saved tree, tensors on ``device`` in their saved
    dtypes. With ``like`` (a tree of tensors, ``LeafSpec``s or Python
    scalars): its structure must be the saved one; each tensor goes to its
    ``like`` leaf's device and dtype, and its shape must match."""
    path = os.path.abspath(path)
    spec = _read_spec(path)
    flat = load_file(os.path.join(path, LEAVES_FILE))
    device = torch.device(device)

    def build(s, like_node, where):
        if "dict" in s:
            keys = sorted(k for k, _ in s["dict"])
            if like_node is not None and (not isinstance(like_node, dict)
                                          or sorted(like_node) != keys):
                raise _mismatch(path, where, f"saved keys {keys}")
            return {k: build(v, None if like_node is None else like_node[k],
                             f"{where}/{k}") for k, v in s["dict"]}
        for kind, typ in (("list", list), ("tuple", tuple)):
            if kind in s:
                if like_node is not None and (
                        not isinstance(like_node, (list, tuple))
                        or len(like_node) != len(s[kind])):
                    raise _mismatch(path, where, f"a {kind} of "
                                    f"{len(s[kind])}")
                return typ(build(v, None if like_node is None
                                 else like_node[i], f"{where}/{i}")
                           for i, v in enumerate(s[kind]))
        if isinstance(like_node, (dict, list, tuple)):
            raise _mismatch(path, where, "a leaf")
        arr = flat[s["leaf"]]
        if "py" in s:
            return _PY_KINDS[s["py"]](arr.item())
        dtype = getattr(torch, s["dtype"])
        dev = device
        if like_node is not None:
            if tuple(like_node.shape) != tuple(s["shape"]):
                raise _mismatch(path, where, f"shape {s['shape']} vs "
                                f"{list(like_node.shape)}")
            dtype, dev = like_node.dtype, like_node.device
        t = torch.from_numpy(np.array(arr).reshape(s["shape"]))
        # bf16 leaves were saved as exact f32: the cast restores their bits
        return t.to(dtype=getattr(torch, s["dtype"])).to(device=dev,
                                                         dtype=dtype)

    return build(spec, like, "")


class AsyncSaver:
    """Checkpointing that overlaps the disk write with the next steps.

    ``save()`` copies the tree off the device in the calling thread (so the
    write cannot race the next step's updates) and writes it in a
    background thread. At most one write is in flight: a new save first
    waits out the previous one. ``wait()`` blocks until the write is done;
    ``close()`` drains it. A failed write raises from the next ``save``,
    ``wait`` or ``close``."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, tree: Any) -> None:
        self.wait()
        spec, flat = _host_snapshot(tree)

        def run():
            try:
                _write(path, spec, flat)
            except BaseException as err:  # noqa: BLE001 -- re-raised by wait
                self._error = err

        self._thread = threading.Thread(target=run, name="ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()
