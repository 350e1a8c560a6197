"""Parameter conversion from the JAX package's parameter trees.

The two packages share one parameter layout (``models/vit.py`` and
``models/swin.py``: linear weights ``[D_in, D_out]``, qkv columns
``[3][H][dh]``, dicts and lists of leaves), so conversion is a tree-map of
numpy arrays to tensors. The Swin tree nests further than the ViT one
(``stages`` is a list of lists of block dicts, ``merges`` a list, and a
headless config's ``head`` is an empty dict); the map keeps every
container as it is. The JAX
package's own converters (torchvision, timm, safetensors) produce that
tree, and this is the one bridge the tests use to make both packages
compute the same thing. A quantized tree (``ops/quant.quantize_tree``)
maps one to one too: its leaf-dicts carry the same keys in both.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from interactive_vit_tpu_torch.ops.quant import AQKEY, ASKEY, QKEY, SKEY

_INT8_KEYS = {QKEY: torch.int8, AQKEY: torch.int8, SKEY: torch.float32,
              ASKEY: torch.float32}


def _int8_leaf(v: Any, key: str, device) -> torch.Tensor:
    """An int8 leaf-dict's weight (int8) or column scale (f32), unchanged."""
    arr = np.array(v, dtype=np.int8 if _INT8_KEYS[key] == torch.int8
                   else np.float32)
    return torch.from_numpy(arr).to(device)


def from_jax(params_np: Any, device="cpu", dtype=torch.float32) -> Any:
    """Map a JAX ViT or Swin parameter tree (leaves as numpy arrays, or
    anything ``np.asarray`` takes) to tensors on ``device`` in ``dtype``.

    Leaves go through f32 on the host, so bf16 numpy leaves (``ml_dtypes``)
    convert exactly. Callers pass ``device`` explicitly; the CPU default is
    a staging place (the tests' CPU path), not where a model serves.

    Int8 leaf-dicts (``ops/quant.py``) keep their types: the int8 weight
    as ``torch.int8``, its column scale as f32, whatever ``dtype`` is."""
    if isinstance(params_np, dict):
        return {k: (_int8_leaf(v, k, device) if k in _INT8_KEYS
                    else from_jax(v, device, dtype))
                for k, v in params_np.items()}
    if isinstance(params_np, (list, tuple)):
        return type(params_np)(from_jax(v, device, dtype) for v in params_np)
    arr = np.array(params_np, dtype=np.float32)  # a writable copy
    return torch.from_numpy(arr).to(device=device, dtype=dtype)
