"""Int8 quantization of the serving path: weight-only and W8A8.

Counterpart of ``interactive_vit_tpu/ops/quant.py``, with the same
leaf-dict keys so that ``models/weights.from_jax`` maps a quantized JAX
tree one to one:

* weight-only (``QKEY``/``SKEY``): a linear weight ``[D_in, D_out]`` is
  stored as symmetric per-output-channel int8 plus an f32 column scale;
  ``layers.linear`` multiplies by the int8 weight cast to the activation
  dtype and rescales the f32 accumulator by the column scale;
* W8A8 (``AQKEY``/``ASKEY``): the same int8 weight and scale under other
  keys; the activations are quantized per token at run time and the
  product is s8 x s8 -> s32 (``linear_w8a8`` here; the fused MLP kernel
  ``ops/fused_mlp.fused_mlp_w8a8_block`` on the card).

Two roundings, each matching its JAX twin:

* ``quantize_weight`` (host numpy) and ``quantize_acts`` round half to
  even (``np.round`` / ``torch.round``, as ``jnp.round``);
* ``quant_rows_mosaic`` / ``quant_cols_mosaic``, the quantizers inside the
  W8A8 MLP kernel and the s8 mode of the fused block, round half up:
  ``floor(x / s + 0.5)`` with a true f32 division (the Pallas kernels'
  ``floor(x + 0.5)``, which Mosaic lowers where it has no half-even
  rounding). The two differ only on exact .5 lattice points of x / s.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

#: key markers of a weight-only int8 leaf-dict
QKEY, SKEY = "int8_q", "int8_s"
#: key markers of a W8A8 leaf-dict: the same int8 weight and column scale
#: under other keys, so the mode is read from the tree's structure
AQKEY, ASKEY = "int8a8_q", "int8a8_s"

#: the transformer-block linear weights quantized by default; the patch
#: embedding and the classifier head stay dense (the usual int8 recipe)
BLOCK_WEIGHTS = frozenset({"qkv_w", "proj_w", "fc1_w", "fc2_w"})


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and QKEY in w


def is_w8a8(w: Any) -> bool:
    return isinstance(w, dict) and AQKEY in w


def quantize_weight(w, mode: str = "w8") -> Dict[str, torch.Tensor]:
    """[D_in, D_out] float -> symmetric per-output-channel int8 + f32 scale,
    on ``w``'s device.

    scale[j] = max_i |w[i, j]| / 127 (1 where the column is all zero);
    q = round(w / scale), half to even, on the host in numpy as the JAX
    package does, so both packages store the same bits. ``mode="w8a8"``
    stores them under the W8A8 keys."""
    device = w.device if isinstance(w, torch.Tensor) else "cpu"
    wf = (w.detach().to("cpu", torch.float32).numpy()
          if isinstance(w, torch.Tensor) else np.asarray(w, np.float32))
    if wf.ndim != 2:
        raise ValueError(f"quantize_weight wants 2-D, got {wf.shape}")
    s = np.max(np.abs(wf), axis=0) / np.float32(127.0)
    s = np.where(s == 0, np.float32(1.0), s).astype(np.float32)
    q = np.clip(np.round(wf / s), -127, 127).astype(np.int8)
    qk, sk = (QKEY, SKEY) if mode == "w8" else (AQKEY, ASKEY)
    return {qk: torch.from_numpy(q).to(device),
            sk: torch.from_numpy(s).to(device)}


def dequantize_weight(w: Dict[str, torch.Tensor], dtype=torch.float32):
    q = w[QKEY] if QKEY in w else w[AQKEY]
    s = w[SKEY] if SKEY in w else w[ASKEY]
    return (q.float() * s).to(dtype)


def quantize_acts(x: torch.Tensor):
    """Per-token symmetric int8 quantization: x [..., D] -> (q int8
    [..., D], s f32 [..., 1]), s = max_d |x| / 127, q = round(x / s) half
    to even (``jnp.round``)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact s8 x s8 -> s32 product of int8 [..., K] and [K, N], on any
    device: float64 holds every partial sum exactly (|acc| <= 127^2 * K <
    2^53), so the result is the integer product, returned as int32."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def linear_w8a8(x: torch.Tensor, w: Dict[str, torch.Tensor], b=None):
    """x @ W + b with both operands int8: per-token activation scales
    (``quantize_acts``, half to even), an exact s8 x s8 -> s32 product and
    the rank-1 f32 rescale acc * (s_x * s_w), as JAX ``linear_w8a8``."""
    qx, sx = quantize_acts(x)
    acc = int_matmul(qx, w[AQKEY])
    y = acc.float() * (sx * w[ASKEY])
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _round_half_up(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x + 0.5)


def quant_rows_mosaic(xf: torch.Tensor):
    """f32 [..., R, C] -> (int8, f32 [..., R, 1] scale); per-row symmetric,
    rounding half up: the quantizer inside the W8A8 MLP kernel and the s8
    mode of the fused block."""
    s = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(_round_half_up(xf / s), -127, 127).to(torch.int8)
    return q, s


def quant_cols_mosaic(xf: torch.Tensor):
    """f32 [..., R, C] -> (int8, f32 [..., 1, C] scale); per-column
    symmetric (the s8 PV product's v quantizer), rounding half up as
    ``quant_rows_mosaic``."""
    s = xf.abs().amax(dim=-2, keepdim=True) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(_round_half_up(xf / s), -127, 127).to(torch.int8)
    return q, s


def quantize_tree(params: Any, names: frozenset = BLOCK_WEIGHTS,
                  mode: str = "w8") -> Any:
    """Replace 2-D float weight leaves named in ``names`` with their int8
    form (``mode`` "w8" or "w8a8"); every other leaf is left as it is."""

    def walk(obj: Any) -> Any:
        if isinstance(obj, dict):
            return {k: (quantize_weight(v, mode=mode)
                        if (k in names and isinstance(v, torch.Tensor)
                            and v.ndim == 2 and v.is_floating_point())
                        else walk(v))
                    for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(walk(v) for v in obj)
        return obj

    return walk(params)
