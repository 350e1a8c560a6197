"""Sequence-parallel attention as a pluggable ``attn_impl``.

Counterpart of ``interactive_vit_tpu/parallel/sp_attention.py``: puts
``parallel/sequence.py``'s ring and Ulysses attention in the model's
attention slot (``vit.forward(attn_impl=...)``):

    mesh = make_mesh({"data": 1, "model": 4})
    impl = make_sp_attn_impl(mesh, axis="model", kind="ulysses")
    out = vit.forward(params, images, cfg, want_attn=True, attn_impl=impl)

The forward runs on every rank of the axis on the same activations; the
impl computes this rank's shard and gathers the whole result over the axis
(the output's tokens, Ulysses' maps by head), so it keeps the contract of
``ops/attention.attention_reference``. A ring cannot return whole maps (no
rank holds an N x N row), so asking a ring impl for them raises.
"""

from __future__ import annotations

from typing import Optional

from interactive_vit_tpu_torch.parallel.mesh import all_gather_rows
from interactive_vit_tpu_torch.parallel.sequence import (
    ring_attention,
    ulysses_attention,
)


def make_sp_attn_impl(mesh, axis: str, kind: str = "ulysses"):
    """An ``(q, k, v, want_attn, n_real=None) -> (out, probs)`` impl."""
    if kind not in ("ring", "ulysses"):
        raise ValueError(f"unknown SP kind {kind!r}")

    def impl(q, k, v, want_attn: bool = False, n_real: Optional[int] = None):
        if kind == "ring":
            if want_attn:
                raise ValueError(
                    "ring attention cannot tap full attention maps (no "
                    "device holds a whole N x N row); use kind='ulysses'"
                )
            out = ring_attention(q, k, v, mesh, axis=axis, n_real=n_real)
            return all_gather_rows(out, mesh, axis, dim=2), None
        out, probs = ulysses_attention(q, k, v, mesh, axis=axis,
                                       n_real=n_real, want_attn=want_attn)
        if probs is not None:
            probs = all_gather_rows(probs, mesh, axis, dim=1)
        return all_gather_rows(out, mesh, axis, dim=2), probs

    return impl
