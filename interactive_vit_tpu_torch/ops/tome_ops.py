"""Token merging (ToMe): bipartite soft matching and size-weighted merges.

Counterpart of ``interactive_vit_tpu/ops/tome_ops.py`` (a copy, not an
import). Between a block's attention and its MLP the ``r`` most similar
token pairs merge into size-weighted averages, so every later layer runs
on fewer tokens (Bolya et al. 2023, "Token Merging: Your ViT But Faster").

Semantics, as in the JAX package (pinned against the numpy
``bipartite_merge_reference``):

* tokens alternate into sets **a** (even indices) and **b** (odd);
* each a-token's best partner in b is scored by cosine similarity of the
  metric (the head-meaned attention keys); ``argmax`` takes the first
  index on ties;
* the ``r`` highest-scoring a-tokens merge into their partners as
  size-weighted averages (a stable ``argsort``, as ``jnp.argsort``);
* the CLS token (index 0, in set a) is protected: its scores are -inf;
* survivors are laid out ``[kept-a (ascending, CLS first) | all-b]``.

The shapes are static per block (``r`` is clamped by ``merge_counts``), so
the token ladder is fixed. Matching and merging are plain tensor ops, as
they are XLA ops in JAX. ``apply_merge`` folds rows with a batched product
against the one-hot assignment matrix, keeping the JAX cast points: sizes
and weighting in f32, the weighted rows cast to bf16 for bf16 values, f32
accumulation, the sum rounded to the values' compute type, then divided by
the f32 sizes. Added zeros leave a sum unchanged, so the product gives the
scatter's sums in a fixed order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def merge_counts(n: int, r: int, protect: int = 1) -> int:
    """The merge count at sequence length ``n``: ``r`` clamped so protected
    tokens survive and at most every a-token merges."""
    na = (n + 1) // 2
    return max(0, min(r, na - protect))


def match_scores(metric: torch.Tensor, protect: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """The matching's scores on ``metric`` [B, N, Dk]: ``(scores [B, Na,
    Nb]`` cosine similarities of a- to b-tokens with the protected rows
    -inf, each a-token's best score and partner ``[B, Na]``, and the
    a-tokens in merge order ``[B, Na]`` (a stable argsort of the best
    scores, descending)``)``."""
    mf = metric.float()
    mf = mf / torch.clamp(torch.linalg.vector_norm(mf, dim=-1, keepdim=True),
                          min=1e-6)
    scores = torch.matmul(mf[:, 0::2], mf[:, 1::2].transpose(1, 2))
    if protect:
        scores[:, :protect, :] = -torch.inf
    node_max = scores.amax(dim=-1)
    node_idx = torch.argmax(scores, dim=-1)
    # one stable argsort gives a disjoint merged / kept partition
    order = torch.argsort(-node_max, dim=-1, stable=True)
    return scores, node_max, node_idx, order


def bipartite_matching(metric: torch.Tensor, r: int, protect: int = 1
                       ) -> Tuple[torch.Tensor, int]:
    """Pick the ``r`` most similar (a, b) token pairs to merge.

    ``metric`` [B, N, Dk]. Returns ``(lut [B, N] int32, n_new)``: ``lut``
    maps every old token index to its new index (a merged a-token maps to
    its absorber's)."""
    b, n, _ = metric.shape
    dev = metric.device
    r = merge_counts(n, r, protect)
    if r == 0:
        return (torch.arange(n, dtype=torch.int32, device=dev)
                .expand(b, n).clone(), n)
    na, nb = (n + 1) // 2, n // 2
    _, node_max, node_idx, order = match_scores(metric, protect)
    merge_rows = order[:, :r]
    keep_rows = torch.sort(order[:, r:], dim=-1).values
    dst = torch.gather(node_idx, 1, merge_rows)            # [B, r] b-index
    n_keep = na - r
    lut = torch.zeros((b, n), dtype=torch.int32, device=dev)
    ar = torch.arange(max(n_keep, nb), dtype=torch.int32, device=dev)
    lut.scatter_(1, 2 * keep_rows, ar[:n_keep].expand(b, n_keep))
    lut[:, 1::2] = (n_keep + ar[:nb]).expand(b, nb)
    lut.scatter_(1, 2 * merge_rows, (n_keep + dst).to(torch.int32))
    return lut, n - r


def apply_merge(values: torch.Tensor, s: torch.Tensor, lut: torch.Tensor,
                n_new: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge rows of ``values`` [B, N, ...] per ``lut``, size-weighted:
    ``out[b, j] = sum_{i: lut[b,i]=j} s[b,i] values[b,i] / sum s[b,i]``.
    Returns ``(merged [B, n_new, ...], s_new [B, n_new] f32)``."""
    b, n = values.shape[:2]
    sf = s.float()
    onehot = (lut[:, None, :].long() == torch.arange(
        n_new, device=lut.device)[None, :, None]).float()   # [B, n_new, N]
    s_new = torch.matmul(onehot, sf[:, :, None])[..., 0]
    cdt = torch.bfloat16 if values.dtype == torch.bfloat16 else torch.float32
    flat = (values.reshape(b, n, -1).float() * sf[:, :, None]).to(cdt)
    acc = torch.matmul(onehot, flat.float()).to(cdt).float()
    out = acc / s_new[:, :, None]
    return (out.reshape((b, n_new) + tuple(values.shape[2:]))
            .to(values.dtype), s_new)


def bipartite_merge(x: torch.Tensor, s: torch.Tensor, metric: torch.Tensor,
                    r: int, protect: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matching and merge in one call: ``[B,N,D] -> [B,N-r,D]``. Returns
    ``(x_out, s_out [B, N-r] f32, lut [B, N] int32)``."""
    lut, n_new = bipartite_matching(metric, r, protect)
    if n_new == x.shape[1]:
        return x, s.float(), lut
    x_out, s_out = apply_merge(x, s, lut, n_new)
    return x_out, s_out, lut


def bipartite_merge_reference(x, s, metric, r: int, protect: int = 1):
    """Semantic ground truth: a per-sample numpy loop (tests only)."""
    x = np.asarray(x, np.float64)
    s = np.asarray(s, np.float64)
    metric = np.asarray(metric, np.float64)
    b, n, _ = x.shape
    r = merge_counts(n, r, protect)
    if r == 0:
        return x, s, np.broadcast_to(np.arange(n, dtype=np.int32), (b, n))
    na, nb = (n + 1) // 2, n // 2
    xs, ss, luts = [], [], []
    for i in range(b):
        m = metric[i] / np.maximum(
            np.linalg.norm(metric[i], axis=-1, keepdims=True), 1e-6)
        scores = m[0::2] @ m[1::2].T                    # [Na, Nb]
        scores[:protect] = -np.inf
        node_max = scores.max(-1)
        node_idx = scores.argmax(-1)
        order = np.argsort(-node_max, kind="stable")
        merge_rows = order[:r]
        keep_rows = np.sort(order[r:])
        xa, xb = x[i, 0::2].copy(), x[i, 1::2].copy()
        sa, sb = s[i, 0::2].copy(), s[i, 1::2].copy()
        acc = xb * sb[:, None]
        for a_row in merge_rows:
            d_row = node_idx[a_row]
            acc[d_row] += xa[a_row] * sa[a_row]
            sb[d_row] += sa[a_row]
        xb = acc / sb[:, None]
        lut = np.zeros(n, np.int32)
        lut[2 * keep_rows] = np.arange(na - r)
        lut[2 * np.arange(nb) + 1] = na - r + np.arange(nb)
        lut[2 * merge_rows] = na - r + node_idx[merge_rows]
        xs.append(np.concatenate([xa[keep_rows], xb]))
        ss.append(np.concatenate([sa[keep_rows], sb]))
        luts.append(lut)
    return np.stack(xs), np.stack(ss), np.stack(luts)


def merge_map_render(assign: torch.Tensor, skip: int = 1) -> torch.Tensor:
    """Render a patch -> token assignment as a colour image [B, 3, g, g].

    ``assign`` [B, P] int: the current token of each original token
    (``skip`` leading CLS entries dropped; the rest must tile a square
    grid). Tokens get stable colours from the golden-ratio hue walk, so
    patches of one colour were merged into one surviving token."""
    pa = assign[:, skip:]
    b, p = pa.shape
    g = int(round(float(np.sqrt(p))))
    if g * g != p:
        raise ValueError(f"assignment length {p} (skip={skip}) is not a "
                         f"square patch grid")
    hue = torch.remainder(pa.float() * 0.61803398875, 1.0)
    # HSV -> RGB at s=0.78, v=1: each channel an offset triangle wave
    h6 = hue * 6.0
    k = torch.stack([torch.remainder(h6 + 5.0, 6.0),
                     torch.remainder(h6 + 3.0, 6.0),
                     torch.remainder(h6 + 1.0, 6.0)])
    rgb = 1.0 - 0.78 * torch.clamp(
        torch.minimum(torch.minimum(k, 4.0 - k), torch.ones_like(k)),
        0.0, 1.0)
    return rgb.transpose(0, 1).reshape(b, 3, g, g)
