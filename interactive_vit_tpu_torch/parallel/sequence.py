"""Sequence parallelism: ring attention and Ulysses head-parallel attention.

Counterpart of ``interactive_vit_tpu/parallel/sequence.py``. When one
device can no longer hold a sequence's K/V, the token axis is sharded over
a mesh axis:

* **Ring attention**: each rank keeps its Q shard and passes K/V shards
  round the ring (``dist.batch_isend_irecv`` to the next rank on the axis),
  folding each visiting shard into an f32 online-softmax accumulator.
* **Ulysses**: ``all_to_all_single`` re-shards [tokens] -> [heads], so each
  rank computes full attention for a head subset (whole per-head maps stay
  on one rank, the tap-friendly variant), and back.

``ring_attention`` / ``ulysses_attention`` take the global [B, H, N, D]
tensors, as the JAX functions take them before ``shard_map`` splits them,
check JAX's divisibility rules and return this rank's shard of the result
(the ``out_specs`` shard): the token shard of the output, and for Ulysses
the head shard of the probabilities. ``ring_attention_local`` /
``ulysses_attention_local`` are the per-rank bodies on local token shards.
The math is the JAX bodies' (f32 logits, ``MASK_VALUE`` beyond ``n_real``
by global column). No gradient flows through the collectives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from interactive_vit_tpu_torch.parallel import mesh as mesh_lib

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _token_shard(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    p, i = mesh_lib.axis_size(mesh, axis), mesh_lib.axis_index(mesh, axis)
    nl = x.shape[2] // p
    return x[:, :, i * nl:(i + 1) * nl]


def _ring_shift(xs, mesh, axis: str):
    """Each tensor of ``xs`` sent to the next rank on ``axis`` and
    replaced by the previous rank's (JAX's ppermute j -> j + 1)."""
    ranks = mesh_lib.axis_ranks(mesh, axis)
    p, i = len(ranks), mesh_lib.axis_index(mesh, axis)
    nxt, prev = ranks[(i + 1) % p], ranks[(i - 1) % p]
    group = mesh_lib.axis_group(mesh, axis)
    outs = [torch.empty_like(x) for x in xs]
    ops = []
    for x, o in zip(xs, outs):
        ops.append(dist.P2POp(dist.isend, x.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, o, prev, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mesh, axis: str = "data",
                         n_real: Optional[int] = None) -> torch.Tensor:
    """The per-rank ring body: q, k, v are this rank's [B, H, nl, D] token
    shards (rank i holds tokens [i nl, (i + 1) nl)); returns its [B, H,
    nl, D] output shard. ``n_real``: keys at or beyond this global column
    are masked (padded tokens)."""
    p = mesh_lib.axis_size(mesh, axis)
    my = mesh_lib.axis_index(mesh, axis)
    b, h, nl, d = q.shape
    n_real = nl * p if n_real is None else n_real
    scale = d ** -0.5
    qf = q.float()
    m = torch.full((b, h, nl, 1), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, nl, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, nl, d), dtype=torch.float32, device=q.device)
    cols = torch.arange(nl, device=q.device)
    k_cur, v_cur = k, v
    for step in range(p):
        # k_cur started on rank (my - step) mod p: its global key range
        src = (my - step) % p
        s = torch.matmul(qf, k_cur.float().transpose(-1, -2)) * scale
        s = torch.where(cols + src * nl < n_real, s,
                        torch.full_like(s, MASK_VALUE))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new)
        l = alpha * l + pexp.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(pexp, v_cur.float())
        m = m_new
        if step + 1 < p:
            k_cur, v_cur = _ring_shift([k_cur, v_cur], mesh, axis)
    return (acc / l).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "data",
                   n_real: Optional[int] = None) -> torch.Tensor:
    """Sequence-sharded attention over a mesh axis. q, k, v: the global [B,
    H, N, D]; N must divide by the axis size (pad and pass ``n_real``
    otherwise). Returns this rank's [B, H, N/p, D] token shard."""
    n = q.shape[2]
    p = mesh_lib.axis_size(mesh, axis)
    if n % p:
        raise ValueError(
            f"ring_attention: token count {n} must be divisible by mesh "
            f"axis {axis!r} (size {p}) — pad and pass n_real")
    return ring_attention_local(
        *(_token_shard(x, mesh, axis) for x in (q, k, v)), mesh, axis=axis,
        n_real=n if n_real is None else n_real)


def _all_to_all(x: torch.Tensor, mesh, axis: str, split: int,
                concat: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` split into p chunks along
    ``split``, chunk j sent to rank j, the chunks received concatenated
    along ``concat`` in rank order."""
    p = mesh_lib.axis_size(mesh, axis)
    chunks = torch.stack(x.chunk(p, dim=split)).contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks,
                           group=mesh_lib.axis_group(mesh, axis))
    return torch.cat(out.unbind(0), dim=concat)


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mesh, axis: str = "data",
                            n_real: Optional[int] = None,
                            want_attn: bool = False
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The per-rank Ulysses body: [B, H, nl, D] token shards -> all-to-all
    to [B, H/p, N, D] head shards -> full attention on them -> back.
    Returns (this rank's [B, H, nl, D] output shard, its [B, H/p, N, N]
    probs or None)."""
    qh, kh, vh = (_all_to_all(x, mesh, axis, split=1, concat=2)
                  for x in (q, k, v))
    n = qh.shape[2]
    n_real = n if n_real is None else n_real
    scale = qh.shape[-1] ** -0.5
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    s = torch.where(torch.arange(n, device=q.device) < n_real, s,
                    torch.full_like(s, MASK_VALUE))
    probs = torch.softmax(s, dim=-1)
    out = torch.matmul(probs, vh.float()).to(q.dtype)
    out = _all_to_all(out, mesh, axis, split=2, concat=1)
    return out, (probs.to(q.dtype) if want_attn else None)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis: str = "data", n_real: Optional[int] = None,
                      want_attn: bool = False
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Ulysses attention: tokens -> heads all-to-all, full local attention.
    q, k, v: the global [B, H, N, D]; heads and N must divide by the axis
    size. Returns (this rank's [B, H, N/p, D] token shard, its [B, H/p, N,
    N] head shard of the probs or None)."""
    n = q.shape[2]
    p = mesh_lib.axis_size(mesh, axis)
    if q.shape[1] % p:
        raise ValueError(
            f"ulysses_attention: heads {q.shape[1]} must be divisible by "
            f"mesh axis {axis!r} (size {p})")
    if n % p:
        raise ValueError(
            f"ulysses_attention: token count {n} must be divisible by "
            f"mesh axis {axis!r} (size {p}) — pad and pass n_real")
    return ulysses_attention_local(
        *(_token_shard(x, mesh, axis) for x in (q, k, v)), mesh, axis=axis,
        n_real=n if n_real is None else n_real, want_attn=want_attn)
