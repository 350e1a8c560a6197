"""Pipeline parallelism: GPipe microbatched stages over a mesh axis.

Counterpart of ``interactive_vit_tpu/parallel/pipeline.py``. Each rank on
the "stage" axis holds L/S consecutive blocks (stage s blocks [s L/S,
(s + 1) L/S)); microbatches fill the pipe on the classic (M + S - 1)-tick
schedule, and between ticks each stage's activation goes to the next
stage (``dist.batch_isend_irecv``, the JAX ring ``ppermute``). A stage
computes only on the ticks that carry one of its microbatches. At the end
the last stage's outputs go to every stage (a broadcast: JAX's psum of
buffers that are zero elsewhere), and the tapped layers' activations are
summed over the stages (each row written by its one owner).

The data axis composes: where each microbatch's rows divide by it, a rank
pipelines only its data rows of every microbatch and the results are
gathered over "data" at the end, so every rank returns the whole batch, as
the JAX function's result holds it. No gradient flows through the hops.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.parallel import mesh as mesh_lib


def _stack_blocks(blocks: List[Any]):
    """Per-layer param dicts -> one tree with a leading layer dim."""
    if isinstance(blocks[0], dict):
        return {k: _stack_blocks([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack(blocks)


def _unstack(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: _unstack(v, i) for k, v in stacked.items()}
    return stacked[i]


def _n_rows(stacked) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


def _hop(state: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``state`` to the next stage, the previous stage's in return."""
    ranks = mesh_lib.axis_ranks(mesh, axis)
    s, n = mesh_lib.axis_index(mesh, axis), len(ranks)
    group = mesh_lib.axis_group(mesh, axis)
    out = torch.empty_like(state)
    ops = [dist.P2POp(dist.isend, state.contiguous(), ranks[(s + 1) % n],
                      group),
           dist.P2POp(dist.irecv, out, ranks[(s - 1) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _pp_local(layers: List[Any], x_micro: torch.Tensor, layer_fn, mesh,
              axis: str, tap_layers=()):
    """The per-rank schedule. ``layers``: this stage's per-layer params;
    ``x_micro`` [M, mb, ...]: the microbatches. Returns the outputs [M,
    mb, ...] (and a [K, M, mb, ...] tap buffer with ``tap_layers``), whole
    on every stage."""
    n_stages = mesh_lib.axis_size(mesh, axis)
    stage = mesh_lib.axis_index(mesh, axis)
    n_micro, lps = x_micro.shape[0], len(layers)
    outputs = torch.zeros_like(x_micro)
    taps = (torch.zeros((len(tap_layers),) + tuple(x_micro.shape),
                        dtype=x_micro.dtype, device=x_micro.device)
            if tap_layers else None)
    state = torch.zeros_like(x_micro[0])
    ticks = n_micro + n_stages - 1
    for t in range(ticks):
        if stage == 0 and t < n_micro:
            state = x_micro[t]
        m = t - stage  # the microbatch this stage holds at tick t
        if 0 <= m < n_micro:
            ys = []
            for p in layers:
                state = layer_fn(p, state)
                ys.append(state)
            for k, lyr in enumerate(tap_layers):
                s_l, row = divmod(lyr, lps)
                if s_l == stage:
                    taps[k, m] = ys[row]
            if stage == n_stages - 1:
                outputs[m] = state
        if t + 1 < ticks and n_stages > 1:
            state = _hop(state, mesh, axis)
    if n_stages == 1:
        return (outputs, taps) if tap_layers else outputs
    ranks = mesh_lib.axis_ranks(mesh, axis)
    group = mesh_lib.axis_group(mesh, axis)
    dist.broadcast(outputs, src=ranks[-1], group=group)
    if tap_layers:
        dist.all_reduce(taps, op=dist.ReduceOp.SUM, group=group)
        return outputs, taps
    return outputs


def pipeline_apply_stacked(
    stacked: Any,
    x: torch.Tensor,
    layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh,
    axis: str = "stage",
    n_micro: Optional[int] = None,
    n_layers: Optional[int] = None,
    tap_layers=(),
):
    """``x`` through the layers of a layer-stacked tree, pipelined over
    ``mesh[axis]``. ``stacked``: this stage's layers (a leading dim of
    L/S, as ``mesh.shard_params`` leaves a ``__pp`` subtree); ``n_layers``:
    the global layer count L (default L/S times the stage count).

    ``n_micro`` defaults to the stage count where it divides the batch,
    else 1. ``tap_layers``: global layer indices whose activations are also
    returned: the result is then ``(y, {layer: [B, ...] activation})``."""
    n_stages = mesh_lib.axis_size(mesh, axis)
    if n_layers is None:
        n_layers = _n_rows(stacked) * n_stages
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers not divisible by {n_stages} stages")
    layers = [_unstack(stacked, i) for i in range(_n_rows(stacked))]
    return _pipeline(layers, n_layers, x, layer_fn, mesh, axis, n_micro,
                     tap_layers)


def _pipeline(layers, n_layers, x, layer_fn, mesh, axis, n_micro,
              tap_layers):
    b = x.shape[0]
    n_stages = mesh_lib.axis_size(mesh, axis)
    if n_micro is not None and n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    if n_micro is None:
        # as many microbatches as divide the batch, capped at the stages
        n_micro = n_stages if b % n_stages == 0 else 1
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    mb = b // n_micro
    x_micro = x.reshape(n_micro, mb, *x.shape[1:])
    tap_layers = tuple(sorted(tap_layers))
    if tap_layers and (min(tap_layers) < 0 or max(tap_layers) >= n_layers):
        raise ValueError(
            f"tap_layers {tap_layers} out of range 0..{n_layers - 1}")
    # PP composes with DP: a rank pipelines its data rows of each
    # microbatch where they divide (else every data rank runs them all)
    n_data = mesh_lib.axis_size(mesh, "data")
    data_ok = n_data > 1 and mb % n_data == 0
    if data_ok:
        ml = mb // n_data
        d = mesh_lib.axis_index(mesh, "data")
        x_micro = x_micro[:, d * ml:(d + 1) * ml]
    res = _pp_local(layers, x_micro, layer_fn, mesh, axis, tap_layers)
    y, taps = (res if tap_layers else (res, None))
    if data_ok:
        y = mesh_lib.all_gather_rows(y, mesh, "data", dim=1)
        if taps is not None:
            taps = mesh_lib.all_gather_rows(taps, mesh, "data", dim=2)
    y = y.reshape(b, *x.shape[1:])
    if not tap_layers:
        return y
    tap_out: Dict[int, torch.Tensor] = {
        lyr: taps[k].reshape(b, *x.shape[1:])
        for k, lyr in enumerate(tap_layers)}
    return y, tap_out


def pipeline_apply(
    blocks: List[Any],
    x: torch.Tensor,
    layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh,
    axis: str = "stage",
    n_micro: Optional[int] = None,
) -> torch.Tensor:
    """Run ``x`` through ``blocks`` (every layer's params; this rank keeps
    its stage's) pipelined over ``mesh[axis]``. x: [B, ...]; B must divide
    by ``n_micro``. ``layer_fn(params, x) -> y`` applies one block."""
    n_stages = mesh_lib.axis_size(mesh, axis)
    if len(blocks) % n_stages:
        raise ValueError(
            f"{len(blocks)} layers not divisible by {n_stages} stages")
    lps = len(blocks) // n_stages
    s = mesh_lib.axis_index(mesh, axis)
    return _pipeline(blocks[s * lps:(s + 1) * lps], len(blocks), x,
                     layer_fn, mesh, axis, n_micro, ())


def pipelined_vit_forward(params, images: torch.Tensor, cfg: vit.ViTConfig,
                          mesh, axis: str = "stage",
                          n_micro: Optional[int] = None) -> torch.Tensor:
    """The ViT forward with the blocks pipelined; returns logits. Embed,
    final norm and head run on every rank (cheap); the L blocks run as
    ``mesh[axis]`` pipeline stages."""
    x = vit.embed(params, images, cfg)

    def layer_fn(p, x):
        y, _, _ = vit.block(p, x, cfg, want_attn=False)
        return y

    x = pipeline_apply(params["blocks"], x, layer_fn, mesh, axis=axis,
                       n_micro=n_micro)
    x = vit.final_norm(params, x, cfg)
    return vit.head(params, x)
