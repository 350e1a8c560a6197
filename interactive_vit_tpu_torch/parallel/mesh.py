"""Device meshes on ``torch.distributed`` and the ViT sharding rules.

Counterpart of ``interactive_vit_tpu/parallel/mesh.py``. The JAX package
has one controller and lets GSPMD partition a program over a ``Mesh``;
the port runs one process per device (rank), launched by ``torchrun``,
so what ``shard_map`` does there is plain per-rank code on local tensors
here, with named collectives over the mesh's axes:

    data   the batch. Every rank draws the global batch from the same
           seeded stream and keeps the rows ``batch_sharding`` gives it;
           gradients are averaged over the axis (``all_reduce_mean``).
    model  tensor parallelism, as GSPMD does it: the leaves that
           ``param_spec`` shards become DTensors on ``mesh["model"]`` and
           the family forwards run unchanged on them (the Megatron split:
           qkv / fc1 on the output dim, proj / fc2 on the input dim,
           experts on their first dim).
    stage  pipeline parallelism (``parallel/pipeline.py``); only present
           when above 1.

Where the model axis is 1 every rank holds whole weights as plain tensors,
so its step is the one-device step on its rows and the attention kernels
run as there.

The canonical layout of every block's fused qkv weight ``[D, 3D]`` and
bias ``[3D]`` is torch's ``[3][H][dh]``; ``permute_qkv_head_major`` packs
them ``[H][3][dh]``, which makes the column shard of a model rank whole
heads (and is what the packed train kernel reads).
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

Params = Dict[str, Any]

AXES = ("data", "model", "stage")


# -- the qkv layouts ---------------------------------------------------------


def _repack_w(w: torch.Tensor, heads: int, src: str) -> torch.Tensor:
    d = w.shape[0]
    dh = d // heads
    shape = (d, 3, heads, dh) if src == "canonical" else (d, heads, 3, dh)
    return w.reshape(shape).transpose(1, 2).reshape(d, 3 * d)


def _repack_b(b: torch.Tensor, heads: int, src: str) -> torch.Tensor:
    d = b.shape[0] // 3
    dh = d // heads
    shape = (3, heads, dh) if src == "canonical" else (heads, 3, dh)
    return b.reshape(shape).transpose(0, 1).reshape(3 * d)


def _repack(params: Params, heads: int, src: str) -> Params:
    out = dict(params)
    out["blocks"] = [
        {**blk,
         "qkv_w": _repack_w(blk["qkv_w"], heads, src),
         "qkv_b": _repack_b(blk["qkv_b"], heads, src)}
        for blk in params["blocks"]
    ]
    return out


def permute_qkv_head_major(params: Params, heads: int) -> Params:
    """Re-pack every block's qkv columns [3][H][dh] -> [H][3][dh] (new
    tensors; the other leaves are shared). Pair with
    ``vit.forward(..., qkv_head_major=True)``. Apply to whole tensors,
    before ``shard_params``."""
    return _repack(params, heads, "canonical")


def unpermute_qkv_head_major(params: Params, heads: int) -> Params:
    """Inverse of ``permute_qkv_head_major``: [H][3][dh] -> [3][H][dh], the
    canonical layout every converter and the serving forward expect."""
    return _repack(params, heads, "head_major")


# -- the process group and the mesh ----------------------------------------------


def init_distributed(device="cuda") -> torch.device:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` in the environment) and return this
    rank's device: NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU. Without
    that environment no group is made and the device is ``device`` itself
    (the one-device path). A CUDA device without a card raises
    (``runtime/device.require_device``). A group made earlier in the
    process (``dist.init_process_group``) is kept."""
    from interactive_vit_tpu_torch.runtime.device import require_device

    dev = require_device(device)
    env = os.environ
    if dist.is_initialized():
        return (torch.device("cuda", torch.cuda.current_device())
                if dev.type == "cuda" else dev)
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return dev
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", rank=rank, world_size=world,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world)
    return dev


def parse_mesh(spec: str) -> Optional[Dict[str, int]]:
    """``--mesh``: "data=all" (None: every rank on data) or comma-separated
    ``axis=N`` with axes from ``AXES``; anything else raises ValueError."""
    if spec == "data=all":
        return None
    sizes: Dict[str, int] = {}
    for kv in spec.split(","):
        k, sep, v = kv.partition("=")
        if not sep or k not in AXES or not v.isdigit() or int(v) < 1:
            raise ValueError(
                f"--mesh {spec!r}: expected 'data=all' or comma-separated "
                f"axis=N with axes {list(AXES)} and N >= 1")
        sizes[k] = int(v)
    return sizes


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None):
    """A ``DeviceMesh`` with axes ("data", "model"[, "stage"]), in the JAX
    package's order; "stage" only when above 1. Default: every rank on
    "data" (pure data parallelism). Where the mesh needs fewer ranks than
    were launched, the first ones form it, as JAX takes the first devices
    (``in_mesh`` is False on the others). Needs a process group
    (``init_distributed`` under torchrun, or ``dist.init_process_group``)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if axis_sizes is None:
        axis_sizes = {"data": world, "model": 1}
    unknown = set(axis_sizes) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}")
    names = ["data", "model"]
    shape = [axis_sizes.get("data", 1), axis_sizes.get("model", 1)]
    if axis_sizes.get("stage", 1) > 1:
        names.append("stage")
        shape.append(axis_sizes["stage"])
    need = math.prod(shape)
    if need > world:
        raise ValueError(
            f"mesh {tuple(shape)} needs {need} devices, got {world}")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group: launch with "
            "torchrun (init_distributed) or call dist.init_process_group")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=tuple(names))


def make_run_mesh(spec: str):
    """An entry point's ``--mesh``: the mesh of ``parse_mesh(spec)`` where a
    process group exists (or the spec needs more than one device, which
    then raises as ``make_mesh`` does); None otherwise, the one-device
    path."""
    sizes = parse_mesh(spec)
    if dist.is_initialized() or math.prod((sizes or {}).values()) > 1:
        return make_mesh(sizes)
    return None


def is_chief() -> bool:
    """Rank 0, or a process with no group: the one that logs and writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def in_mesh(mesh) -> bool:
    """Whether this rank is one of ``mesh``'s."""
    return mesh is None or mesh.get_coordinate() is not None


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 for no mesh or an axis it lacks)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's index on ``axis`` (0 for no mesh or an axis it lacks)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def axis_ranks(mesh, axis: str) -> List[int]:
    """The global ranks of this rank's line along ``axis``, in axis
    order (the peers of a ``dist.P2POp``)."""
    return dist.get_process_group_ranks(axis_group(mesh, axis))


def mesh_shape(mesh) -> Dict[str, int]:
    return {n: axis_size(mesh, n) for n in mesh.mesh_dim_names}


def mesh_device(mesh) -> torch.device:
    """This rank's device: its card on a NCCL mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# -- the sharding rules -----------------------------------------------------------


def param_spec(path: str) -> tuple:
    """The PartitionSpec of a parameter, keyed by its "/"-joined tree path
    (JAX's rules; a tuple naming the mesh axis of each dim, () =
    replicated). Int8 leaves (``ops/quant.py``) sit one level deeper
    (``.../qkv_w/int8_q`` [D_in, D_out], ``.../int8_s`` [D_out]) and shard
    like their dense parent."""
    if path.endswith("/int8_q") or path.endswith("/int8a8_q"):
        return param_spec(path[: path.rfind("/")])
    if path.endswith("/int8_s") or path.endswith("/int8a8_s"):
        parent = param_spec(path[: path.rfind("/")])
        # the scale is per output channel: sharded iff the out dim is
        return (parent[1],) if len(parent) == 2 else ()
    if path.endswith("exp_fc1_w") or path.endswith("exp_fc2_w"):
        # expert parallelism: experts over "model" (models/moe.py)
        return ("model", None, None)
    if path.endswith("exp_fc1_b") or path.endswith("exp_fc2_b"):
        return ("model", None)
    if path.endswith("qkv_w") or path.endswith("fc1_w"):
        return (None, "model")           # output features
    if path.endswith("qkv_b") or path.endswith("fc1_b"):
        return ("model",)
    if path.endswith("proj_w") or path.endswith("fc2_w"):
        return ("model", None)           # input features
    return ()


def _walk(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, prefix + "/" + k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, prefix + f"/{i}")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _leaf_spec(path: str) -> tuple:
    return ("stage",) if "/__pp" in path else param_spec(path)


def param_shardings(params: Params):
    """The PartitionSpec of every leaf of ``params`` (a tree of the same
    shape). A subtree under a ``__pp<i>`` key is a layer-stacked pipeline
    capture: its leaves carry a leading layer dim over "stage"."""
    return _walk(params, lambda path, _: _leaf_spec(path))


def _placements(spec: tuple):
    from torch.distributed.tensor import Replicate, Shard

    dims = [i for i, a in enumerate(spec) if a == "model"]
    return [Shard(dims[0])] if dims else [Replicate()]


def shard_params(params: Params, mesh) -> Params:
    """This rank's share of ``params`` (whole tensors, the same on every
    rank). Where the model axis is above 1 every leaf becomes a DTensor on
    ``mesh["model"]`` placed by ``param_spec`` (each rank slices its own
    shard; nothing is sent); a ``__pp`` leaf keeps this stage's layers.
    Otherwise the leaves are returned as they are."""
    from torch.distributed.tensor import distribute_tensor

    tp = axis_size(mesh, "model") > 1
    n_stage, stage = axis_size(mesh, "stage"), axis_index(mesh, "stage")

    def place(path, x):
        spec = _leaf_spec(path)
        if spec == ("stage",):
            n = x.shape[0] // n_stage
            return x[stage * n:(stage + 1) * n]
        if not tp:
            return x
        return distribute_tensor(x, mesh["model"], _placements(spec),
                                 src_data_rank=None)

    return _walk(params, place)


def shard_captures(tree, mesh):
    """The serving placement of one graph node's captures
    (``Executor(mesh=)``, the JAX executor's ``_place_captures``): where
    the model axis is above 1, each tensor leaf that ``param_spec`` shards
    over it becomes a DTensor on ``mesh["model"]`` (each rank slices its
    own shard; nothing is sent) and every other leaf stays a plain tensor,
    whole on every rank: replicated, as DTensor's implicit replication,
    under which such a mesh's pass runs, treats it. Where the model axis is
    1 the tree is returned as it is."""
    from torch.distributed.tensor import distribute_tensor

    if axis_size(mesh, "model") == 1:
        return tree

    def place(path, x):
        spec = param_spec(path)
        if not isinstance(x, torch.Tensor) or "model" not in spec:
            return x
        return distribute_tensor(x, mesh["model"], _placements(spec),
                                 src_data_rank=None)

    return _walk(tree, place)


def gather_whole(x, mesh, rows_sharded: bool = False):
    """A pass's output whole: a DTensor gathered over its mesh
    (``full_tensor``) and, with ``rows_sharded`` (a stacked group whose
    rows ``batch_rows`` scattered over "data"), every data rank's rows
    concatenated in axis order. Every rank of the mesh calls it, in the
    same order, and every rank gets the whole tensor."""
    x = full_tensor(x)
    if rows_sharded:
        x = all_gather_rows(x, mesh, "data")
    return x


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def full_tensor(x):
    """The whole tensor of a DTensor (a collective over its mesh), other
    values unchanged."""
    return x.full_tensor() if is_dtensor(x) else x


def local(x):
    """A DTensor's local shard, other values unchanged."""
    return x.to_local() if is_dtensor(x) else x


def unshard(tree):
    """``tree`` with every DTensor leaf gathered whole (every rank of the
    mesh must call it)."""
    return _walk(tree, lambda _, x: full_tensor(x))


def reshard_like(tree, like):
    """Whole tensors placed as the leaves of ``like``: a DTensor leaf of
    ``like`` gives a DTensor of the same mesh and placements (each rank
    slices its shard), any other leaf is kept."""
    from torch.distributed.tensor import distribute_tensor

    likes: List[Any] = []
    _walk(like, lambda p, x: likes.append(x))
    it = iter(likes)

    def place(_, x):
        lk = next(it)
        if is_dtensor(lk) and not is_dtensor(x):
            return distribute_tensor(x, lk.device_mesh, lk.placements,
                                     src_data_rank=None)
        return x

    return _walk(tree, place)


def batch_rows(mesh, batch: int, accum_steps: int = 1) -> Sequence[int]:
    """The global rows of a ``batch`` that this rank computes, in order:
    for each of the ``accum_steps`` microbatches of ``batch / accum_steps``
    rows, the slice that ``P("data")`` puts on this rank's data index.
    With one microbatch that is the rank's ``P("data")`` rows; with
    several, each microbatch is data-sharded as in the JAX package's
    accumulation scan, so the rank's rows split into microbatches are the
    JAX microbatches' rows on this rank."""
    n_data, d = axis_size(mesh, "data"), axis_index(mesh, "data")
    if batch % (n_data * accum_steps):
        raise ValueError(
            f"batch {batch} is not divisible by the data axis ({n_data}) "
            f"times the accumulation steps ({accum_steps})")
    mb = batch // accum_steps
    ml = mb // n_data
    return [i * mb + d * ml + t for i in range(accum_steps)
            for t in range(ml)]


def batch_sharding(mesh, accum_steps: int = 1) -> Callable:
    """``rows(x)``: this rank's rows (``batch_rows``) of a global batch
    ``x`` (a tensor or numpy array, batch first): a view where they are
    contiguous."""
    def rows(x):
        idx = batch_rows(mesh, x.shape[0], accum_steps)
        if idx == list(range(idx[0], idx[0] + len(idx))):
            return x[idx[0]:idx[0] + len(idx)]
        if isinstance(x, torch.Tensor):
            return x[torch.tensor(idx, device=x.device)]
        return x[idx]

    return rows


def replicated(mesh) -> Callable:
    """``rows(x)`` of a replicated input: every row, on every rank."""
    return lambda x: x


# -- collectives over an axis -------------------------------------------------------


def all_reduce_mean(tensors: List[torch.Tensor], mesh, axis: str = "data"
                    ) -> List[torch.Tensor]:
    """The mean over ``axis`` of each tensor (a DTensor's local shard), as
    new tensors: one all-reduce (SUM; gloo has no AVG) of a flat buffer a
    dtype, then a division by the axis size."""
    n = axis_size(mesh, axis)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(local(t).dtype, []).append(i)
    group = axis_group(mesh, axis)
    for dtype, idx in by_dtype.items():
        parts = [local(tensors[i]) for i in idx]
        flat = torch.cat([p.reshape(-1) for p in parts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat / n
        off = 0
        for i, p in zip(idx, parts):
            piece = flat[off:off + p.numel()].view(p.shape)
            off += p.numel()
            t = tensors[i]
            if is_dtensor(t):
                from torch.distributed.tensor import DTensor

                piece = DTensor.from_local(piece, t.device_mesh, t.placements,
                                           run_check=False, shape=t.shape,
                                           stride=t.stride())
            out[i] = piece
    return out  # type: ignore[return-value]


def mean_over(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """``x`` averaged over ``axis`` in the forward, the identity in the
    backward: the gradient a rank's share of a batch mean needs when the
    ranks' gradients are averaged after (the MoE load-balance term's f_e
    and P_e)."""
    if axis_size(mesh, axis) == 1:
        return x
    mean = all_reduce_mean([x.detach()], mesh, axis)[0]
    return x + (mean - x.detach())


def all_gather_rows(x: torch.Tensor, mesh, axis: str = "data",
                    dim: int = 0) -> torch.Tensor:
    """The concatenation along ``dim`` of every rank's ``x`` on ``axis``, in
    axis order (no gradient)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    x = local(x).contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=axis_group(mesh, axis))
    return torch.cat(parts, dim=dim)
