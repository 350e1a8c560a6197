"""ViT training steps on one device.

Counterpart of the single-device path of
``interactive_vit_tpu/parallel/train.py``: the loss, the optimizer (optax's
AdamW chain written out on the parameter dict), per-block
rematerialisation, mixed precision, gradient accumulation and ``setup``,
the one-device counterpart of ``setup_sharded``. The parameter tree is the
JAX package's (``models/vit.py``: dicts and lists of tensors), so the
paths that pick weight decay and layer-wise LR decay are the same strings
(``"['blocks'][3]['qkv_w']"``). PyTorch runs eagerly, so a train step is a
plain function; it is functional like the JAX one (new params and state
come back, nothing is updated in place). Distillation and MAE steps are
not ported.
"""

from __future__ import annotations

import functools
import math
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.parallel import mesh as mesh_lib
from interactive_vit_tpu_torch.runtime.device import require_device

Params = Dict[str, Any]


# -- the parameter tree ---------------------------------------------------------


def tree_leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in the JAX package's order (dict keys sorted, lists in
    order) with ``jax.tree_util.keystr`` paths."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_leaves_with_path(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in tree_leaves_with_path(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_leaves(tree) -> List[Any]:
    return [x for _, x in tree_leaves_with_path(tree)]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            # fill in sorted order, keep the original key order
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def tree_map_with_path(fn: Callable, tree) -> Any:
    return tree_unflatten(tree, [fn(p, x)
                                 for p, x in tree_leaves_with_path(tree)])


# -- loss -----------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy in f32. ``labels``: int ``[B]`` or soft
    ``[B, C]``; ``smoothing``: label smoothing (uniform mass s/C)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if labels.ndim == 2:
        tgt = labels.float()
        if smoothing:
            tgt = tgt * (1.0 - smoothing) + smoothing / logits.shape[-1]
        return -(tgt * logp).sum(dim=-1).mean()
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    if smoothing:
        # target (1-s) onehot + s/C in closed form
        nll = (1.0 - smoothing) * nll - smoothing * logp.mean(dim=-1)
    return nll.mean()


# -- optimizer ------------------------------------------------------------------


def _decay_mask(params):
    """True where AdamW weight decay applies: rank-2 weights (and rank-4
    convolution kernels); LayerNorm, biases, cls and position tables are
    exempt. Expert matmuls (``exp_fc``) are rank 3."""
    def decayed(path, x):
        nd = x.ndim
        if "exp_fc" in path:
            return nd == 3
        return nd in (2, 4)

    return tree_map_with_path(decayed, params)


def _llrd_layer_id(path_str: str):
    """A parameter path's LLRD group: ("embed",), ("block", i),
    ("stage", s, b) or ("stage_end", s); None for the head and final norm
    (always the full LR)."""
    m = re.search(r"\['blocks'\]\[(\d+)\]", path_str)
    if m:
        return ("block", int(m.group(1)))
    m = re.search(r"\['stages'\]\[(\d+)\]\[(\d+)\]", path_str)
    if m:
        return ("stage", int(m.group(1)), int(m.group(2)))
    m = re.search(r"\['(?:merges|downs)'\]\[(\d+)\]", path_str)
    if m:
        return ("stage_end", int(m.group(1)))
    if re.search(r"\['(?:head|head_dist|norm)'\]", path_str):
        return None
    return ("embed",)


def llrd_factors(params, decay: float):
    """Per-leaf LR multipliers of layer-wise LR decay: the head and final
    norm at 1, block j of L at decay^(L-j), the embedding tier at
    decay^(L+1). A tree of Python floats shaped like ``params``."""
    flat = tree_leaves_with_path(params)
    ids = {p: _llrd_layer_id(p) for p, _ in flat}
    blocks = sorted({i for i in ids.values()
                     if i is not None and i[0] in ("block", "stage")})
    order = {b: j for j, b in enumerate(blocks)}
    for i in set(ids.values()):
        if i is not None and i[0] == "stage_end":
            last = max(b for b in blocks if b[:2] == ("stage", i[1]))
            order[i] = order[last]
    n = len(blocks)

    def factor(path, x):
        i = ids[path]
        if i is None:
            return 1.0
        if i == ("embed",):
            return decay ** (n + 1)
        return decay ** (n - order[i])

    return tree_map_with_path(factor, params)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int):
    """optax's ``warmup_cosine_decay_schedule(0, lr, warmup, total,
    end_value=lr * 0.01)``, evaluated in f32: count -> lr."""
    end = lr * 0.01
    alpha = 0.0 if lr == 0.0 else end / lr
    decay_steps = float(total_steps - warmup_steps)
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs total_steps > "
                         f"warmup_steps, got {total_steps}, {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - _f32(min(max(count, 0), warmup_steps)) / warmup_steps
            return float((0.0 - lr) * frac + lr)
        c = torch.minimum(_f32(count - warmup_steps), _f32(decay_steps))
        cos = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return float(lr * ((1 - alpha) * cos + alpha))

    return schedule


class AdamW:
    """optax's ``chain(clip_by_global_norm(clip_norm), adamw(schedule,
    weight_decay, mask=_decay_mask), scale_by_llrd(llrd))`` on a parameter
    tree, with its rounding points. Where it differs from torch's own
    tools: the schedule is read at the count *before* the update (step 0
    of a warmup takes lr = 0); clipping is ``g`` when the global norm is
    below ``clip_norm``, else ``g / norm * clip_norm``; the decay mask is
    ``_decay_mask``. The state (count, mu, nu) keeps mu and nu in f32
    whatever the parameter dtype."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, schedule: Callable[[int], float], weight_decay: float,
                 clip_norm: float = 0.0, llrd: float = 0.0):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.llrd = llrd

    def init(self, params) -> Dict[str, Any]:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"count": 0,
                "mu": tree_map_with_path(lambda _, p: zeros(p), params),
                "nu": tree_map_with_path(lambda _, p: zeros(p), params)}

    def update(self, grads, state, params):
        """(updates, new state); ``apply_updates`` adds the updates."""
        g = [x.float() for x in tree_leaves(grads)]
        p = tree_leaves(params)
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        if self.clip_norm:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(g)))
            keep = norm < self.clip_norm
            div = torch.where(keep, torch.ones_like(norm), norm)
            mul = torch.where(keep, torch.ones_like(norm),
                              torch.full_like(norm, self.clip_norm))
            g = torch._foreach_mul(torch._foreach_div(g, div), mul)
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                torch._foreach_mul(mu, self.b1))
        g2 = torch._foreach_mul(g, g)
        nu = torch._foreach_add(torch._foreach_mul(g2, 1 - self.b2),
                                torch._foreach_mul(nu, self.b2))
        count = state["count"]
        bc1 = float(1 - _f32(self.b1) ** (count + 1))
        bc2 = float(1 - _f32(self.b2) ** (count + 1))
        den = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(nu, bc2)), self.eps)
        u = list(torch._foreach_div(torch._foreach_div(mu, bc1), den))
        mask = tree_leaves(_decay_mask(params))
        idx = [i for i, m in enumerate(mask) if m]
        if self.weight_decay and idx:
            dec = torch._foreach_add(
                [u[i] for i in idx],
                torch._foreach_mul([p[i].float() for i in idx],
                                   self.weight_decay))
            for i, d in zip(idx, dec):
                u[i] = d
        u = torch._foreach_mul(u, -self.schedule(count))
        if self.llrd:
            u = torch._foreach_mul(
                u, [float(_f32(f)) for f in
                    tree_leaves(llrd_factors(params, self.llrd))])
        new_state = {"count": count + 1,
                     "mu": tree_unflatten(params, mu),
                     "nu": tree_unflatten(params, nu)}
        return tree_unflatten(params, u), new_state


def apply_updates(params, updates):
    """p + u, cast back to each parameter's dtype (optax's); one foreach
    pass where params and updates share their dtypes (f32 masters)."""
    p, u = tree_leaves(params), tree_leaves(updates)
    if all(a.dtype == b.dtype for a, b in zip(p, u)):
        return tree_unflatten(params, torch._foreach_add(p, u))
    return tree_unflatten(params, [(a + b).to(a.dtype)
                                   for a, b in zip(p, u)])


def make_optimizer(lr: float = 3e-4, wd: float = 0.05,
                   warmup_steps: int = 0, total_steps: int = 0,
                   clip_norm: float = 0.0, llrd: float = 0.0) -> AdamW:
    """AdamW (decay masked to rank-2 weights), optionally with global-norm
    clipping, a warmup + cosine schedule (``total_steps=0``: constant lr)
    and layer-wise LR decay (``llrd`` in (0, 1]; 0 = uniform)."""
    schedule: Callable[[int], float] = lambda count: lr  # noqa: E731
    if total_steps:
        schedule = warmup_cosine(lr, max(1, warmup_steps), total_steps)
    if llrd and not 0.0 < llrd <= 1.0:
        raise ValueError(f"llrd must be in (0, 1], got {llrd}")
    return AdamW(schedule, wd, clip_norm, llrd)


# -- the step -------------------------------------------------------------------


def device_memory_bytes(device) -> int:
    """The memory of ``device``: a card's ``total_memory``, the host's RAM
    for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


# the share of the device's memory the train step's working set may take
REMAT_BUDGET = 0.7


def auto_remat(cfg, per_device_batch: int, dtype=torch.float32,
               flash_attn: bool = False, hbm_bytes: Optional[int] = None,
               device="cuda") -> bool:
    """Per-block rematerialisation from a working-set estimate: True (remat
    on) only when the saved activations, params, grads and AdamW moments
    would pass ``REMAT_BUDGET`` of the device's memory (``hbm_bytes``,
    default that of ``device``). The JAX package's estimate."""
    d = getattr(cfg, "width", None)
    depth = getattr(cfg, "depth", None)
    if not (d and depth and hasattr(cfg, "img_size")
            and hasattr(cfg, "patch")):
        return True
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes(device)
    bytes_per = torch.empty((), dtype=dtype).element_size()
    n = (cfg.img_size // cfg.patch) ** 2 + 2
    heads = getattr(cfg, "heads", 1)
    mlp_dim = getattr(cfg, "mlp_dim", 4 * d)
    per_block = per_device_batch * n * (12 * d + 2 * mlp_dim) * bytes_per
    if not flash_attn:
        # autograd of the plain attention saves the f32 probs
        per_block += 2 * per_device_batch * heads * n * n * 4
    n_params = (depth * (4 * d * d + 2 * d * mlp_dim)
                + 2 * n * d + d * getattr(cfg, "num_classes", 1000))
    static = n_params * (2 * bytes_per + 8)
    return depth * per_block + static > REMAT_BUDGET * hbm_bytes


def model_family(cfg):
    """The module implementing ``cfg``'s forward: the plain ViTs only."""
    if isinstance(cfg, vit.ViTConfig):
        return vit
    raise NotImplementedError(
        f"training {type(cfg).__name__} {getattr(cfg, 'name', cfg)!r} is "
        f"not ported: the port trains the plain ViT family only")


def loss_fn(params: Params, images: torch.Tensor, labels: torch.Tensor,
            cfg, attn_impl=None, block_wrapper=None,
            qkv_head_major: bool = False,
            label_smoothing: float = 0.0) -> torch.Tensor:
    logits = model_family(cfg).forward(
        params, images, cfg, attn_impl=attn_impl,
        block_wrapper=block_wrapper, qkv_head_major=qkv_head_major)["logits"]
    return cross_entropy(logits, labels, label_smoothing)


def wants_head_major(cfg, attn_impl=None) -> bool:
    """Whether training runs head-major qkv columns: when the packed
    kernel is in play and takes the shape (there is no mesh here, so the
    tensor-parallel reason of the JAX function does not arise)."""
    model_family(cfg)
    return (getattr(attn_impl, "packed", None) is not None
            and attn_impl.packed_ok(cfg.heads, cfg.width // cfg.heads,
                                    cfg.tokens))


# the products whose outputs remat="dots" keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrapper(remat):
    """The per-block checkpoint wrapper: None for no remat; True for
    ``torch.utils.checkpoint`` (non-reentrant: only the block inputs are
    kept, the block runs again in the backward); "dots" for a selective
    checkpoint that keeps the outputs of ``mm`` / ``addmm`` / ``bmm`` and
    recomputes the elementwise chains (LN, GELU, softmax)."""
    if not remat:
        return None
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts,
    )

    kw: Dict[str, Any] = {"use_reentrant": False}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def wrap(fn):
        return functools.partial(checkpoint, fn, **kw)

    return wrap


def cast_params(params: Params, dtype) -> Params:
    """The floating leaves of ``params`` in ``dtype`` (None: unchanged).
    The mixed-precision compute cast: master params stay f32, the forward
    runs in ``dtype``, and autograd of the cast hands f32 gradients back."""
    if dtype is None:
        return params
    return tree_map_with_path(
        lambda _, x: x.to(dtype) if x.is_floating_point() else x, params)


def make_train_step(cfg, optimizer=None, attn_impl=None, remat=True,
                    qkv_head_major: bool = False, accum_steps: int = 1,
                    label_smoothing: float = 0.0, compute_dtype=None):
    """A train step ``(params, opt_state, images, labels) -> (params,
    opt_state, loss)``.

    ``remat``: see ``remat_wrapper``. ``accum_steps=k``: the batch is split
    into k microbatches run in turn, their gradients summed in f32 and
    averaged before one optimizer update (the full-batch step by linearity
    of the mean loss). ``compute_dtype``: mixed precision (``cast_params``).
    """
    optimizer = optimizer or make_optimizer()
    wrapper = remat_wrapper(remat)

    def value_and_grad(params, images, labels):
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        loss = loss_fn(cast_params(p, compute_dtype), images, labels, cfg,
                       attn_impl=attn_impl, block_wrapper=wrapper,
                       qkv_head_major=qkv_head_major,
                       label_smoothing=label_smoothing)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(x) if g is None else g
                               for x, g in zip(leaves, grads)]

    def step(params, opt_state, images, labels):
        if accum_steps == 1:
            loss, grads = value_and_grad(params, images, labels)
        else:
            mb = images.shape[0] // accum_steps
            acc = [torch.zeros(x.shape, dtype=torch.float32,
                               device=x.device) for x in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=images.device)
            for i in range(accum_steps):
                sl = slice(i * mb, (i + 1) * mb)
                loss_i, g_i = value_and_grad(params, images[sl], labels[sl])
                torch._foreach_add_(acc, [g.float() for g in g_i])
                loss = loss + loss_i
            # back to the param dtype after the f32 sum
            grads = [(a / accum_steps).to(x.dtype)
                     for a, x in zip(acc, tree_leaves(params))]
            loss = loss / accum_steps
        updates, opt_state = optimizer.update(
            tree_unflatten(params, grads), opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return step


def setup(cfg, device="cuda", seed: int = 0, lr: float = 3e-4,
          attn_impl=None, remat=True, optimizer=None, dtype=None,
          accum_steps: int = 1, label_smoothing: float = 0.0,
          compute_dtype=None):
    """Init params and optimizer state on ``device``; returns ``(params,
    opt_state, train_step, infer_fn)``.

    Weights are drawn from a ``torch.Generator`` seeded with ``seed``.
    ``attn_impl``: a callable, None for the plain attention, or a policy
    name for ``ops.dispatch.default_train_attn_impl`` ("auto" = the
    kernels on a CUDA device). ``dtype``: the parameter dtype (None = f32);
    ``compute_dtype``: mixed precision over f32 master params. With the
    packed kernel the params come back in the head-major qkv layout
    (``wants_head_major``); ``infer_fn(params, images) -> logits`` takes
    them so."""
    dev = require_device(device)
    model_family(cfg)
    optimizer = optimizer or make_optimizer(lr)
    params = vit.init_params(cfg, torch.Generator().manual_seed(seed),
                             dtype=dtype or torch.float32, device=dev)
    if isinstance(attn_impl, str):
        from interactive_vit_tpu_torch.ops.dispatch import (
            default_train_attn_impl,
        )

        attn_impl = default_train_attn_impl(
            attn_impl, dtype=compute_dtype or dtype or torch.float32,
            cfg=cfg, device=dev)
    head_major = wants_head_major(cfg, attn_impl)
    if head_major:
        params = mesh_lib.permute_qkv_head_major(params, cfg.heads)
    opt_state = optimizer.init(params)
    step = make_train_step(cfg, optimizer, attn_impl=attn_impl, remat=remat,
                           qkv_head_major=head_major,
                           accum_steps=accum_steps,
                           label_smoothing=label_smoothing,
                           compute_dtype=compute_dtype)

    def infer(params, images):
        with torch.no_grad():
            images = torch.as_tensor(images, device=dev)
            return vit.forward(cast_params(params, compute_dtype), images,
                               cfg, attn_impl=attn_impl,
                               qkv_head_major=head_major)["logits"]

    return params, opt_state, step, infer
