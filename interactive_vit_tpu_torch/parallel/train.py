"""Training steps on one device: the ViT, MoE, Swin and ConvNeXt families,
DeiT distillation and MAE pretraining.

Counterpart of the single-device path of
``interactive_vit_tpu/parallel/train.py``: the loss, the optimizer (optax's
AdamW chain written out on the parameter dict), per-block
rematerialisation, mixed precision, gradient accumulation, ``setup`` (the
one-device counterpart of ``setup_sharded``), the distillation step and
``setup_distill`` (``setup_sharded_distill``), the MAE step and
``setup_mae`` (``setup_sharded_mae``). The parameter trees are the JAX
package's (dicts and lists of tensors), so the paths that pick weight decay
and layer-wise LR decay are the same strings (``"['blocks'][3]['qkv_w']"``).
PyTorch runs eagerly, so a train step is a plain function; it is functional
like the JAX one (new params and state come back, nothing is updated in
place). The device mesh is not ported.
"""

from __future__ import annotations

import functools
import math
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from interactive_vit_tpu_torch.models import convnext, mae, moe, swin, vit
from interactive_vit_tpu_torch.ops.node_ops import fold_in
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
    # an MoE block holds n_experts MLPs
    experts = getattr(cfg, "n_experts", 0) or 1
    n_params = (depth * (4 * d * d + 2 * d * mlp_dim * experts)
                + 2 * n * d + d * getattr(cfg, "num_classes", 1000))
    static = n_params * (2 * bytes_per + 8)
    return depth * per_block + static > REMAT_BUDGET * hbm_bytes


MOE_AUX_WEIGHT = 0.01  # the Switch load-balance loss's coefficient


def model_family(cfg):
    """The module implementing ``cfg``'s forward and init: swin, convnext,
    moe or vit. Other families (ResNet, VGG, CLIP) are served only, in the
    JAX package too."""
    if isinstance(cfg, swin.SwinConfig):
        return swin
    if isinstance(cfg, convnext.ConvNeXtConfig):
        return convnext
    if isinstance(cfg, moe.MoEViTConfig):
        return moe
    if isinstance(cfg, vit.ViTConfig):
        return vit
    raise NotImplementedError(
        f"{type(cfg).__name__} {getattr(cfg, 'name', cfg)!r} is not a "
        f"trainable family (vit, moe, swin, convnext)")


def _plain_forward_family(fam) -> bool:
    """Families whose forward takes no attention or qkv-layout knobs
    (swin's windowed attention, convnext's convolutions): only the remat
    hook."""
    return fam in (swin, convnext)


def _logits(out) -> torch.Tensor:
    """A forward's logits (convnext's forward returns them bare)."""
    return out["logits"] if isinstance(out, dict) else out


def _family_logits(cfg, params, images, attn_impl=None, block_wrapper=None,
                   qkv_head_major: bool = False, want_aux: bool = False):
    """(logits, aux) of ``cfg``'s family's forward: the one place that
    knows which knobs a family takes (swin and convnext only
    ``block_wrapper``). ``aux``: MoE's load-balance term with ``want_aux``,
    else None."""
    fam = model_family(cfg)
    if _plain_forward_family(fam):
        out = fam.forward(params, images, cfg, block_wrapper=block_wrapper)
        return _logits(out), None
    kw = dict(attn_impl=attn_impl, block_wrapper=block_wrapper,
              qkv_head_major=qkv_head_major)
    if fam is moe and want_aux:
        out = moe.forward(params, images, cfg, want_aux=True, **kw)
        return out["logits"], out["aux"]
    return fam.forward(params, images, cfg, **kw)["logits"], None


def loss_fn(params: Params, images: torch.Tensor, labels: torch.Tensor,
            cfg, attn_impl=None, block_wrapper=None,
            qkv_head_major: bool = False,
            label_smoothing: float = 0.0) -> torch.Tensor:
    """Cross-entropy of any trainable family; MoE adds ``MOE_AUX_WEIGHT``
    times its load-balance term."""
    logits, aux = _family_logits(cfg, params, images, attn_impl,
                                 block_wrapper, qkv_head_major,
                                 want_aux=True)
    loss = cross_entropy(logits, labels, label_smoothing)
    return loss if aux is None else loss + MOE_AUX_WEIGHT * aux


def wants_head_major(cfg, attn_impl=None) -> bool:
    """Whether training runs head-major qkv columns: never for swin and
    convnext; otherwise when the packed kernel is in play and takes the
    shape (``packed_ok``). The JAX function also repacks whenever a mesh
    has a model axis above 1; the port has no mesh, so that branch has no
    counterpart. Exports must consult this: the canonical layout on disk
    is torch's ``[3][H][dh]`` (``mesh.unpermute_qkv_head_major``)."""
    if _plain_forward_family(model_family(cfg)):
        return False
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


def _value_and_grad(lf, params, *args):
    """(loss detached, the gradient of each leaf of ``params`` in
    ``tree_leaves`` order) of ``lf(params, *args)``; a leaf the loss does
    not reach gets zeros."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss = lf(tree_unflatten(params, leaves), *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g
                           for x, g in zip(leaves, grads)]


def _split_batch(i: int, mb: int, images, labels):
    """Microbatch ``i`` of ``mb`` images and their labels."""
    sl = slice(i * mb, (i + 1) * mb)
    return images[sl], labels[sl]


def _step(lf, optimizer, accum_steps: int, microbatch=_split_batch):
    """``step(params, opt_state, images, extra) -> (params, opt_state,
    loss)`` of the loss ``lf(params, images, extra)``. ``accum_steps=k``:
    the batch is split into k microbatches run in turn (``microbatch(i,
    mb, images, extra)`` gives microbatch i's arguments), their gradients
    summed in f32 and averaged before one optimizer update (the full-batch
    step by linearity of the mean loss), as the JAX package's
    ``lax.scan``."""
    def step(params, opt_state, images, extra):
        if accum_steps == 1:
            loss, grads = _value_and_grad(lf, params, images, extra)
        else:
            mb = images.shape[0] // accum_steps
            acc = [torch.zeros(x.shape, dtype=torch.float32,
                               device=x.device) for x in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=images.device)
            for i in range(accum_steps):
                loss_i, g_i = _value_and_grad(
                    lf, params, *microbatch(i, mb, images, extra))
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


def make_train_step(cfg, optimizer=None, attn_impl=None, remat=True,
                    qkv_head_major: bool = False, accum_steps: int = 1,
                    label_smoothing: float = 0.0, compute_dtype=None):
    """A train step ``(params, opt_state, images, labels) -> (params,
    opt_state, loss)`` of any trainable family.

    ``remat``: see ``remat_wrapper``. ``accum_steps``: see ``_step``.
    ``compute_dtype``: mixed precision (``cast_params``).
    """
    optimizer = optimizer or make_optimizer()
    wrapper = remat_wrapper(remat)

    def lf(p, images, labels):
        return loss_fn(cast_params(p, compute_dtype), images, labels, cfg,
                       attn_impl=attn_impl, block_wrapper=wrapper,
                       qkv_head_major=qkv_head_major,
                       label_smoothing=label_smoothing)

    return _step(lf, optimizer, accum_steps)


def _resolve_attn(attn_impl, cfg, dtype, device):
    """A policy name through ``ops.dispatch.default_train_attn_impl``; a
    callable or None unchanged."""
    if not isinstance(attn_impl, str):
        return attn_impl
    from interactive_vit_tpu_torch.ops.dispatch import default_train_attn_impl

    return default_train_attn_impl(attn_impl, dtype=dtype, cfg=cfg,
                                   device=device)


def _infer_fn(cfg, dev, attn_impl, head_major: bool, compute_dtype):
    """``infer(params, images) -> logits`` under ``no_grad``: the plain
    forward for swin and convnext, the family's forward with the train
    attention and layout otherwise."""
    def infer(params, images):
        with torch.no_grad():
            images = torch.as_tensor(images, device=dev)
            return _family_logits(cfg, cast_params(params, compute_dtype),
                                  images, attn_impl,
                                  qkv_head_major=head_major)[0]

    return infer


def _init(cfg, seed: int, dtype, dev) -> Params:
    """``cfg``'s family's init from a ``torch.Generator`` seeded with
    ``seed``, on ``dev`` in ``dtype`` (None: f32)."""
    return model_family(cfg).init_params(
        cfg, torch.Generator().manual_seed(seed),
        dtype=dtype or torch.float32, device=dev)


def setup(cfg, device="cuda", seed: int = 0, lr: float = 3e-4,
          attn_impl=None, remat=True, optimizer=None, dtype=None,
          accum_steps: int = 1, label_smoothing: float = 0.0,
          compute_dtype=None):
    """Init params and optimizer state on ``device``; returns ``(params,
    opt_state, train_step, infer_fn)``.

    Any trainable family (``model_family``). Weights are drawn from a
    ``torch.Generator`` seeded with ``seed``. ``attn_impl``: a callable,
    None for the plain attention, or a policy name for
    ``ops.dispatch.default_train_attn_impl`` ("auto" = the kernels on a
    CUDA device). ``dtype``: the parameter dtype (None = f32);
    ``compute_dtype``: mixed precision over f32 master params. With the
    packed kernel the params come back in the head-major qkv layout
    (``wants_head_major``); ``infer_fn(params, images) -> logits`` takes
    them so."""
    dev = require_device(device)
    optimizer = optimizer or make_optimizer(lr)
    params = _init(cfg, seed, dtype, dev)
    attn_impl = _resolve_attn(attn_impl, cfg,
                              compute_dtype or dtype or torch.float32, dev)
    head_major = wants_head_major(cfg, attn_impl)
    if head_major:
        params = mesh_lib.permute_qkv_head_major(params, cfg.heads)
    opt_state = optimizer.init(params)
    step = make_train_step(cfg, optimizer, attn_impl=attn_impl, remat=remat,
                           qkv_head_major=head_major,
                           accum_steps=accum_steps,
                           label_smoothing=label_smoothing,
                           compute_dtype=compute_dtype)
    return (params, opt_state, step,
            _infer_fn(cfg, dev, attn_impl, head_major, compute_dtype))


# -- distillation -----------------------------------------------------------


def _student_logits(p, images, cfg, attn_impl=None, wrapper=None,
                    qkv_head_major: bool = False):
    """The distilled student's forward with the heads un-averaged: (cls,
    dist) logits. ``vit.forward``'s wrapped trunk (embed, each block one
    ``wrapper`` unit, the prefix tokens' final norm), so remat applies."""
    x = vit.embed(p, images, cfg)

    def one(bp, x):
        y, _, _ = vit.block(bp, x, cfg, attn_impl=attn_impl,
                            qkv_head_major=qkv_head_major)
        return y

    if wrapper is not None:
        one = wrapper(one)
    for bp in p["blocks"]:
        x = one(bp, x)
    x = vit.final_norm(p, x[:, :cfg.prefix_tokens], cfg)
    return vit.head_split(p, x)


def make_teacher_fn(teacher_cfg, teacher_params, attn_impl=None):
    """``images -> logits`` of a frozen teacher of any trainable family,
    under ``torch.no_grad`` (nothing of it enters autograd; the params are
    closed over, never updated). The canonical qkv layout on purpose:
    ``attn_impl`` runs on the [B, H, N, dh] split (on the card the train
    attention's forward kernel), never the packed one."""
    model_family(teacher_cfg)  # refuses an untrainable family up front

    def teacher_logits(images):
        with torch.no_grad():
            return _family_logits(teacher_cfg, teacher_params, images,
                                  attn_impl)[0].detach()

    return teacher_logits


def distill_loss(cls_l, dist_l, teacher_l, labels, alpha: float = 0.5,
                 tau: float = 0.0, label_smoothing: float = 0.0):
    """``(1 - alpha) CE(cls, labels) + alpha distill``: ``tau = 0`` hard
    (CE of the distillation head against the teacher's argmax), ``tau >
    0`` soft (CE against the teacher's softmax at ``tau``, f32, scaled by
    tau^2)."""
    if tau > 0:
        logq = torch.log_softmax(dist_l.float() / tau, dim=-1)
        pt = torch.softmax(teacher_l.float() / tau, dim=-1)
        distill = -(pt * logq).sum(dim=-1).mean() * (tau * tau)
    else:
        distill = cross_entropy(dist_l, torch.argmax(teacher_l, dim=-1))
    return ((1.0 - alpha) * cross_entropy(cls_l, labels, label_smoothing)
            + alpha * distill)


def make_distill_train_step(cfg, teacher_cfg, teacher_params,
                            optimizer=None, attn_impl=None, remat=False,
                            qkv_head_major: bool = False,
                            accum_steps: int = 1, alpha: float = 0.5,
                            tau: float = 0.0, label_smoothing: float = 0.0,
                            compute_dtype=None):
    """The DeiT distillation step (Touvron et al. 2021), ``(params,
    opt_state, images, labels) -> (params, opt_state, loss)``: the
    student's class head trains on the labels, its distillation head
    (token 1) on a frozen teacher's predictions (``distill_loss``). The
    teacher is cast once to ``compute_dtype`` and runs through
    ``make_teacher_fn`` with the student's ``attn_impl``."""
    if not cfg.distilled:
        raise ValueError(
            f"{cfg.name} has no distillation token/head (distilled=False) "
            f"— distillation training needs a deit_* style student")
    if teacher_cfg.img_size != cfg.img_size:
        raise ValueError(
            f"teacher resolution {teacher_cfg.img_size} != student "
            f"{cfg.img_size}: both consume the same batch")
    if teacher_cfg.num_classes != cfg.num_classes:
        raise ValueError(
            f"teacher classes {teacher_cfg.num_classes} != student "
            f"{cfg.num_classes}: the dist head trains on teacher logits")
    optimizer = optimizer or make_optimizer()
    wrapper = remat_wrapper(remat)
    # frozen: no master copy needed, cast once
    teacher = make_teacher_fn(teacher_cfg,
                              cast_params(teacher_params, compute_dtype),
                              attn_impl=attn_impl)

    def lf(p, images, labels):
        cls_l, dist_l = _student_logits(
            cast_params(p, compute_dtype), images, cfg, attn_impl=attn_impl,
            wrapper=wrapper, qkv_head_major=qkv_head_major)
        return distill_loss(cls_l, dist_l, teacher(images), labels, alpha,
                            tau, label_smoothing)

    return _step(lf, optimizer, accum_steps)


def setup_distill(cfg, teacher_cfg, teacher_params, device="cuda",
                  seed: int = 0, lr: float = 3e-4, remat=False,
                  optimizer=None, dtype=None, attn_impl=None,
                  accum_steps: int = 1, alpha: float = 0.5, tau: float = 0.0,
                  label_smoothing: float = 0.0, compute_dtype=None):
    """``setup``'s tuple for a distilled student against a frozen teacher
    (JAX's ``setup_sharded_distill`` without the mesh). The student runs
    head-major where the packed kernel applies; the teacher keeps the
    canonical layout, is cast to ``dtype`` on ``device`` and lives only in
    the step's closure: it is in neither the optimizer state nor the
    returned params."""
    dev = require_device(device)
    optimizer = optimizer or make_optimizer(lr)
    params = _init(cfg, seed, dtype, dev)
    attn_impl = _resolve_attn(attn_impl, cfg,
                              compute_dtype or dtype or torch.float32, dev)
    head_major = wants_head_major(cfg, attn_impl)
    if head_major:
        params = mesh_lib.permute_qkv_head_major(params, cfg.heads)
    teacher_params = tree_map_with_path(
        lambda _, x: x.to(dev), cast_params(teacher_params, dtype))
    opt_state = optimizer.init(params)
    step = make_distill_train_step(
        cfg, teacher_cfg, teacher_params, optimizer, attn_impl=attn_impl,
        remat=remat, qkv_head_major=head_major, accum_steps=accum_steps,
        alpha=alpha, tau=tau, label_smoothing=label_smoothing,
        compute_dtype=compute_dtype)
    return (params, opt_state, step,
            _infer_fn(cfg, dev, attn_impl, head_major, compute_dtype))


# -- MAE pretraining ---------------------------------------------------------


def _split_keyed(i: int, mb: int, images, key):
    """Microbatch ``i`` of ``mb`` images and ``fold_in(key, i)``: each
    microbatch draws its own masks, as JAX's scan over the index."""
    return images[i * mb:(i + 1) * mb], fold_in(key, i)


def make_mae_train_step(cfg, optimizer=None, remat=False,
                        accum_steps: int = 1, mask_ratio: float = None,
                        compute_dtype=None):
    """The MAE pretraining step ``(params, opt_state, images, key) ->
    (params, opt_state, loss)``: ``make_train_step``'s structure on the
    masked-reconstruction loss (``mae.forward_pretrain``). ``key``: a
    threefry key (k0, k1) of ``jax.random``'s (``ops/node_ops.prng_key`` /
    ``fold_in``: fold the step into it for a resumable stream); under
    accumulation microbatch i draws from ``fold_in(key, i)``."""
    optimizer = optimizer or make_optimizer()
    wrapper = remat_wrapper(remat)

    def lf(p, images, key):
        return mae.forward_pretrain(
            cast_params(p, compute_dtype), images, cfg, key,
            mask_ratio=mask_ratio, block_wrapper=wrapper)["loss"]

    return _step(lf, optimizer, accum_steps, _split_keyed)


def setup_mae(cfg, device="cuda", seed: int = 0, lr: float = 1.5e-4,
              remat=False, optimizer=None, dtype=None, accum_steps: int = 1,
              mask_ratio: float = None, compute_dtype=None):
    """Init MAE params and optimizer state on ``device``; returns
    ``(params, opt_state, train_step)``. The canonical qkv layout through
    the plain attention, as JAX's ``setup_sharded_mae``: the visible-token
    count varies with the ratio, which the packed kernel's fixed token
    counts do not take."""
    dev = require_device(device)
    optimizer = optimizer or make_optimizer(lr)
    params = mae.init_params(cfg, torch.Generator().manual_seed(seed),
                             dtype=dtype or torch.float32, device=dev)
    opt_state = optimizer.init(params)
    step = make_mae_train_step(cfg, optimizer, remat=remat,
                               accum_steps=accum_steps,
                               mask_ratio=mask_ratio,
                               compute_dtype=compute_dtype)
    return params, opt_state, step
