"""The forward kernel routes of rows 1-7 as ``torch.library`` custom ops.

Port-only (the JAX package's kernels are Pallas calls that ``jax.export``
serializes as they are). Every wrapper of this package chooses its kernel
inside the launch from its operands' addresses (16-byte alignment), which
a traced program cannot read: ``torch.export`` and ``make_fx`` run a
function on fake tensors, which have no storage. So each public wrapper
checks what a shape and a dtype tell (``_check_operands``) and then, on a
CUDA tensor, calls one op of the ``ivt`` namespace:

==============================  ==========================================
``ivt::fused_attn_block``       row 1 (``fused_block.fused_attn_block`` and
                                its s8 mode ``fused_attn_block_s8``: dense,
                                maps, head-mean, an ``attn_heads`` subset,
                                ToMe's key bias and key metric)
``ivt::headwise_attn_block``    row 2 (``fused_block.headwise_attn_block``)
``ivt::flash_attention``        row 3 (``flash_attention.flash_attention``,
                                the row-resident kernel; probs, ``n_real``)
``ivt::flash_attention_online`` row 4 (``flash_attention_online``)
``ivt::fused_window_attn``      row 5 (``fused_window.fused_window_attn``)
``ivt::fused_mlp_block``        row 6 (``fused_mlp.fused_mlp_block``)
``ivt::fused_mlp_w8a8_block``   row 7 (``fused_mlp.fused_mlp_w8a8_block``)
==============================  ==========================================

An op's CUDA implementation is the wrapper's launch as it was: it picks
the route (tensor cores, split TF32 or FMA) from the real operands'
addresses, builds the kernel at first use, launches it and counts the
launch in the route's counter, so the live executor and a loaded exported
program run the same kernels and count them alike. A missing ``nvcc``, a
failed build or a failed launch raises; nothing falls back to the plain
version. Its fake implementation gives the plain version's output shapes,
dtypes and strides. An op returns a fixed tuple: an output that the
arguments do not ask for (maps off, no head-mean, no metric) is an empty
tensor of the activation dtype, and the helpers below give the wrappers'
``None`` back. An op's implementation is the launch whatever the device:
the wrappers give it CUDA tensors only (a CPU tensor runs the plain
version before it is reached), and a launch on another tensor raises.

Rows 8-9, the trainable attention (``attention_vjp._AttentionTrain`` and
``_AttentionTrainPacked``), stay ``torch.autograd.Function``s: only
training reaches them, and the gradient node kinds run the plain twins.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from interactive_vit_tpu_torch.ops import (
    flash_attention as fa, fused_block as fb, fused_mlp as fm,
    fused_window as fw, quant,
)

Params = Dict[str, torch.Tensor]

NAMESPACE = "ivt"
ROW1_KEYS = ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b")
WINDOW_KEYS = ("qkv_w", "qkv_b", "proj_w", "proj_b")
MLP_KEYS = ("ln2_s", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")
# each op and the kernel row of PERF.md's table it carries
ROWS = {"fused_attn_block": 1, "headwise_attn_block": 2,
        "flash_attention": 3, "flash_attention_online": 4,
        "fused_window_attn": 5, "fused_mlp_block": 6,
        "fused_mlp_w8a8_block": 7}


def _none(x: torch.Tensor) -> torch.Tensor:
    """The placeholder of an output that was not asked for."""
    return x.new_empty(0)


def _some(t: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return _none(x) if t is None else t


def _heads_arg(attn_heads) -> Optional[List[int]]:
    return None if attn_heads is None else [int(h) for h in attn_heads]


# -- row 1 -----------------------------------------------------------------------


@torch.library.custom_op("ivt::fused_attn_block", mutates_args=())
def _row1(x: torch.Tensor, ln1_s: torch.Tensor, ln1_b: torch.Tensor,
          qkv_w: torch.Tensor, qkv_b: torch.Tensor, proj_w: torch.Tensor,
          proj_b: torch.Tensor, heads: int, eps: float, want_attn: bool,
          want_mean: bool, fast_softmax: bool,
          attn_heads: Optional[List[int]], key_bias: Optional[torch.Tensor],
          want_metric: bool, int8_mode: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    p = dict(zip(ROW1_KEYS, (ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b)))
    kw = dict(want_attn=want_attn, want_mean=want_mean,
              fast_softmax=fast_softmax, attn_heads=attn_heads,
              key_bias=key_bias, want_metric=want_metric)
    out = fb._launch_counted(fb._block_route_of(x, p, heads), int8_mode > 0,
                             x, p, heads, eps, int8_mode == 2, kw)
    y, probs, rest = out[0], out[1], list(out[2:])
    mean = rest.pop(0) if want_mean else None
    metric = rest.pop(0) if want_metric else None
    return y, _some(probs, x), _some(mean, x), _some(metric, x)


@_row1.register_fake
def _row1_fake(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, heads, eps,
               want_attn, want_mean, fast_softmax, attn_heads, key_bias,
               want_metric, int8_mode):
    b, n, d = x.shape
    emit = fb._emit_heads(heads, want_attn, attn_heads)
    probs = (x.new_empty((b, heads if emit is None else len(emit), n, n))
             if want_attn else _none(x))
    mean = x.new_empty((b, n, n)) if want_mean else _none(x)
    metric = (x.new_empty((b, n, d // heads), dtype=torch.float32)
              if want_metric else _none(x))
    return torch.empty_like(x), probs, mean, metric


def fused_attn_block(x: torch.Tensor, p: Params, heads: int, eps: float,
                     int8_mode: int, want_attn: bool, want_mean: bool,
                     fast_softmax: bool, attn_heads, key_bias,
                     want_metric: bool):
    """``ivt::fused_attn_block`` on checked operands, with the wrappers'
    result: ``(y, probs | None)`` [+ mean] [+ metric]. ``int8_mode``: 0
    dense, 1 s8 scores with a dense PV product, 2 s8 scores and PV."""
    y, probs, mean, metric = torch.ops.ivt.fused_attn_block(
        x, *(p[k] for k in ROW1_KEYS), int(heads), float(eps),
        bool(want_attn), bool(want_mean), bool(fast_softmax),
        _heads_arg(attn_heads), key_bias, bool(want_metric), int(int8_mode))
    out = [y, probs if want_attn else None]
    if want_mean:
        out.append(mean)
    if want_metric:
        out.append(metric)
    return tuple(out)


# -- row 2 -----------------------------------------------------------------------


@torch.library.custom_op("ivt::headwise_attn_block", mutates_args=())
def _row2(x: torch.Tensor, ln1_s: torch.Tensor, ln1_b: torch.Tensor,
          qkv_w: torch.Tensor, qkv_b: torch.Tensor, proj_w: torch.Tensor,
          proj_b: torch.Tensor, heads: int, eps: float, want_attn: bool,
          want_mean: bool, fast_softmax: bool,
          attn_heads: Optional[List[int]]
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    p = dict(zip(ROW1_KEYS, (ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b)))
    out = fb.headwise_launch(x, p, heads, eps, want_attn=want_attn,
                             want_mean=want_mean, fast_softmax=fast_softmax,
                             attn_heads=attn_heads)
    return (out[0], _some(out[1], x),
            out[2] if want_mean else _none(x))


@_row2.register_fake
def _row2_fake(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, heads, eps,
               want_attn, want_mean, fast_softmax, attn_heads):
    b, n, d = x.shape
    emit = fb._emit_heads(heads, want_attn, attn_heads)
    probs = (x.new_empty((b, heads if emit is None else len(emit), n, n))
             if want_attn else _none(x))
    mean = x.new_empty((b, n, n)) if want_mean else _none(x)
    return torch.empty_like(x), probs, mean


def headwise_attn_block(x: torch.Tensor, p: Params, heads: int, eps: float,
                        want_attn: bool, want_mean: bool, fast_softmax: bool,
                        attn_heads):
    """``ivt::headwise_attn_block`` on checked operands, with the wrapper's
    result: ``(y, probs | None)`` [+ mean]."""
    y, probs, mean = torch.ops.ivt.headwise_attn_block(
        x, *(p[k] for k in ROW1_KEYS), int(heads), float(eps),
        bool(want_attn), bool(want_mean), bool(fast_softmax),
        _heads_arg(attn_heads))
    out = (y, probs if want_attn else None)
    return out + (mean,) if want_mean else out


# -- rows 3 and 4 ------------------------------------------------------------------


def _token_major(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised [B, H, N, dh] view of a [B, N, H, dh] tensor: the
    layout the flash kernels write o in."""
    b, h, n, dh = q.shape
    return q.new_empty((b, n, h, dh)).transpose(1, 2)


@torch.library.custom_op("ivt::flash_attention", mutates_args=())
def _row3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          want_attn: bool, n_real: int) -> Tuple[torch.Tensor, torch.Tensor]:
    o, probs = fa.rowfull_launch(q, k, v, want_attn, n_real)
    return o, _some(probs, q)


@_row3.register_fake
def _row3_fake(q, k, v, want_attn, n_real):
    b, h, n, _ = q.shape
    return (_token_major(q),
            q.new_empty((b, h, n, n)) if want_attn else _none(q))


@torch.library.custom_op("ivt::flash_attention_online", mutates_args=())
def _row4(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          n_real: int) -> torch.Tensor:
    return fa.online_launch(q, k, v, n_real)


@_row4.register_fake
def _row4_fake(q, k, v, n_real):
    return _token_major(q)


def flash_attention(q, k, v, want_attn: bool, n_real: int):
    """``ivt::flash_attention`` on checked operands: ``(o, probs | None)``."""
    o, probs = torch.ops.ivt.flash_attention(q, k, v, bool(want_attn),
                                             int(n_real))
    return o, (probs if want_attn else None)


def flash_attention_online(q, k, v, n_real: int) -> torch.Tensor:
    """``ivt::flash_attention_online`` on checked operands: o."""
    return torch.ops.ivt.flash_attention_online(q, k, v, int(n_real))


# -- row 5 -----------------------------------------------------------------------


@torch.library.custom_op("ivt::fused_window_attn", mutates_args=())
def _row5(y: torch.Tensor, qkv_w: torch.Tensor, qkv_b: torch.Tensor,
          proj_w: torch.Tensor, proj_b: torch.Tensor, heads: int,
          window: int, bias: torch.Tensor, mask: Optional[torch.Tensor],
          want_attn: bool, fast_softmax: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    p = dict(zip(WINDOW_KEYS, (qkv_w, qkv_b, proj_w, proj_b)))
    a, probs = fw.window_launch(y, p, heads, window, bias, mask, want_attn,
                                fast_softmax)
    return a, _some(probs, y)


@_row5.register_fake
def _row5_fake(y, qkv_w, qkv_b, proj_w, proj_b, heads, window, bias, mask,
               want_attn, fast_softmax):
    b, hres, wres, _ = y.shape
    t = window * window
    nw = (hres // window) * (wres // window)
    return (torch.empty_like(y),
            y.new_empty((b, nw, heads, t, t)) if want_attn else _none(y))


def fused_window_attn(y, p: Params, heads: int, window: int, bias, mask,
                      want_attn: bool, fast_softmax: bool):
    """``ivt::fused_window_attn`` on checked operands: ``(a, probs |
    None)``; ``mask`` a tensor on y's device or None."""
    a, probs = torch.ops.ivt.fused_window_attn(
        y, *(p[k] for k in WINDOW_KEYS), int(heads), int(window), bias, mask,
        bool(want_attn), bool(fast_softmax))
    return a, (probs if want_attn else None)


# -- rows 6 and 7 ------------------------------------------------------------------


@torch.library.custom_op("ivt::fused_mlp_block", mutates_args=())
def _row6(x: torch.Tensor, ln2_s: torch.Tensor, ln2_b: torch.Tensor,
          fc1_w: torch.Tensor, fc1_b: torch.Tensor, fc2_w: torch.Tensor,
          fc2_b: torch.Tensor, eps: float) -> torch.Tensor:
    return fm.mlp_launch(x, dict(zip(MLP_KEYS, (ln2_s, ln2_b, fc1_w, fc1_b,
                                                fc2_w, fc2_b))), eps)


@_row6.register_fake
def _row6_fake(x, ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, eps):
    return torch.empty_like(x)


def fused_mlp_block(x, p: Params, eps: float) -> torch.Tensor:
    """``ivt::fused_mlp_block`` on checked operands: y."""
    return torch.ops.ivt.fused_mlp_block(x, *(p[k] for k in MLP_KEYS),
                                         float(eps))


@torch.library.custom_op("ivt::fused_mlp_w8a8_block", mutates_args=())
def _row7(x: torch.Tensor, ln2_s: torch.Tensor, ln2_b: torch.Tensor,
          fc1_q: torch.Tensor, fc1_s: torch.Tensor, fc1_b: torch.Tensor,
          fc2_q: torch.Tensor, fc2_s: torch.Tensor, fc2_b: torch.Tensor,
          eps: float) -> torch.Tensor:
    p = {"ln2_s": ln2_s, "ln2_b": ln2_b, "fc1_b": fc1_b, "fc2_b": fc2_b,
         "fc1_w": {quant.AQKEY: fc1_q, quant.ASKEY: fc1_s},
         "fc2_w": {quant.AQKEY: fc2_q, quant.ASKEY: fc2_s}}
    return fm.w8a8_launch(x, p, eps)


@_row7.register_fake
def _row7_fake(x, ln2_s, ln2_b, fc1_q, fc1_s, fc1_b, fc2_q, fc2_s, fc2_b,
               eps):
    return torch.empty_like(x)


def fused_mlp_w8a8_block(x, p: Params, eps: float) -> torch.Tensor:
    """``ivt::fused_mlp_w8a8_block`` on checked operands (W8A8 leaf-dicts
    for fc1_w and fc2_w): y."""
    w1, w2 = p["fc1_w"], p["fc2_w"]
    return torch.ops.ivt.fused_mlp_w8a8_block(
        x, p["ln2_s"], p["ln2_b"], w1[quant.AQKEY], w1[quant.ASKEY],
        p["fc1_b"], w2[quant.AQKEY], w2[quant.ASKEY], p["fc2_b"], float(eps))


def count_ivt_nodes(graph) -> Dict[str, int]:
    """{op name: call count} of the ``ivt`` ops in an FX graph (an
    exported program's ``graph``)."""
    counts: Dict[str, int] = {}
    for node in graph.nodes:
        target = node.target
        if node.op == "call_function" and getattr(
                target, "namespace", None) == NAMESPACE:
            name = target.name().split("::", 1)[1].split(".")[0]
            counts[name] = counts.get(name, 0) + 1
    return counts
