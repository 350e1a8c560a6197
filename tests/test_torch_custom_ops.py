"""The forward kernel routes as ``torch.library`` custom ops
(``ops/custom_ops.py``), on the CPU.

The card is not needed to check the card's program: a public wrapper
called on fake CUDA tensors (``FakeTensorMode``) goes through its ``ivt``
op, whose fake implementation must give the plain version's output shapes
and dtypes in every mode (maps off or on, head-mean, an ``attn_heads``
subset, ToMe's key bias and metric, s8, ``n_real``, a seam mask, W8A8);
the plain versions themselves are held against the JAX kernels by the
other ``test_torch_*`` files, and row 1's shapes here against
``jax.eval_shape`` of the JAX function too. A module that calls the
wrappers, exported with fake CUDA tensors, holds the ``ivt`` nodes (two
row-1 ops and two row-6 ops for a 2-block ViT, no ATen attention), and
``torch.export.save`` / ``load`` keep them. On the CPU the wrappers take
the plain versions (no ``ivt`` node), and an op never falls back: called
without a kernel it raises.
"""

import io

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

from interactive_vit_tpu.ops import fused_block as jfb
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.ops import (
    custom_ops, flash_attention as fa, fused_block as fb, fused_mlp as fm,
    fused_window as fw, quant,
)

torch.set_num_threads(2)

B, N, D, H = 2, 17, 64, 4
WIN = 7


def _t(rng, shape, dtype=torch.float32, scale=0.1):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)


def _block_params(rng, dtype):
    return {"ln1_s": 1 + _t(rng, (D,), dtype), "ln1_b": _t(rng, (D,), dtype),
            "qkv_w": _t(rng, (D, 3 * D), dtype),
            "qkv_b": _t(rng, (3 * D,), dtype),
            "proj_w": _t(rng, (D, D), dtype), "proj_b": _t(rng, (D,), dtype),
            "ln2_s": 1 + _t(rng, (D,), dtype), "ln2_b": _t(rng, (D,), dtype),
            "fc1_w": _t(rng, (D, 4 * D), dtype),
            "fc1_b": _t(rng, (4 * D,), dtype),
            "fc2_w": _t(rng, (4 * D, D), dtype), "fc2_b": _t(rng, (D,), dtype)}


def _operands(case, dtype=torch.float32):
    """(wrapper, args, kwargs, op name) of one case, on CPU tensors."""
    rng = np.random.default_rng(0)
    kind, kw = case
    if kind in ("row1", "row1_s8", "row2"):
        x, p = _t(rng, (B, N, D), dtype, 1.0), _block_params(rng, dtype)
        kw = dict(kw)
        if kw.pop("tome", False):
            kw["key_bias"] = _t(rng, (B, N))
            kw["want_metric"] = True
        fn = {"row1": fb.fused_attn_block, "row1_s8": fb.fused_attn_block_s8,
              "row2": fb.headwise_attn_block}[kind]
        op = "headwise_attn_block" if kind == "row2" else "fused_attn_block"
        return fn, (x, p, H, 1e-6), kw, op
    if kind in ("row3", "row4"):
        q, k, v = (_t(rng, (B, H, N, 16), dtype, 1.0) for _ in range(3))
        if kind == "row3":
            return fa.flash_attention, (q, k, v), kw, "flash_attention"
        return (fa.flash_attention_online, (q, k, v), kw,
                "flash_attention_online")
    if kind == "row5":
        y = _t(rng, (B, 14, 14, D), dtype, 1.0)
        p = {k: _t(rng, s, dtype) for k, s in (
            ("qkv_w", (D, 3 * D)), ("qkv_b", (3 * D,)), ("proj_w", (D, D)),
            ("proj_b", (D,)))}
        bias = _t(rng, (2, WIN * WIN, WIN * WIN))
        kw = dict(kw)
        if kw.pop("masked", False):
            kw["mask"] = torch.where(_t(rng, (4, WIN * WIN, WIN * WIN)) > 0,
                                     0.0, -100.0)
        return fw.fused_window_attn, (y, p, 2, WIN, bias), kw, \
            "fused_window_attn"
    x, p = _t(rng, (B, N, D), dtype, 1.0), _block_params(rng, dtype)
    if kind == "row6":
        return fm.fused_mlp_block, (x, p, 1e-6), kw, "fused_mlp_block"
    p = dict(p, fc1_w=quant.quantize_weight(p["fc1_w"], "w8a8"),
             fc2_w=quant.quantize_weight(p["fc2_w"], "w8a8"))
    return fm.fused_mlp_w8a8_block, (x, p, 1e-6), kw, "fused_mlp_w8a8_block"


CASES = {
    "row1_dense": ("row1", {}),
    "row1_maps": ("row1", {"want_attn": True}),
    "row1_subset": ("row1", {"want_attn": True, "attn_heads": (2, 0)}),
    "row1_mean": ("row1", {"want_attn": True, "want_mean": True}),
    "row1_mean_only": ("row1", {"want_mean": True}),
    "row1_tome": ("row1", {"tome": True}),
    "row1_tome_maps": ("row1", {"tome": True, "want_attn": True,
                                "fast_softmax": False}),
    "row1_s8": ("row1_s8", {}),
    "row1_s8_maps_nopv": ("row1_s8", {"want_attn": True, "int8_pv": False}),
    "row1_s8_tome_mean": ("row1_s8", {"tome": True, "want_mean": True}),
    "row2_dense": ("row2", {}),
    "row2_maps": ("row2", {"want_attn": True}),
    "row2_subset": ("row2", {"want_attn": True, "attn_heads": (1,)}),
    "row2_mean": ("row2", {"want_attn": True, "want_mean": True}),
    "row3_dense": ("row3", {}),
    "row3_maps": ("row3", {"want_attn": True}),
    "row3_n_real": ("row3", {"want_attn": True, "n_real": 11}),
    "row4_dense": ("row4", {}),
    "row4_n_real": ("row4", {"n_real": 9}),
    "row5_dense": ("row5", {}),
    "row5_maps_masked": ("row5", {"want_attn": True, "masked": True,
                                  "fast_softmax": False}),
    "row6": ("row6", {}),
    "row7": ("row7", {}),
}


def _fake(tree, mode):
    """Fake CUDA tensors of ``tree``'s shapes and dtypes."""
    if isinstance(tree, torch.Tensor):
        with mode:
            return torch.empty(tree.shape, dtype=tree.dtype, device="cuda")
    if isinstance(tree, dict):
        return {k: _fake(v, mode) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_fake(v, mode) for v in tree)
    return tree


def _outs(res):
    return res if isinstance(res, tuple) else (res,)


def _meta(res):
    return [None if t is None else (tuple(t.shape), t.dtype)
            for t in _outs(res)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fake_gives_the_plain_versions_shapes(case, dtype):
    """The wrapper on fake CUDA tensors (through its op's fake
    implementation) gives the shapes, dtypes and None-ness of the plain
    version on the same operands on the CPU."""
    fn, args, kw, _ = _operands(CASES[case], dtype)
    want = _meta(fn(*args, **kw))
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fargs, fkw = _fake(args, mode), _fake(kw, mode)
    with mode:
        got = fn(*fargs, **fkw)
    assert all(t is None or t.device.type == "cuda" for t in _outs(got))
    assert _meta(got) == want


@pytest.mark.parametrize("case", ["row1_dense", "row1_subset", "row1_mean",
                                  "row1_tome", "row1_s8_tome_mean"])
def test_row1_fake_shapes_match_the_jax_function(case):
    """Row 1's fake outputs have ``jax.eval_shape``'s shapes of the JAX
    kernel's function with the same arguments."""
    fn, (x, p, heads, eps), kw, _ = _operands(CASES[case])
    s8 = fn is fb.fused_attn_block_s8
    jkw = dict(kw, int8_scores=s8)
    jx = jax.ShapeDtypeStruct(tuple(x.shape), jnp.float32)
    jp = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
          for k, v in p.items()}
    kb = (jax.ShapeDtypeStruct((B, N), jnp.float32)
          if jkw.pop("key_bias", None) is not None else None)
    want = jax.eval_shape(lambda a, b, c: jfb.fused_attn_block(
        a, b, heads, eps, key_bias=c, **jkw), jx, jp, kb)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fargs, fkw = _fake((x, p), mode), _fake(kw, mode)
    with mode:
        got = fn(*fargs, heads, eps, **fkw)
    assert [None if t is None else tuple(t.shape) for t in got] == [
        None if t is None else tuple(t.shape) for t in want]


class _Call(torch.nn.Module):
    """``fn(*args, **kw)`` with the tensor (and tensor-dict) arguments,
    positional then keyword, as the module's inputs."""

    def __init__(self, fn, args, kw):
        super().__init__()
        self.fn, self.args, self.kw = fn, args, kw

    def forward(self, *tensors):
        it = iter(tensors)
        args = [next(it) if _is_input(a) else a for a in self.args]
        kw = {k: next(it) if _is_input(v) else v for k, v in self.kw.items()}
        return tuple(t for t in _outs(self.fn(*args, **kw)) if t is not None)


def _is_input(a):
    return isinstance(a, (torch.Tensor, dict))


def _inputs(args, kw):
    return tuple(a for a in (*args, *kw.values()) if _is_input(a))


def _save_load(ep):
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    return torch.export.load(buf)


@pytest.mark.parametrize("case", ["row1_maps", "row1_s8_tome_mean",
                                  "row2_subset", "row3_n_real",
                                  "row4_dense", "row5_maps_masked", "row6",
                                  "row7"])
def test_wrapper_exports_its_op_with_fake_cuda_tensors(case):
    """A module calling the public wrapper, exported with fake CUDA
    tensors, holds one node of the wrapper's op; save / load keep it."""
    fn, args, kw, op = _operands(CASES[case])
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    ep = torch.export.export(_Call(fn, args, kw),
                             _fake(_inputs(args, kw), mode), strict=False)
    assert custom_ops.count_ivt_nodes(ep.graph) == {op: 1}
    assert custom_ops.count_ivt_nodes(_save_load(ep).graph) == {op: 1}


def test_two_block_vit_exports_two_row1_and_two_row6_ops():
    """``vit.block`` twice with the fused block and MLP wrappers, traced
    on fake CUDA tensors: two ``ivt::fused_attn_block`` and two
    ``ivt::fused_mlp_block`` nodes, and no ATen attention op (softmax,
    matmul, bmm, addmm) for those blocks."""
    cfg = tvit.ViTConfig("vit_ops", img_size=32, patch=16, width=D, depth=2,
                         heads=H, num_classes=8)
    params = tvit.init_params(cfg, torch.Generator().manual_seed(0))
    blocks = [params["blocks"][i] for i in range(2)]

    class TwoBlocks(torch.nn.Module):
        def forward(self, x, ps):
            for p in ps:
                x, _, _ = tvit.block(p, x, cfg, block_impl=fb.fused_attn_block,
                                     mlp_impl=fm.fused_mlp_block)
            return x

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        x = torch.empty((B, 5, D), device="cuda")
    ep = torch.export.export(TwoBlocks(), (x, _fake(tuple(blocks), mode)),
                             strict=False)
    want = {"fused_attn_block": 2, "fused_mlp_block": 2}
    assert custom_ops.count_ivt_nodes(ep.graph) == want
    aten = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert not [t for t in aten if any(
        s in t for s in ("softmax", "matmul", "bmm", "addmm", ".mm."))]
    assert custom_ops.count_ivt_nodes(_save_load(ep).graph) == want


@pytest.mark.parametrize("case", ["row1_tome_maps", "row2_mean", "row3_maps",
                                  "row5_dense", "row6", "row7"])
def test_cpu_program_keeps_the_plain_version(case):
    """On CPU tensors the wrappers run the plain versions: the exported
    CPU program holds no ``ivt`` node and gives the eager bits."""
    fn, args, kw, _ = _operands(CASES[case])
    mod = _Call(fn, args, kw)
    tensors = _inputs(args, kw)
    ep = torch.export.export(mod, tensors, strict=False)
    assert custom_ops.count_ivt_nodes(ep.graph) == {}
    for got, want in zip(ep.module()(*tensors), mod(*tensors)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["row1_dense", "row2_dense", "row3_dense",
                                  "row4_dense", "row5_dense", "row6",
                                  "row7"])
def test_an_op_without_its_kernel_raises(case):
    """Called on tensors it cannot launch on (here: no nvcc, no card),
    an op raises; it never computes the plain version instead."""
    fn, args, kw, op = _operands(CASES[case])
    helper = getattr(custom_ops, op)
    with pytest.raises((RuntimeError, ValueError)):
        if op in ("fused_attn_block",):
            helper(args[0], args[1], H, 1e-6, 0, want_attn=False,
                   want_mean=False, fast_softmax=True, attn_heads=None,
                   key_bias=None, want_metric=False)
        elif op == "headwise_attn_block":
            helper(args[0], args[1], H, 1e-6, False, False, True, None)
        elif op == "flash_attention":
            helper(*args, False, N)
        elif op == "flash_attention_online":
            helper(*args, N)
        elif op == "fused_window_attn":
            helper(*args, None, False, True)
        else:
            helper(*args)


def test_every_op_is_registered_and_pure():
    """Each op of ``ROWS`` exists in the ``ivt`` namespace, writes none of
    its arguments, and returns tensors only (a fixed list: an output not
    asked for is an empty tensor, never None)."""
    assert len(custom_ops.ROWS) == 7
    for name in custom_ops.ROWS:
        schema = getattr(torch.ops.ivt, name).default._schema
        assert not any(a.alias_info is not None and a.alias_info.is_write
                       for a in schema.arguments)
        assert schema.returns and all(
            str(r.type) == "Tensor" for r in schema.returns)
