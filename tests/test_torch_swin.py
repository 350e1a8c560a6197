"""The port's Swin model against the JAX package's, on shared weights.

A tiny Swin config (two stages, window 4, a shifted block in stage 0) is
initialised by the JAX initializer, converted through
``models/weights.from_jax`` and run through both packages on the same
numpy images: the static tables and the bicubic resampling matrices must be
equal exactly (both sides build them with numpy), everything computed in
f32 agrees at atol 1e-4 (the two frameworks differ only in the order of f32
sums).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import swin as jswin
from interactive_vit_tpu.ops import layers as jlayers
from interactive_vit_tpu.ops import preprocess_mm as jpre
from interactive_vit_tpu_torch.models import swin as tswin
from interactive_vit_tpu_torch.models.swin_plugin import make_swin_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import fused_window as fw
from interactive_vit_tpu_torch.ops import layers as tlayers
from interactive_vit_tpu_torch.ops import preprocess_mm as tpre

torch.set_num_threads(2)

ATOL = 1e-4
GEOM = dict(img_size=32, patch=4, embed_dim=16, depths=(2, 2), heads=(2, 4),
            window=4, num_classes=10)
JCFG = jswin.SwinConfig("swin_port", **GEOM)
TCFG = tswin.SwinConfig("swin_port", **GEOM)


@pytest.fixture(scope="module")
def shared():
    """(JAX params, the same as tensors, images [2, 3, 32, 32])."""
    jparams = jswin.init_params(jax.random.key(11), JCFG)
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    imgs = np.random.default_rng(11).random((2, 3, 32, 32), np.float32)
    return jparams, tparams, imgs


def test_variants_and_geometry_match_jax():
    assert set(tswin.VARIANTS) == set(jswin.VARIANTS)
    for name, jcfg in jswin.VARIANTS.items():
        tcfg = tswin.VARIANTS[name]
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        for s, depth in enumerate(jcfg.depths):
            assert tcfg.stage_res(s) == jcfg.stage_res(s)
            assert tcfg.stage_dim(s) == jcfg.stage_dim(s)
            assert ([tcfg.stage_shift(s, b) for b in range(depth)]
                    == [jcfg.stage_shift(s, b) for b in range(depth)])
    # stage 3 at 224 px is one window: the shift clamps to 0
    assert tswin.VARIANTS["swin_t"].stage_shift(3, 1) == 0
    assert tswin.VARIANTS["swin_t"].stage_shift(2, 5) == 3


@pytest.mark.parametrize("window", [4, 7, 12])
def test_relative_position_index_equals_jax(window):
    np.testing.assert_array_equal(tswin.relative_position_index(window),
                                  jswin.relative_position_index(window))


@pytest.mark.parametrize("res,window,shift", [(8, 4, 2), (56, 7, 3),
                                              (28, 7, 3), (14, 7, 0)])
def test_shift_attn_mask_equals_jax(res, window, shift):
    got = tswin.shift_attn_mask(res, window, shift)
    want = jswin.shift_attn_mask(res, window, shift)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("sizes", [(40, 33), (300, 232), (224, 232),
                                   (64, 64)])
def test_resize_matrix_equals_jax(method, sizes):
    got = tpre.resize_matrix(*sizes, method)
    want = jpre.resize_matrix(*sizes, method)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [(40, 48, 32, None), (40, 48, 32, 33),
                                  (300, 200, 224, 232), (224, 224, 224, 224)])
def test_target_dims_equals_jax(args):
    assert tlayers.target_dims(*args) == jlayers.target_dims(*args)


@pytest.mark.parametrize("shape", [(2, 3, 40, 48), (3, 50, 36)])
def test_preprocess_mm_bicubic_matches_jax(shape):
    img = np.random.default_rng(0).random(shape, np.float32)
    want = jpre.preprocess_mm(jnp.asarray(img), 32, resize_to=33,
                              method="bicubic")
    got = tpre.preprocess_mm(torch.from_numpy(img), 32, resize_to=33,
                             method="bicubic")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_from_jax_keeps_the_swin_tree(shared):
    jparams, tparams, _ = shared
    assert isinstance(tparams["stages"], list)
    assert [len(st) for st in tparams["stages"]] == list(JCFG.depths)
    assert isinstance(tparams["stages"][0], list)
    assert len(tparams["merges"]) == len(JCFG.depths) - 1
    jl, jdef = jax.tree.flatten(jparams)
    tl, tdef = jax.tree.flatten(tparams)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert isinstance(b, torch.Tensor) and b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # a headless config's head is an empty dict and stays one
    headless = jswin.init_params(
        jax.random.key(0), dataclasses.replace(JCFG, num_classes=0))
    assert from_jax(jax.tree.map(np.asarray, headless))["head"] == {}


def test_init_params_layout_matches_jax(shared):
    jparams, _, _ = shared
    mine = tswin.init_params(TCFG, torch.Generator().manual_seed(0))
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jparams))
    tl, tdef = jax.tree.flatten(mine)
    assert jdef == tdef
    assert [tuple(t.shape) for t in tl] == [a.shape for a in jl]
    again = tswin.init_params(TCFG, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(tl, jax.tree.leaves(again)))
    headless = tswin.init_params(dataclasses.replace(TCFG, num_classes=0),
                                 torch.Generator().manual_seed(0))
    assert headless["head"] == {}


@pytest.mark.parametrize("window_impl", [None, fw.fused_window_attn],
                         ids=["unfused", "fused"])
def test_forward_matches_jax(shared, window_impl):
    jparams, tparams, imgs = shared
    want = jswin.forward(jparams, jnp.asarray(imgs), JCFG, want_attn=True)
    got = tswin.forward(tparams, torch.from_numpy(imgs), TCFG,
                        want_attn=True, window_impl=window_impl)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL)
    assert len(got["attn"]) == len(want["attn"]) == sum(JCFG.depths)
    for a, b in zip(got["attn"], want["attn"]):
        assert tuple(a.shape) == b.shape  # [B, nW, heads, T, T]
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    off = tswin.forward(tparams, torch.from_numpy(imgs), TCFG,
                        window_impl=window_impl)
    assert set(off) == {"logits"}
    np.testing.assert_allclose(off["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL)


def test_headless_forward_emits_pooled_features(shared):
    jparams, tparams, imgs = shared
    jcfg = dataclasses.replace(JCFG, num_classes=0)
    tcfg = dataclasses.replace(TCFG, num_classes=0)
    want = jswin.forward(jparams, jnp.asarray(imgs), jcfg)["logits"]
    got = tswin.forward(tparams, torch.from_numpy(imgs), tcfg)["logits"]
    assert got.shape == (2, TCFG.stage_dim(1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert [n for n, _, _ in tswin.layer_fns(tcfg)][-1] == "pool"


def _chain(layers, params_of, x, to_np, want_attn=()):
    outs, taps = {}, {}
    for name, extra, fn in layers:
        if extra:
            out = fn(params_of(name), {"o": x},
                     want=frozenset(["attn"] if name in want_attn else []))
            if name in want_attn:
                taps[name] = to_np(out["attn"])
        else:
            out = fn(params_of(name), {"o": x})
        x = out["o"]
        outs[name] = to_np(x)
    return outs, taps


def test_layer_fns_match_jax_node_by_node_and_equal_forward(shared):
    jparams, tparams, _ = shared
    img = np.random.default_rng(4).random((3, 40, 48), np.float32)
    jlayer_fns, tlayer_fns = jswin.layer_fns(JCFG), tswin.layer_fns(TCFG)
    names = [n for n, _, _ in tlayer_fns]
    assert names == [n for n, _, _ in jlayer_fns]
    assert names == ["transform", "patch_embed", "stages.0.0", "stages.0.1",
                     "merge.0", "stages.1.0", "stages.1.1", "norm", "pool",
                     "head"]
    assert [e for _, e, _ in tlayer_fns] == [e for _, e, _ in jlayer_fns]
    blocks = [n for n in names if n.startswith("stages.")]
    jouts, jtaps = _chain(jlayer_fns,
                          lambda n: jswin.layer_params(jparams, n),
                          jnp.asarray(img), np.asarray, blocks)
    touts, ttaps = _chain(tlayer_fns,
                          lambda n: tswin.layer_params(tparams, n),
                          torch.from_numpy(img), lambda t: t.numpy(), blocks)
    for name in names:
        assert touts[name].shape == jouts[name].shape, name
        np.testing.assert_allclose(touts[name], jouts[name], atol=ATOL,
                                   err_msg=name)
    for name in blocks:
        np.testing.assert_allclose(ttaps[name], jtaps[name], atol=ATOL,
                                   err_msg=name)
    # the chain after the transform is the monolithic forward
    fwd = tswin.forward(tparams, torch.from_numpy(touts["transform"]), TCFG,
                        want_attn=True)
    np.testing.assert_allclose(touts["head"], fwd["logits"].numpy(),
                               atol=1e-6)
    for name, a in zip(blocks, fwd["attn"]):
        np.testing.assert_allclose(ttaps[name], a.numpy(), atol=1e-6)


def _block_fn(name):
    return next(f for n, _, f in tswin.layer_fns(TCFG) if n == name)


def test_attn_heads_and_attn_win_select_the_tap(shared):
    _, tparams, _ = shared
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 8, 8, 16)).astype(np.float32))
    fn, p = _block_fn("stages.0.1"), tparams["stages"][0][1]
    full = fn(p, {"o": x}, want=frozenset(["attn"]))["attn"]
    assert full.shape == (2, 4, 2, 16, 16)
    heads = fn(p, {"o": x}, want=frozenset(["attn"]),
               node_params={"attn_heads": "[1]"})["attn"]
    assert torch.equal(heads, full[:, :, [1]])
    win = fn(p, {"o": x}, want=frozenset(["attn"]),
             node_params={"attn_win": "3"})["attn"]
    assert torch.equal(win, full[:, 3])
    both = fn(p, {"o": x}, want=frozenset(["attn"]),
              node_params={"attn_heads": "[1, 0]", "attn_win": "2.0"})["attn"]
    assert torch.equal(both, full[:, 2][:, [1, 0]])  # in the list's order
    untapped = fn(p, {"o": x}, node_params={"attn_win": "3"})
    assert set(untapped) == {"o"}


@pytest.mark.parametrize("node_params,msg", [
    ({"attn_heads": "[2]"}, "attn_heads .* out of range for 2 heads"),
    ({"attn_heads": "[-1]"}, "out of range"),
    ({"attn_win": "4"}, "attn_win 4 out of range for 4 windows"),
    ({"attn_win": "-1"}, "out of range"),
])
def test_tap_selectors_are_range_checked(shared, node_params, msg):
    _, tparams, _ = shared
    x = torch.zeros((1, 8, 8, 16))
    with pytest.raises(ValueError, match=msg):
        _block_fn("stages.0.0")(tparams["stages"][0][0], {"o": x},
                                want=frozenset(["attn"]),
                                node_params=node_params)


def test_block_refuses_wrong_map_size(shared):
    _, tparams, _ = shared
    with pytest.raises(ValueError, match="expects 8x8 maps"):
        tswin.block(tparams["stages"][0][0], torch.zeros((1, 4, 4, 16)),
                    TCFG, 0, 0)


@pytest.mark.parametrize("window_impl", [None, fw.fused_window_attn],
                         ids=["unfused", "fused"])
def test_bf16_forward_is_finite_and_close(shared, window_impl):
    jparams, tparams, imgs = shared
    f32 = tswin.forward(tparams, torch.from_numpy(imgs), TCFG,
                        want_attn=True)
    bparams = from_jax(jax.tree.map(np.asarray, jparams),
                       dtype=torch.bfloat16)
    got = tswin.forward(bparams, torch.from_numpy(imgs), TCFG,
                        want_attn=True, window_impl=window_impl)
    assert got["logits"].dtype == torch.bfloat16
    assert torch.isfinite(got["logits"].float()).all()
    # bf16 keeps 8 bits: a few percent of the logits' scale through 4 blocks
    scale = f32["logits"].abs().max().item()
    assert (got["logits"].float() - f32["logits"]).abs().max() < 0.1 * scale
    for a, b in zip(got["attn"], f32["attn"]):
        assert a.dtype == torch.bfloat16
        assert (a.float() - b).abs().max() < 2e-2


def test_make_swin_model_surface(shared):
    _, tparams, _ = shared
    model = make_swin_model("swin_port", params=tparams, cfg=TCFG,
                            device="cpu")
    assert model.name == "swin_port"
    assert model.list_node_names()[2] == "swin_port:stages.0.0"
    assert model.category_names is not None and len(
        model.category_names) == 10
    assert "shift=2" in model.describe("stages.0.1")
    assert "shift" not in model.describe("stages.0.0")
    assert "bicubic" in model.describe("transform")
    bare = make_swin_model("swin_port", params=tparams, cfg=TCFG,
                           device="cpu", with_categories=False)
    assert bare.category_names is None
    with pytest.raises(NotImplementedError, match="quantized Swin"):
        make_swin_model("swin_t", device="cpu", quantize="w8a8")


def test_cached_tables_outlive_inference_mode(shared):
    """The cached index and mask tensors are first built while serving
    (under inference mode); a later caller under autograd must be able to
    use them: a shifted block then takes a gradient through both."""
    _, tparams, _ = shared
    tswin._bias_index.cache_clear()
    tswin._mask_on.cache_clear()
    p = tparams["stages"][0][1]
    shift = TCFG.stage_shift(0, 1)
    assert shift
    res, c = TCFG.stage_res(0), TCFG.stage_dim(0)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, res, res, c)).astype(np.float32))
    with torch.inference_mode():
        tswin.block(p, x, TCFG, 0, shift)
    assert not tswin._bias_index(TCFG.window, x.device).is_inference()
    assert not tswin._mask_on(res, TCFG.window, shift,
                              x.device).is_inference()
    table = p["bias_table"].clone().requires_grad_(True)
    y, _ = tswin.block({**p, "bias_table": table}, x.clone(), TCFG, 0, shift)
    y.sum().backward()
    assert table.grad is not None and torch.isfinite(table.grad).all()
