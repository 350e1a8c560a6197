"""The port's CLIP image tower (``models/clip.py``, ``clip_plugin.py``)
against the JAX package on the CPU, on shared inputs.

A small config (64 px, patch 32: N=5; width 128 in 2 heads 64 wide,
depth 2) is initialised by JAX and carried across (``weights.from_jax``);
images are made with numpy from a seed. Tolerances: the monolithic
forward (embedding and maps) within 1e-5, the chain graph through both
executors within 1e-4, row 1's plain version against JAX's
``fused_attn_block`` (the Pallas kernel in interpret mode) within 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.executor import Executor as JExecutor
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import clip as jclip
from interactive_vit_tpu.models.clip_plugin import (
    make_clip_model as jmake_clip,
)
from interactive_vit_tpu.ops import fused_block as jfb
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph.executor import Executor
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import clip
from interactive_vit_tpu_torch.models.autoregister import (
    known_variants, make_model, plain_vit_family,
)
from interactive_vit_tpu_torch.models.clip_plugin import make_clip_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import fused_block as tfb
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.wire import schema

torch.set_num_threads(2)

FWD_ATOL = 1e-5
CHAIN_ATOL = 1e-4
SMALL = dict(name="clip_small", img_size=64, patch=32, width=128, depth=2,
             heads=2, embed_dim=32)
JCFG = jclip.CLIPVisionConfig(**SMALL)
TCFG = clip.CLIPVisionConfig(**SMALL)


@pytest.fixture(scope="module")
def shared():
    """JAX-initialised small params (numpy) and a batch of two images."""
    params = jax.tree.map(np.asarray, jclip.init_params(jax.random.key(7),
                                                        JCFG))
    images = np.random.default_rng(7).random((2, 3, 64, 64),
                                             dtype=np.float32)
    return params, images


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, dtype=np.float32),
                               atol=atol, rtol=0)


def test_config_matches_jax():
    for field in ("tokens", "mlp_dim", "width", "depth", "heads",
                  "embed_dim", "ln_eps", "patch", "img_size", "name"):
        assert getattr(clip.CLIPVisionConfig(), field) == getattr(
            jclip.CLIPVisionConfig(), field)
    assert clip.CLIPVisionConfig().tokens == 50
    assert clip.CLIP_MEAN == jclip.CLIP_MEAN and clip.CLIP_STD == \
        jclip.CLIP_STD


# quick_gelu against JAX's, each op rounding to the dtype: the two f32
# sigmoids differ in the last ulp (rtol 1e-6); in bf16 XLA's CPU logistic
# also rounds 1 + exp(-x) to bf16, which near 1 moves the sigmoid by an
# ulp, so a bf16 result may lie two ulps (2^-6) from the port's
@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6),
                                        ("bfloat16", 2.0 ** -6)])
def test_quick_gelu_matches_jax(dtype, rtol):
    x = np.random.default_rng(1).standard_normal(257).astype(np.float32) * 4
    want = jclip.quick_gelu(jnp.asarray(x, getattr(jnp, dtype)))
    got = clip.quick_gelu(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("want_attn", [False, True])
def test_forward_matches_jax(shared, want_attn):
    params, images = shared
    want = jclip.forward(jax.tree.map(jnp.asarray, params),
                         jnp.asarray(images), JCFG, want_attn=want_attn)
    got = clip.forward(from_jax(params), torch.from_numpy(images), TCFG,
                       want_attn=want_attn)
    assert got["embedding"].shape == (2, 32)
    _close(got["embedding"], want["embedding"], FWD_ATOL)
    norms = torch.linalg.vector_norm(got["embedding"], dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-6)
    assert ("attn" in got) == want_attn
    if want_attn:
        assert len(got["attn"]) == 2
        for g, w in zip(got["attn"], want["attn"]):
            assert g.shape == (2, 2, 5, 5)
            _close(g, w, FWD_ATOL)


def test_init_params_layout_matches_jax(shared):
    params, _ = shared
    got = clip.init_params(TCFG, torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    tree_t = {jax.tree_util.keystr(k): v.shape for k, v in flat_j}
    mine = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda t: np.zeros(tuple(t.shape)), got))[0]
    assert {jax.tree_util.keystr(k): v.shape for k, v in mine} == tree_t
    assert not got["patch_embed"].get("b")  # bias-free projection


MODES = [
    dict(),
    dict(want_attn=True),
    dict(want_attn=True, want_mean=True),
    dict(want_attn=True, want_mean=True, attn_heads=(1,)),
    dict(want_attn=True, attn_heads=(0, 1), fast_softmax=False),
]


@pytest.mark.parametrize("kw", MODES)
def test_row1_plain_version_at_clip_shape_matches_pallas(shared, kw,
                                                         monkeypatch):
    """Row 1 at the small tower's block shape (N=5: no multiple of the
    kernels' tiles), its plain version against JAX's kernel interpreted."""
    import jax.experimental.pallas as pl

    monkeypatch.setattr(jfb.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    params, _ = shared
    blk = params["blocks"][1]
    x = np.random.default_rng(4).standard_normal(
        (2, TCFG.tokens, TCFG.width)).astype(np.float32)
    want = jfb.fused_attn_block(jnp.asarray(x),
                                jax.tree.map(jnp.asarray, blk), JCFG.heads,
                                JCFG.ln_eps, **kw)
    got = tfb.fused_attn_block(torch.from_numpy(x), from_jax(blk),
                               TCFG.heads, TCFG.ln_eps, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            _close(g, w, FWD_ATOL)


def test_block_through_row1_matches_jax_kernel_block(shared, monkeypatch):
    """``clip.block`` with ``block_impl`` (the wrapper's plain version on
    the CPU) against JAX's block on the interpreted kernel, MLP
    included."""
    import jax.experimental.pallas as pl

    monkeypatch.setattr(jfb.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    params, _ = shared
    x = np.random.default_rng(5).standard_normal(
        (1, TCFG.tokens, TCFG.width)).astype(np.float32)
    wy, wp = jclip.block(jax.tree.map(jnp.asarray, params["blocks"][0]),
                         jnp.asarray(x), JCFG, want_attn=True,
                         block_impl=jfb.fused_attn_block)
    gy, gp = clip.block(from_jax(params["blocks"][0]), torch.from_numpy(x),
                        TCFG, want_attn=True, block_impl=tfb.fused_attn_block)
    _close(gy, wy, FWD_ATOL)
    _close(gp, wp, FWD_ATOL)


@pytest.fixture(scope="module")
def chain(shared):
    """Both packages' small towers registered, and the port's generated
    chain graph."""
    params, _ = shared
    reg, jreg = Registry(), JRegistry()
    register_builtin(reg)
    jbuiltin(jreg)
    jmake_clip(params=jax.tree.map(jnp.asarray, params),
               cfg=JCFG).register(jreg)
    model = make_clip_model(params=from_jax(params), cfg=TCFG, device="cpu")
    model.register(reg)
    return reg, jreg, model


def _request(mod, obj, image):
    g = mod.graph_from_json(obj)
    g.add_input(image, g.nodes[0], "o")
    return g


def test_chain_graph_matches_jax(chain):
    reg, jreg, model = chain
    obj = model.generate_graph_json()
    names = [n["instance"]["endpoint"] for n in obj["nodes"]]
    assert names == ["clip_small:transform", "clip_small:embed",
                     "clip_small:blocks.0", "clip_small:blocks.1",
                     "clip_small:embedding"]
    assert len(obj["edges"]) == 4  # no category sink
    image = np.random.default_rng(9).random((3, 70, 90), dtype=np.float32)
    taps = {(0, "o"), (2, "attn"), (3, "attn"), (3, "o"), (4, "o")}
    got = Executor(reg, device="cpu").run(_request(schema, obj, image), taps)
    want = JExecutor(jreg).run(_request(jschema, obj, image), taps)
    assert got[0]["o"].shape == (3, 64, 64)  # unbatched through transform
    assert got[4]["o"].shape == (1, 32)
    for i, ch in taps:
        _close(torch.from_numpy(got[i][ch]), want[i][ch], CHAIN_ATOL)


def test_chain_stacked_group_matches_single_runs(chain):
    """Two requests as one stacked pass: each row its own run's."""
    reg, _, model = chain
    obj = model.generate_graph_json()
    ex = Executor(reg, device="cpu")
    images = np.random.default_rng(11).random((2, 3, 64, 64),
                                              dtype=np.float32)
    taps = {(2, "attn"), (4, "o")}
    group = ex.run_stacked([_request(schema, obj, im) for im in images],
                           taps)
    for im, res in zip(images, group):
        single = ex.run(_request(schema, obj, im), taps)
        for i, ch in taps:
            np.testing.assert_allclose(res[i][ch], single[i][ch],
                                       atol=1e-6, rtol=0)


def test_layer_surface_and_descriptions_match_jax(chain):
    reg, jreg, model = chain
    assert [n for n, _, _ in clip.layer_fns(TCFG)] == [
        n for n, _, _ in jclip.layer_fns(JCFG)]
    assert [e for _, e, _ in clip.layer_fns(TCFG)] == [
        e for _, e, _ in jclip.layer_fns(JCFG)]
    jmodel = jreg.get_node("clip_small:embed").model
    assert model.descriptions == jmodel.descriptions
    for name in model.list_node_names():
        assert reg.get_node(name).io({}) == jreg.get_node(name).io({})


def test_from_openai_matches_jax_converter():
    """A state dict in OpenAI's naming, built here, converts to the JAX
    converter's tree."""
    rng = np.random.default_rng(3)
    d, p, e = TCFG.width, TCFG.patch, TCFG.embed_dim
    sd = {"visual.conv1.weight": rng.standard_normal((d, 3, p, p)),
          "visual.class_embedding": rng.standard_normal(d),
          "visual.positional_embedding": rng.standard_normal(
              (TCFG.tokens, d)),
          "visual.proj": rng.standard_normal((d, e))}
    for ln in ("ln_pre", "ln_post"):
        sd[f"visual.{ln}.weight"] = rng.standard_normal(d)
        sd[f"visual.{ln}.bias"] = rng.standard_normal(d)
    for i in range(TCFG.depth):
        pre = f"visual.transformer.resblocks.{i}."
        for name, shape in (("ln_1.weight", (d,)), ("ln_1.bias", (d,)),
                            ("attn.in_proj_weight", (3 * d, d)),
                            ("attn.in_proj_bias", (3 * d,)),
                            ("attn.out_proj.weight", (d, d)),
                            ("attn.out_proj.bias", (d,)),
                            ("ln_2.weight", (d,)), ("ln_2.bias", (d,)),
                            ("mlp.c_fc.weight", (4 * d, d)),
                            ("mlp.c_fc.bias", (4 * d,)),
                            ("mlp.c_proj.weight", (d, 4 * d)),
                            ("mlp.c_proj.bias", (d,))):
            sd[pre + name] = rng.standard_normal(shape)
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    want = jax.tree.map(np.asarray, jclip.from_openai(sd, JCFG))
    got = clip.from_openai(sd, TCFG)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict((jax.tree_util.keystr(k), v) for k, v in
                  jax.tree_util.tree_flatten_with_path(
                      jax.tree.map(lambda t: t.numpy(), got))[0])
    assert sorted(flat_g) == sorted(jax.tree_util.keystr(k)
                                    for k, _ in flat_w)
    for k, v in flat_w:
        np.testing.assert_array_equal(flat_g[jax.tree_util.keystr(k)], v)


def test_autoregister_builds_clip_and_keeps_refusals(caplog):
    import logging

    assert {"clip_b32", "clip_text_b32", "vgg16"} <= set(known_variants())
    for v in ("clip_b32", "clip_text_b32", "vgg16"):
        assert not plain_vit_family(v)
    with pytest.raises(ValueError, match="plain-ViT"):
        make_model("clip_b32@448", device="cpu")
    with pytest.raises(ValueError, match="plain-ViT family only"):
        make_model("clip_b32", device="cpu", block_kernel="int8-scores")
    with caplog.at_level(logging.WARNING):
        m = make_model("clip_b32", device="cpu", quantize="w8",
                       dtype=torch.bfloat16)
    assert "int8 not wired for clip_b32" in caplog.text
    assert m.params["proj"].dtype == torch.bfloat16
    assert m.name == "clip_b32" and len(m.layers) == 15
    # on the CPU the unfused path: no kernel, so no gradient twins
    assert m.grad_layers == {}
    if not torch.cuda.is_available():
        for v in ("clip_b32", "clip_text_b32", "vgg16"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_model(v)  # the card by default
