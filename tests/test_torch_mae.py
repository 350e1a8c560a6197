"""The port's MAE (``models/mae.py``, ``models/mae_plugin.py``) against the
JAX package.

A tiny MAE in both packages: a 32 px encoder at patch 8 (16 patches),
width 32, 2 blocks, 2 heads; a decoder 16 wide, 1 block, 2 heads. The
mask, ``ids_keep`` and ``ids_restore`` are compared exactly (the draw is
``jax.random.uniform``'s bits, the argsorts stable); the reconstruction's
f32 views within 1e-4, the error map and the loss within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.executor import Executor as JExecutor
from interactive_vit_tpu.graph.ir import GraphError as JGraphError
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import mae as jmae
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.mae_plugin import make_mae_model as jmake
from interactive_vit_tpu.models.weights import to_native_flat as jto_native
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph.executor import Executor
from interactive_vit_tpu_torch.graph.ir import GraphError
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import mae
from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.models.autoregister import make_model
from interactive_vit_tpu_torch.models.mae_plugin import make_mae_model
from interactive_vit_tpu_torch.models.weights import (
    from_jax, from_native_flat, to_native_flat,
)
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.wire import schema

torch.set_num_threads(2)

NAME = "mae_micro"
ENC = dict(img_size=32, patch=8, width=32, depth=2, heads=2)
DEC = dict(dec_width=16, dec_depth=1, dec_heads=2)
CFG = mae.MAEConfig(NAME, "vit_t16", enc_override=vit.ViTConfig("e", **ENC),
                    **DEC)
JCFG = jmae.MAEConfig(NAME, "vit_t16",
                      enc_override=jvit.ViTConfig("e", **ENC), **DEC)


@pytest.fixture(scope="module")
def params():
    jp = jmae.init_params(jax.random.key(4), JCFG)
    # a non-zero mask token and decoder biases, so that a misplaced one
    # shows
    jp = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(
        jax.random.key(a.size), a.shape), jp)
    return from_jax(jax.tree.map(np.asarray, jp)), jp


def _np(t):
    return t.detach().float().numpy()


def _img(seed, shape=(2, 3, 32, 32)):
    return np.random.default_rng(seed).random(shape, np.float32)


@pytest.mark.parametrize("seed", [0, 7, 123456, 2 ** 31 - 1, -1])
@pytest.mark.parametrize("shape", [(1, 196, 49), (3, 16, 4), (2, 16, 12)])
def test_random_masking_is_jax_bit_for_bit(seed, shape):
    """``jax.random.uniform(key(seed), (B, L))`` through the stable
    argsorts: the kept ids, the mask and the restore order exactly (a
    negative seed is its u32 pattern, as ``jax.random.key`` of an int32)."""
    b, length, keep = shape
    jk, jm, jr = jmae.random_masking(
        jax.random.key(jnp.asarray(seed, jnp.int32)), b, length, keep)
    tk, tm, tr = mae.random_masking(
        torch.tensor(seed & 0xFFFFFFFF, dtype=torch.int64), b, length, keep)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("ratio,norm_pix", [(None, True), (0.5, True),
                                            (0.25, False)])
def test_reconstruct_matches_jax(params, ratio, norm_pix):
    tp, jp = params
    cfg = mae.MAEConfig(**{**CFG.__dict__, "norm_pix": norm_pix})
    jcfg = jmae.MAEConfig(**{**JCFG.__dict__, "norm_pix": norm_pix})
    x = _img(1)
    got = mae.reconstruct(tp, torch.from_numpy(x), cfg,
                          seed=torch.tensor(9), mask_ratio=ratio)
    want = jmae.reconstruct(jp, jnp.asarray(x), jcfg, jax.random.key(9),
                            mask_ratio=ratio)
    assert sorted(got) == sorted(want) == ["err", "mask", "masked", "o"]
    np.testing.assert_array_equal(_np(got["mask"]), np.asarray(want["mask"]))
    np.testing.assert_array_equal(_np(got["masked"]),
                                  np.asarray(want["masked"]))
    np.testing.assert_allclose(_np(got["o"]), np.asarray(want["o"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(got["err"]), np.asarray(want["err"]),
                               atol=1e-5, rtol=0)
    assert tuple(got["err"].shape) == (2, 4, 4)
    assert float(got["mask"].sum()) == 2 * (16 - cfg.len_keep(ratio))


def test_forward_pretrain_and_encode_match_jax(params):
    tp, jp = params
    x = _img(2)
    got = mae.forward_pretrain(tp, torch.from_numpy(x), CFG,
                               seed=torch.tensor(3))
    want = jmae.forward_pretrain(jp, jnp.asarray(x), JCFG,
                                 jax.random.key(3))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(_np(got["pred"]), np.asarray(want["pred"]),
                               atol=1e-4, rtol=0)
    # the whole grid through the encoder: the plain ViT features
    z = mae.encode(tp, torch.from_numpy(x), CFG)
    jz = jmae.encode(jp, jnp.asarray(x), JCFG)
    np.testing.assert_allclose(_np(z), np.asarray(jz), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="no masked patches"):
        mae.forward_pretrain(tp, torch.from_numpy(x), CFG,
                             seed=torch.tensor(3), mask_ratio=0.0)


def test_unpatchify_inverts_patchify():
    from interactive_vit_tpu_torch.ops.layers import patchify

    x = torch.rand(2, 3, 32, 24)
    back = mae.unpatchify(patchify(x, 8), 8, (4, 3))
    assert torch.equal(back, x)


def test_configs_and_geometries_are_jax_s():
    for name in ("mae_t16", "mae_s16", "mae_b16", "mae_t16@64",
                 "mae_b16@p32", "mae_s16@96p8"):
        t, j = mae.resolve_variant(name), jmae.resolve_variant(name)
        for attr in ("num_patches", "grid"):
            assert getattr(t, attr) == getattr(j, attr), (name, attr)
        assert t.len_keep() == j.len_keep() and t.len_keep(0.5) == \
            j.len_keep(0.5)
        assert (t.dec_cfg.width, t.dec_cfg.depth, t.enc_cfg.width) == (
            j.dec_cfg.width, j.dec_cfg.depth, j.enc_cfg.width)
    assert mae.resolve_variant("mae_t16@64").enc_cfg.img_size == 64
    with pytest.raises(ValueError, match="unknown MAE variant"):
        mae.resolve_variant("mae_x16")
    with pytest.raises(ValueError, match="resolution"):
        mae.resolve_variant("mae_t16@65")
    with pytest.raises(ValueError, match="must be in"):
        mae.VARIANTS["mae_t16"].len_keep(1.0)
    deit = mae.MAEConfig("m", "deit_t16")
    with pytest.raises(ValueError, match="one CLS prefix"):
        deit.enc_cfg


def test_encoder_export_and_load_into(params):
    tp, _ = params
    enc = mae.encoder_params(tp)
    assert enc["head"] == {}
    target = vit.init_params(vit.ViTConfig("t", **ENC, num_classes=10),
                             torch.Generator().manual_seed(0))
    out = mae.load_encoder_into(target, enc,
                                vit.ViTConfig("t", 48, 8, 32, 2, 2))
    assert out["head"] is target["head"]
    assert out["blocks"] is enc["blocks"]
    assert out["pos_emb"].shape == (1, 37, 32)


def test_native_file_of_jax_serves(params):
    """The JAX package's native names of an MAE tree load in the port
    (``from_native_flat``; the maker puts back the encoder's empty head)
    and round-trip to the same names."""
    tp, jp = params
    flat = jto_native(jp)
    loaded = from_native_flat(flat)
    assert "head" not in loaded["enc"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(mae.VARIANTS, NAME, CFG)
        model = make_mae_model(NAME, params=loaded, device="cpu")
    assert model.params["enc"]["head"] == {}
    back = to_native_flat(model.params)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))


@pytest.fixture(scope="module")
def regs(params):
    tp, jp = params
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jmae.VARIANTS, NAME, JCFG)
        mp.setitem(mae.VARIANTS, NAME, CFG)
        reg, jreg = Registry(), JRegistry()
        register_builtin(reg)
        jbuiltin(jreg)
        tm = make_mae_model(NAME, params=tp, device="cpu")
        jm = jmake(NAME, params=jp)
        tm.register(reg)
        jm.register(jreg)
        yield reg, jreg, tm, jm


TAPS = [(1, "o"), (1, "masked"), (1, "err"), (1, "mask")]


def _graph(model, seed, params=None, jax_side=False, shape=(3, 40, 36),
           img_seed=0):
    mod = jschema if jax_side else schema
    g = mod.graph_from_json(model.generate_graph_json())
    g.nodes[1].params.update({"seed": str(seed), **(params or {})})
    g.add_input(np.random.default_rng(img_seed).random(shape, np.float32),
                g.nodes[0], "o")
    return g


def test_node_contents_and_io_are_jax_s(regs):
    reg, jreg, tm, jm = regs
    name = NAME + ":reconstruct"
    for params in ({}, {"seed": "4", "mask_ratio": "0.5"}):
        assert reg.get_node(name).contents(params) == \
            jreg.get_node(name).contents(params)
        assert reg.get_node(name).io(params) == jreg.get_node(name).io(
            params)
    assert tm.list_node_names() == jm.list_node_names()
    assert tm.describe("reconstruct") == jm.describe("reconstruct")
    assert tm.generate_graph_json() == jm.generate_graph_json()


@pytest.mark.parametrize("npar,match", [
    ({"mask_ratio": "x"}, "is not a number"),
    ({"mask_ratio": "1.0"}, "must be in"),
    ({"seed": "1.5"}, "is not an integer")])
def test_bad_params_raise_graph_errors_as_jax(regs, npar, match):
    reg, jreg, tm, jm = regs
    with pytest.raises(Exception, match=match) as got:
        Executor(reg, device="cpu").run(_graph(tm, 0, npar), TAPS)
    with pytest.raises(Exception, match=match) as want:
        JExecutor(jreg).run(_graph(jm, 0, npar, jax_side=True), TAPS)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value.__cause__ or got.value, GraphError) == \
        isinstance(want.value.__cause__ or want.value, JGraphError)


@pytest.mark.parametrize("seed,ratio", [(0, None), (5, "0.5")])
def test_graph_runs_like_jax(regs, seed, ratio):
    reg, jreg, tm, jm = regs
    npar = {"mask_ratio": ratio} if ratio else {}
    got = Executor(reg, device="cpu").run(_graph(tm, seed, npar), TAPS)
    want = JExecutor(jreg).run(_graph(jm, seed, npar, jax_side=True), TAPS)
    assert got[1]["o"].shape == (1, 3, 32, 32)
    np.testing.assert_array_equal(got[1]["mask"], want[1]["mask"])
    for ch in ("o", "masked", "err"):
        np.testing.assert_allclose(got[1][ch], want[1][ch], atol=1e-4,
                                   rtol=0, err_msg=ch)


def test_seed_edit_is_a_cache_hit_with_a_new_mask(regs):
    """A seed edit replays the staged program (a cache hit) with a new
    mask; a mask_ratio edit stages a new one."""
    reg, _, tm, _ = regs
    ex = Executor(reg, device="cpu")
    first = ex.run(_graph(tm, 1), TAPS)
    assert not ex.last_stats.cache_hit
    second = ex.run(_graph(tm, 2), TAPS)
    assert ex.last_stats.cache_hit
    assert not np.array_equal(first[1]["mask"], second[1]["mask"])
    assert first[1]["mask"].sum() == second[1]["mask"].sum() == 12
    ex.run(_graph(tm, 2, {"mask_ratio": "0.5"}), TAPS)
    assert not ex.last_stats.cache_hit


@pytest.mark.parametrize("shape", [(3, 40, 36), (1, 3, 40, 36)])
def test_run_stacked_draws_each_request_from_its_seed(regs, shape):
    """A group of two seeds (and two images): each request's views equal
    its own run bit for bit, and JAX's ``run_stacked`` (the seed vmapped a
    request) within 1e-4, its mask exactly."""
    reg, jreg, tm, jm = regs
    ex = Executor(reg, device="cpu")
    cases = [(3, 0), (11, 1)]
    graphs = [_graph(tm, s, shape=shape, img_seed=i) for s, i in cases]
    stacked = ex.run_stacked(graphs, TAPS)
    for (s, i), res in zip(cases, stacked):
        alone = ex.run(_graph(tm, s, shape=shape, img_seed=i), TAPS)
        for ch in alone[1]:
            np.testing.assert_array_equal(res[1][ch], alone[1][ch])
    assert not np.array_equal(stacked[0][1]["mask"], stacked[1][1]["mask"])
    jstacked = JExecutor(jreg).run_stacked(
        [_graph(jm, s, jax_side=True, shape=shape, img_seed=i)
         for s, i in cases], TAPS)
    for res, jres in zip(stacked, jstacked):
        np.testing.assert_array_equal(res[1]["mask"], jres[1]["mask"])
        for ch in ("o", "masked", "err"):
            np.testing.assert_allclose(res[1][ch], jres[1][ch], atol=1e-4,
                                       rtol=0)


def test_make_model_builds_the_at_geometries():
    model = make_model("mae_t16@64", device="cpu")
    assert model.cfg.num_patches == 16
    assert model.params["dec"]["pos_emb"].shape == (1, 17, 128)
    assert model.params["enc"]["pos_emb"].shape == (1, 17, 192)
