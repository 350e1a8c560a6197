"""The port's MoE ViT (``models/moe.py``) against the JAX package.

A narrow family in both packages: 32 px at patch 8 (17 tokens), width 32,
2 heads, 4 blocks (blocks 1 and 3 routed), 4 experts. The dispatch masks
and the routed experts are compared exactly; per-layer modules within
1e-5 and the logits and taps within 1e-4 (f32); bf16 within its stated
bound. ``run_stacked`` folds K requests into the batch axis; routing and
capacity are per image, so each request gets its own routing exactly (the
dispatch and the "experts" tap bit for bit) and its values within 1e-5:
the expert products' summation order follows the group's size (a batched
GEMM over K x C rows), so they are not bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.executor import Executor as JExecutor
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import moe as jmoe
from interactive_vit_tpu.models.moe_plugin import make_moe_model as jmake
from interactive_vit_tpu.models.weights import to_native_flat as jto_native
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph.executor import Executor
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import moe
from interactive_vit_tpu_torch.models.moe_plugin import make_moe_model
from interactive_vit_tpu_torch.models.weights import (
    from_jax, from_native_flat, to_native_flat,
)
from interactive_vit_tpu_torch.ops.dispatch import default_attn_impl
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.wire import schema

torch.set_num_threads(2)

NAME = "vit_moe_micro"
NARROW = dict(img_size=32, patch=8, width=32, depth=4, heads=2,
              num_classes=10, n_experts=4)
CFG = moe.MoEViTConfig(NAME, **NARROW)
JCFG = jmoe.MoEViTConfig(NAME, **NARROW)


@pytest.fixture(scope="module")
def params():
    """(port tree, JAX tree): JAX's init through ``from_jax``."""
    jp = jmoe.init_params(jax.random.key(5), JCFG)
    return from_jax(jax.tree.map(np.asarray, jp)), jp


def _np(t):
    return t.detach().float().numpy()


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def test_config_is_jax_s():
    full, jfull = moe.VARIANTS["vit_moe_s16"], jmoe.VARIANTS["vit_moe_s16"]
    assert full == moe.MoEViTConfig(**{
        f: getattr(jfull, f) for f in jfull.__dataclass_fields__})
    assert full.capacity(197) == jfull.capacity(197) == 31
    assert [full.is_moe(i) for i in range(12)] == [i % 2 == 1
                                                   for i in range(12)]


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("shape", [(2, 17), (3, 40)])
def test_route_is_jax_s(params, shape, factor):
    """The dispatch mask exactly, the combine weights and gates within
    1e-6, also where the capacity drops tokens (factor 0.5)."""
    tp, jp = params
    cfg = moe.MoEViTConfig(NAME, **{**NARROW, "capacity_factor": factor})
    jcfg = jmoe.MoEViTConfig(NAME, **{**NARROW, "capacity_factor": factor})
    x = _x(sum(shape), shape + (32,))
    rw = tp["blocks"][1]["router_w"]
    d, c, g = moe.route(torch.from_numpy(x), rw, cfg)
    jd, jc, jg = jmoe.route(jnp.asarray(x), jp["blocks"][1]["router_w"],
                            jcfg)
    np.testing.assert_array_equal(_np(d), np.asarray(jd))
    np.testing.assert_allclose(_np(c), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(g), np.asarray(jg), atol=1e-6, rtol=0)
    if factor < 1:
        assert float(d.sum()) < shape[0] * shape[1]


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_mlp_matches_reference_and_jax(params, factor):
    tp, jp = params
    cfg = moe.MoEViTConfig(NAME, **{**NARROW, "capacity_factor": factor})
    jcfg = jmoe.MoEViTConfig(NAME, **{**NARROW, "capacity_factor": factor})
    x = _x(7, (3, 17, 32))
    p = tp["blocks"][3]
    y, gates, aux = moe.moe_mlp(torch.from_numpy(x), p, cfg)
    ref = moe.moe_mlp_reference(torch.from_numpy(x), p, cfg)
    jy, jg, jaux = jmoe.moe_mlp(jnp.asarray(x), jp["blocks"][3], jcfg)
    jref = jmoe.moe_mlp_reference(jnp.asarray(x), jp["blocks"][3], jcfg)
    np.testing.assert_allclose(_np(y), _np(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(ref), np.asarray(jref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)


def test_capacity_overflow_drops_the_later_tokens(params):
    """A router that sends every token to expert 2: the first C tokens of
    each image are routed (their branch is the expert's output times the
    gate), the rest are dropped (branch 0, the residual passes them)."""
    tp, _ = params
    p = dict(tp["blocks"][1])
    rw = torch.zeros(32, 4)
    rw[:, 2] = 1.0
    p["router_w"] = rw
    x = torch.from_numpy(np.abs(_x(9, (2, 17, 32))))
    y, gates, aux = moe.moe_mlp(x, p, CFG)
    c = CFG.capacity(17)
    assert c == 6
    assert torch.all(y[:, c:] == 0)
    assert torch.all(y[:, :c].abs().sum(-1) > 0)
    np.testing.assert_allclose(_np(y), _np(moe.moe_mlp_reference(x, p, CFG)),
                               atol=1e-5, rtol=0)
    # the load-balance term counts the raw routing (all 34 tokens on
    # expert 2), not the 12 that capacity kept
    frac_raw = 1.0
    assert abs(float(aux) - 4 * frac_raw * float(gates[..., 2].mean())) \
        < 1e-6


def test_forward_matches_jax(params):
    tp, jp = params
    x = _x(11, (2, 3, 32, 32))
    got = moe.forward(tp, torch.from_numpy(x), CFG, want_attn=True,
                      want_aux=True)
    want = jmoe.forward(jp, jnp.asarray(x), JCFG, want_attn=True,
                        want_aux=True)
    np.testing.assert_allclose(_np(got["logits"]), np.asarray(want["logits"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(got["aux"]), float(want["aux"]),
                               atol=1e-6)
    for a, b in zip(got["attn"], want["attn"]):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5, rtol=0)


def test_bf16_logits_within_bound(params):
    """bf16 against the f32 logits: within 4 % of their range. (The JAX
    forward does not run in bf16 on the CPU: XLA's CPU dot refuses bf16 x
    bf16 = f32, which the routed einsums ask for.)"""
    tp, jp = params
    x = _x(12, (2, 3, 32, 32))
    tb = jax.tree.map(lambda t: t.to(torch.bfloat16), tp)
    got = _np(moe.forward(tb, torch.from_numpy(x), CFG)["logits"])
    ref = np.asarray(jmoe.forward(jp, jnp.asarray(x), JCFG)["logits"])
    assert np.abs(got - ref).max() <= 0.04 * float(np.ptp(ref))


@pytest.mark.parametrize("block", [2, 3])
def test_block_taps_match_jax(params, block):
    """A dense and a routed block's fn with "attn" (heads [1]), "r" and
    "experts" wanted: the JAX fn's outputs, "experts" [B, E, gh, gw] bf16."""
    tp, jp = params
    x = _x(13, (2, 17, 32))
    name = f"blocks.{block}"
    tfn = dict((n, f) for n, _, f in moe.layer_fns(CFG))[name]
    jfn = dict((n, f) for n, _, f in jmoe.layer_fns(JCFG))[name]
    want_set = frozenset({"attn", "r", "experts"})
    npar = {"attn_heads": "[1]"}
    got = tfn(tp["blocks"][block], {"o": torch.from_numpy(x)},
              want=want_set, node_params=npar)
    want = jfn(jp["blocks"][block], {"o": jnp.asarray(x)}, want=want_set,
               node_params=npar)
    assert sorted(got) == sorted(want)
    for ch in want:
        assert tuple(got[ch].shape) == want[ch].shape, ch
        np.testing.assert_allclose(_np(got[ch]),
                                   np.asarray(want[ch], np.float32),
                                   atol=1e-4 if ch != "experts" else 4e-3,
                                   rtol=0, err_msg=ch)
    if block == 3:
        assert got["experts"].dtype == torch.bfloat16
        assert tuple(got["experts"].shape) == (2, 4, 4, 4)


def test_native_names_round_trip(params):
    """The expert stacks keep JAX's [E, D, M] layout and names."""
    _, jp = params
    flat = jto_native(jp)
    assert flat["blocks/1/exp_fc1_w"].shape == (4, 32, 128)
    back = to_native_flat(from_native_flat(flat))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))


@pytest.fixture(scope="module")
def regs(params):
    """(ours, JAX's) with the narrow model registered (on the plain
    attention), the same weights in both."""
    tp, jp = params
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jmoe.VARIANTS, NAME, JCFG)
        mp.setitem(moe.VARIANTS, NAME, CFG)
        reg, jreg = Registry(), JRegistry()
        register_builtin(reg)
        jbuiltin(jreg)
        tm = make_moe_model(NAME, params=tp, device="cpu")
        jm = jmake(NAME, params=jp)
        tm.register(reg)
        jm.register(jreg)
        yield reg, jreg, tm, jm


TAPS = [(3, "attn"), (3, "r"), (3, "experts"), (5, "experts"), (5, "o"),
        (7, "o")]


def _graph(model, seed, jax_side=False, shape=(3, 40, 36)):
    mod = jschema if jax_side else schema
    g = mod.graph_from_json(model.generate_graph_json())
    g.add_input(np.random.default_rng(seed).random(shape, np.float32),
                g.nodes[0], "o")
    return g


def test_plugin_is_jax_s(regs):
    reg, jreg, tm, jm = regs
    assert tm.list_node_names() == jm.list_node_names()
    for name, extras, _ in tm.layers:
        assert tm.describe(name) == jm.describe(name)
    assert [e for _, e, _ in tm.layers] == [e for _, e, _ in jm.layers]
    assert tm.generate_graph_json() == jm.generate_graph_json()
    assert reg.get_node(NAME + ":blocks.1").io({}) == \
        jreg.get_node(NAME + ":blocks.1").io({})


def test_graph_runs_like_jax(regs):
    reg, jreg, tm, jm = regs
    got = Executor(reg, device="cpu").run(_graph(tm, 1), TAPS)
    want = JExecutor(jreg).run(_graph(jm, 1, jax_side=True), TAPS)
    assert sorted(got) == sorted(want)
    for i in want:
        for ch in want[i]:
            atol = 4e-3 if ch == "experts" else 1e-4
            np.testing.assert_allclose(got[i][ch], want[i][ch], atol=atol,
                                       rtol=0, err_msg=f"{i} {ch}")


@pytest.mark.parametrize("shape", [(3, 40, 36), (1, 3, 40, 36)])
def test_run_stacked_equals_separate_runs(regs, shape):
    """A group of 3 requests (unbatched or batched images) folds into one
    batch of 3: each request's "experts" tap (its routing) equals its own
    run's bit for bit, every other tap within 1e-5 (the expert GEMMs sum
    in the group's order); JAX's ``run_stacked`` within 1e-4."""
    reg, jreg, tm, jm = regs
    ex = Executor(reg, device="cpu")
    seeds = (21, 22, 23)
    stacked = ex.run_stacked([_graph(tm, s, shape=shape) for s in seeds],
                             TAPS)
    for s, res in zip(seeds, stacked):
        alone = ex.run(_graph(tm, s, shape=shape), TAPS)
        assert sorted(res) == sorted(alone)
        for i in alone:
            for ch in alone[i]:
                assert res[i][ch].shape == alone[i][ch].shape
                if ch == "experts":
                    np.testing.assert_array_equal(res[i][ch], alone[i][ch])
                np.testing.assert_allclose(res[i][ch], alone[i][ch],
                                           atol=1e-5, rtol=0)
    jstacked = JExecutor(jreg).run_stacked(
        [_graph(jm, s, jax_side=True, shape=shape) for s in seeds], TAPS)
    for res, jres in zip(stacked, jstacked):
        for i in jres:
            for ch in jres[i]:
                atol = 4e-3 if ch == "experts" else 1e-4
                np.testing.assert_allclose(res[i][ch], jres[i][ch],
                                           atol=atol, rtol=0)


def test_attn_impl_gives_plain_gradient_twins(params):
    tp, _ = params
    plain = make_moe_model(cfg=CFG, params=tp, device="cpu")
    assert plain.grad_layers == {}
    flash = make_moe_model(cfg=CFG, params=tp, device="cpu",
                           attn_impl=default_attn_impl("flash"))
    assert sorted(flash.grad_layers) == sorted(n for n, _, _ in
                                               flash.layers)
    seeded = make_moe_model(cfg=CFG, device="cpu", seed=3)
    blk = seeded.params["blocks"][1]
    assert "fc1_w" not in blk and blk["exp_fc2_w"].shape == (4, 128, 32)
