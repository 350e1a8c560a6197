"""The port's gradient node kinds (saliency, dream, occlusion) on the CPU,
against the JAX package.

* ``node_fixtures.json``'s saliency, dream and occlusion entries: the
  committed request bytes decode and ``Executor(device="cpu")`` gives the
  pinned values (atol 5e-5: 6 decimals); the committed f32 responses are
  our outputs encoded byte for byte where the kind is exact here, else
  within 1e-6, and the bf16 ones within one bf16 rounding.
* The same graphs through the JAX ``Executor`` and ours, seeded numpy
  inputs, f32 within 1e-4 of max(1, |ref|): saliency in all four modes and
  node-wrt (Grad-CAM) through a ViT of depth 2, width 64, 2 heads, 32 px,
  patch 8; dream at 3 steps and occlusion with overlapping and clamped
  windows; the generated ``<variant>_saliency.json`` of that ViT, of a
  two-stage Swin and of a ToMe ViT of depth 2, every output.
* SmoothGrad's noise: ``fold_in`` bit-equal to ``jax.random.fold_in``; the
  uniform floats bit-equal; the normal draw within ``NORMAL_ULPS`` of
  ``jax.random.normal`` (XLA's log1p inside erf_inv is not torch's).
* The executor contracts: every ``NodeError`` text and node index as
  JAX's; dynamic params a cache hit with new values; a stacked group of
  distinct classes equal to K runs bit for bit; fault isolation on the
  eager paths; the replay on the twin, occlusion on ``fn``; the committed
  saliency graphs of every ported family generated again equal.
* The entry points turn TF32 off.
"""

import base64
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.executor import Executor as JExecutor
from interactive_vit_tpu.graph.executor import NodeError as JNodeError
from interactive_vit_tpu.graph.ir import Graph as JGraph
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import swin as jswin
from interactive_vit_tpu.models import tome as jtome
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.swin_plugin import make_swin_model as jswin_make
from interactive_vit_tpu.models.tome_plugin import make_tome_model as jtome_make
from interactive_vit_tpu.models.vit_plugin import make_vit_model as jvit_make
from interactive_vit_tpu.ops import node_ops as J
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph.executor import Executor, NodeError
from interactive_vit_tpu_torch.graph.ir import Graph
from interactive_vit_tpu_torch.graph.registry import NodeKind, Registry
from interactive_vit_tpu_torch.models import swin as tswin
from interactive_vit_tpu_torch.models import tome as ttome
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.autoregister import make_model
from interactive_vit_tpu_torch.models.model_plugin import TorchModel
from interactive_vit_tpu_torch.models.swin_plugin import make_swin_model
from interactive_vit_tpu_torch.models.tome_plugin import make_tome_model
from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import node_ops as T
from interactive_vit_tpu_torch.wire import schema
from interactive_vit_tpu_torch.wire.codec import Request, Response

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
GRAPHS = os.path.join(os.path.dirname(HERE), "static", "graphs")
with open(os.path.join(HERE, "fixtures", "node_fixtures.json")) as f:
    FIXTURES = json.load(f)
GRADIENT_KINDS = ("saliency", "dream", "occlusion")
# kinds whose fixture responses are our f32 bytes exactly
EXACT = {"saliency", "dream"}
# the normal draw's distance from jax.random.normal, in f32 ulps (measured
# 3 over 200k draws; log1p differs by up to 2 ulps, the rest is rounding)
NORMAL_ULPS = 3

VIT = dict(img_size=32, patch=8, width=64, depth=2, heads=2, num_classes=10)
SWIN = dict(img_size=32, patch=4, embed_dim=16, depths=(2, 2), heads=(2, 4),
            window=4, num_classes=10)
# the tiny models' names: the module's registries hold them beside the
# real variants (the saved-graph test builds those)
VITN, SWINN, TOMEN = "vitg_t", "swing_t", "vitg_tome"
TOME = dict(img_size=32, patch=8, width=64, depth=2, heads=2, num_classes=10,
            r=2)


def _flat(out):
    return {f"{i}/{ch}": np.asarray(v) for i, sub in out.items()
            for ch, v in sub.items()}


def _close(got, want, what=""):
    """f32 within 1e-4 of max(1, |ref|)."""
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    tol = 1e-4 * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol, f"{what}: {err} > {tol}"


def _both(build):
    """``build(graph_cls)`` for our Graph and the JAX one."""
    return build(Graph), build(JGraph)


@pytest.fixture(scope="module")
def regs():
    """(ours, JAX's): the built-in kinds and the three tiny models, the
    JAX initializer's weights in both."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VARIANTS, VITN, jvit.ViTConfig(VITN, **VIT))
        mp.setitem(tvit.VARIANTS, VITN, tvit.ViTConfig(VITN, **VIT))
        mp.setitem(jtome.VARIANTS, TOMEN,
                   jtome.ToMeViTConfig(TOMEN, **TOME))
        mp.setitem(ttome.VARIANTS, TOMEN,
                   ttome.ToMeViTConfig(TOMEN, **TOME))
        reg, jreg = Registry(), JRegistry()
        T.register_builtin(reg)
        J.register_builtin(jreg)
        models = {}
        jp = jvit.init_params(jax.random.key(3), jvit.VARIANTS[VITN])
        jm = jvit_make(VITN, params=jp)
        tm = make_vit_model(VITN, params=from_jax(
            jax.tree.map(np.asarray, jp)), device="cpu")
        models[VITN] = (tm, jm)
        jcfg = jswin.SwinConfig(SWINN, **SWIN)
        jp = jswin.init_params(jax.random.key(5), jcfg)
        jm = jswin_make(SWINN, params=jp, cfg=jcfg)
        tm = make_swin_model(SWINN, params=from_jax(
            jax.tree.map(np.asarray, jp)), cfg=tswin.SwinConfig(
                SWINN, **SWIN), device="cpu")
        models[SWINN] = (tm, jm)
        jp = jtome.init_params(jax.random.key(7),
                               jtome.VARIANTS[TOMEN])
        jm = jtome_make(TOMEN, params=jp)
        tm = make_tome_model(TOMEN, params=from_jax(
            jax.tree.map(np.asarray, jp)), device="cpu")
        models[TOMEN] = (tm, jm)
        for tm, jm in models.values():
            tm.register(reg)
            jm.register(jreg)
        yield reg, jreg, models


def _image(seed, shape=(3, 40, 36)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# -- the committed fixtures ---------------------------------------------------


def _fixture_run(name):
    reg = Registry()
    T.register_builtin(reg)
    req = Request()
    req.decode(base64.b64decode(FIXTURES[name]["request_b64"]))
    return Executor(reg, device="cpu").run(req.graph,
                                           taps=req.taps or "primary")


@pytest.mark.parametrize("name", GRADIENT_KINDS)
def test_fixture_request_evaluates_to_pinned_values(name):
    fx = FIXTURES[name]
    flat = _flat(_fixture_run(name))
    assert sorted(flat) == sorted(fx["expected"])
    for key, exp in fx["expected"].items():
        assert list(flat[key].shape) == exp["dims"], key
        np.testing.assert_allclose(flat[key].ravel(),
                                   np.asarray(exp["values"], np.float32),
                                   atol=5e-5, err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", GRADIENT_KINDS)
def test_committed_responses_are_ours(name):
    """f32 byte for byte (saliency, dream), else within 1e-6; bf16 our f32
    value's rounding or its neighbour."""
    fx = FIXTURES[name]
    out = _fixture_run(name)
    for key, dtype in (("response_b64", "f32"), ("response_bf16_b64", "bf16")):
        committed = base64.b64decode(fx[key])
        if dtype == "f32" and name in EXACT:
            assert Response(out).encode(dtype=dtype) == committed
            continue
        theirs = _flat(Response.decode(committed))
        ours = _flat(Response.decode(Response(out).encode(dtype=dtype)))
        assert sorted(theirs) == sorted(ours)
        for k in theirs:
            if dtype == "f32":
                np.testing.assert_allclose(ours[k], theirs[k], atol=1e-6,
                                           rtol=1e-6, err_msg=k)
            else:
                ulp = np.abs(ours[k]) * 2.0 ** -8 + 1e-30
                assert (np.abs(ours[k] - theirs[k]) <= ulp).all(), k


# -- through the tiny models, against the JAX executor ------------------------


def _vit_modes(graph_cls):
    """image -> embed -> 2 blocks -> norm -> head, and saliency nodes: ig
    (class target), smooth, and Grad-CAM wrt block 0 (the transform,
    gradxinput and dream run in the generated graph's test)."""
    g = graph_cls()
    chain = [g.add_node(f"{VITN}:{n}") for n in
             ("embed", "blocks.0", "blocks.1", "norm", "head")]
    for a, b in zip(chain, chain[1:]):
        g.connect(a, "o", b, "o")
    for params in ({"target": "class", "class": "3", "mode": "ig",
                    "steps": "3"},
                   {"target": "max", "mode": "smooth", "steps": "3",
                    "sigma": "0.2", "seed": "5"},
                   {"target": "max", "mode": "gradxinput",
                    "wrt": f"node:{chain[1].index}"}):
        g.connect(chain[-1], "o", g.add_node("saliency", params), "o")
    g.add_input(_image(0, (1, 3, 32, 32)), chain[0], "o")
    return g


@pytest.fixture(scope="module")
def vit_modes(regs):
    reg, jreg, _ = regs
    g, jg = _both(_vit_modes)
    taps = {(n.index, ch) for n in g.nodes if n.name == "saliency"
            for ch in ("o", "g")}
    return (_flat(Executor(reg, device="cpu").run(g, taps)),
            _flat(JExecutor(jreg).run(jg, taps)))


@pytest.mark.parametrize("node", range(5, 8))
def test_vit_saliency_matches_jax(vit_modes, node):
    """Node 5: ig; 6: smooth (per-sample range, the normal draws); 7:
    Grad-CAM wrt block 0 (token-shaped g, the patch-grid render)."""
    got, want = vit_modes
    keys = [k for k in want if int(k.split("/")[0]) == node]
    assert len(keys) == 2
    for k in keys:
        _close(got[k], want[k], k)
    if node == 7:
        assert got["7/g"].shape == (1, 17, 64)
        assert got["7/o"].shape == (1, 3, 4, 4)


@pytest.mark.parametrize("shape", [(3, 5, 6), (2, 3, 4, 4), (4, 7)])
@pytest.mark.parametrize("mode", ["grad", "gradxinput", "ig", "smooth"])
def test_saliency_modes_match_jax(regs, mode, shape):
    """Each mode through cos on a CHW image (the channel-collapsed heat,
    one input range), a batch of images (per-sample heat and range) and a
    matrix (|attr| normalized as a whole)."""
    reg, jreg, _ = regs
    params = {"target": "max", "mode": mode, "steps": "4", "sigma": "0.3",
              "seed": "9"}
    x = _image(50, shape) * 2 - 1
    g, jg = _chain(Graph, "saliency", params, x), _chain(
        JGraph, "saliency", params, x)
    taps = {(1, "o"), (1, "g")}
    got = _flat(Executor(reg, device="cpu").run(g, taps))
    want = _flat(JExecutor(jreg).run(jg, taps))
    for k in want:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("variant", [VITN, SWINN, TOMEN])
def test_generated_saliency_graph_matches_jax(regs, variant):
    """The model's generated saliency graph (dream at 3 steps, occlusion
    patch 16 stride 12 on 32 px: overlapping windows, the last clamped)
    equals JAX's JSON and gives JAX's values at every output."""
    reg, jreg, models = regs
    tm, jm = models[variant]
    obj = tm.generate_saliency_graph_json()
    assert obj == jm.generate_saliency_graph_json()
    for n in obj["nodes"]:
        inst = n["instance"]
        if inst.get("endpoint") == "dream":
            inst["params"]["steps"] = "3"
        if inst.get("endpoint") == "occlusion":
            inst["params"].update(patch="16", stride="12")
    image = _image(1, (3, 36, 40))
    g, jg = schema.graph_from_json(obj), jschema.graph_from_json(obj)
    for graph in (g, jg):
        graph.add_input(image, graph.nodes[0], "o")
    got = _flat(Executor(reg, device="cpu").run(g, "all"))
    want = _flat(JExecutor(jreg).run(jg, "all"))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], f"{variant} {k}")
    occ = next(n.index for n in g.nodes if n.name == "occlusion")
    assert got[f"{occ}/g"].shape == (3, 3)


OCCLUSION_CASES = [
    ((3, 7, 8), {"target": "sum", "patch": "3", "stride": "2"}),
    ((3, 9, 9), {"target": "max", "patch": "4", "stride": "3",
                 "fill": "0.5"}),
    ((2, 3, 6, 6), {"target": "sum", "patch": "2", "stride": "2"}),
    ((1, 5, 5), {"target": "class", "class": "2", "patch": "9"}),
]


@pytest.mark.parametrize("case", range(len(OCCLUSION_CASES)))
def test_occlusion_windows_match_jax(regs, case):
    """Overlapping windows, a clamped last window, a batched leaf, a patch
    larger than the image; the masked forwards run in chunks of
    ``OCCLUSION_CHUNK`` (case 1 has 9 positions, 0 has 12)."""
    reg, jreg, _ = regs
    shape, params = OCCLUSION_CASES[case]
    x = _image(10 + case, shape)

    def build(graph_cls):
        g = graph_cls()
        c = g.add_node("cos", {"A": "1.5", "b": "0.25"})
        o = g.add_node("occlusion", params)
        g.connect(c, "o", o, "o")
        g.add_input(x, c, "o")
        return g

    g, jg = _both(build)
    got = _flat(Executor(reg, device="cpu").run(g, {(1, "o"), (1, "g")}))
    want = _flat(JExecutor(jreg).run(jg, {(1, "o"), (1, "g")}))
    for k in want:
        _close(got[k], want[k], k)


def test_occlusion_chunks_equal_one_position_at_a_time(regs, monkeypatch):
    """The chunked masked forwards give each position's score as a pass of
    that one position does (chunk 1)."""
    reg, _, _ = regs
    g = _vit_chain(Graph, {"target": "max", "patch": "8", "stride": "8"},
                   "occlusion")
    ex = Executor(reg, device="cpu")
    chunked = ex.run(g, {(len(g.nodes) - 1, "g")})
    monkeypatch.setattr(T, "OCCLUSION_CHUNK", 1)
    single = Executor(reg, device="cpu").run(g, {(len(g.nodes) - 1, "g")})
    _close(chunked[len(g.nodes) - 1]["g"], single[len(g.nodes) - 1]["g"])


def _vit_chain(graph_cls, params, kind):
    g = graph_cls()
    chain = [g.add_node(f"{VITN}:{n}") for n in
             ("embed", "blocks.0", "blocks.1", "norm", "head")]
    for a, b in zip(chain, chain[1:]):
        g.connect(a, "o", b, "o")
    g.connect(chain[-1], "o", g.add_node(kind, params), "o")
    g.add_input(_image(4, (1, 3, 32, 32)), chain[0], "o")
    return g


# -- SmoothGrad's noise -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5, 123456789, 4294967295])
def test_fold_in_is_jax_bit_for_bit(seed):
    key = jax.random.key(np.uint32(seed))
    for data in (0, 1, 7, 15, 2 ** 31 + 3):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(key, data)))
        got = T.fold_in((0, torch.tensor(seed, dtype=torch.int64)), data)
        assert [int(t) for t in got] == [int(v) for v in want], data


@pytest.mark.parametrize("seed", [0, 5, 4294967295])
def test_normal_draw_within_its_ulp_bound(seed):
    """The uniform floats under the normal draw are JAX's bit for bit;
    the draw itself within ``NORMAL_ULPS``."""
    for i in (0, 3, 15):
        jkey = jax.random.fold_in(jax.random.key(np.uint32(seed)), i)
        key = T.fold_in((0, torch.tensor(seed, dtype=torch.int64)), i)
        lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
        u_want = np.asarray(jax.random.uniform(jkey, (3, 32, 32),
                                               jnp.float32, lo, 1.0))
        u = (T._unit_floats(key[0], key[1], [3, 32, 32], "cpu")
             * T._NORMAL_SPAN + float(lo)).clamp_min(float(lo)).numpy()
        np.testing.assert_array_equal(u.view(np.uint32),
                                      u_want.view(np.uint32))
        want = np.asarray(jax.random.normal(jkey, (3, 32, 32), jnp.float32))
        got = T.normal_bits(key, [3, 32, 32]).numpy()
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= NORMAL_ULPS


# -- errors --------------------------------------------------------------------


def _chain(graph_cls, kind, params, x=None, mid=("cos", {"A": "2.0",
                                                          "b": "0.5"})):
    g = graph_cls()
    m = g.add_node(*mid)
    s = g.add_node(kind, params)
    g.connect(m, "o", s, "o")
    g.add_input(np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
                if x is None else x, m, "o")
    return g


def _two_inputs(graph_cls, kind, params):
    """cos(a) -> kind, with a second input on a parallel cos."""
    g = graph_cls()
    c0 = g.add_node("cos", {})
    c1 = g.add_node("cos", {})
    s = g.add_node(kind, params)
    g.connect(c0, "o", s, "o")
    x = np.ones((3, 4, 4), np.float32)
    g.add_input(x, c0, "o")
    g.add_input(x, c1, "o")
    return g


ERRORS = [
    ("saliency", {"target": "sum", "wrt": "5"}, _chain),
    ("saliency", {"target": "sum", "wrt": "node:9"}, _chain),
    ("saliency", {"target": "sum", "wrt": "node:0:zz"}, _chain),
    ("saliency", {"target": "sum", "wrt": "node:0:o:x"}, _chain),
    ("saliency", {"target": "sum", "wrt": "node:1"}, _two_inputs),
    ("dream", {"target": "sum", "wrt": "1"}, _two_inputs),
    ("occlusion", {"target": "sum"}, _chain),
    ("saliency", {"target": "blorp"}, _chain),
    ("saliency", {"mode": "wat"}, _chain),
    ("saliency", {"steps": "0"}, _chain),
    ("dream", {"steps": "0"}, _chain),
    ("dream", {"target": "nope"}, _chain),
    ("occlusion", {"patch": "0"}, _chain),
    ("occlusion", {"stride": "-1"}, _chain),
    ("saliency", {"class": "abc"}, _chain),
]


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_errors_match_jax(regs, case):
    """The node index and the text of the JAX executor's ``NodeError``:
    a wrt out of range, a missing wrt node or channel, a bad wrt spec, a
    wired tensor independent of the leaf, a non-image occlusion leaf, and
    bad params."""
    reg, jreg, _ = regs
    kind, params, build = ERRORS[case]
    g, jg = build(Graph, kind, params), build(JGraph, kind, params)
    taps = {(i, ch) for i, ch in ((1, "o"), (2, "o")) if i < len(g.nodes)
            and g.nodes[i].name == kind}
    with pytest.raises(JNodeError) as jerr:
        JExecutor(jreg).run(jg, taps)
    with pytest.raises(NodeError) as err:
        Executor(reg, device="cpu").run(g, taps)
    assert (err.value.node_index, err.value.node_name, str(err.value)) == (
        jerr.value.node_index, jerr.value.node_name, str(jerr.value))


def _nested(graph_cls):
    """x -> cos -> saliency(a) -> saliency(b): b's replay holds a."""
    g = graph_cls()
    c = g.add_node("cos", {"A": "2.0", "b": "0.5"})
    a = g.add_node("saliency", {"target": "sum"})
    b = g.add_node("saliency", {"target": "sum"})
    g.connect(c, "o", a, "o")
    g.connect(a, "o", b, "o")
    g.add_input(np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4), c,
                "o")
    return g


def test_nested_gradient_refused_on_the_eager_path_as_jax(regs):
    reg, jreg, _ = regs
    outs, errs = Executor(reg, device="cpu").run_eager(_nested(Graph))
    jouts, jerrs = JExecutor(jreg).run_eager(_nested(JGraph))
    assert errs == jerrs
    assert sorted(outs) == sorted(jouts) == [0, 1]
    _close(outs[1]["g"], jouts[1]["g"])


def test_nested_gradient_on_the_staged_path_matches_jax(regs):
    """The staged path composes them: b differentiates through a's
    gradient (a double backward through the plain ops)."""
    reg, jreg, _ = regs
    taps = {(2, "g"), (1, "g")}
    got = _flat(Executor(reg, device="cpu").run(_nested(Graph), taps))
    want = _flat(JExecutor(jreg).run(_nested(JGraph), taps))
    for k in want:
        _close(got[k], want[k], k)


# -- dynamic params, groups, eager paths -------------------------------------


SCRUBS = [
    ("saliency", {"target": "class", "class": "1"}, {"class": "3"}),
    ("saliency", {"mode": "smooth", "steps": "3", "sigma": "0.2",
                  "target": "sum"}, {"sigma": "0.5"}),
    ("saliency", {"mode": "smooth", "steps": "3", "seed": "1",
                  "target": "sum"}, {"seed": "-7"}),
    ("dream", {"target": "class", "class": "1", "steps": "4"},
     {"class": "2"}),
    ("dream", {"target": "sum", "steps": "4", "lr": "0.1"}, {"lr": "0.3"}),
    ("occlusion", {"target": "class", "class": "0", "patch": "2"},
     {"class": "3"}),
    ("occlusion", {"target": "sum", "patch": "2"}, {"fill": "0.7"}),
]


@pytest.mark.parametrize("case", range(len(SCRUBS)))
def test_dynamic_param_scrub_is_a_cache_hit_with_new_values(regs, case):
    reg, jreg, _ = regs
    kind, params, edit = SCRUBS[case]
    x = _image(20, (3, 4, 4))
    ex, jex = Executor(reg, device="cpu"), JExecutor(jreg)
    outs = []
    for n, p in enumerate((params, {**params, **edit})):
        g = _chain(Graph, kind, p, x)
        jg = _chain(JGraph, kind, p, x)
        got = _flat(ex.run(g, "all"))
        assert ex.last_stats.cache_hit == (n == 1)
        want = _flat(jex.run(jg, "all"))
        for k in want:
            _close(got[k], want[k], k)
        outs.append(got["1/o"])
    assert ex.cache_info()["entries"] == 1
    assert not np.array_equal(outs[0], outs[1])


STACKED = [
    ("saliency", {"target": "class", "mode": "grad"}, "class"),
    ("saliency", {"target": "sum", "mode": "smooth", "steps": "2"}, "seed"),
    ("dream", {"target": "class", "steps": "3"}, "class"),
    ("occlusion", {"target": "class", "patch": "2"}, "class"),
]


@pytest.mark.parametrize("case", range(len(STACKED)))
def test_stacked_group_of_distinct_values_equals_runs(regs, case):
    """Three graphs that differ in a dynamic value (and their images) share
    a group; one stacked pass gives each its own run's values bit for
    bit, the per-row semantics (CHW heat, per-sample SmoothGrad range)
    those of one request."""
    reg, _, _ = regs
    kind, params, key = STACKED[case]
    graphs = [_chain(Graph, kind, {**params, key: str(v)},
                     _image(30 + v, (3, 4, 4))) for v in (0, 2, 3)]
    ex = Executor(reg, device="cpu")
    assert len({ex.group_sig(g) for g in graphs}) == 1
    stacked = ex.run_stacked(graphs, "all")
    for g, res in zip(graphs, stacked):
        single = _flat(ex.run(g, "all"))
        for k, v in single.items():
            np.testing.assert_array_equal(_flat(res)[k], v, err_msg=k)
    assert not np.array_equal(_flat(stacked[0])["1/o"],
                              _flat(stacked[1])["1/o"])


def test_stacked_vit_saliency_equals_runs(regs):
    """A group of two through the ViT (its blocks stacked, the gradient
    step once a row): each row its own run's, within 1e-6 (the stacked
    blocks multiply a batch of 2)."""
    reg, _, _ = regs
    graphs = []
    for c in ("1", "4"):
        g = _vit_chain(Graph, {"target": "class", "class": c,
                               "mode": "gradxinput"}, "saliency")
        graphs.append(g)
    ex = Executor(reg, device="cpu")
    taps = {(5, "o"), (5, "g")}
    for g, res in zip(graphs, ex.run_stacked(graphs, taps)):
        single = _flat(ex.run(g, taps))
        for k, v in single.items():
            np.testing.assert_allclose(_flat(res)[k], v, atol=1e-6)


def _two_saliency(graph_cls, wrt="5"):
    """cos -> a good saliency, a saliency of ``wrt`` (5: out of range) and
    an occlusion."""
    g = graph_cls()
    c = g.add_node("cos", {"A": "2.0", "b": "0.5"})
    good = g.add_node("saliency", {"target": "sum"})
    bad = g.add_node("saliency", {"target": "sum", "wrt": wrt})
    occ = g.add_node("occlusion", {"target": "sum", "patch": "2"})
    g.connect(c, "o", good, "o")
    g.connect(c, "o", bad, "o")
    g.connect(c, "o", occ, "o")
    g.add_input(_image(40, (3, 4, 4)), c, "o")
    return g


@pytest.mark.parametrize("path", ["run_eager", "run_timed_eager"])
def test_eager_paths_isolate_a_bad_gradient_node(regs, path):
    """One misconfigured saliency node fails alone, with JAX's text; the
    good one and the occlusion beside it match the staged pass."""
    reg, jreg, _ = regs
    ex = Executor(reg, device="cpu")
    res = getattr(ex, path)(_two_saliency(Graph))
    errors = res[-1]
    _, jerrs = JExecutor(jreg).run_eager(_two_saliency(JGraph))
    assert errors == jerrs and list(errors) == [2]
    staged = _flat(ex.run(_two_saliency(Graph, "0"), {(1, "g"), (3, "g"),
                                                      (1, "o"), (3, "o")}))
    if path == "run_eager":
        for k, v in staged.items():
            i, ch = k.split("/")
            _close(res[0][int(i)][ch], v, k)
    else:
        timings, shapes, _ = res
        assert set(timings) == {0, 1, 3}
        assert shapes[3] == {"o": [3, 4, 4], "g": [2, 2]}


class _TwinProbe(NodeKind):
    """Counts its fn and grad_safe_fn calls (y = 2x both)."""

    def __init__(self):
        super().__init__("twin_probe")
        self.calls = {"fn": 0, "twin": 0}

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def _counted(self, which):
        def f(ins):
            self.calls[which] += 1
            return {"o": ins["o"] * 2.0}
        return f

    def fn(self, params):
        return self._counted("fn")

    def grad_safe_fn(self, params):
        return self._counted("twin")


@pytest.mark.parametrize("kind", ["saliency", "occlusion"])
def test_replay_runs_the_twin_and_occlusion_keeps_fn(kind):
    reg = Registry()
    T.register_builtin(reg)
    probe = _TwinProbe()
    probe.register(reg)
    g = Graph()
    p = g.add_node("twin_probe", {})
    s = g.add_node(kind, {"target": "sum", "patch": "2"})
    g.connect(p, "o", s, "o")
    g.add_input(np.ones((3, 4, 4), np.float32), p, "o")
    out = Executor(reg, device="cpu").run(g, {(1, "g")})
    if kind == "saliency":
        np.testing.assert_allclose(out[1]["g"], 2.0)
        assert probe.calls["twin"] >= 1 and probe.calls["fn"] == 1
    else:
        assert probe.calls == {"fn": 2 + 1, "twin": 0}


def test_model_twin_runs_in_the_replay():
    """A ``TorchModel`` layer with ``grad_layers``: the pass runs its fn,
    the saliency replay its twin."""
    calls = {"fn": 0, "twin": 0}

    def layer(which):
        def f(p, ins):
            calls[which] += 1
            return {"o": ins["o"] * 2.0}
        return f

    reg = Registry()
    T.register_builtin(reg)
    TorchModel("twiny", [("scale", [], layer("fn"))], params={},
               layer_params_fn=lambda p, n: None,
               grad_layers={"scale": layer("twin")}).register(reg)
    g = Graph()
    m = g.add_node("twiny:scale")
    s = g.add_node("saliency", {"target": "sum"})
    g.connect(m, "o", s, "o")
    g.add_input(np.linspace(0, 1, 8, dtype=np.float32), m, "o")
    out = Executor(reg, device="cpu").run(g, {(1, "g")})
    np.testing.assert_allclose(out[1]["g"], 2.0)
    assert calls == {"fn": 1, "twin": 1}


class _ModeProbe(NodeKind):
    """Records whether its fn runs in inference mode (y = x + 1)."""

    def __init__(self):
        super().__init__("mode_probe")
        self.modes = []

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def fn(self, params):
        def f(ins):
            self.modes.append(torch.is_inference_mode_enabled())
            return {"o": ins["o"] + 1.0}
        return f


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("entry", ["run", "run_stacked", "run_eager",
                                   "run_timed_eager"])
def test_pass_runs_in_inference_mode_unless_it_differentiates(entry, grad):
    """A graph with no gradient node runs under inference_mode; one with a
    gradient node under no_grad, whose tensors autograd can save."""
    reg = Registry()
    T.register_builtin(reg)
    probe = _ModeProbe()
    probe.register(reg)
    g = Graph()
    p = g.add_node("mode_probe", {})
    if grad:
        g.connect(p, "o", g.add_node("occlusion", {"target": "sum",
                                                   "patch": "2"}), "o")
    g.add_input(np.ones((3, 4, 4), np.float32), p, "o")
    ex = Executor(reg, device="cpu")
    if entry == "run_stacked":
        ex.run_stacked([g, g])
    else:
        getattr(ex, entry)(g)
    assert probe.modes and all(m is not grad for m in probe.modes)


@pytest.mark.parametrize("kind", ["saliency", "dream"])
def test_gradient_graph_after_an_inference_pass(regs, kind):
    """The model's chain run alone first (inference_mode, which fills the
    device-constant caches), then with a gradient node on the same
    executor: equal bit for bit to a fresh executor's run."""
    reg, _, _ = regs
    params = {"target": "class", "class": "2", "steps": "2"}
    g = _vit_chain(Graph, params, kind)
    taps = {(5, "g" if kind == "saliency" else "delta")}
    plain = _vit_chain(Graph, {"A": "1.0", "b": "0.0"}, "cos")
    ex = Executor(reg, device="cpu")
    ex.run(plain, {(4, "o")})
    ex.run_stacked([plain, plain], {(4, "o")})
    after = _flat(ex.run(g, taps))
    fresh = _flat(Executor(reg, device="cpu").run(g, taps))
    for k, v in fresh.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)


def test_quantized_vit_twins_dequantize(regs):
    """Weight-only int8: the twins exist and dequantize inline; saliency
    through them equals JAX's (its twins dequantize the same bits)."""
    reg0, _, models = regs
    jm = models[VITN][1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VARIANTS, "vit_q", jvit.ViTConfig("vit_q", **VIT))
        mp.setitem(tvit.VARIANTS, "vit_q", tvit.ViTConfig("vit_q", **VIT))
        reg, jreg = Registry(), JRegistry()
        T.register_builtin(reg)
        J.register_builtin(jreg)
        tm = make_vit_model("vit_q", params=from_jax(jax.tree.map(
            np.asarray, jm.params)), device="cpu", quantize="w8")
        assert tm.grad_layers and set(tm.grad_layers) == {
            ln for ln, _, _ in tm.layers}
        tm.register(reg)
        jvit_make("vit_q", params=jm.params, quantize="w8").register(jreg)

        def build(graph_cls):
            g = graph_cls()
            chain = [g.add_node(f"vit_q:{n}") for n in
                     ("embed", "blocks.0", "blocks.1", "norm", "head")]
            for a, b in zip(chain, chain[1:]):
                g.connect(a, "o", b, "o")
            g.connect(chain[-1], "o", g.add_node("saliency",
                                                 {"target": "max"}), "o")
            g.add_input(_image(4, (1, 3, 32, 32)), chain[0], "o")
            return g

        got = _flat(Executor(reg, device="cpu").run(build(Graph), {(5, "g")}))
        want = _flat(JExecutor(jreg).run(build(JGraph), {(5, "g")}))
        _close(got["5/g"], want["5/g"])
        assert np.abs(got["5/g"]).max() > 0


# -- the saved graphs ------------------------------------------------------------


SAVED = ["vit_t16", "vit_t16@256", "deit_s16", "dinov2_s14",
         "dinov2_s14_reg", "swin_t", "vit_b16_tome", "vit_s16_tome"]


@pytest.mark.parametrize("variant", SAVED)
def test_committed_saliency_graph_is_generated_again(variant):
    """Each ported family's committed ``<variant>_saliency.json`` (written
    by the JAX server) is what the port's model generates, and loads and
    validates against the model's kinds on the CPU, its taps resolving.
    The weights are seeded at the real widths; the graph's JSON does not
    depend on them."""
    from interactive_vit_tpu_torch.graph.executor import resolve_taps

    with open(os.path.join(GRAPHS, f"{variant}_saliency.json")) as f:
        saved = json.load(f)
    model = make_model(variant, device="cpu")
    assert model.generate_saliency_graph_json() == saved
    reg = Registry()
    T.register_builtin(reg)
    model.register(reg)
    g = schema.graph_from_json(saved)
    g.add_input(np.zeros((3, 8, 8), np.float32), g.nodes[0], "o")
    Executor(reg, device="cpu").validate(g)
    kinds = {n.name for n in g.nodes}
    assert {"saliency", "dream", "occlusion"} <= kinds
    assert (variant + ":attrib" in kinds) == (variant not in (
        "swin_t", "vit_b16_tome", "vit_s16_tome"))
    assert resolve_taps(g, "primary", reg)


# -- the entry points ---------------------------------------------------------


def test_server_and_run_graph_turn_tf32_off(tmp_path):
    from interactive_vit_tpu_torch.serving.server import build_app
    from interactive_vit_tpu_torch.tools import run_graph

    for run in (lambda: build_app(models=(), device="cpu").close(),
                lambda: run_graph.main(["demo_noise", "--out",
                                        str(tmp_path), "--device", "cpu"])):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            run()
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False


def test_server_writes_the_saliency_graph(tmp_path, regs):
    """With ``--graphs-dir`` the server writes a classifier's saliency
    graph as the JAX server does (the tiny ViT's here); /compute serves it
    as ``Executor.run`` does and /debug_eval times its gradient nodes."""
    import urllib.request

    from interactive_vit_tpu_torch.serving.server import build_app
    from interactive_vit_tpu_torch.wire.codec import (
        REQUEST_MAGIC, decode_message, encode_message,
    )

    _, _, models = regs
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tvit.VARIANTS, VITN, tvit.ViTConfig(VITN, **VIT))
        app = build_app(models=[VITN], graphs_dir=str(tmp_path),
                        device="cpu")
    try:
        obj = app.graphs.load(f"{VITN}_saliency.json")
        assert obj == models[VITN][1].generate_saliency_graph_json()
        for n in obj["nodes"]:
            if n["instance"].get("endpoint") == "dream":
                n["instance"]["params"]["steps"] = "2"
        g = schema.graph_from_json(obj)
        g.add_input(_image(2), g.nodes[0], "o")
        body, tensors = decode_message(Request.encode(g),
                                       expect_magic=REQUEST_MAGIC)
        req = encode_message(REQUEST_MAGIC, body, tensors)
        httpd = app.serve("127.0.0.1", 0, background=True)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    url + "/compute", data=req, method="POST"),
                    timeout=60) as r:
                got = _flat(Response.decode(r.read()))
            with urllib.request.urlopen(urllib.request.Request(
                    url + "/debug_eval", data=req, method="POST"),
                    timeout=60) as r:
                dbg = json.loads(r.read())
        finally:
            httpd.shutdown()
        want = _flat(app.executor.run(g, "primary"))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)
        grad_nodes = {str(n.index) for n in g.nodes if n.name in (
            "saliency", "dream", "occlusion", f"{VITN}:attrib")}
        assert not dbg.get("errors")
        assert grad_nodes <= set(dbg["timings_ms"])
    finally:
        app.close()


def test_run_graph_runs_a_saliency_graph(regs, tmp_path):
    """``tools/run_graph.py`` on the tiny ViT's saliency graph (dream at 2
    steps): every gradient node's outputs in the manifest, occlusion's
    heatmap finite, image-shaped and rendered to a PNG."""
    from interactive_vit_tpu_torch.tools import run_graph

    _, _, models = regs
    obj = models[VITN][0].generate_saliency_graph_json()
    for n in obj["nodes"]:
        if n["instance"].get("endpoint") == "dream":
            n["instance"]["params"]["steps"] = "2"
    path = tmp_path / "sal.json"
    path.write_text(json.dumps(obj))
    image = tmp_path / "image.npy"
    np.save(image, _image(6))
    out = tmp_path / "taps"
    assert run_graph.main([str(path), "--image", str(image), "--out",
                           str(out), "--device", "cpu"]) == 0
    manifest = json.loads((out / "manifest.json").read_text())
    names = {m["name"] for m in manifest.values()}
    assert {"saliency", "dream", "occlusion", f"{VITN}:attrib"} <= names
    stem, meta = next((s, m) for s, m in manifest.items()
                      if m["name"] == "occlusion")
    assert meta["shape"] == [3, 40, 36] and meta["png"]
    assert np.isfinite(np.load(out / f"{stem}.npy")).all()
