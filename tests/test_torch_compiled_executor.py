"""The executor's compiled path on the CPU: the program signature and its
LRU cache, staging, the dynamic-param refresh (``cos``'s A and b), the
stats, power-of-two buckets for stacked groups, and ``precompile``,
against the JAX executor on the same graphs and seeded numpy inputs.

Off the card the staged pass runs eagerly, so these tests cover the
logic that the CUDA graph capture sits on; the capture and replay
themselves are ``tests/test_torch_cuda_graphs.py`` (card only) and
``chip_smoke.py``. ``cos`` is held to the JAX kind within 1e-6 in f32, a
2-block ViT at width 64 within 1e-4. Also the device-cached resize
matrices of ``ops/preprocess_mm.py``.
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
from interactive_vit_tpu.graph.ir import Graph as JGraph
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.vit_plugin import make_vit_model as jvit_make
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu_torch.graph.executor import Executor, NodeError
from interactive_vit_tpu_torch.graph.ir import Graph
from interactive_vit_tpu_torch.graph.registry import NodeKind, Registry
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import preprocess_mm as pmm
from interactive_vit_tpu_torch.ops.node_ops import CosNode, register_builtin
from interactive_vit_tpu_torch.runtime import constants
from interactive_vit_tpu_torch.wire.codec import Request, Response

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
COS_TOL = 1e-6
VIT_ATOL = 1e-4


@pytest.fixture
def reg():
    r = Registry()
    register_builtin(r)
    return r


@pytest.fixture
def jreg():
    r = JRegistry()
    jbuiltin(r)
    return r


def _cos_graph(mod, x, a=None, b=None):
    g = mod()
    params = {}
    if a is not None:
        params["A"] = str(a)
    if b is not None:
        params["b"] = str(b)
    n = g.add_node("cos", params)
    g.add_input(x, n, "o")
    return g


def _cos_chain(mod, x):
    g = mod()
    a = g.add_node("cos", {"A": "2.0"})
    b = g.add_node("cos")
    g.connect(a, "o", b, "o")
    g.add_input(x, a, "o")
    return g


def _close(got, want, tol=COS_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want,
                                                           dtype=np.float32),
                               rtol=tol, atol=tol)


# -- cos, the first kind with dynamic params ----------------------------------


def test_single_cos_node_matches_jax(reg, jreg):
    x = np.linspace(0, 3, 16, dtype=np.float32)
    got = Executor(reg, device="cpu").run(_cos_graph(Graph, x, 2.0, 1.0))
    want = JExecutor(jreg).run(_cos_graph(JGraph, x, 2.0, 1.0))
    _close(got[0]["o"], want[0]["o"])
    _close(got[0]["o"], np.cos(2.0 * x + 1.0))


def test_cos_kind_contract(reg):
    """Dynamic A and b as 0-d f32 captures; the io and the editable
    contents of the JAX kind; a bf16 stream stays bf16."""
    kind = reg.get_node("cos")
    assert kind.dynamic_params() == frozenset({"A", "b"})
    assert kind.dynamic_capture_keys() is None
    assert kind.dynamic_sig({"A": "3"}) is None
    caps = kind.captures({"A": "2.5", "b": "-1"})
    assert {k: (v.shape, v.dtype, float(v)) for k, v in caps.items()} == {
        "A": ((), torch.float32, 2.5), "b": ((), torch.float32, -1.0)}
    assert kind.io({}) == {"ins": ["o"], "outs": ["o"]}
    assert 'data-param="A"' in kind.contents({"A": "2"})
    x = torch.linspace(-1, 1, 8, dtype=torch.bfloat16)
    y = kind.fn({})({"o": x}, kind.captures({"A": "2.0", "b": "0.5"}))["o"]
    assert y.dtype == torch.bfloat16
    jy = jnp.cos(jnp.asarray(np.float32(2.0)).astype(jnp.bfloat16)
                 * jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                 + jnp.asarray(np.float32(0.5)).astype(jnp.bfloat16))
    # one bf16 ulp: the two libraries' f32 cos may round to either side
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), atol=2 ** -8)


def test_cos_fixture_request_bytes(reg):
    """The committed client request for ``cos`` decodes and evaluates to
    its pinned values, and the committed response decodes to ours."""
    with open(os.path.join(HERE, "fixtures", "node_fixtures.json")) as f:
        fx = json.load(f)["cos"]
    req = Request()
    req.decode(base64.b64decode(fx["request_b64"]))
    out = Executor(reg, device="cpu").run(req.graph, taps=req.taps)
    flat = {f"{i}/{ch}": v for i, sub in out.items() for ch, v in sub.items()}
    assert sorted(flat) == sorted(fx["expected"])
    committed = Response.decode(base64.b64decode(fx["response_b64"]))
    for key, exp in fx["expected"].items():
        assert list(flat[key].shape) == exp["dims"]
        # the pinned values carry 6 decimals
        np.testing.assert_allclose(flat[key].ravel(),
                                   np.asarray(exp["values"], np.float32),
                                   atol=5e-5)
        i, ch = key.split("/")
        _close(flat[key], committed[int(i)][ch])


# -- the cache ----------------------------------------------------------------


def test_compile_cache_hit(reg, jreg):
    """The same shape and topology hits the cache (and gives the new
    values), a new shape misses: as the JAX executor."""
    ex, jex = Executor(reg, device="cpu"), JExecutor(jreg)
    hits, jhits = [], []
    for x in (np.zeros(4, np.float32), np.full(4, 1.0, np.float32),
              np.zeros(8, np.float32)):
        got = ex.run(_cos_graph(Graph, x))
        hits.append(ex.last_stats.cache_hit)
        want = jex.run(_cos_graph(JGraph, x))
        jhits.append(jex.last_stats.cache_hit)
        _close(got[0]["o"], want[0]["o"])
    assert hits == jhits == [False, True, False]
    stats = ex.last_stats.as_dict()
    assert sorted(stats) == sorted(jex.last_stats.as_dict())
    assert stats["compile_s"] == 0.0 and stats["stage_s"] > 0


def test_compile_cache_lru_eviction(reg, jreg):
    ex = Executor(reg, max_cache_entries=2, device="cpu")
    jex = JExecutor(jreg, max_cache_entries=2)
    for size in (4, 8, 16):
        x = np.zeros(size, np.float32)
        ex.run(_cos_graph(Graph, x))
        jex.run(_cos_graph(JGraph, x))
    assert ex.cache_info()["entries"] == jex.cache_info()["entries"] == 2
    # the oldest (size 4) was evicted: running it again misses
    ex.run(_cos_graph(Graph, np.zeros(4, np.float32)))
    assert not ex.last_stats.cache_hit
    ex.clear_cache()
    assert ex.cache_info() == {"entries": 0, "captured_bytes": 0}
    assert Executor.MAX_CACHE_ENTRIES == JExecutor.MAX_CACHE_ENTRIES == 64


def test_unjitted_executor_path(reg, jreg):
    """use_jit=False: the staged pass runs eagerly, the same results as
    the JAX unjitted and jitted executors; the flag keys the program."""
    x = np.linspace(0, 1, 8, dtype=np.float32)
    ex = Executor(reg, use_jit=False, device="cpu")
    got = ex.run(_cos_chain(Graph, x))
    _close(got[1]["o"], JExecutor(jreg, use_jit=False).run(
        _cos_chain(JGraph, x))[1]["o"])
    _close(got[1]["o"], JExecutor(jreg).run(_cos_chain(JGraph, x))[1]["o"])
    _close(got[1]["o"], np.cos(np.cos(2.0 * x)))
    g = _cos_chain(Graph, x)
    assert ex.is_compiled(g, "all")
    assert not Executor(reg, device="cpu").is_compiled(g, "all")
    assert not ex.precompile(g)  # moot without use_jit, as in JAX


def test_dynamic_params_rekey_without_restaging(reg, jreg, monkeypatch):
    """An edit of cos's A hits the cached program (nothing is staged
    again) and delivers the new value; so does b; a new shape stages."""
    ex, jex = Executor(reg, device="cpu"), JExecutor(jreg)
    staged = []
    real = ex._stage
    monkeypatch.setattr(ex, "_stage",
                        lambda *a, **kw: staged.append(1) or real(*a, **kw))
    x = np.ones(4, np.float32)
    for a, b in ((1.0, None), (2.0, None), (2.0, 0.5)):
        got = ex.run(_cos_graph(Graph, x, a, b), taps="all")
        want = jex.run(_cos_graph(JGraph, x, a, b), taps="all")
        assert ex.last_stats.cache_hit == jex.last_stats.cache_hit
        _close(got[0]["o"], want[0]["o"])
        _close(got[0]["o"], np.cos(a * x + (b or 0.0)))
    assert staged == [1]
    assert ex.last_stats.cache_hit
    ex.run(_cos_graph(Graph, np.ones(5, np.float32), 3.0), taps="all")
    assert not ex.last_stats.cache_hit and staged == [1, 1]


def test_group_sig_leaves_out_dynamic_values(reg):
    ex = Executor(reg, device="cpu")
    x = np.ones(4, np.float32)
    sig = ex.group_sig(_cos_graph(Graph, x, 1.0))
    assert sig == ex.group_sig(_cos_graph(Graph, x, 7.5, -2.0))
    assert sig != ex.group_sig(_cos_graph(Graph, np.ones(5, np.float32)))
    # the signature keeps every param of a kind without dynamic params
    g1, g2 = Graph(), Graph()
    g1.add_node("img_src", {"k": "1"})
    g2.add_node("img_src", {"k": "2"})
    assert ex.group_sig(g1) != ex.group_sig(g2)


def test_dynamic_params_refresh_in_stacked_runs(reg, jreg):
    ex, jex = Executor(reg, device="cpu"), JExecutor(jreg)

    def graphs(mod, a, k=3):
        return [_cos_graph(mod, np.full(4, float(i), np.float32), a)
                for i in range(k)]

    r1 = ex.run_stacked(graphs(Graph, 1.0), taps="all")
    r2 = ex.run_stacked(graphs(Graph, 3.0), taps="all")
    assert ex.last_stats.cache_hit
    j2 = jex.run_stacked(graphs(JGraph, 3.0), taps="all")
    for i in range(3):
        _close(r1[i][0]["o"], np.cos(1.0 * np.full(4, float(i))))
        _close(r2[i][0]["o"], np.cos(3.0 * np.full(4, float(i))))
        _close(r2[i][0]["o"], j2[i][0]["o"])


def test_dynamic_param_edge_cases(reg, jreg):
    """A bad param decode in captures() is attributed to its node, on a
    cache miss and on a hit; a bf16 stream stays bf16 through cos and
    agrees with the JAX kind's bf16 values."""
    ex = Executor(reg, device="cpu")
    x = np.ones(4, np.float32)
    with pytest.raises(NodeError) as ei:
        ex.run(_cos_graph(Graph, x, "abc"))
    assert ei.value.node_index == 0 and "node 0 (cos)" in str(ei.value)
    ex.run(_cos_graph(Graph, x, 1.0))
    with pytest.raises(NodeError) as ei:
        ex.run(_cos_graph(Graph, x, "abc"))  # a hit: refresh attributes
    assert ei.value.node_index == 0
    with pytest.raises(NodeError):
        ex.run_stacked([_cos_graph(Graph, x, 1.0), _cos_graph(Graph, x, "?")])

    xb = torch.linspace(-2, 2, 8, dtype=torch.bfloat16)
    got = ex.run(_cos_graph(Graph, xb, 2.0), taps="all")[0]["o"]
    want = JExecutor(jreg).run(_cos_graph(
        JGraph, jnp.asarray(xb.float().numpy(), jnp.bfloat16), 2.0),
        taps="all", to_host=False)[0]["o"]
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=2 ** -8)
    # the values the host gets are bf16's: cos(2x) rounded to 8 bits
    assert np.array_equal(got, torch.from_numpy(got).to(
        torch.bfloat16).float().numpy())


def test_stacked_batches_mixed_dynamic_values(reg, jreg):
    """Requests that differ only in A share one pass, each with its own
    A; a cache hit on new values refreshes every row; mixed static
    signatures refuse to stack."""
    ex, jex = Executor(reg, device="cpu"), JExecutor(jreg)
    xs = [np.full(4, float(i + 1), np.float32) for i in range(3)]
    for a_vals, hit in (([0.5, 1.0, 2.0], False), ([3.0, 4.0, 5.0], True)):
        res = ex.run_stacked([_cos_graph(Graph, x, a)
                              for a, x in zip(a_vals, xs)], taps="all")
        assert ex.last_stats.cache_hit == hit
        jres = jex.run_stacked([_cos_graph(JGraph, x, a)
                                for a, x in zip(a_vals, xs)], taps="all")
        for i, (a, x) in enumerate(zip(a_vals, xs)):
            _close(res[i][0]["o"], np.cos(a * x))
            _close(res[i][0]["o"], jres[i][0]["o"])
    with pytest.raises(ValueError, match="mixed graph signatures"):
        ex.run_stacked([_cos_graph(Graph, xs[0]),
                        _cos_graph(Graph, np.ones(5, np.float32))])


def test_group_of_three_runs_in_bucket_four(reg):
    """K=3 pads to the bucket of 4 (copies of request 0) and equals three
    ``run``s bit for bit; K=1..8 map to the JAX executor's buckets."""
    ex = Executor(reg, device="cpu")
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2, 5)).astype(np.float32) for _ in range(3)]
    graphs = [_cos_chain(Graph, x) for x in xs]
    seen = []
    real = CosNode.stacked_fn

    def spy(self, params, caps_axes=None):
        f = real(self, params, caps_axes)
        return lambda ins, caps: seen.append(ins["o"].shape[0]) or f(ins,
                                                                     caps)

    CosNode.stacked_fn = spy
    try:
        got = ex.run_stacked(graphs)
    finally:
        CosNode.stacked_fn = real
    assert seen == [4, 4] and len(got) == 3
    for g, res in zip(graphs, got):
        single = ex.run(g)
        assert list(res) == list(single)
        for i in single:
            np.testing.assert_array_equal(res[i]["o"], single[i]["o"])
    assert [ex._stacked_bucket(k) for k in range(1, 9)] == [
        JExecutor(JRegistry())._stacked_bucket(k) for k in range(1, 9)]


def test_is_compiled_is_cache_membership(reg):
    ex = Executor(reg, device="cpu")
    x = np.ones((2, 3), np.float32)
    g = _cos_chain(Graph, x)
    assert not ex.is_compiled(g, "all")
    ex.run(g)
    assert ex.is_compiled(g, "all") and ex.cache_info()["entries"] == 1
    assert not ex.is_compiled(g, "sinks")
    assert not ex.is_compiled(g, "all", 1)  # run_stacked([g]): stacked
    ex.run_stacked([g, _cos_chain(Graph, x + 1), _cos_chain(Graph, x)])
    assert ex.is_compiled(g, "all", 3) and ex.is_compiled(g, "all", 4)
    assert not ex.is_compiled(g, "all", 2)
    assert ex.cache_info()["entries"] == 2
    assert ex.precompile(g, "all", batch=2)
    assert not ex.precompile(g, "all", batch=2)
    assert ex.is_compiled(g, "all", 2)
    assert ex.precompile(g, "sinks")
    assert ex.is_compiled(g, "sinks")
    assert ex.cache_info()["entries"] == 4
    ex.run(g, "sinks")
    assert ex.last_stats.cache_hit  # precompile filled it
    ex.clear_cache()
    assert not ex.is_compiled(g, "all")


def test_error_attribution_on_miss(reg):
    """An unknown kind or a missing input is attributed to its node even
    though the signature is computed before validation."""
    ex = Executor(reg, device="cpu")
    g = Graph()
    g.add_node("no_such_kind")
    with pytest.raises(NodeError) as ei:
        ex.run(g)
    assert ei.value.node_index == 0
    g = Graph()
    g.add_node("cos")
    with pytest.raises(NodeError, match="missing input 'o'"):
        ex.run(g, taps="all")
    assert not ex.is_compiled(g, "all")


class _SizedDyn(NodeKind):
    """A kind whose dynamic capture's length is its dynamic value: the
    staged program (on a card, its buffers) holds for one length only,
    unless the kind declares the length in ``dynamic_sig``."""

    def __init__(self, name, sig):
        super().__init__(name)
        self._sig = sig

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def dynamic_params(self):
        return frozenset({"n"})

    def dynamic_sig(self, params):
        return params.get("n", "1") if self._sig else None

    def captures(self, params):
        return {"v": torch.ones(int(params.get("n", 1)))}

    def fn(self, params):
        return lambda ins, caps: {"o": ins["o"] * caps["v"].sum()}


@pytest.mark.parametrize("declared", [False, True])
def test_dynamic_capture_shapes_need_dynamic_sig(reg, declared):
    ex = Executor(reg, device="cpu")
    _SizedDyn("sized_dyn", declared).register(reg)

    def graph(n):
        g = Graph()
        node = g.add_node("sized_dyn", {"n": str(n)})
        g.add_input(np.ones(3, np.float32), node, "o")
        return g

    np.testing.assert_array_equal(ex.run(graph(2))[0]["o"], 2 * np.ones(3))
    if not declared:
        with pytest.raises(NodeError, match="dynamic_sig"):
            ex.run(graph(5))
        with pytest.raises(NodeError, match="dynamic_sig"):
            ex.run_stacked([graph(2), graph(2), graph(5)])
        np.testing.assert_array_equal(ex.run(graph(2))[0]["o"],
                                      2 * np.ones(3))
        assert ex.last_stats.cache_hit
        return
    np.testing.assert_array_equal(ex.run(graph(5))[0]["o"], 5 * np.ones(3))
    assert not ex.last_stats.cache_hit
    assert ex.group_sig(graph(2)) != ex.group_sig(graph(5))
    res = ex.run_stacked([graph(4), graph(4)])
    np.testing.assert_array_equal(res[1][0]["o"], 4 * np.ones(3))


# -- device constants owned by the programs -------------------------------------


def _constant_calls():
    from interactive_vit_tpu_torch.models import swin
    from interactive_vit_tpu_torch.ops import layers

    dev = torch.device("cpu")
    return {
        "crop_matrices": lambda: pmm.crop_matrices(40, 48, 32, None,
                                                   "bilinear", dev),
        "norm_constants": lambda: pmm.norm_constants(torch.float32, dev),
        "index_on": lambda: layers.index_on((1, 4, 9), dev),
        "swin_bias_index": lambda: swin._bias_index(7, dev),
        "swin_mask_on": lambda: swin._mask_on(14, 7, 3, dev),
    }


@pytest.mark.parametrize("name", sorted(_constant_calls()))
def test_device_constants_are_retained(name):
    """Each cached device constant that a pass reads, on a miss and on a
    hit, is handed to the ``retained()`` collection open in the thread
    (the executor's warm pass and capture keep them in the program, whose
    graph reads their addresses); outside one nothing is kept, and a
    nested block collects its own."""
    call = _constant_calls()[name]
    constants.clear_all()
    call()  # outside any collection
    with constants.retained() as outer:
        first = call()  # a hit
        with constants.retained() as inner:
            call()
        constants.clear_all()
        fresh = call()  # a miss: built again
    assert len(inner) == 1 and len(outer) == 2
    assert outer[0] is first and outer[1] is fresh and inner[0] is first
    assert fresh is not first


# -- a 2-block ViT at width 64 --------------------------------------------------

VIT = dict(img_size=32, patch=16, width=64, depth=2, heads=4,
           num_classes=10)


@pytest.fixture(scope="module")
def vit():
    name = "vit_ce_port"
    jvit.VARIANTS[name] = jvit.ViTConfig(name, **VIT)
    tvit.VARIANTS[name] = tvit.ViTConfig(name, **VIT)
    try:
        jparams = jvit.init_params(jax.random.key(5), jvit.VARIANTS[name])
        reg, jreg = Registry(), JRegistry()
        register_builtin(reg)
        jbuiltin(jreg)
        jvit_make(name, params=jparams).register(jreg)
        model = make_vit_model(name, params=from_jax(jax.tree.map(
            np.asarray, jparams)), device="cpu")
        model.register(reg)
        yield name, reg, jreg, model.generate_graph_json()
    finally:
        del jvit.VARIANTS[name]
        del tvit.VARIANTS[name]


def _vit_graph(vit, seed, jax_side=False):
    from interactive_vit_tpu.wire import schema as jschema
    from interactive_vit_tpu_torch.wire import schema

    _, _, _, obj = vit
    g = (jschema if jax_side else schema).graph_from_json(obj)
    img = np.random.default_rng(seed).random((3, 40, 48), dtype=np.float32)
    g.add_input(img, g.nodes[0], "o")
    return g


# nodes: 0 transform, 1 embed, 2-3 blocks, 4 norm, 5 head, 6 category
VIT_TAPS = [(2, "attn"), (2, "r"), (3, "o"), (5, "o")]


def _vit_close(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        assert sorted(got[i]) == sorted(want[i])
        for ch in want[i]:
            ref = np.asarray(want[i][ch], np.float32)
            assert got[i][ch].shape == ref.shape, (i, ch)
            np.testing.assert_allclose(got[i][ch], ref, atol=VIT_ATOL,
                                       err_msg=f"node {i} {ch}")


def test_vit_run_and_cache_hit_match_jax(vit):
    _, reg, jreg, _ = vit
    ex, jex = Executor(reg, device="cpu"), JExecutor(jreg)
    for seed, hit in ((1, False), (2, True)):
        got = ex.run(_vit_graph(vit, seed), VIT_TAPS)
        assert ex.last_stats.cache_hit == hit
        _vit_close(got, jex.run(_vit_graph(vit, seed, True), VIT_TAPS))
    assert ex.is_compiled(_vit_graph(vit, 3), VIT_TAPS)
    assert not ex.is_compiled(_vit_graph(vit, 3), "primary")


def test_vit_stacked_groups_match_jax(vit):
    """A group of 3 (bucket 4), then a hit with other images: each equal
    to separate runs bit for bit, and to the JAX run_stacked at 1e-4."""
    _, reg, jreg, _ = vit
    ex, jex = Executor(reg, device="cpu"), JExecutor(jreg)
    for seeds, hit in (((4, 5, 6), False), ((7, 8, 9), True)):
        got = ex.run_stacked([_vit_graph(vit, s) for s in seeds], VIT_TAPS)
        assert ex.last_stats.cache_hit == hit and len(got) == 3
        want = jex.run_stacked([_vit_graph(vit, s, True) for s in seeds],
                               VIT_TAPS)
        for s, res, jres in zip(seeds, got, want):
            _vit_close(res, jres)
            single = ex.run(_vit_graph(vit, s), VIT_TAPS)
            for i in single:
                for ch in single[i]:
                    np.testing.assert_array_equal(res[i][ch], single[i][ch])


# -- per-pass uploads -------------------------------------------------------------


@pytest.mark.parametrize("h,w,size,method", [
    (40, 48, 32, "bilinear"), (240, 300, 224, "bicubic"),
    (224, 224, 224, "bilinear")])
def test_preprocess_matrices_cached_on_the_device(h, w, size, method):
    """The cached crop matrices and constants equal freshly built ones,
    and ``preprocess_mm`` gives the bits of the uncached formula."""
    dev = torch.device("cpu")
    rh, rw = pmm.crop_matrices(h, w, size, None, method, dev)
    assert pmm.crop_matrices(h, w, size, None, method, dev)[0] is rh
    nh, nw = pmm.target_dims(h, w, size, None)
    top, left = (nh - size) // 2, (nw - size) // 2
    fresh_h = torch.from_numpy(
        pmm.resize_matrix(h, nh, method)[top:top + size].copy())
    fresh_w = torch.from_numpy(
        pmm.resize_matrix(w, nw, method)[left:left + size].copy())
    assert torch.equal(rh, fresh_h) and torch.equal(rw, fresh_w)
    images = torch.from_numpy(np.random.default_rng(3).random(
        (2, 3, h, w), dtype=np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        x = images.to(dtype)
        y = x.reshape(6, h, w).float()
        y = torch.matmul(torch.matmul(fresh_h, y), fresh_w.t())
        y = y.reshape(2, 3, size, size).to(dtype)
        m = torch.tensor(pmm.IMAGENET_MEAN, dtype=dtype).reshape(1, -1, 1, 1)
        s = torch.tensor(pmm.IMAGENET_STD, dtype=dtype).reshape(1, -1, 1, 1)
        want = (y - m) / s
        got = pmm.preprocess_mm(x, size, method=method)
        assert got.dtype == dtype
        assert torch.equal(got, want)
        assert torch.equal(pmm.preprocess_mm(x[0], size, method=method),
                           want[0])
    cm, cs = pmm.norm_constants(torch.float32, dev)
    assert pmm.norm_constants(torch.float32, dev)[0] is cm
    assert cm.shape == cs.shape == (1, 3, 1, 1)
