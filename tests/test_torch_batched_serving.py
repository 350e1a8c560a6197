"""Micro-batched serving on the CPU: ``Executor.run_stacked`` as one
batched pass, the pipelined batcher, and the server's POST routes and
flags, against separate runs and the JAX package.

Small configs (a ViT with ``attn`` / ``r`` / ``cls`` taps, a Swin with
window taps, a ToMe ViT with its ``s`` / ``a`` / ``merge`` channels) get
weights from the JAX initializer in both packages (handed to the port
through ``models/weights.from_jax``). A group of K requests must give K
separate ``run``s' results bit for bit, and the JAX executor's
``run_stacked`` within f32 atol 1e-4.
"""

import concurrent.futures
import json
import logging
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from interactive_vit_tpu.graph.executor import Executor as JExecutor
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import swin as jswin
from interactive_vit_tpu.models import tome as jtome
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.swin_plugin import make_swin_model as jswin_make
from interactive_vit_tpu.models.tome_plugin import make_tome_model as jtome_make
from interactive_vit_tpu.models.vit_plugin import make_vit_model as jvit_make
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph.executor import Executor, NodeError
from interactive_vit_tpu_torch.graph.ir import Graph
from interactive_vit_tpu_torch.graph.registry import (
    NodeKind, Registry, scan_plugins,
)
from interactive_vit_tpu_torch.models import swin as tswin
from interactive_vit_tpu_torch.models import tome as ttome
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.model_plugin import TorchModel
from interactive_vit_tpu_torch.models.swin_plugin import (
    SwinTorchModel, make_swin_model,
)
from interactive_vit_tpu_torch.models.tome_plugin import (
    ToMeModel, make_tome_model,
)
from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import fused_block as tfb
from interactive_vit_tpu_torch.ops import fused_window as tfw
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.serving import server as tserver
from interactive_vit_tpu_torch.serving.app import App
from interactive_vit_tpu_torch.serving.batcher import MicroBatcher
from interactive_vit_tpu_torch.wire import schema
from interactive_vit_tpu_torch.wire.codec import Request, Response

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
KS = (1, 2, 3, 5)

VIT = dict(img_size=32, patch=16, width=64, depth=3, heads=4,
           num_classes=10)
SWIN = dict(img_size=32, patch=4, embed_dim=16, depths=(2, 2),
            heads=(2, 4), window=4, num_classes=10)
TOME = dict(img_size=32, patch=8, width=64, depth=3, heads=4,
            num_classes=10, r=6)


class Family:
    """One small model in both packages: registries, the generated chain
    graph, its taps and node params, and the port model's layer fns."""

    def __init__(self, name, reg, jreg, model, graph_obj, taps,
                 node_params=None, shape=(3, 40, 48)):
        self.name, self.reg, self.jreg = name, reg, jreg
        self.model, self.graph_obj, self.taps = model, graph_obj, taps
        self.node_params = node_params or {}
        self.shape = shape

    def graph(self, seed, jax_side=False, shape=None):
        mod = jschema if jax_side else schema
        g = mod.graph_from_json(self.graph_obj)
        for i, params in self.node_params.items():
            g.nodes[i].params.update(params)
        img = np.random.default_rng(seed).random(shape or self.shape,
                                                 dtype=np.float32)
        g.add_input(img, g.nodes[0], "o")
        return g


def _registries():
    reg, jreg = Registry(), JRegistry()
    register_builtin(reg)
    jbuiltin(jreg)
    return reg, jreg


def _vit_family():
    name = "vit_bs_port"
    jcfg = jvit.ViTConfig(name, **VIT)
    jparams = jvit.init_params(jax.random.key(11), jcfg)
    reg, jreg = _registries()
    jvit_make(name, params=jparams).register(jreg)
    model = make_vit_model(name, params=from_jax(jax.tree.map(np.asarray,
                                                              jparams)),
                           device="cpu")
    model.register(reg)
    # nodes: 0 transform, 1 embed, 2-4 blocks, 5 norm, 6 head, 7 category
    taps = [(2, "attn"), (2, "r"), (3, "r"), (3, "cls"), (4, "attn"),
            (4, "r"), (4, "o"), (6, "o")]
    return Family(name, reg, jreg, model, model.generate_graph_json(), taps,
                  node_params={4: {"attn_heads": "[3, 1]"}})


def _swin_family():
    name = "swin_bs_port"
    jcfg, tcfg = jswin.SwinConfig(name, **SWIN), tswin.SwinConfig(name, **SWIN)
    jparams = jswin.init_params(jax.random.key(12), jcfg)
    reg, jreg = _registries()
    jswin_make(name, params=jparams, cfg=jcfg).register(jreg)
    model = make_swin_model(name, params=from_jax(jax.tree.map(np.asarray,
                                                               jparams)),
                            cfg=tcfg, device="cpu")
    model.register(reg)
    # nodes: 0 transform, 1 patch_embed, 2-3 stages.0.*, 4 merge.0,
    # 5-6 stages.1.*, 7 norm, 8 pool, 9 head, 10 category
    taps = [(2, "attn"), (3, "attn"), (5, "attn"), (6, "attn"), (4, "o"),
            (9, "o")]
    return Family(name, reg, jreg, model, model.generate_graph_json(), taps,
                  node_params={3: {"attn_win": "1"},
                               6: {"attn_heads": "[0, 3]"}})


def _tome_family():
    name = "tome_bs_port"
    jcfg = jtome.ToMeViTConfig(name, **TOME)
    jtome.VARIANTS[name] = jcfg
    ttome.VARIANTS[name] = ttome.ToMeViTConfig(name, **TOME)
    jparams = jvit.init_params(jax.random.key(13), jcfg)
    reg, jreg = _registries()
    jtome_make(name, params=jparams).register(jreg)
    model = make_tome_model(name, params=from_jax(jax.tree.map(np.asarray,
                                                               jparams)),
                            device="cpu")
    model.register(reg)
    # nodes: 0 transform, 1 embed, 2-4 blocks, 5 norm, 6 head, 7 category
    taps = [(2, "attn"), (2, "r"), (2, "merge"), (3, "s"), (3, "a"),
            (4, "merge"), (4, "r"), (4, "cls"), (6, "o")]
    return Family(name, reg, jreg, model, model.generate_graph_json(), taps)


@pytest.fixture(scope="module")
def families():
    vit_name = "vit_bs_port"
    jvit.VARIANTS[vit_name] = jvit.ViTConfig(vit_name, **VIT)
    tvit.VARIANTS[vit_name] = tvit.ViTConfig(vit_name, **VIT)
    try:
        yield {"vit": _vit_family(), "swin": _swin_family(),
               "tome": _tome_family()}
    finally:
        del jvit.VARIANTS[vit_name]
        del tvit.VARIANTS[vit_name]
        for table in (jtome.VARIANTS, ttome.VARIANTS):
            table.pop("tome_bs_port", None)


def _assert_same(got, want):
    """Keys, key order, shapes and values, bit for bit."""
    assert list(got) == list(want)
    for i in want:
        assert list(got[i]) == list(want[i])
        for ch in want[i]:
            assert got[i][ch].shape == want[i][ch].shape, (i, ch)
            np.testing.assert_array_equal(got[i][ch], want[i][ch],
                                          err_msg=f"node {i} {ch}")


# -- run_stacked as one pass ---------------------------------------------------


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("family", ["vit", "swin", "tome"])
def test_run_stacked_equals_separate_runs_exactly(families, family, k):
    fam = families[family]
    ex = Executor(fam.reg, device="cpu")
    graphs = [fam.graph(seed) for seed in range(k)]
    stacked = ex.run_stacked(graphs, fam.taps)
    assert len(stacked) == k
    for g, res in zip(graphs, stacked):
        _assert_same(res, ex.run(g, fam.taps))


@pytest.mark.parametrize("family", ["vit", "swin", "tome"])
def test_run_stacked_matches_jax_run_stacked(families, family):
    fam = families[family]
    ex = Executor(fam.reg, device="cpu")
    jex = JExecutor(fam.jreg)
    seeds = (21, 22, 23)
    got = ex.run_stacked([fam.graph(s) for s in seeds], fam.taps)
    want = jex.run_stacked([fam.graph(s, jax_side=True) for s in seeds],
                           fam.taps)
    assert len(got) == len(want) == len(seeds)
    for res, jres in zip(got, want):
        assert sorted(res) == sorted(jres)
        for i in jres:
            assert sorted(res[i]) == sorted(jres[i])
            for ch in jres[i]:
                ref = np.asarray(jres[i][ch], dtype=np.float32)
                assert res[i][ch].shape == ref.shape, (i, ch)
                np.testing.assert_allclose(res[i][ch], ref, atol=ATOL,
                                           err_msg=f"node {i} {ch}")


def _counting(fn, seen):
    def wrapped(x, *args, **kw):
        seen.append(x.shape[0])
        return fn(x, *args, **kw)
    return wrapped


def _counted_model(family, fam, seen):
    """The family's port model with its block kernel wrapped to record the
    batch of each call (the wrappers run their plain versions on the
    CPU)."""
    if family == "vit":
        cls, mod = TorchModel, tvit
        layers = tvit.layer_fns(tvit.VARIANTS[fam.name], block_impl=_counting(
            tfb.fused_attn_block, seen))
    elif family == "swin":
        cls, mod = SwinTorchModel, tswin
        layers = tswin.layer_fns(tswin.SwinConfig(fam.name, **SWIN),
                                 window_impl=_counting(
                                     tfw.fused_window_attn, seen))
    else:
        cls, mod = ToMeModel, ttome
        layers = ttome.layer_fns(ttome.VARIANTS[fam.name],
                                 block_impl=_counting(
                                     tfb.fused_attn_block, seen))
    model = cls(fam.name, layers, fam.model.params, mod.layer_params)
    return model, sum(1 for _, extra, _ in layers if extra)


@pytest.mark.parametrize("family", ["vit", "swin", "tome"])
def test_group_runs_each_block_once_with_batch_k(families, family):
    """A group of K calls each block's kernel wrapper once, on a batch of
    K's power-of-two bucket (K=3 runs padded to 4, as the JAX executor
    pads); the result is the same as with the unwrapped model."""
    fam = families[family]
    seen = []
    model, depth = _counted_model(family, fam, seen)
    reg, _ = _registries()
    model.register(reg)
    ex = Executor(reg, device="cpu")
    k = 3
    graphs = [fam.graph(seed) for seed in range(k)]
    got = ex.run_stacked(graphs, fam.taps)
    assert len(got) == k
    assert seen == [4] * depth
    seen.clear()
    single = ex.run(graphs[1], fam.taps)
    assert seen == [1] * depth
    for i in single:
        for ch in single[i]:
            np.testing.assert_allclose(got[1][i][ch], single[i][ch],
                                       atol=1e-6)


def test_deferred_runs_materialize_to_the_same_results(families):
    fam = families["vit"]
    ex = Executor(fam.reg, device="cpu")
    graphs = [fam.graph(seed) for seed in (1, 2)]
    assert not ex.is_compiled(graphs[0], fam.taps)
    assert not ex.is_compiled(graphs[0], fam.taps, 2)
    _assert_same(ex.run(graphs[0], fam.taps, defer=True).materialize(),
                 ex.run(graphs[0], fam.taps))
    assert ex.is_compiled(graphs[0], fam.taps)
    assert not ex.is_compiled(graphs[0], fam.taps, 2)
    handle = ex.run_stacked(graphs, fam.taps, defer=True)
    assert ex.is_compiled(graphs[1], fam.taps, 2)
    assert not ex.is_compiled(graphs[1], "primary", 2)
    for res, want in zip(handle.materialize(),
                         ex.run_stacked(graphs, fam.taps)):
        _assert_same(res, want)


def test_stacked_failure_is_attributed_without_fallback(families):
    """A node that fails in a group raises NodeError with its index for
    the whole group; no request is rerun alone."""
    fam = families["vit"]
    ex = Executor(fam.reg, device="cpu")
    graphs = []
    for seed in range(2):
        g = Graph()
        emb = g.add_node(fam.name + ":embed")
        blk = g.add_node(fam.name + ":blocks.0")
        g.connect(emb, "o", blk, "o")
        g.add_input(np.zeros((3, 48, 48), np.float32) + seed, emb, "o")
        graphs.append(g)
    calls = []
    real_run = ex.run
    ex.run = lambda *a, **kw: calls.append(a) or real_run(*a, **kw)
    with pytest.raises(NodeError) as ei:
        ex.run_stacked(graphs, "all")
    assert ei.value.node_index in (0, 1)
    assert calls == []


class _Affine(NodeKind):
    """A plain-torch kind (no stacked_fn of its own): y = w * x + b."""

    def __init__(self):
        super().__init__("affine_bs")

    def io(self, params):
        return {"ins": ["o"], "outs": ["o", "sum"]}

    def captures(self, params):
        return {"w": torch.tensor(float(params.get("w", "2"))),
                "b": torch.arange(3, dtype=torch.float32)}

    def fn(self, params):
        return lambda ins, caps: {"o": caps["w"] * ins["o"] + caps["b"],
                                  "sum": ins["o"].sum()}


class _Const(NodeKind):
    """A kind with no input."""

    def __init__(self):
        super().__init__("const_bs")

    def io(self, params):
        return {"ins": [], "outs": ["o"]}

    def fn(self, params):
        return lambda ins: {"o": torch.full((2,), 7.0)}


def test_default_stacked_fn_vmaps_plain_kinds():
    reg = Registry()
    register_builtin(reg)
    _Affine().register(reg)
    _Const().register(reg)
    ex = Executor(reg, device="cpu")

    def graph(seed):
        g = Graph()
        a = g.add_node("affine_bs", {"w": "0.5"})
        v = g.add_node("img_view")
        c = g.add_node("const_bs")
        g.connect(a, "o", v, "o")
        g.add_input(np.random.default_rng(seed).random(
            (4, 3), dtype=np.float32), a, "o")
        del c
        return g

    graphs = [graph(s) for s in range(3)]
    for g, res in zip(graphs, ex.run_stacked(graphs, "all")):
        _assert_same(res, ex.run(g, "all"))
        np.testing.assert_array_equal(res[2]["o"], [7.0, 7.0])


def test_scan_plugins_registers_port_plugins_and_skips_jax_ones(
        tmp_path, caplog):
    (tmp_path / "double.py").write_text(
        "import torch\n"
        "from interactive_vit_tpu_torch.graph.registry import NodeKind\n"
        "class Double(NodeKind):\n"
        "    def __init__(self):\n"
        "        super().__init__('double_bs')\n"
        "    def io(self, params):\n"
        "        return {'ins': ['o'], 'outs': ['o']}\n"
        "    def fn(self, params):\n"
        "        return lambda ins: {'o': 2 * ins['o']}\n"
        "def instances():\n"
        "    return [Double()]\n")
    (tmp_path / "broken.py").write_text("raise RuntimeError('boom')\n")
    (tmp_path / "notes.txt").write_text("not a plugin")
    reg = Registry()
    with caplog.at_level(logging.INFO):
        scan_plugins([str(tmp_path), os.path.join(ROOT, "nodes"),
                      str(tmp_path / "missing")], reg)
    assert reg.names() == ["double_bs"]
    # the JAX package's example plugin (nodes/scale.py) is never run
    assert "scale" not in reg
    assert any("imports JAX" in r.message for r in caplog.records)
    assert any("broken.py" in r.message for r in caplog.records)
    ex = Executor(reg, device="cpu")
    g = Graph()
    n = g.add_node("double_bs")
    g.add_input(np.ones((2,), np.float32), n, "o")
    np.testing.assert_array_equal(ex.run(g)[0]["o"], [2.0, 2.0])


# -- the pipelined batcher -----------------------------------------------------


@pytest.fixture(scope="module")
def base_results(families):
    """Each of 9 mixed requests (two graph signatures of the ViT, two tap
    sets) run alone."""
    fam = families["vit"]
    ex = Executor(fam.reg, device="cpu")
    reqs = []
    for i in range(9):
        shape = fam.shape if i % 3 else (3, 32, 32)
        taps = fam.taps if i % 2 else [(6, "o")]
        g = fam.graph(100 + i, shape=shape)
        reqs.append((g, taps, ex.run(g, taps)))
    return reqs


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_pipeline_depths_give_identical_results(families, base_results,
                                                depth):
    fam = families["vit"]
    ex = Executor(fam.reg, device="cpu")
    b = MicroBatcher(ex, max_batch=4, max_wait_ms=20.0, pipeline_depth=depth)
    dispatched = []
    b.on_dispatch = lambda g, taps, batch, n: dispatched.append((batch, n))
    assert b.pipeline_depth == depth
    try:
        futs = [b.submit(g, taps) for g, taps, _ in base_results]
        for f, (_, _, want) in zip(futs, base_results):
            _assert_same(f.result(timeout=120), want)
            assert f.ivt_timing["batch"] >= 1
        assert sum(n for _, n in dispatched) == len(base_results)
        assert all(batch is None if n == 1 else batch == n
                   for batch, n in dispatched)
        assert b.inflight == 0
        snap = b.metrics.snapshot()["counters"]
        assert snap["batched_requests"] == len(base_results)
        assert snap["batches"] == len(dispatched) < len(base_results)
    finally:
        b.stop()


class _Handle:
    """An in-flight group whose results have not landed until it is
    materialized (a card still busy with it)."""

    def __init__(self, log, i, k):
        self.log, self.i, self.k = log, i, k

    def ready(self):
        return False

    def materialize(self):
        self.log.append(("materialize", self.i))
        res = {0: {"o": np.full((1,), float(self.i), np.float32)}}
        return res if self.k is None else [res] * self.k


class _DeferringExecutor:
    """Records dispatches and materializations; its first dispatch waits
    until the test has queued every request."""

    def __init__(self, warm=True):
        self.log, self.gate, self.n, self.warm = [], threading.Event(), 0, warm

    def group_sig(self, graph, extra=()):
        return graph + str(extra)

    def is_compiled(self, graph, taps, batch=None):
        return self.warm

    def _dispatch(self, k):
        if self.n == 0:
            self.gate.wait(30)
        self.n += 1
        self.log.append(("dispatch", self.n - 1))
        return _Handle(self.log, self.n - 1, k)

    def run(self, graph, taps, defer=False):
        return self._dispatch(None)

    def run_stacked(self, graphs, taps, defer=False):
        return self._dispatch(len(graphs))


@pytest.mark.parametrize("depth,warm", [(0, True), (1, True), (2, True),
                                        (2, False)])
def test_pipeline_keeps_depth_groups_in_flight(depth, warm):
    """With results not yet landed, group i is materialized right after
    group i + depth is dispatched (depth 0: before the next dispatch); a
    group whose run is cold (``is_compiled`` false) first materializes
    every group in flight."""
    ex = _DeferringExecutor(warm)
    b = MicroBatcher(ex, max_batch=4, max_wait_ms=1.0, pipeline_depth=depth)
    try:
        futs = [b.submit(f"g{i}", "all") for i in range(6)]
        ex.gate.set()
        for i, f in enumerate(futs):
            assert f.result(timeout=30)[0]["o"][0] == i
    finally:
        b.stop()
    log = ex.log
    lag = depth if warm else 0
    for i in range(6):
        later = i + lag + 1
        if later < 6:
            assert log.index(("materialize", i)) < \
                log.index(("dispatch", later)), log
        if lag and i + lag < 6:
            assert log.index(("materialize", i)) > \
                log.index(("dispatch", i + lag)), log


class _EchoExecutor:
    """Graphs are (signature, id) pairs; each result carries its graph's
    id, materialized later (never ready before)."""

    def __init__(self):
        self.sizes = []

    def group_sig(self, graph, extra=()):
        return f"{graph[0]}{extra}"

    def is_compiled(self, graph, taps, batch=None):
        return True

    def run(self, graph, taps, defer=False):
        return self.run_stacked([graph], taps, defer, single=True)

    def run_stacked(self, graphs, taps, defer=False, single=False):
        self.sizes.append(len(graphs))
        results = [{0: {"o": np.array([g[1]], np.float32)}} for g in graphs]
        handle = _Handle([], 0, None)
        handle.materialize = lambda: results[0] if single else results
        return handle


def test_batcher_stress_routes_every_result_to_its_future():
    """24 threads submit at once (more than this machine's cores), with a
    short switch interval, over three signatures at pipeline depth 2:
    every future gets its own graph's result."""
    import sys

    ex = _EchoExecutor()
    b = MicroBatcher(ex, max_batch=5, max_wait_ms=2.0, pipeline_depth=2)
    got, errors = {}, []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(c):
            try:
                for i in range(20):
                    gid = c * 100 + i
                    out = b.submit((f"sig{gid % 3}", gid), "all")
                    got[gid] = out.result(timeout=60)[0]["o"][0]
            except Exception as err:  # noqa: BLE001 -- asserted below
                errors.append(err)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        b.stop()
    assert errors == []
    assert len(got) == 24 * 20
    assert all(v == gid for gid, v in got.items())
    assert sum(ex.sizes) == 24 * 20 and max(ex.sizes) > 1
    assert b.inflight == 0


def test_batcher_bad_graph_fails_only_its_group(families):
    fam = families["vit"]
    ex = Executor(fam.reg, device="cpu")
    b = MicroBatcher(ex, max_batch=4, max_wait_ms=20.0, pipeline_depth=1)
    try:
        good = [fam.graph(s) for s in range(3)]
        bad = Graph()
        bad.add_node("nonexistent_kind")
        futs = [b.submit(good[0], ((6, "o") for _ in range(1))),
                b.submit(bad, "all"), b.submit(good[1], [(6, "o")]),
                b.submit(good[2], [(6, "o")])]
        out = futs[0].result(timeout=60)
        assert list(out) == [6] and list(out[6]) == ["o"]
        with pytest.raises(NodeError):
            futs[1].result(timeout=60)
        for f, g in zip(futs[2:], good[1:]):
            _assert_same(f.result(timeout=60), ex.run(g, [(6, "o")]))
        assert b.metrics.snapshot()["counters"]["batch_errors"] == 1
        # the worker keeps serving
        _assert_same(b.submit(good[0], "primary").result(timeout=60),
                     ex.run(good[0], "primary"))
    finally:
        b.stop()


def test_batcher_stop_drains_and_quiet_for(families):
    fam = families["vit"]
    ex = Executor(fam.reg, device="cpu")
    b = MicroBatcher(ex, max_batch=2, max_wait_ms=1.0)
    assert b.quiet_for(0.0)
    gate = threading.Event()
    real_run = ex.run

    def slow_run(*a, **kw):
        gate.wait(30)
        return real_run(*a, **kw)

    ex.run = slow_run
    futs = [b.submit(fam.graph(s, shape=(3, 32 + 8 * s, 32)), [(6, "o")])
            for s in range(4)]
    assert not b.quiet_for(0.0)
    stopper = threading.Thread(target=b.stop)
    stopper.start()
    gate.set()
    stopper.join(timeout=60)
    assert not stopper.is_alive()
    done = [f for f in futs if f.exception(timeout=60) is None]
    failed = [f for f in futs if f.exception(timeout=60) is not None]
    assert len(done) + len(failed) == 4 and done
    assert all("batcher stopped" in str(f.exception()) for f in failed)
    assert b.inflight == 0


# -- the app's POST routes and the server ----------------------------------------


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read(), r.headers


@pytest.fixture(scope="module")
def served(families, tmp_path_factory):
    fam = families["vit"]
    # a wide window: concurrent requests must meet in one group even on a
    # loaded machine (no test here sends sequential /compute requests)
    app = App(reg=fam.reg, graphs_dir=str(tmp_path_factory.mktemp("g")),
              device="cpu", max_wait_ms=200.0)
    fam.model.register(fam.reg, app.graphs)
    httpd = app.serve("127.0.0.1", 0, background=True)
    try:
        yield app, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        app.close()


def test_debug_eval_times_shapes_and_isolates(served, families):
    app, url = served
    fam = families["vit"]
    g = fam.graph(0)
    raw, _ = _post(url + "/debug_eval", bytes(Request.encode(g)))
    out = json.loads(raw)
    assert out["errors"] == {}
    assert set(out["timings_ms"]) == {str(n.index) for n in g.nodes}
    assert out["output_shapes"]["1"]["o"] == [1, 5, 64]
    assert out["output_shapes"]["6"]["o"] == [1, 10]

    bad = Graph()
    emb = bad.add_node(fam.name + ":embed")
    blk = bad.add_node(fam.name + ":blocks.0")
    src = bad.add_node("img_src")
    bad.connect(emb, "o", blk, "o")
    bad.add_input(np.zeros((3, 48, 48), np.float32), emb, "o")
    bad.add_input(np.ones((2, 2), np.float32), src, "o")
    out = json.loads(_post(url + "/debug_eval",
                           bytes(Request.encode(bad)))[0])
    failed = min(int(i) for i in out["errors"])
    assert all(out["errors"][i] == "eval error upstream"
               for i in out["errors"] if int(i) != failed)
    assert out["output_shapes"]["2"]["o"] == [2, 2]


def test_debug_eval_computes_wired_optional_channels(served, families):
    """A block's wired ``attn`` channel is computed (``__taps__``)."""
    app, _ = served
    fam = families["vit"]
    g = Graph()
    emb = g.add_node(fam.name + ":embed")
    b0 = g.add_node(fam.name + ":blocks.0")
    view = g.add_node("attn_view")
    g.connect(emb, "o", b0, "o")
    g.connect(b0, "attn", view, "attn")
    g.add_input(np.random.default_rng(0).random((1, 3, 32, 32),
                                                dtype=np.float32), emb, "o")
    out = app.debug_eval(bytes(Request.encode(g)))
    assert out["errors"] == {}
    assert out["output_shapes"]["1"]["attn"] == [1, 4, 5, 5]


def test_save_graph_route(served, families):
    app, url = served
    fam = families["vit"]
    raw, _ = _post(url + "/save_graph/mine", json.dumps(
        fam.graph_obj).encode())
    assert json.loads(raw) == {"saved": "mine.json"}
    assert "mine.json" in app.list_graphs()
    assert app.graphs.load("mine.json") == fam.graph_obj
    for path, body in (("/save_graph/x.json", b"{not json"),
                       ("/save_graph/..%2F..%2Fescape", b"{}")):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + path, body)
        assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url + "/nope", b"")
    assert ei.value.code == 404


def test_profile_route(served, families):
    app, url = served
    body = bytes(Request.encode(families["vit"].graph(3)))
    rep = json.loads(_post(url + "/profile?iters=2&top=5", body)[0])
    assert set(rep) == {"iters", "wall_ms", "total_device_us", "top_ops_us",
                        "note"}
    assert rep["iters"] == 2 and rep["wall_ms"] > 0
    # the CPU reports wall time only
    assert rep["total_device_us"] == 0 and rep["top_ops_us"] == {}


def test_profile_busy_is_409_and_bad_bytes_400(served, families):
    app, url = served
    body = bytes(Request.encode(families["vit"].graph(4)))
    app._profile_lock.acquire()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/profile", body)
        assert ei.value.code == 409
    finally:
        app._profile_lock.release()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url + "/profile", b"garbage")
    assert ei.value.code == 400
    json.loads(_post(url + "/profile", body)[0])  # free again


def test_concurrent_computes_share_a_batch_and_report_it(served, families):
    app, url = served
    fam = families["vit"]
    graphs = [fam.graph(50 + i) for i in range(4)]
    bodies = [bytes(Request.encode(g)) for g in graphs]
    before = app.metrics.snapshot()["counters"].get("batches", 0)
    out = [None] * 4

    def worker(i):
        out[i] = _post(url + "/compute", bodies[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    batches = app.metrics.snapshot()["counters"]["batches"] - before
    assert batches < 4, "concurrent requests did not share a batch"
    sizes = []
    for (raw, headers), g in zip(out, graphs):
        timing = dict(kv.split("=") for kv in
                      headers["X-IVT-Timing"].split(";"))
        sizes.append(int(timing["batch"]))
        _assert_same(Response.decode(raw), Response.decode(bytes(Response(
            app.executor.run(g, "primary")).encode())))
    assert max(sizes) > 1


def test_compute_timeout_returns_503(tmp_path, families):
    app = App(reg=Registry(), graphs_dir=str(tmp_path), device="cpu",
              compute_timeout_s=0.2)

    class WedgedBatcher:
        def submit(self, graph, taps):
            return concurrent.futures.Future()  # never resolves

        def start(self):
            pass

        def stop(self):
            pass

    app.batcher = WedgedBatcher()
    httpd = app.serve("127.0.0.1", 0, background=True)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/compute",
                  bytes(Request.encode(families["vit"].graph(0))))
        assert ei.value.code == 503
        assert "exceeded" in ei.value.read().decode()
    finally:
        httpd.shutdown()
        app.close()


def test_server_flags_parse():
    args = tserver.make_parser().parse_args([
        "--pipeline-depth", "2", "--compute-timeout-s", "7.5", "--warmup",
        "--frontend-dir", "front", "--plugin-dirs", "a,b", "--max-batch",
        "4"])
    assert (args.pipeline_depth, args.compute_timeout_s, args.warmup,
            args.frontend_dir, args.plugin_dirs, args.max_batch) == \
        (2, 7.5, True, "front", "a,b", 4)
    args = tserver.make_parser().parse_args([])
    assert (args.pipeline_depth, args.compute_timeout_s, args.warmup,
            args.frontend_dir, args.plugin_dirs) == \
        (1, 120.0, False, None, "")


def test_build_app_takes_the_new_options_and_warms(families, tmp_path):
    fam = families["vit"]
    front = tmp_path / "front"
    front.mkdir()
    (front / "index.html").write_text("<html>mine</html>")
    plugins = tmp_path / "plugins"
    plugins.mkdir()
    (plugins / "neg.py").write_text(
        "from interactive_vit_tpu_torch.graph.registry import NodeKind\n"
        "class Neg(NodeKind):\n"
        "    def __init__(self):\n"
        "        super().__init__('neg_bs')\n"
        "    def io(self, params):\n"
        "        return {'ins': ['o'], 'outs': ['o']}\n"
        "    def fn(self, params):\n"
        "        return lambda ins: {'o': -ins['o']}\n"
        "def instances():\n"
        "    return [Neg()]\n")
    graphs = tmp_path / "graphs"
    app = tserver.build_app(
        models=[fam.name], graphs_dir=str(graphs), device="cpu",
        frontend_dir=str(front),
        plugin_dirs=[str(plugins), os.path.join(ROOT, "nodes")],
        compute_timeout_s=3.0, pipeline_depth=2, max_batch=3)
    try:
        assert "neg_bs" in app.reg and "scale" not in app.reg
        assert app.compute_timeout_s == 3.0
        assert app.batcher.pipeline_depth == 2
        g = schema.graph_from_json(app.graphs.load(fam.name + ".json"))
        g.add_input(np.zeros((3, 224, 224), np.float32), g.nodes[0], "o")
        assert not app.executor.is_compiled(g, "primary")
        tserver.warmup(app, [fam.name, "no_graph_model"],
                       batch_sizes=(1, 3))
        assert app.executor.is_compiled(g, "primary")
        assert app.executor.is_compiled(g, "primary", 3)
        assert not app.executor.is_compiled(g, "primary", 2)
        httpd = app.serve("127.0.0.1", 0, background=True)
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            with urllib.request.urlopen(url + "/", timeout=30) as r:
                assert r.read() == b"<html>mine</html>"
        finally:
            httpd.shutdown()
    finally:
        app.close()
