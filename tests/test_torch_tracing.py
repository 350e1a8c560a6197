"""The port's tracing utilities against the JAX package's, on the CPU.

* ``trace``: the Chrome trace of a port pass holds one range a node, named
  exactly as the JAX executor's ``jax.named_scope`` for the same graph
  (read from the lowered JAX program's debug locations), for a cos -> cos
  chain and a 2-block ViT chain, through the staged pass and the eager
  debug path;
* ``node_timings``: JAX's keys;
* ``debug_nans``: a ``binop`` "/" fed two zeros. The JAX package's
  ``Executor.run`` raises (its private ``InternalFloatingPointError``), the
  port's ``FloatingPointError`` naming the node; ``run_eager`` /
  ``run_timed_eager`` give JAX's ``run_eager`` error keys, each message
  saying NaN. Off, outputs are bit-equal to a run with no switch ever on
  and no profiler;
* ``profiler_server``: not available in torch, raises.

The switch is process-wide in both packages: every test that turns it on
turns it off in a fixture.
"""

import glob
import json
import re

import numpy as np
import pytest
import torch

import jax

from interactive_vit_tpu.graph.executor import Executor as JExecutor
from interactive_vit_tpu.graph.executor import resolve_taps as jresolve
from interactive_vit_tpu.graph.ir import Graph as JGraph
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.vit_plugin import make_vit_model as jvit_make
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.utils import tracing as jtracing
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph.executor import Executor
from interactive_vit_tpu_torch.graph.ir import Graph
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.utils import tracing
from interactive_vit_tpu_torch.wire import schema

torch.set_num_threads(2)

VIT = dict(img_size=32, patch=16, width=64, depth=2, heads=4,
           num_classes=10)
NAME = "vit_trace_port"


@pytest.fixture(scope="module")
def regs():
    """(port registry, JAX registry, the ViT's saved chain as JSON), the
    builtin kinds and a 2-block ViT on the same weights in both."""
    jvit.VARIANTS[NAME] = jvit.ViTConfig(NAME, **VIT)
    tvit.VARIANTS[NAME] = tvit.ViTConfig(NAME, **VIT)
    try:
        jparams = jvit.init_params(jax.random.key(3), jvit.VARIANTS[NAME])
        reg, jreg = Registry(), JRegistry()
        register_builtin(reg)
        jbuiltin(jreg)
        jvit_make(NAME, params=jparams).register(jreg)
        model = make_vit_model(NAME, params=from_jax(jax.tree.map(
            np.asarray, jparams)), device="cpu")
        model.register(reg)
        yield reg, jreg, model.generate_graph_json()
    finally:
        del jvit.VARIANTS[NAME]
        del tvit.VARIANTS[NAME]


@pytest.fixture
def nans():
    """Turns both packages' NaN switches off after the test."""
    yield
    tracing.debug_nans(False)
    jtracing.debug_nans(False)


def _cos_chain(mod, _obj):
    g = mod()
    a = g.add_node("cos", {"A": "2.0"})
    b = g.add_node("cos")
    g.connect(a, "o", b, "o")
    g.add_input(np.linspace(0, 3, 64, dtype=np.float32), a, "o")
    return g


def _vit_chain(mod, obj):
    g = (jschema if mod is JGraph else schema).graph_from_json(obj)
    img = np.random.default_rng(4).random((3, 40, 48), dtype=np.float32)
    g.add_input(img, g.nodes[0], "o")
    return g


def _nan_graph(mod):
    """Node 0: binop "/" of two zero vectors (NaN); node 1: cos of it."""
    g = mod()
    d = g.add_node("binop", {"op": "/"})
    c = g.add_node("cos")
    g.connect(d, "c", c, "o")
    g.add_input(np.zeros(8, np.float32), d, "a")
    g.add_input(np.zeros(8, np.float32), d, "b")
    return g


CHAINS = {"cos_cos": _cos_chain, "vit": _vit_chain}


def _jax_scopes(jreg, g):
    """The ``n<i>_<kind>`` scopes of the JAX executor's staged program for
    ``g``: the first component under ``jit(staged)`` of each location in
    the lowered program's debug info."""
    jex = JExecutor(jreg)
    staged, _, caps = jex._stage(g, jresolve(g, "all", jreg))
    inputs = tuple(e.tensor for _, _, e in g.input_edges())
    text = jax.jit(staged).lower(inputs, caps).as_text(debug_info=True)
    return set(re.findall(r"jit\(staged\)/(n\d+_[^/\"\s]+)", text))


def _trace_ranges(log_dir):
    """The node ranges of the one Chrome trace in ``log_dir``."""
    (path,) = glob.glob(f"{log_dir}/*.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events
            if e.get("cat") == "user_annotation"
            and re.fullmatch(r"n\d+_\S+", e.get("name", ""))]


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("path", ["run", "run_eager"])
def test_trace_ranges_are_jax_scope_names(regs, tmp_path, chain, path):
    """One range a node, each named as JAX's scope for that node: every
    scope of the lowered JAX program is a range of the trace, and the
    ranges are JAX's ``f"n{index}_{kind}"`` names (':' as '.') of all the
    graph's nodes (a node that adds no operation, the ViT's ``category``
    sink, leaves no location in JAX's program)."""
    reg, jreg, obj = regs
    make = CHAINS[chain]
    jg = make(JGraph, obj)
    lowered = _jax_scopes(jreg, jg)
    ex = Executor(reg, device="cpu")
    with tracing.trace(str(tmp_path)):
        getattr(ex, path)(make(Graph, obj))
    got = _trace_ranges(tmp_path)
    assert len(got) == len(set(got)) == len(jg.nodes)
    assert set(got) == {f"n{n.index}_{n.name.replace(':', '.')}"
                        for n in jg.nodes}
    assert lowered <= set(got) and len(lowered) >= len(jg.nodes) - 1


def test_trace_of_a_graph_with_an_unknown_dir_creates_it(regs, tmp_path):
    reg, _, obj = regs
    target = tmp_path / "a" / "b"
    with tracing.trace(str(target)):
        Executor(reg, device="cpu").run(_cos_chain(Graph, obj))
    assert len(glob.glob(f"{target}/*.json")) == 1


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_node_timings_keys_match_jax(regs, chain):
    reg, jreg, obj = regs
    make = CHAINS[chain]
    got = tracing.node_timings(Executor(reg, device="cpu"), make(Graph, obj))
    want = jtracing.node_timings(JExecutor(jreg), make(JGraph, obj))
    assert set(got) == set(want) == set(range(len(make(Graph, obj).nodes)))
    assert all(v >= 0 for v in got.values())


def test_debug_nans_run_raises_naming_the_node(regs, nans):
    reg, jreg, _ = regs
    jtracing.debug_nans(True)
    with pytest.raises(Exception):  # noqa: B017 -- JAX's private class
        JExecutor(jreg).run(_nan_graph(JGraph))
    tracing.debug_nans(True)
    assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
    for use_jit in (True, False):
        with pytest.raises(FloatingPointError,
                           match=r"\(nan\).*node 0 \(binop\)"):
            Executor(reg, device="cpu", use_jit=use_jit).run(
                _nan_graph(Graph))
    tracing.debug_nans(False)
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("method", ["run_eager", "run_timed_eager"])
def test_debug_nans_eager_error_keys_match_jax(regs, nans, method):
    """JAX's ``run_eager`` under its switch: node 0's NaN error, node 1
    "eval error upstream"; the port's eager paths give the same keys."""
    reg, jreg, _ = regs
    jtracing.debug_nans(True)
    _, jerrs = JExecutor(jreg).run_eager(_nan_graph(JGraph))
    tracing.debug_nans(True)
    errs = getattr(Executor(reg, device="cpu"), method)(_nan_graph(Graph))[-1]
    assert set(errs) == set(jerrs) == {0, 1}
    assert errs[1] == jerrs[1] == "eval error upstream"
    assert "nan" in errs[0].lower() and "nan" in jerrs[0].lower()
    assert "node 0 (binop)" in errs[0]


def test_debug_nans_off_changes_no_output(regs, nans, tmp_path):
    """Off (after being on), and under a profiler, the ViT chain's outputs
    are bit-equal to a plain run; the NaN graph runs and returns its NaNs."""
    reg, _, obj = regs
    taps = [(2, "attn"), (3, "o"), (5, "o")]
    base = Executor(reg, device="cpu").run(_vit_chain(Graph, obj), taps)
    tracing.debug_nans(True)
    tracing.debug_nans(False)
    again = Executor(reg, device="cpu").run(_vit_chain(Graph, obj), taps)
    with tracing.trace(str(tmp_path)):
        traced = Executor(reg, device="cpu").run(_vit_chain(Graph, obj), taps)
    for out in (again, traced):
        for i in base:
            for ch in base[i]:
                np.testing.assert_array_equal(out[i][ch], base[i][ch])
    res = Executor(reg, device="cpu").run(_nan_graph(Graph))
    assert np.isnan(res[1]["o"]).all()


def test_profiler_server_is_not_available():
    with pytest.raises(NotImplementedError, match="tracing.trace"):
        tracing.profiler_server(9999)
