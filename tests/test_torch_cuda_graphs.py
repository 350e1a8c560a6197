"""The executor's compiled path on the card: each program signature is
captured once into a CUDA graph and replayed.

Marked ``cuda``: each test skips (inside a fixture) when no CUDA device is
present. On a machine with the card and the CUDA toolkit, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py

(``--noconftest``: this file imports only torch and the port). A replay
must give what the eager pass (``use_jit=False``) gives for the same
request, bit for bit: the captured launches are the eager ones on the same
shapes and the same routes.
"""

import numpy as np
import pytest
import torch

from interactive_vit_tpu_torch.graph.executor import Executor, NodeError
from interactive_vit_tpu_torch.graph.ir import Graph
from interactive_vit_tpu_torch.graph.registry import NodeKind, Registry
from interactive_vit_tpu_torch.models.swin_plugin import make_swin_model
from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model
from interactive_vit_tpu_torch.ops import fused_block as fb
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.runtime import constants
from interactive_vit_tpu_torch.wire import schema

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _registry():
    reg = Registry()
    register_builtin(reg)
    return reg


def _cos(x, a=1.0):
    g = Graph()
    n = g.add_node("cos", {"A": str(a)})
    g.add_input(x, n, "o")
    return g


def _count_captures(ex, monkeypatch):
    captured = []
    real = ex._capture
    monkeypatch.setattr(ex, "_capture", lambda *a: captured.append(1)
                        or real(*a))
    return captured


def test_cos_edit_replays_without_a_new_capture(cuda, monkeypatch):
    ex = Executor(_registry())
    captured = _count_captures(ex, monkeypatch)
    x = np.linspace(-1, 1, 64, dtype=np.float32)
    np.testing.assert_allclose(ex.run(_cos(x, 1.0))[0]["o"], np.cos(x),
                               atol=1e-6)
    assert not ex.last_stats.cache_hit and ex.last_stats.compile_s > 0
    for a in (2.0, -0.5):
        out = ex.run(_cos(x, a))[0]["o"]
        assert ex.last_stats.cache_hit and ex.last_stats.compile_s == 0
        np.testing.assert_allclose(out, np.cos(a * x), atol=1e-6)
    assert captured == [1]
    xs = [x * (i + 1) for i in range(3)]
    res = ex.run_stacked([_cos(xi, a) for xi, a in zip(xs, (1, 2, 3))])
    res2 = ex.run_stacked([_cos(xi, a) for xi, a in zip(xs, (4, 5, 6))])
    assert ex.last_stats.cache_hit and captured == [1, 1]
    for i, xi in enumerate(xs):
        np.testing.assert_allclose(res[i][0]["o"], np.cos((i + 1) * xi),
                                   atol=1e-6)
        np.testing.assert_allclose(res2[i][0]["o"], np.cos((i + 4) * xi),
                                   atol=1e-6)


class _ReadsBack(NodeKind):
    """A kind that reads a value back to the host in its pass: it cannot
    be captured."""

    def __init__(self):
        super().__init__("reads_back")

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def fn(self, params):
        return lambda ins: {"o": ins["o"] * float(ins["o"].sum().item())}


def test_uncapturable_kind_raises_without_fallback(cuda):
    reg = _registry()
    _ReadsBack().register(reg)
    ex = Executor(reg)
    g = Graph()
    a = g.add_node("cos")
    b = g.add_node("reads_back")
    g.connect(a, "o", b, "o")
    g.add_input(np.ones(8, np.float32), a, "o")
    with pytest.raises(NodeError) as ei:
        ex.run(g)
    assert ei.value.node_index == 1
    assert not ex.is_compiled(g, "all")
    # the eager path still runs it; the card is usable after the failure
    assert Executor(reg, use_jit=False).run(g)[1]["o"].shape == (8,)
    x = np.linspace(0, 1, 8, dtype=np.float32)
    np.testing.assert_allclose(ex.run(_cos(x))[0]["o"], np.cos(x), atol=1e-6)


def test_pipelined_replays_keep_their_results(cuda):
    ex = Executor(_registry())
    xs = [np.full(1 << 16, float(i), np.float32) for i in range(4)]
    ex.run(_cos(xs[0]))
    handles = [ex.run(_cos(x), defer=True) for x in xs]
    for x, h in zip(xs, handles):
        np.testing.assert_allclose(h.materialize()[0]["o"], np.cos(x),
                                   atol=1e-6)


def _model(name):
    """A registry with ``name`` (vit_t16 or swin_t, bf16, random weights)
    and a maker of its chain graph with an image and node params."""
    reg = _registry()
    if name == "swin_t":
        model = make_swin_model(name, dtype=torch.bfloat16)
    else:
        model = make_vit_model(name, dtype=torch.bfloat16)
    model.register(reg)
    obj = model.generate_graph_json()

    def graph(im, node_params=None):
        g = schema.graph_from_json(obj)
        for i, params in (node_params or {}).items():
            g.nodes[i].params.update(params)
        g.add_input(im, g.nodes[0], "o")
        return g

    return reg, graph


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        for ch in want[i]:
            np.testing.assert_array_equal(got[i][ch], want[i][ch])


def test_vit_replay_equals_eager_with_launch_counts(cuda):
    """vit_t16 in bf16: a replay equals the eager pass of the same request
    bit for bit. A replay calls no wrapper, so the block kernel's counter
    grows by the eager passes' 12 launches each; the profile of a replay
    shows the kernels of its 12 block launches."""
    from torch.profiler import ProfilerActivity, profile

    reg, graph = _model("vit_t16")
    rng = np.random.default_rng(0)
    images = [rng.random((3, 224, 224), dtype=np.float32) for _ in range(3)]
    taps = [(2, "attn"), (2, "r"), (13, "o")]
    ex, eager = Executor(reg), Executor(reg, use_jit=False)
    ex.run(graph(images[0]), taps)
    before = fb.fused_attn_block_mma.launches
    for im in images[1:]:
        got = ex.run(graph(im), taps)
        assert ex.last_stats.cache_hit
        _assert_equal(got, eager.run(graph(im), taps))
    # two eager passes, 12 launches each; the two replays none
    assert fb.fused_attn_block_mma.launches - before == 24
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ex.run(graph(images[1]), taps)
        torch.cuda.synchronize()
    seen = {part: sum(e.count for e in prof.key_averages()
                      if part in e.key)
            for part in ("row1_qkv_mma_kernel", "row1_attn_mma_kernel",
                         "proj_mma_kernel")}
    assert seen == dict.fromkeys(seen, 12), seen


# (model, its tapped node with a head subset, another tapped node): the
# ViT reads the resize matrices and normalisation constants, Swin also
# its bias index, the shifted blocks' seam masks and the subset's index
EVICTED = {"vit_t16": (7, 13), "swin_t": (16, 3)}


@pytest.mark.parametrize("name", sorted(EVICTED))
def test_evicted_constants_replay_unchanged(cuda, name):
    """The program holds the cached device constants that its graph reads
    (resize matrices, normalisation constants, a head subset's index,
    Swin's bias index and masks): with every cache emptied and memory of
    those sizes on the capture's stream filled with NaN and zeros, a
    replay still equals the eager pass bit for bit."""
    reg, graph = _model(name)
    image = np.random.default_rng(1).random((3, 250, 260), dtype=np.float32)
    node, other = EVICTED[name]
    heads = {node: {"attn_heads": "[0,2]"}}
    taps = [(node, "attn"), (other, "attn" if name == "swin_t" else "o")]
    ex, eager = Executor(reg), Executor(reg, use_jit=False)
    constants.clear_all()
    ex.run(graph(image, heads), taps)
    with constants.retained() as seen:
        want = eager.run(graph(image, heads), taps)
    fill = [(t.shape, t.dtype) for v in seen
            for t in (v if isinstance(v, tuple) else [v])
            if t is not None]
    assert fill and (name != "swin_t"
                     or any(dtype == torch.int64 for _, dtype in fill))
    constants.clear_all()
    del seen
    with torch.cuda.stream(ex._stream):
        filler = [torch.full(shape, float("nan") if dtype.is_floating_point
                             else 0, dtype=dtype, device="cuda")
                  for shape, dtype in fill for _ in range(64)]
    got = ex.run(graph(image, heads), taps)
    assert ex.last_stats.cache_hit
    _assert_equal(got, want)
    del filler


def _nan_graph(zero: bool):
    """binop "/" of two equal inputs into cos: node 0 makes 0 / 0 = NaN
    when ``zero``, 1 otherwise; node 1 carries it."""
    g = Graph()
    d = g.add_node("binop", {"op": "/"})
    c = g.add_node("cos")
    g.connect(d, "c", c, "o")
    x = np.zeros(16, np.float32) if zero else np.ones(16, np.float32)
    g.add_input(x, d, "a")
    g.add_input(x.copy(), d, "b")
    return g


def test_debug_nans_names_the_node_on_a_replay(cuda):
    """With ``debug_nans`` on, a replay whose tapped output holds a NaN
    reruns its eager pass and raises ``FloatingPointError`` naming node 0;
    the warm pass of a fresh signature raises the same; off, the same
    replay returns its NaNs."""
    from interactive_vit_tpu_torch.utils import tracing

    ex = Executor(_registry(), device="cuda")
    ex.run(_nan_graph(False), taps=[(1, "o")])  # captured, finite
    try:
        tracing.debug_nans(True)
        assert ex.run(_nan_graph(False), taps=[(1, "o")])[1]["o"].min() > 0
        assert ex.last_stats.cache_hit
        with pytest.raises(FloatingPointError, match=r"node 0 \(binop\)"):
            ex.run(_nan_graph(True), taps=[(1, "o")])
        with pytest.raises(FloatingPointError, match=r"node 0 \(binop\)"):
            Executor(_registry(), device="cuda").run(_nan_graph(True))
    finally:
        tracing.debug_nans(False)
    out = ex.run(_nan_graph(True), taps=[(1, "o")])
    assert ex.last_stats.cache_hit and np.isnan(out[1]["o"]).all()
