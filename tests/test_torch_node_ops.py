"""The port's built-in node kinds on the CPU, against the JAX package.

* Every entry of ``tests/fixtures/node_fixtures.json`` but the gradient
  kinds (saliency, dream, occlusion: ``tests/test_torch_grad_nodes.py``
  holds those): the committed request
  bytes decode and ``Executor(device="cpu")`` gives the pinned values
  (atol 5e-5: they carry 6 decimals); the committed f32 and bf16 responses
  are our outputs encoded, byte for byte where the kinds are exact (noise,
  binop, slice, shuffle, const and the sinks fed by them), else within
  1e-6 (f32) and one bf16 rounding; ``error_contract`` gives the same node
  index, name and text.
* Each kind against the JAX kind on seeded numpy inputs, in f32 and bf16,
  with the tolerance stated beside each case.
* ``contents()`` equal to the JAX kind's; an edit of each dynamic param is a
  cache hit with the new values; ``run_stacked`` of graphs that differ only
  in dynamic values equals the separate runs bit for bit.
* ``static/graphs/demo_noise.json`` and ``demo_slice.json`` against the JAX
  executor; ``static/graphs/dino_s16.json`` cut to 2 blocks at width 64
  (weights through ``weights.from_jax``) against the JAX app at 1e-4.
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
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.vit_plugin import make_vit_model as jvit_make
from interactive_vit_tpu.ops import node_ops as J
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph.executor import Executor, NodeError
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import node_ops as T
from interactive_vit_tpu_torch.wire import schema
from interactive_vit_tpu_torch.wire.codec import Request, Response

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GRAPHS = os.path.join(ROOT, "static", "graphs")
with open(os.path.join(HERE, "fixtures", "node_fixtures.json")) as f:
    FIXTURES = json.load(f)
GRADIENT_KINDS = {"saliency", "dream", "occlusion"}
REPLAYED = sorted(n for n in FIXTURES if n not in GRADIENT_KINDS
                  and not FIXTURES[n].get("no_request")
                  and "error" not in FIXTURES[n])
# entries whose kinds are exact (integer bits, copies, indexing, one IEEE
# op a value): their committed responses are our bytes
EXACT = {"noise", "binop", "slice", "shuffle", "const",
         "img_view_compositing", "attn_view", "overlay", "multi_view"}


@pytest.fixture(scope="module")
def reg():
    r = Registry()
    T.register_builtin(r)
    return r


@pytest.fixture(scope="module")
def jreg():
    r = JRegistry()
    J.register_builtin(r)
    return r


def _flat(out):
    return {f"{i}/{ch}": v for i, sub in out.items() for ch, v in sub.items()}


def _b64(m: np.ndarray) -> str:
    return base64.b64encode(np.asarray(m, "<f4").tobytes()).decode()


# -- the committed fixtures ---------------------------------------------------


def test_unported_kinds_are_the_gradient_kinds():
    """No kind is left unported: the gradient kinds, the last ones, are
    ported too, and their fixture entries are held in
    ``tests/test_torch_grad_nodes.py``, not replayed here."""
    jnames = {k.name for k in J.instances()}
    tnames = {k.name for k in T.instances()}
    assert tnames == jnames
    assert GRADIENT_KINDS <= tnames
    assert set(FIXTURES) - set(REPLAYED) == GRADIENT_KINDS | {
        "img_src", "error_contract"}


@pytest.mark.parametrize("name", REPLAYED)
def test_fixture_request_evaluates_to_pinned_values(reg, name):
    fx = FIXTURES[name]
    req = Request()
    req.decode(base64.b64decode(fx["request_b64"]))
    out = Executor(reg, device="cpu").run(req.graph,
                                          taps=req.taps or "primary")
    flat = _flat(out)
    assert sorted(flat) == sorted(fx["expected"])
    for key, exp in fx["expected"].items():
        assert list(flat[key].shape) == exp["dims"], key
        np.testing.assert_allclose(flat[key].ravel(),
                                   np.asarray(exp["values"], np.float32),
                                   atol=5e-5, err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", REPLAYED)
def test_committed_responses_are_ours(reg, name):
    """The committed f32 and bf16 response bytes against our outputs:
    byte for byte for the exact kinds; else every f32 value within 1e-6
    (sums in another order), and each bf16 value our f32 value's bf16
    rounding or its neighbour (one rounding of a value within 1e-6 of a
    bf16 rounding boundary)."""
    fx = FIXTURES[name]
    req = Request()
    req.decode(base64.b64decode(fx["request_b64"]))
    out = Executor(reg, device="cpu").run(req.graph,
                                          taps=req.taps or "primary")
    for key, dtype in (("response_b64", "f32"), ("response_bf16_b64", "bf16")):
        committed = base64.b64decode(fx[key])
        if name in EXACT:
            assert Response(out).encode(dtype=dtype) == committed, dtype
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


def test_error_contract(reg):
    """The failing node's wire index, kind and numpy's full text; the eager
    path marks only the node downstream of it."""
    fx = FIXTURES["error_contract"]
    req = Request()
    req.decode(base64.b64decode(fx["request_b64"]))
    ex = Executor(reg, device="cpu")
    with pytest.raises(NodeError) as exc:
        ex.run(req.graph, taps=req.taps or "primary")
    err = exc.value
    assert (err.node_index, err.node_name, str(err)) == (
        fx["error"]["node_index"], fx["error"]["node_name"],
        fx["error"]["text"])
    _, errors = ex.run_eager(req.graph)
    bad = fx["error"]["node_index"]
    assert errors[bad] != "eval error upstream"
    assert [i for i, m in errors.items()
            if m == "eval error upstream"] == [bad + 1]


# -- each kind against the JAX kind -------------------------------------------


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x, dtype):
    """(torch tensor, jnp array) of numpy ``x`` in ``dtype``."""
    if dtype == "bf16":
        return (torch.from_numpy(x).to(torch.bfloat16),
                jnp.asarray(x).astype(jnp.bfloat16))
    return torch.from_numpy(x), jnp.asarray(x)


def _run_kind(name, params, ins_np, dtype="f32"):
    """(ours, JAX's) output channels of one kind on the same inputs, as f32
    numpy, with the output dtypes."""
    tk = next(k for k in T.instances() if k.name == name)
    jk = next(k for k in J.instances() if k.name == name)
    tins, jins = {}, {}
    for ch, x in ins_np.items():
        tins[ch], jins[ch] = _both(x, dtype)
    tc, jc = tk.captures(params), jk.captures(params)
    tout = tk.fn(params)(tins) if tc is None else tk.fn(params)(tins, tc)
    jout = jk.fn(params)(jins) if jc is None else jk.fn(params)(jins, jc)
    assert sorted(tout) == sorted(jout)
    res = {}
    for ch in jout:
        t, j = tout[ch], jout[ch]
        assert tuple(t.shape) == tuple(j.shape), ch
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), ch
        res[ch] = (t.float().numpy(), np.asarray(j, np.float32))
    return res


def _check(res, atol, rtol=0.0):
    for ch, (got, want) in res.items():
        if atol == 0:
            np.testing.assert_array_equal(got, want, err_msg=ch)
        else:
            np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                                       err_msg=ch)


BINOP_SHAPES = [((3, 8, 8), (3, 8, 8)), ((3, 8, 8), (8,)),
                ((2, 1, 5), (4, 1))]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("op", ["+", "-", "*", "/"])
@pytest.mark.parametrize("shapes", BINOP_SHAPES)
def test_binop_matches_jax(op, shapes, dtype):
    """Exact: one IEEE op a value (bf16 through f32 and one rounding, in
    both), numpy broadcasting."""
    res = _run_kind("binop", {"op": op}, {"a": _rand(1, *shapes[0]),
                                          "b": _rand(2, *shapes[1])}, dtype)
    _check(res, 0)


def test_binop_promotes_as_jax():
    """bf16 with f32 gives f32; integer division a float."""
    tk = T.BinOpNode()
    x = np.linspace(-1, 1, 6, dtype=np.float32)
    y = tk.fn({"op": "+"})({"a": torch.from_numpy(x).bfloat16(),
                            "b": torch.from_numpy(x)})["c"]
    assert y.dtype == torch.float32
    want = J.BinOpNode().fn({"op": "+"})(
        {"a": jnp.asarray(x).astype(jnp.bfloat16), "b": jnp.asarray(x)})["c"]
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))
    q = tk.fn({"op": "/"})({"a": torch.arange(1, 4, dtype=torch.int32),
                            "b": torch.tensor([2, 2, 2], dtype=torch.int32)})
    assert q["c"].dtype == torch.float32
    np.testing.assert_array_equal(q["c"].numpy(), [0.5, 1.0, 1.5])


INDEX_CASES = [
    ("slice", {"fixed": [{"dim": 0, "val": 1}],
               "free": [{"in_dim": 1, "out_dim": 0},
                        {"in_dim": 2, "out_dim": 1}]}),
    ("slice", {"fixed": [{"dim": 2, "val": -1}],
               "free": [{"in_dim": 0, "out_dim": 1},
                        {"in_dim": 1, "out_dim": 0}]}),
    ("slice", {"fixed": [{"dim": 0, "val": 2}, {"dim": 1, "val": 3}],
               "free": [{"in_dim": 2, "out_dim": 0}]}),
    ("shuffle", {"fixed": [], "free": [{"in_dim": 2, "out_dim": 0},
                                       {"in_dim": 0, "out_dim": 1},
                                       {"in_dim": 1, "out_dim": 2}]}),
    ("shuffle", {"fixed": [], "free": []}),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(INDEX_CASES)))
def test_slice_and_shuffle_match_jax(case, dtype):
    """Exact: indexing and a permutation."""
    name, p = INDEX_CASES[case]
    params = {k: json.dumps(v) for k, v in p.items()}
    _check(_run_kind(name, params, {"o": _rand(3, 3, 5, 7)}, dtype), 0)


@pytest.mark.parametrize("value", ["2.5", "-0.1", "1e-3"])
def test_const_matches_jax(value):
    """Exact: f32 fill."""
    _check(_run_kind("const", {"value": value, "dims": "[4, 3, 2]"}, {}), 0)


@pytest.mark.parametrize("seed", ["0", "7", "-1", "4294967295", "123456789"])
@pytest.mark.parametrize("dims", ["[2, 5, 5]", "[128, 128]", "[3]",
                                  "[1, 2, 4, 4]"])
def test_noise_matches_jax_random_bit_for_bit(seed, dims):
    """``jax.random.uniform(jax.random.key(seed))``, bit for bit; a seed of
    -1 is 2^32 - 1, as the JAX kind masks it."""
    res = _run_kind("noise", {"seed": seed, "dims": dims}, {})
    got, want = res["o"]
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_noise_seed_7_is_the_pinned_fixture():
    want = FIXTURES["noise"]["expected"]["0/o"]
    k = T.NoiseNode()
    got = k.fn({"dims": "[2,5,5]"})({}, k.captures({"seed": "7"}))["o"]
    np.testing.assert_allclose(got.numpy().ravel(), want["values"],
                               atol=5e-7)


CONV_CASES = [((3, 9, 11), 3, 3), ((2, 10, 8), 2, 5), ((7, 6), 5, 3),
              ((1, 6, 6), 1, 1)]


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv2d_matches_jax(case):
    """f32 within 1e-5 (k*k products summed in another order); h != w."""
    shape, h, w = case
    m = _rand(9, h, w)
    params = {"matrix": _b64(m), "h": str(h), "w": str(w)}
    _check(_run_kind("conv2d", params, {"o": _rand(4, *shape)}), 1e-5)


def test_conv2d_float64_reference_and_default_matrix():
    """Within 1e-5 of a float64 cross-correlation; no matrix: the k x k
    identity (the centre cell 1)."""
    k = T.Conv2dNode()
    x, m = _rand(5, 2, 12, 10), _rand(6, 3, 5)
    params = {"matrix": _b64(m), "h": "3", "w": "5"}
    y = k.fn(params)({"o": torch.from_numpy(x)}, k.captures(params))["o"]
    ref = np.zeros((2, 10, 6))
    for i in range(3):
        for j in range(5):
            ref += m[i, j].astype(np.float64) * x[:, i:i + 10, j:j + 6]
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-5)
    ident = k.fn({})({"o": torch.from_numpy(x)}, k.captures({}))["o"]
    np.testing.assert_array_equal(ident.numpy(), x[:, 1:-1, 1:-1])


def test_conv2d_refuses_bf16_as_jax():
    """The JAX kind's conv refuses a bf16 input against its f32 matrix;
    so does ours, attributed to the node."""
    tk, jk = T.Conv2dNode(), J.Conv2dNode()
    x = _rand(1, 3, 6, 6)
    with pytest.raises(TypeError):
        jk.fn({})({"o": jnp.asarray(x).astype(jnp.bfloat16)}, jk.captures({}))
    with pytest.raises(TypeError, match="bfloat16"):
        tk.fn({})({"o": torch.from_numpy(x).bfloat16()}, tk.captures({}))


RESIZE_CASES = [((3, 16, 16), [8, 8]), ((3, 8, 8), [17, 13]),
                ((3, 12, 20), [20, 9]), ((2, 3, 14, 14), [6, 28]),
                ((3, 9, 9), [9, 9]), ((10, 15), [4, 4])]


@pytest.mark.parametrize("case", RESIZE_CASES)
def test_resize_matches_jax_f32(case):
    """jax.image.resize's antialiased bilinear: down, up, mixed, 4-D,
    identity and 2-D, within 2e-6 (inputs in [-4, 4])."""
    shape, dims = case
    _check(_run_kind("resize", {"dims": json.dumps(dims)},
                     {"o": _rand(5, *shape)}), 2e-6)


@pytest.mark.parametrize("case", RESIZE_CASES[:4])
def test_resize_matches_jax_bf16(case):
    """bf16: ours computes in f32 and rounds once, the JAX kind in bf16;
    within 2^-6 of each value's scale (a few bf16 roundings)."""
    shape, dims = case
    res = _run_kind("resize", {"dims": json.dumps(dims)},
                    {"o": _rand(5, *shape)}, "bf16")
    got, want = res["o"]
    assert (np.abs(got - want) <= 2.0 ** -6 * np.maximum(1, np.abs(want))
            ).all()


PCA_CASES = [(1, 17, 8), (2, 50, 12), (1, 65, 24), (2, 4, 4, 16)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", PCA_CASES)
def test_pca_view_matches_jax(shape, dtype):
    """Tokens [B,N,D] (CLS skipped) and spatial [B,H,W,C] features; both
    compute in f32 from the input; within 1e-4 (96 power steps of the same
    formulation, sums in another order)."""
    x = _rand(6, *shape)
    x[..., :3] *= (4.0, 2.5, 1.5)  # a clear top-3 spread
    _check(_run_kind("pca_view", {"skip": "1"}, {"o": x}, dtype), 1e-4)


def test_pca_view_shape_errors_match_jax():
    for shape, skip in (((1, 18, 8), "1"), ((1, 17, 8), "17"),
                        ((1, 3, 4, 8), "1"), ((8,), "0")):
        x = _rand(0, *shape)
        with pytest.raises(ValueError) as terr:
            T.PcaViewNode().fn({"skip": skip})({"o": torch.from_numpy(x)})
        with pytest.raises(ValueError) as jerr:
            J.PcaViewNode().fn({"skip": skip})({"o": jnp.asarray(x)})
        assert str(terr.value) == str(jerr.value)


PATCH_CASES = [((1, 17, 8), "1", "2", "1"), ((2, 17, 8), "-1", "-1", "1"),
               ((1, 17, 8), "-3", "2", "1"), ((1, 17, 8), "9", "99", "1"),
               ((1, 16, 8), "1", "0", "0"), ((2, 4, 4, 8), "2", "3", "1"),
               ((1, 4, 4, 8), "-1", "1", "1"), ((17, 8), "0", "1", "1")]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", PATCH_CASES)
def test_patch_sim_matches_jax(case, dtype):
    """In-grid, negative (token 0) and out-of-range (clamped) queries, skip
    0, [B,H,W,C] features and 2-D tokens; within 1e-6."""
    shape, row, col, skip = case
    _check(_run_kind("patch_sim", {"row": row, "col": col, "skip": skip},
                     {"o": _rand(7, *shape)}, dtype), 1e-6)


SIM_CASES = [((2, 8), (3, 8), "10"), ((8,), (5, 8), "100"),
             ((3, 16), (4, 16), "1")]


@pytest.mark.parametrize("case", SIM_CASES)
def test_similarity_matches_jax_f32(case):
    """Within 1e-6 of the scale; a 1-D ``a`` gives [P]."""
    a, b, scale = case
    res = _run_kind("similarity", {"scale": scale},
                    {"a": _rand(8, *a), "b": _rand(9, *b)})
    _check(res, 1e-6 * float(scale), 1e-6)


@pytest.mark.parametrize("case", SIM_CASES)
def test_similarity_matches_jax_bf16(case):
    """bf16 logits: both normalize in bf16 and sum in f32; within 2^-6 of
    the scale (the normalized bf16 operands may round apart)."""
    a, b, scale = case
    res = _run_kind("similarity", {"scale": scale},
                    {"a": _rand(8, *a), "b": _rand(9, *b)}, "bf16")
    _check(res, 2.0 ** -6 * float(scale))


def test_similarity_zero_embedding_is_zero_not_nan():
    a = np.zeros((2, 8), np.float32)
    a[1] = 1.0
    res = _run_kind("similarity", {}, {"a": a, "b": _rand(9, 3, 8)})
    got, want = res["o"]
    assert np.isfinite(got).all() and (got[0] == 0).all()
    np.testing.assert_allclose(got, want, atol=1e-4)


# -- contents, dynamic params -------------------------------------------------


CONTENTS = {
    "binop": [{}, {"op": "/"}],
    "slice": [{}, {"fixed": '[{"dim":0,"val":1}]',
                   "free": '[{"in_dim":1,"out_dim":0},'
                           '{"in_dim":2,"out_dim":1}]'}],
    "shuffle": [{"fixed": "[]", "free": '[{"in_dim":1,"out_dim":0}]'}],
    "const": [{}, {"value": "2.5", "dims": "[4, 6]"}],
    "noise": [{}, {"dims": "[2,5,5]", "seed": "-1"}],
    "conv2d": [{}, {"matrix": _b64(np.arange(6) / 7.0), "h": "2", "w": "3"}],
    "resize": [{}, {"dims": "[8, 12]"}],
    "pca_view": [{}, {"skip": "0"}],
    "patch_sim": [{}, {"row": "3", "col": "-1", "skip": "2"}],
    "similarity": [{}, {"scale": "12.5"}],
    "cos": [{"A": "2", "b": "0.5"}],
}


@pytest.mark.parametrize("name", sorted(CONTENTS))
def test_contents_and_io_equal_jax(name):
    tk = next(k for k in T.instances() if k.name == name)
    jk = next(k for k in J.instances() if k.name == name)
    assert tk.dynamic_params() == jk.dynamic_params()
    for params in CONTENTS[name]:
        assert tk.contents(params) == jk.contents(params)
        assert tk.io(params) == jk.io(params)


def _kind_graph(graph_cls, name, params, inputs):
    g = graph_cls()
    n = g.add_node(name, params)
    for ch, x in inputs.items():
        g.add_input(x, n, ch)
    return g


EDITS = [
    ("const", {"dims": "[3, 4]", "value": "1.5"}, {"value": "-2"}, {}),
    ("noise", {"dims": "[6, 5]", "seed": "3"}, {"seed": "-1"}, {}),
    ("conv2d", {"h": "3", "w": "2", "matrix": _b64(np.ones(6))},
     {"matrix": _b64(np.arange(6.0))}, {"o": (3, 7, 9)}),
    ("patch_sim", {"row": "1", "col": "2"}, {"row": "-1"}, {"o": (1, 17, 8)}),
    ("patch_sim", {"row": "1", "col": "2"}, {"col": "3"}, {"o": (1, 17, 8)}),
    ("similarity", {"scale": "10"}, {"scale": "3"},
     {"a": (2, 8), "b": (3, 8)}),
]


def _edit_graphs(case, mod):
    name, params, edit, ins = EDITS[case]
    from interactive_vit_tpu.graph.ir import Graph as JGraph
    from interactive_vit_tpu_torch.graph.ir import Graph as TGraph

    graph = JGraph if mod == "jax" else TGraph
    inputs = {ch: _rand(10 + i, *s) for i, (ch, s) in enumerate(ins.items())}
    return [_kind_graph(graph, name, p, inputs)
            for p in (params, {**params, **edit})]


@pytest.mark.parametrize("case", range(len(EDITS)))
def test_dynamic_edit_is_a_cache_hit_with_new_values(reg, jreg, case):
    ex, jex = Executor(reg, device="cpu"), JExecutor(jreg)
    outs, hits = [], []
    for g, jg in zip(_edit_graphs(case, "torch"), _edit_graphs(case, "jax")):
        got = ex.run(g)
        hits.append(ex.last_stats.cache_hit)
        want = jex.run(jg)
        for i in want:
            for ch in want[i]:
                np.testing.assert_allclose(got[i][ch],
                                           np.asarray(want[i][ch]),
                                           atol=1e-5)
        outs.append(got[0])
    assert hits == [False, True]
    assert ex.cache_info()["entries"] == 1
    ch = next(iter(outs[0]))
    assert not np.array_equal(outs[0][ch], outs[1][ch])


STACKED = [
    ("noise", [{"dims": "[4, 4]", "seed": s} for s in ("0", "7", "-1")], {}),
    ("const", [{"dims": "[2, 3]", "value": v} for v in ("0", "1.5", "-3")],
     {}),
    ("conv2d", [{"h": "2", "w": "3", "matrix": _b64(_rand(s, 6))}
                for s in range(3)], {"o": (2, 6, 7)}),
    ("patch_sim", [{"row": r, "col": c} for r, c in
                   (("0", "0"), ("-1", "2"), ("3", "9"))], {"o": (1, 17, 8)}),
    ("similarity", [{"scale": s} for s in ("1", "10", "100")],
     {"a": (2, 8), "b": (3, 8)}),
]


@pytest.mark.parametrize("case", range(len(STACKED)))
def test_run_stacked_of_dynamic_values_equals_runs(reg, case):
    """Three graphs that differ only in a dynamic value share a group
    signature; one stacked pass gives each one's own run bit for bit."""
    name, plist, ins = STACKED[case]
    from interactive_vit_tpu_torch.graph.ir import Graph as TGraph

    inputs = {ch: _rand(20 + i, *s) for i, (ch, s) in enumerate(ins.items())}
    graphs = [_kind_graph(TGraph, name, p, inputs) for p in plist]
    ex = Executor(reg, device="cpu")
    assert len({ex.group_sig(g) for g in graphs}) == 1
    stacked = ex.run_stacked(graphs, "all")
    for g, res in zip(graphs, stacked):
        single = ex.run(g, "all")
        assert sorted(_flat(res)) == sorted(_flat(single))
        for k, v in _flat(single).items():
            np.testing.assert_array_equal(_flat(res)[k], v, err_msg=k)
    vals = [_flat(r)["0/o"] for r in stacked]
    assert not np.array_equal(vals[0], vals[1])


STACKED_INPUTS = [
    ("binop", {"op": "/"}, {"a": (3, 8, 8), "b": (8,)}),
    ("slice", {k: json.dumps(v) for k, v in INDEX_CASES[1][1].items()},
     {"o": (3, 5, 7)}),
    ("shuffle", {k: json.dumps(v) for k, v in INDEX_CASES[3][1].items()},
     {"o": (3, 5, 7)}),
    ("resize", {"dims": "[5, 11]"}, {"o": (2, 3, 9, 8)}),
    ("conv2d", {"h": "3", "w": "2"}, {"o": (3, 9, 8)}),
    ("pca_view", {"skip": "1"}, {"o": (1, 17, 8)}),
    ("patch_sim", {"row": "2", "col": "1"}, {"o": (2, 4, 4, 8)}),
    ("similarity", {"scale": "7"}, {"a": (8,), "b": (3, 8)}),
]


@pytest.mark.parametrize("case", range(len(STACKED_INPUTS)))
def test_run_stacked_of_inputs_equals_runs(reg, case):
    """Three graphs of one kind that differ in their input values: one
    stacked pass (``torch.func.vmap`` of the kind) gives each one's own
    run bit for bit."""
    name, params, ins = STACKED_INPUTS[case]
    from interactive_vit_tpu_torch.graph.ir import Graph as TGraph

    graphs = [_kind_graph(TGraph, name, params,
                          {ch: _rand(30 + 7 * k + i, *s)
                           for i, (ch, s) in enumerate(ins.items())})
              for k in range(3)]
    ex = Executor(reg, device="cpu")
    for g, res in zip(graphs, ex.run_stacked(graphs, "all")):
        single = ex.run(g, "all")
        assert sorted(_flat(res)) == sorted(_flat(single))
        for k, v in _flat(single).items():
            np.testing.assert_array_equal(_flat(res)[k], v, err_msg=k)


# -- the repository's demo graphs and the dino_s16 graph ----------------------


def _load(name):
    with open(os.path.join(GRAPHS, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["demo_noise.json", "demo_slice.json"])
def test_demo_graphs_match_the_jax_executor(reg, jreg, name):
    """noise / const / binop and slice / shuffle / conv2d; every output of
    every node, exact but conv2d (1e-5)."""
    obj = _load(name)
    image = np.random.default_rng(1).random((3, 224, 224), dtype=np.float32)
    g, jg = schema.graph_from_json(obj), jschema.graph_from_json(obj)
    for graph in (g, jg):
        if graph.nodes[0].name == "img_src":
            graph.add_input(image, graph.nodes[0], "o")
    got, want = _flat(Executor(reg, device="cpu").run(g, "all")), _flat(
        JExecutor(jreg).run(jg, "all"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        tol = 1e-5 if g.nodes[int(k.split("/")[0])].name == "conv2d" else 0
        np.testing.assert_allclose(got[k], np.asarray(v), atol=tol, rtol=0,
                                   err_msg=k)


DINO = dict(img_size=64, patch=16, width=64, depth=2, heads=4, num_classes=0)


def cut_blocks(obj, model, depth):
    """A saved model graph with the blocks from ``depth`` on taken out:
    their edges to later nodes leave the last kept block instead."""
    keep, last = [], None
    for i, n in enumerate(obj["nodes"]):
        ep = n["instance"].get("endpoint", "")
        if ep.startswith(model + ":blocks."):
            if int(ep.rsplit(".", 1)[1]) >= depth:
                continue
            last = i
        keep.append(i)
    where = {old: new for new, old in enumerate(keep)}
    edges = []
    for e in obj["edges"]:
        src, dst = e["in_port"]["node"], e["out_port"]["node"]
        if dst not in where:
            continue
        if src not in where:
            src = last
        edges.append({"in_port": {"node": where[src],
                                  "channel": e["in_port"]["channel"]},
                      "out_port": {"node": where[dst],
                                   "channel": e["out_port"]["channel"]}})
    return {"nodes": [obj["nodes"][i] for i in keep], "edges": edges}


@pytest.fixture(scope="module")
def dino():
    """dino_s16 at width 64, 2 blocks, 64 pixels, in both packages, the JAX
    initializer's weights in both."""
    name = "dino_s16"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VARIANTS, name, jvit.ViTConfig(name, **DINO))
        mp.setitem(tvit.VARIANTS, name, tvit.ViTConfig(name, **DINO))
        jparams = jvit.init_params(jax.random.key(11), jvit.VARIANTS[name])
        reg, jreg = Registry(), JRegistry()
        T.register_builtin(reg)
        J.register_builtin(jreg)
        jvit_make(name, params=jparams).register(jreg)
        make_vit_model(name, params=from_jax(jax.tree.map(np.asarray,
                                                          jparams)),
                       device="cpu").register(reg)
        yield reg, jreg, cut_blocks(_load("dino_s16.json"), name, 2)


def test_dino_graph_views_match_jax(dino):
    """The repository's dino_s16 feature-view graph: pca_view and patch_sim
    on the norm output, block 1's maps (attn_view) and rollout (overlay),
    every output within 1e-4 of the JAX app's; a row / col scrub replays
    the program with the new heatmap."""
    reg, jreg, obj = dino
    names = [n["instance"].get("endpoint") or n["instance"]["kind"]
             for n in obj["nodes"]]
    assert names[:5] == ["img_src", "dino_s16:transform", "dino_s16:embed",
                         "dino_s16:blocks.0", "dino_s16:blocks.1"]
    pca, sim = names.index("pca_view"), names.index("patch_sim")
    image = np.random.default_rng(2).random((3, 80, 72), dtype=np.float32)
    ex, jex = Executor(reg, device="cpu"), JExecutor(jreg)
    taps = [(pca, "o"), (sim, "o"), (4, "attn"), (4, "r"), (5, "o")]
    for n, rc in enumerate(((-1, -1), (1, 2), (3, 0))):
        g, jg = schema.graph_from_json(obj), jschema.graph_from_json(obj)
        for graph in (g, jg):
            graph.nodes[sim].params.update(row=str(rc[0]), col=str(rc[1]))
            graph.add_input(image, graph.nodes[0], "o")
        got, want = _flat(ex.run(g, taps)), _flat(jex.run(jg, taps))
        assert ex.last_stats.cache_hit == (n > 0)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], np.asarray(v), atol=1e-4,
                                       err_msg=k)
        assert got[f"{pca}/o"].shape == (1, 3, 4, 4)
