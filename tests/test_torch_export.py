"""Graph export in the port (``graph/export.py``, ``tools/export_graph.py``,
``tools/run_exported.py``), held against the JAX package's
``tests/test_export.py``: one counterpart of each of its tests, on the CPU.

The staged pass traced by ``torch.export`` must load and run with the live
executor's results, without the node registry or model code. Beside the
port's own contracts, the JAX package exports the same graphs from the
same weights: a tiny f32 ViT and the saliency graph of ``test_export.py``
give outputs within 1e-5 of JAX's artifacts, the same serving metadata key
for key, and selftest statistics within 1e-4 relative of JAX's record.
Artifacts are built once a module (exports and loads take seconds).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from interactive_vit_tpu.graph.executor import Executor as JExecutor
from interactive_vit_tpu.graph.export import (
    export_graph as jexport_graph, load_artifact as jload_artifact,
)
from interactive_vit_tpu.graph.ir import Graph as JGraph
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.vit_plugin import make_vit_model as jmake
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu_torch.graph.executor import Executor
from interactive_vit_tpu_torch.graph.export import (
    ExportedGraph, ExportError, export_graph, load_artifact, shape_struct,
)
from interactive_vit_tpu_torch.graph.ir import Graph
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops.node_ops import register_builtin

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL = 1e-5      # the port's artifact against JAX's, f32
STATS_RTOL = 1e-4   # selftest statistics against JAX's record
SERVING_KEYS = ("graph_nodes", "graph_edges", "dynamic_params", "editable",
                "node_io", "node_meta")


@pytest.fixture
def reg():
    r = Registry()
    register_builtin(r)
    return r


def ex_cpu(reg):
    return Executor(reg, device="cpu")


def chain(mod, x):
    """cos -> binop(+ const) chain over input x."""
    g = mod()
    c = g.add_node("cos", {"A": "2.0", "b": "0.5"})
    k = g.add_node("const", {"value": "0.25",
                             "dims": json.dumps(list(x.shape))})
    b = g.add_node("binop", {"op": "+"})
    g.connect(c, "o", b, "a")
    g.connect(k, "o", b, "b")
    g.add_input(x, c, "o")
    return g, b


def _close(got, want, atol, rtol=0.0):
    assert sorted(got) == sorted(want)
    for i in want:
        assert sorted(got[i]) == sorted(want[i])
        for ch in want[i]:
            np.testing.assert_allclose(
                np.asarray(got[i][ch], np.float32),
                np.asarray(want[i][ch], np.float32), atol=atol, rtol=rtol,
                err_msg=f"node {i} {ch}")


# -- a tiny f32 ViT in both packages, one set of weights ----------------------------

VIT = dict(img_size=32, patch=16, width=64, depth=2, heads=4, num_classes=8)


def _seeded_params(cfg):
    """Seeded numpy weights in the JAX tree's layout (its shapes by
    ``jax.eval_shape``, which compiles nothing): LayerNorm scales about
    1, every other leaf about 0."""
    shapes = jax.eval_shape(lambda: jvit.init_params(jax.random.key(0), cfg))
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        x = (rng.standard_normal(leaf.shape) * 0.05).astype(np.float32)
        last = str(getattr(path[-1], "key", path[-1]))
        return x + 1.0 if last == "s" or last.endswith("_s") else x

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def vit_pair():
    name = "vit_exp_port"
    jvit.VARIANTS[name] = jvit.ViTConfig(name, **VIT)
    tvit.VARIANTS[name] = tvit.ViTConfig(name, **VIT)
    try:
        params = _seeded_params(jvit.VARIANTS[name])
        reg, jreg = Registry(), JRegistry()
        register_builtin(reg)
        jbuiltin(jreg)
        jmake(name, params=jax.tree.map(jax.numpy.asarray,
                                        params)).register(jreg)
        make_vit_model(name, params=from_jax(params),
                       device="cpu").register(reg)
        yield name, reg, jreg
    finally:
        del jvit.VARIANTS[name]
        del tvit.VARIANTS[name]


IMG = np.random.default_rng(0).random((2, 3, 32, 32)).astype(np.float32)


def _vit_graph(mod, name, saliency: bool, depth: int = 2):
    g = mod()
    prev = emb = g.add_node(f"{name}:embed")
    for i in range(depth):
        b = g.add_node(f"{name}:blocks.{i}")
        g.connect(prev, "o", b, "o")
        prev = b
    head = g.add_node(f"{name}:head")
    g.connect(prev, "o", head, "o")
    taps = {(head.index, "o")}
    if saliency:
        s = g.add_node("saliency", {"target": "class", "class": "3"})
        g.connect(head, "o", s, "o")
        taps.add((s.index, "g"))
    g.add_input(IMG, emb, "o")
    return g, taps


def _export_both(vit_pair, tmp_path_factory, saliency):
    name, reg, jreg = vit_pair
    g, taps = _vit_graph(Graph, name, saliency)
    jg, _ = _vit_graph(JGraph, name, saliency)
    d = str(tmp_path_factory.mktemp("port"))
    jd = str(tmp_path_factory.mktemp("jax"))
    ex = ex_cpu(reg)
    m = export_graph(g, d, taps=taps, executor=ex)
    jm = jexport_graph(jg, jd, taps=taps, executor=JExecutor(jreg))
    return {"g": g, "taps": taps, "ex": ex, "dir": d, "jdir": jd,
            "manifest": m, "jmanifest": jm, "art": load_artifact(d),
            "jart": jload_artifact(jd)}


@pytest.fixture(scope="module")
def vit_arts(vit_pair, tmp_path_factory):
    return _export_both(vit_pair, tmp_path_factory, saliency=False)


@pytest.fixture(scope="module")
def sal_arts(vit_pair, tmp_path_factory):
    return _export_both(vit_pair, tmp_path_factory, saliency=True)


@pytest.mark.parametrize("which", ["vit", "saliency"])
def test_artifact_matches_jax_artifact(which, vit_arts, sal_arts):
    """The port's artifact and JAX's, exported from the same graph and
    weights, give the same outputs within 1e-5 on the same feeds."""
    arts = vit_arts if which == "vit" else sal_arts
    _close(arts["art"](IMG), arts["jart"](IMG), JAX_TOL)


@pytest.mark.parametrize("which", ["vit", "saliency"])
def test_serving_metadata_and_selftest_match_jax(which, vit_arts, sal_arts):
    """The serving metadata of both manifests is equal key for key, the
    selftest records agree within 1e-4 relative, and each artifact passes
    its own selftest."""
    arts = vit_arts if which == "vit" else sal_arts
    m, jm = arts["manifest"], arts["jmanifest"]
    for key in SERVING_KEYS:
        assert m[key] == jm[key], key
    assert m["format"] == jm["format"] == 1
    assert m["out_keys"] == jm["out_keys"] and m["inputs"] == jm["inputs"]
    stats, jstats = m["selftest"]["stats"], jm["selftest"]["stats"]
    assert sorted(stats) == sorted(jstats)
    for key, want in jstats.items():
        got = stats[key]
        assert got["shape"] == want["shape"]
        scale = max(abs(want["absmax"]), 1e-6)
        for metric in ("mean", "std", "absmax"):
            assert abs(got[metric] - want[metric]) / scale <= STATS_RTOL, (
                key, metric, got[metric], want[metric])
    assert arts["art"].selftest()["ok"]


def test_roundtrip_parity(reg, tmp_path):
    x = np.linspace(-1.0, 1.0, 16, dtype=np.float32)
    g, _ = chain(Graph, x)
    ex = ex_cpu(reg)
    want = ex.run(g, taps="all")

    out_dir = str(tmp_path / "art")
    manifest = export_graph(g, out_dir, taps="all", executor=ex)
    assert manifest["format"] == 1
    assert sorted(os.listdir(out_dir)) == [
        "captures.safetensors", "manifest.json", "program.pt2"]
    got = load_artifact(out_dir)(x)
    _close(got, want, 1e-6)
    # and the JAX executor's results on the same graph
    jreg = JRegistry()
    jbuiltin(jreg)
    jg, _ = chain(JGraph, x)
    _close(got, JExecutor(jreg).run(jg, taps="all"), 1e-6)


def test_load_needs_no_registry(reg, tmp_path):
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g, _ = chain(Graph, x)
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, taps="primary", executor=ex_cpu(reg))
    got = ExportedGraph(out_dir)(x)  # no registry anywhere in this path
    sink = max(got)  # the binop is the graph's only sink
    np.testing.assert_allclose(got[sink]["c"], np.cos(2.0 * x + 0.5) + 0.25,
                               atol=1e-6)


def test_load_in_a_process_without_model_code(vit_arts):
    """A fresh interpreter loads and runs the tiny ViT's CPU artifact with
    neither the models, the registry, the node kinds nor JAX imported."""
    code = f"""
import sys, numpy as np
from interactive_vit_tpu_torch.graph.export import load_artifact
art = load_artifact({vit_arts["dir"]!r})
out = art(np.load({vit_arts["dir"] + "/in.npy"!r}))
np.save({vit_arts["dir"] + "/out.npy"!r}, out[{max(vit_arts["art"].out_keys)[0]}]["o"])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("interactive_vit_tpu_torch.models")
             or m in ("interactive_vit_tpu_torch.graph.registry",
                      "interactive_vit_tpu_torch.ops.node_ops"))
assert not bad, bad
print("clean")
"""
    np.save(vit_arts["dir"] + "/in.npy", IMG)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    head = max(vit_arts["art"].out_keys)[0]
    np.testing.assert_array_equal(np.load(vit_arts["dir"] + "/out.npy"),
                                  vit_arts["art"](IMG)[head]["o"])


def test_dynamic_capture_edit_after_export(reg, tmp_path):
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g = Graph()
    c = g.add_node("cos", {"A": "2.0", "b": "0.5"})
    g.add_input(x, c, "o")
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, taps="all", executor=ex_cpu(reg))

    art = load_artifact(out_dir)
    np.testing.assert_allclose(art(x)[c.index]["o"], np.cos(2.0 * x + 0.5),
                               atol=1e-6)
    art.set_cap(c.index, "A", 3.0)
    np.testing.assert_allclose(art(x)[c.index]["o"], np.cos(3.0 * x + 0.5),
                               atol=1e-6)
    with pytest.raises(ExportError, match="no capture"):
        art.set_cap(c.index, "nope", 1.0)
    with pytest.raises(ExportError, match="shape"):
        art.set_cap(c.index, "A", np.zeros((2, 2), np.float32))


def test_model_graph_with_saliency_exports(sal_arts):
    """The saliency graph of JAX's test (the gradient inside the program,
    the weights in the captures): the live executor's values, and the
    class index a dynamic capture that a set_cap scrubs."""
    art, g = sal_arts["art"], sal_arts["g"]
    want = sal_arts["ex"].run(g, taps=sal_arts["taps"])
    got = art(IMG)
    _close(got, want, 1e-5, 1e-4)
    s = max(i for i, _ in sal_arts["taps"])
    assert sal_arts["manifest"]["editable"][str(s)] == {"class": "int"}
    try:
        art.set_cap(s, "class", 5)
        got5 = art(IMG)
    finally:
        art.set_cap(s, "class", 3)
    assert not np.allclose(got5[s]["g"], got[s]["g"])
    np.testing.assert_array_equal(art(IMG)[s]["g"], got[s]["g"])


def test_input_contract_errors(reg, tmp_path):
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g, _ = chain(Graph, x)
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, executor=ex_cpu(reg))
    art = load_artifact(out_dir)
    with pytest.raises(ExportError, match="takes 1 inputs"):
        art(x, x)
    with pytest.raises(ExportError, match="shape"):
        art(np.zeros((3,), np.float32))


def test_generator_graph_exports_nullary(reg, tmp_path):
    g = Graph()
    k = g.add_node("const", {"value": "1.5", "dims": "[4]"})
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, taps="all", executor=ex_cpu(reg))
    art = load_artifact(out_dir)
    assert art.input_specs == []
    np.testing.assert_allclose(art()[k.index]["o"],
                               np.full((4,), 1.5, np.float32))
    art.set_cap(k.index, "value", 2.5)
    np.testing.assert_allclose(art()[k.index]["o"],
                               np.full((4,), 2.5, np.float32))


def test_corrupt_artifact_errors(reg, tmp_path):
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g, _ = chain(Graph, x)
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, executor=ex_cpu(reg))
    with pytest.raises(ExportError, match="manifest"):
        load_artifact(str(tmp_path / "missing"))
    p = os.path.join(out_dir, "program.pt2")
    with open(p, "r+b") as f:
        f.truncate(10)
    with pytest.raises(ExportError, match="deserialization"):
        load_artifact(out_dir)


def test_jax_artifact_is_refused_by_name(tmp_path):
    """A JAX package artifact (program.stablehlo) is refused, named."""
    jreg = JRegistry()
    jbuiltin(jreg)
    jg = JGraph()
    c = jg.add_node("cos", {"A": "2.0"})
    jg.add_input(np.zeros((4,), np.float32), c, "o")
    d = str(tmp_path / "jax_art")
    jexport_graph(jg, d, executor=JExecutor(jreg))
    with pytest.raises(ExportError, match="program.stablehlo"):
        load_artifact(d)


def test_shape_struct_inputs_export(reg, tmp_path):
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g = Graph()
    c = g.add_node("cos", {"A": "1.0", "b": "0.0"})
    g.add_input(shape_struct(x.shape), c, "o")
    out_dir = str(tmp_path / "art")
    m = export_graph(g, out_dir, executor=ex_cpu(reg))
    assert m["inputs"][0]["shape"] == [8]
    np.testing.assert_allclose(load_artifact(out_dir)(x)[c.index]["o"],
                               np.cos(x), atol=1e-6)


def test_export_cli_end_to_end(tmp_path):
    from interactive_vit_tpu_torch.tools.export_graph import (
        main as export_main,
    )
    from interactive_vit_tpu_torch.tools.run_exported import main as run_main

    out_dir = str(tmp_path / "art")
    rc = export_main(["demo_noise", "--out", out_dir, "--taps", "all",
                      "--check", "--device", "cpu"])
    assert rc == 0
    art = load_artifact(out_dir)
    assert art.manifest["provenance"]["graph"] == "demo_noise.json"
    assert art.manifest["client_graph"]["nodes"]

    feeds = []
    for i, s in enumerate(art.input_specs):
        p = str(tmp_path / f"in{i}.npy")
        np.save(p, np.random.default_rng(i).random(
            s["shape"]).astype(s["dtype"]))
        feeds.append(p)
    taps_dir = str(tmp_path / "taps")
    assert run_main([out_dir, *feeds, "--out", taps_dir]) == 0
    assert any(f.endswith(".npy") for f in os.listdir(taps_dir))
    assert run_main([out_dir, "--selftest"]) == 0
    assert export_main(["demo_noise", "--out", out_dir, "--mesh",
                        "data=4", "--device", "cpu"]) == 2


def test_bf16_model_artifact_roundtrips(vit_pair, tmp_path):
    """A bf16 model's captures are written under BF16 tags and come back
    as bf16 (the reader upcasts to f32; the skeleton's dtype restores)."""
    from interactive_vit_tpu_torch.utils import safetensors_io

    name, _, _ = vit_pair
    reg = Registry()
    register_builtin(reg)
    make_vit_model(name, dtype=torch.bfloat16, device="cpu").register(reg)
    g = Graph()
    emb = g.add_node(f"{name}:embed")
    head = g.add_node(f"{name}:head")
    g.connect(emb, "o", head, "o")
    img = IMG[:1]
    g.add_input(img, emb, "o")
    ex = ex_cpu(reg)
    want = ex.run(g, taps={(head.index, "o")})
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, taps={(head.index, "o")}, executor=ex)
    with open(os.path.join(out_dir, "captures.safetensors"), "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    tags = {v["dtype"] for k, v in header.items() if k != "__metadata__"}
    assert "BF16" in tags
    art = load_artifact(out_dir)
    assert any(leaf.dtype == torch.bfloat16
               for leaf in art.caps[str(emb.index)].values()
               if isinstance(leaf, torch.Tensor))
    np.testing.assert_array_equal(art(img)[head.index]["o"],
                                  want[head.index]["o"])
    assert safetensors_io.load_file(
        os.path.join(out_dir, "captures.safetensors"))


def test_capture_path_collision_refused():
    from interactive_vit_tpu_torch.graph.export import _flatten_caps

    caps = {"a": {"b": torch.zeros(2)}, "a.b": torch.ones(2)}
    with pytest.raises(ExportError, match="collision"):
        _flatten_caps(caps, "c", {})
    with pytest.raises(ExportError, match="not a tensor"):
        _flatten_caps({"a": "text"}, "c", {})


def test_set_cap_on_weights_subtree_is_export_error(vit_pair, tmp_path):
    name, _, _ = vit_pair
    reg = Registry()
    register_builtin(reg)
    make_vit_model(name, quantize="w8", device="cpu").register(reg)
    g = Graph()
    emb = g.add_node(f"{name}:embed")
    b0 = g.add_node(f"{name}:blocks.0")
    g.connect(emb, "o", b0, "o")
    g.add_input(np.zeros((1, 3, 32, 32), np.float32), emb, "o")
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, executor=ex_cpu(reg))
    art = load_artifact(out_dir)
    subtree = next(((int(i), k) for i, c in art.caps.items()
                    if isinstance(c, dict)
                    for k, v in c.items() if isinstance(v, dict)), None)
    assert subtree is not None, "expected a quant-dict capture"
    with pytest.raises(ExportError, match="subtree"):
        art.set_cap(subtree[0], subtree[1], 1.0)


def test_cpu_artifact_names_its_platform(vit_arts):
    """The JAX test lowers one artifact for two platforms; a port artifact
    is traced on one device and names it: a CPU trace holds no ivt op (the
    plain versions) and says ``["cpu"]``."""
    from interactive_vit_tpu_torch.ops import custom_ops

    assert vit_arts["manifest"]["platforms"] == ["cpu"]
    ep = torch.export.load(os.path.join(vit_arts["dir"], "program.pt2"))
    assert custom_ops.count_ivt_nodes(ep.graph) == {}
    assert vit_arts["art"].device.type == "cpu"


def test_mesh_sharded_export_is_refused(reg, tmp_path):
    """Mesh-sharded export is not ported (ROADMAP queue 1 item 7): the
    exporter and the loader refuse it with ``ExportError``."""
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g, _ = chain(Graph, x)
    with pytest.raises(ExportError, match="queue 1 item 7"):
        export_graph(g, str(tmp_path / "m"), executor=ex_cpu(reg),
                     mesh={"data": 4, "model": 2})
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, executor=ex_cpu(reg))
    mpath = os.path.join(out_dir, "manifest.json")
    m = json.load(open(mpath))
    m["mesh"] = {"axes": ["data", "model"], "shape": [4, 2]}
    json.dump(m, open(mpath, "w"))
    with pytest.raises(ExportError, match="queue 1 item 7"):
        load_artifact(out_dir)


def test_cuda_artifact_never_runs_on_the_cpu(reg, tmp_path):
    """An artifact traced on a card (``platforms`` ["cuda"]) refuses to
    load on a host without one: it never runs its program on the CPU."""
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g, _ = chain(Graph, x)
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, executor=ex_cpu(reg))
    mpath = os.path.join(out_dir, "manifest.json")
    m = json.load(open(mpath))
    m["platforms"] = ["cuda"]
    json.dump(m, open(mpath, "w"))
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(ExportError, match=r"exported for \['cuda'\]"):
        load_artifact(out_dir)


def test_deeper_chain_export_roundtrips(vit_pair, tmp_path):
    """The JAX test folds a 4-block chain into a pipeline over a mesh's
    stage axis; the port has no pipeline folding, and the same 4-block
    chain exports unfolded and gives the live executor's values."""
    name, _, _ = vit_pair
    reg = Registry()
    register_builtin(reg)
    tvit.VARIANTS[name + "4"] = tvit.ViTConfig(name + "4",
                                               **dict(VIT, depth=4))
    try:
        make_vit_model(name + "4", seed=4, device="cpu").register(reg)
        g, taps = _vit_graph(Graph, name + "4", False, depth=4)
        ex = ex_cpu(reg)
        out_dir = str(tmp_path / "art")
        export_graph(g, out_dir, taps=taps, executor=ex)
        _close(load_artifact(out_dir)(IMG), ex.run(g, taps=taps), 1e-5)
    finally:
        del tvit.VARIANTS[name + "4"]


def test_manifest_is_json_and_versioned(reg, tmp_path):
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g, _ = chain(Graph, x)
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, executor=ex_cpu(reg))
    m = json.load(open(os.path.join(out_dir, "manifest.json")))
    assert m["format"] == 1
    assert m["torch_version"] == torch.__version__ and "jax_version" not in m
    assert m["inputs"][0]["shape"] == [8]
    assert m["inputs"][0]["dtype"] == "float32"
    assert m["mesh"] is None and m["capture_specs"] is None
    assert all(isinstance(i, list) and len(i) == 2 for i in m["out_keys"])
    leaves = []

    def walk(s):
        if s["t"] == "a":
            leaves.append(s["dt"])
        elif s["t"] == "d":
            for v in s["v"].values():
                walk(v)
        else:
            for v in s["v"]:
                walk(v)

    walk(m["captures_skeleton"])
    assert leaves and set(leaves) <= {"float32", "int64", "int32"}


def test_selftest_passes_and_catches_corruption(reg, tmp_path):
    g = Graph()
    a = g.add_node("cos", {"A": "2.0", "b": "0.5"})
    b = g.add_node("binop", {"op": "*"})
    g.connect(a, "o", b, "a")
    g.connect(a, "o", b, "b")
    g.add_input(np.zeros((64,), np.float32), a, "o")
    d = str(tmp_path / "art")
    export_graph(g, d, taps="primary", executor=ex_cpu(reg))

    res = load_artifact(d).selftest()
    assert res["ok"], res
    assert res["checked"] >= 2

    caps_path = os.path.join(d, "captures.safetensors")
    raw = bytearray(open(caps_path, "rb").read())
    raw[-4:] = b"\x7f\x7f\x7f\x7f"
    open(caps_path, "wb").write(raw)
    res2 = load_artifact(d).selftest()
    assert not res2["ok"], res2


def test_hot_path_properties(reg, tmp_path):
    """Captures live on the artifact's device from load, the loaded module
    is kept for every call, and ``want=`` limits the outputs copied out."""
    g = Graph()
    a = g.add_node("cos", {"A": "2.0"})
    b = g.add_node("cos", {"A": "3.0"})
    g.connect(a, "o", b, "o")
    g.add_input(np.zeros((8,), np.float32), a, "o")
    d = str(tmp_path / "art")
    export_graph(g, d, taps="primary", executor=ex_cpu(reg))

    art = load_artifact(d)
    for c in art.caps.values():
        for leaf in c.values():
            assert isinstance(leaf, torch.Tensor)
            assert leaf.device == art.device
    x = np.linspace(0, 1, 8, dtype=np.float32)
    module = art._module
    full = art(x)
    assert set(full) == {0, 1}
    sub = art(x, want={(1, "o")})
    assert art._module is module
    assert set(sub) == {1}
    np.testing.assert_allclose(sub[1]["o"], full[1]["o"])
    # a per-call overlay edits one call and leaves the artifact as it was
    over = dict(art.caps)
    over["0"] = dict(art.caps["0"], A=torch.tensor(1.0))
    np.testing.assert_allclose(art(x, caps=over)[0]["o"], np.cos(x),
                               atol=1e-6)
    np.testing.assert_array_equal(art(x)[0]["o"], full[0]["o"])
