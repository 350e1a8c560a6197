"""Serving on a mesh: ``Executor(mesh=)``, the makers' ``kernels=`` /
``tp_layout=``, the server's ``--mesh`` with its followers, held against
the JAX package on the CPU.

* Pipeline folding's chains (``graph/executor.find_pp_segments``) against
  JAX's ``Executor(mesh=)._find_pp_segments`` on the repository's saved
  vit_t16 graphs: pure graph logic, no process.
* ``_stacked_bucket`` on data axes of 1, 3 and 4 against JAX's.
* ``make_model(kernels=False, tp_layout=True)``: every tap of the chain
  against JAX's same maker, and JAX's refusal texts.
* The dry run's serving cases (``tools/dryrun_multichip.serving_cases``)
  on four gloo ranks (``tests/torch_parallel_worker.py ... serve``: the
  spawn of ``test_torch_parallel.py`` with its other half) against JAX's
  ``Executor(mesh=)`` on meshes of the same shapes from
  ``jax.devices()[:4]``, JAX's models made as its server makes them on a
  mesh (``kernels=False``, ``tp_layout`` where the model axis is above 1).
* A two-rank gloo server (``tests/torch_mesh_server_worker.py``, vit_t16
  from the repository's saved graph, ``--mesh data=2``) over HTTP against
  the one-device app; and rank 0's answer once its follower is gone.

Tolerances, each with its reason (f32 on both sides, the same weights):
the served taps 1e-4, the JAX dry run's own bound for its mesh executor
(GSPMD's partial sums and the port's row-parallel all-reduce add the
halves of each product in other orders; the gradient kinds differentiate
through them); the two-rank server's responses 1e-4 of the one-device
server's (the same bound; a group's rows run as a batch of one a rank).
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from interactive_vit_tpu.graph import executor as jexec
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import autoregister as jauto
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.vit_plugin import make_vit_model as jmake
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.parallel import mesh as jmesh
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph import executor as texec
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import autoregister as tauto
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.tools import dryrun_multichip as dry
from interactive_vit_tpu_torch.wire import schema
from interactive_vit_tpu_torch.wire.codec import (
    RESPONSE_MAGIC, Request, decode_message,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = os.path.join(ROOT, "static", "graphs")
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
SERVER = os.path.join(ROOT, "tests", "torch_mesh_server_worker.py")
ATOL = 1e-4


class _MemLib:
    """A graph library in memory (the JAX maker's ``register`` writes its
    chain graph into one)."""

    def __init__(self):
        self.store = {}

    def exists(self, name):
        return name in self.store

    def save(self, name, obj):
        self.store[name] = obj

    def load(self, name):
        return self.store[name]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))


def _spawn(script, world, args):
    return [subprocess.Popen([sys.executable, script, str(r), str(world),
                              *args], env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait(procs, timeout=300):
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return logs


# -- pipeline folding's chains --------------------------------------------------


@pytest.fixture(scope="module")
def t16():
    """vit_t16 registered in both packages (JAX's init, its numpy leaves
    handed to the port): (JAX registry, the port's)."""
    jreg = JRegistry()
    jbuiltin(jreg)
    jm = jmake("vit_t16", kernels=False)
    jm.register(jreg, _MemLib())
    treg = Registry()
    register_builtin(treg)
    make_vit_model("vit_t16", device="cpu",
                   params=from_jax(jax.tree.map(np.asarray, jm.params))
                   ).register(treg, None)
    return jreg, treg


def _graph(pkg, name, edit=None):
    with open(os.path.join(GRAPHS, name)) as f:
        obj = json.load(f)
    g = pkg.graph_from_json(obj)
    g.add_input(np.zeros((3, 224, 224), np.float32), g.nodes[0], "o")
    if edit is not None:
        edit(g)
    return g


def _wire_r(g):
    """blocks.5's rollout wired into blocks.6 (a consumed extra channel,
    and a second input of the consumer)."""
    g.connect(g.nodes[7], "r", g.nodes[8], "r")


def _saliency_mid(g):
    """A saliency node off blocks.5's output: a gradient cone over the
    chain's first eight nodes."""
    s = g.add_node("saliency", {"target": "max"})
    g.connect(g.nodes[7], "o", s, "o")


CHAIN_CASES = {
    # name: (saved graph, its edit, taps, stage count, a kind made dynamic)
    "primary_2": ("vit_t16.json", None, "primary", 2, None),
    "primary_3": ("vit_t16.json", None, "primary", 3, None),
    "trimmed_5": ("vit_t16.json", None, "primary", 5, None),
    "interior_o": ("vit_t16.json", None, {(5, "o"), (9, "o"), (15, "o")}, 2,
                   None),
    "extra_tap": ("vit_t16.json", None, {(6, "attn"), (15, "o")}, 2, None),
    "extra_wired": ("vit_t16.json", _wire_r, "primary", 2, None),
    "gradient_cone": ("vit_t16.json", _saliency_mid, "primary", 2, None),
    "saliency_graph": ("vit_t16_saliency.json", None, "primary", 2, None),
    "dynamic_kind": ("vit_t16.json", None, "primary", 2,
                     "vit_t16:blocks.6"),
}


def _segments(pkg, reg, case, jax_side):
    path, edit, taps, n_stages, dyn_kind = CHAIN_CASES[case]
    g = _graph(pkg, path, edit)
    order = g.order()
    kinds = {n.index: reg.get_node(n.name) for n in g.nodes}
    ex_mod = jexec if jax_side else texec
    tap_set = ex_mod.resolve_taps(g, taps, reg)
    caps = {n.index: kinds[n.index].captures(n.params) for n in g.nodes}
    protected = set()
    for gi, sp in ex_mod._grad_specs(g, order, g.input_edges(),
                                     kinds).items():
        protected |= {gi, *(m.index for m in sp.anc)}
        if sp.wrt_key[0] != "in":
            protected.add(sp.wrt_key[0])
    if jax_side:
        ex = jexec.Executor(reg, mesh=jmesh.make_mesh(
            {"stage": n_stages}, jax.devices()[:n_stages]))
        segs = ex._find_pp_segments(order, g, kinds, tap_set, caps,
                                    protected=protected)
    else:
        segs = texec.find_pp_segments(order, g, kinds, tap_set, caps,
                                      n_stages, protected)
    return [[m.index for m in seg] for seg in segs]


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_find_pp_segments_is_jax_s(t16, case, monkeypatch):
    """The chains the executor folds on a "stage" axis: JAX's on the saved
    vit_t16 graphs for plain chains (trimmed to a multiple of 2, 3 and 5
    stages), interior "o" taps (kept inside), an extra-channel tap and a
    wired extra channel (each breaks the chain), a gradient cone (none of
    it folds) and a kind with dynamic params (breaks the chain)."""
    jreg, treg = t16
    dyn_kind = CHAIN_CASES[case][4]
    if dyn_kind is not None:
        for reg in (jreg, treg):
            monkeypatch.setattr(reg.get_node(dyn_kind), "dynamic_params",
                                lambda: frozenset({"gain"}))
    want = _segments(jschema, jreg, case, jax_side=True)
    got = _segments(schema, treg, case, jax_side=False)
    assert got == want
    if case == "primary_2":
        assert got == [list(range(2, 14))]
    if case == "trimmed_5":
        assert got == [list(range(2, 12))]


class _MeshShape:
    """A stand-in for a ``DeviceMesh``'s shape queries (no process
    group): the executor reads only its axes' sizes here."""

    device_type = "cpu"

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, i):
        return self._sizes[i]


@pytest.mark.parametrize("n_data", [1, 3, 4])
def test_stacked_bucket_rounds_to_the_data_axis_as_jax(n_data):
    """A group's bucket: the power of two, rounded up to the data axis
    (3: 1 -> 3, 4 -> 6), for groups of 1 to 9, JAX's."""
    ex = texec.Executor(Registry(), device="cpu",
                        mesh=_MeshShape({"data": n_data, "model": 1}))
    jex = jexec.Executor(JRegistry(), mesh=jmesh.make_mesh(
        {"data": n_data}, jax.devices()[:n_data]))
    got = [ex._stacked_bucket(k) for k in range(1, 10)]
    assert got == [jex._stacked_bucket(k) for k in range(1, 10)]
    assert all(b % n_data == 0 and b >= k for k, b in enumerate(got, 1))


# -- the makers' kernels= and tp_layout= ----------------------------------------------


NAME = "vit_tp_port"
SMALL = dict(img_size=32, patch=16, width=64, depth=2, heads=4,
             num_classes=10)


@pytest.fixture
def small():
    cfg_j = jvit.ViTConfig(NAME, **SMALL)
    jvit.VARIANTS[NAME] = cfg_j
    tvit.VARIANTS[NAME] = tvit.ViTConfig(NAME, **SMALL)
    try:
        yield jax.tree.map(np.asarray, jax.jit(
            jvit.init_params, static_argnums=1)(jax.random.key(3), cfg_j))
    finally:
        del jvit.VARIANTS[NAME], tvit.VARIANTS[NAME]


def test_tp_layout_model_matches_jax(small):
    """``make_model(NAME, kernels=False, tp_layout=True)`` (head-major qkv
    columns, every block and the attribution on that layout): every tap of
    its chain and of ``:attrib`` within 1e-4 of JAX's same maker on the
    same weights, and of the canonical layout's."""
    jreg, treg, creg = JRegistry(), Registry(), Registry()
    jbuiltin(jreg)
    register_builtin(treg)
    register_builtin(creg)
    jm = jauto.make_model(NAME, params=small, kernels=False, tp_layout=True)
    jm.register(jreg, _MemLib())
    tm = tauto.make_model(NAME, params=from_jax(small), device="cpu",
                          kernels=False, tp_layout=True)
    tm.register(treg, None)
    tauto.make_model(NAME, params=from_jax(small),
                     device="cpu").register(creg, None)
    assert not torch.equal(tm.params["blocks"][0]["qkv_w"],
                           from_jax(small)["blocks"][0]["qkv_w"])
    image = np.random.default_rng(5).random((3, 32, 32), dtype=np.float32)
    obj = tm.generate_graph_json()

    def graph(pkg):
        g = pkg.graph_from_json(obj)
        g.nodes[3].params["attn_heads"] = "[0,3]"
        g.add_input(image, g.nodes[0], "o")
        att = g.add_node(NAME + ":attrib", {"target": "max"})
        g.connect(g.nodes[1], "o", att, "o")
        return g

    want = jexec.Executor(jreg).run(graph(jschema), taps="all")
    for reg in (treg, creg):
        got = texec.Executor(reg, device="cpu").run(graph(schema),
                                                    taps="all")
        assert sorted(got) == sorted(want)
        for i in want:
            assert sorted(got[i]) == sorted(want[i]), i
            for ch in want[i]:
                np.testing.assert_allclose(got[i][ch], np.asarray(
                    want[i][ch]), rtol=0, atol=ATOL, err_msg=f"{i}/{ch}")


@pytest.mark.parametrize("kw", [
    dict(tp_layout=True),
    dict(kernels=False, block_kernel="int8-scores"),
    dict(kernels=False, quantize="w8a8"),
], ids=["tp_layout_with_kernels", "block_kernel_without_kernels",
        "w8a8_without_kernels"])
def test_maker_refusals_are_jax_s(small, kw):
    """The refusals of ``kernels=`` / ``tp_layout=``: JAX's texts."""
    with pytest.raises(ValueError) as jerr:
        jauto.make_model(NAME, params=small, **kw)
    with pytest.raises(ValueError) as terr:
        tauto.make_model(NAME, params=from_jax(small), device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_make_model_passes_kernels_to_every_family_that_has_it():
    """``make_model``'s ``kernels=False`` reaches Swin, ToMe and CLIP's
    image tower (their makers' flag; on the CPU "auto" is the plain path
    too, so the flag shows in the maker's arguments), ``tp_layout`` only
    the plain ViTs."""
    import inspect

    from interactive_vit_tpu_torch.models import (
        clip_plugin, swin_plugin, tome_plugin,
    )

    for mod, fn in ((swin_plugin, "make_swin_model"),
                    (tome_plugin, "make_tome_model"),
                    (clip_plugin, "make_clip_model")):
        assert "kernels" in inspect.signature(getattr(mod, fn)).parameters
    src = inspect.getsource(tauto.make_model)
    assert src.count("kernels=kernels") == 4
    assert src.count("tp_layout=tp_layout") == 1


# -- the dry run's serving cases on four gloo ranks -----------------------------------


def _jax_serving(inputs):
    """The serving cases through JAX's ``Executor(mesh=)``, its models made
    as its server makes them on a mesh."""
    cfg = jvit.ViTConfig("vit_dryrun", **dry.CFG)
    jvit.VARIANTS[cfg.name] = cfg
    images = inputs["serve_images"]
    out = {}
    try:
        exs = {}
        for case, sizes in dry.SERVE_MESHES.items():
            reg = JRegistry()
            jbuiltin(reg)
            m = jmake(cfg.name, params=inputs["vit"], kernels=False,
                      tp_layout=sizes.get("model", 1) > 1)
            m.register(reg, _MemLib())
            exs[case] = (jexec.Executor(reg, mesh=jmesh.make_mesh(
                sizes, jax.devices()[:4])), m)

        def graphs(m, imgs, node_params=None):
            res = []
            for im in imgs:
                g = jschema.graph_from_json(m.generate_graph_json())
                for i, p in (node_params or {}).items():
                    g.nodes[i].params.update(p)
                g.add_input(im, g.nodes[0], "o")
                res.append(g)
            return res

        ex, m = exs["a"]
        out.update(dry._results("serve_a", ex.run_stacked(
            graphs(m, images[:4], dry.SERVE_HEADS), taps="all")))
        g = graphs(m, images[4:5])[0]
        head = next(n for n in g.nodes if n.name.endswith(":head"))
        emb = next(n for n in g.nodes if n.name.endswith(":embed"))
        sal = g.add_node("saliency", {"target": "max"})
        g.connect(head, "o", sal, "o")
        att = g.add_node(cfg.name + ":attrib", {"target": "max"})
        g.connect(emb, "o", att, "o")
        out.update(dry._results("serve_grad", ex.run(g, taps={
            (sal.index, "g"), (att.index, "rel"), (att.index, "o")})))
        ge = graphs(m, images[4:5])[0]
        sal = ge.add_node("saliency", {"target": "max"})
        ge.connect(ge.nodes[head.index], "o", sal, "o")
        att = ge.add_node(cfg.name + ":attrib", {"target": "max"})
        ge.connect(ge.nodes[emb.index], "o", att, "o")
        outs, errors = ex.run_eager(ge)
        assert not errors, errors
        out.update(dry._results("serve_eager", outs))
        ex, m = exs["pp"]
        gs = graphs(m, images[:5])
        taps = {(2, "o"), (head.index, "o")}
        out.update(dry._results("serve_pp_one", ex.run(gs[4], taps=taps)))
        segs = [ex.last_pp_segments]
        out.update(dry._results("serve_pp_group",
                                ex.run_stacked(gs[:4], taps=taps)))
        out["pp_segments"] = np.asarray(segs + [ex.last_pp_segments])
        ex, m = exs["dp"]
        out.update(dry._results("serve_dp", ex.run_stacked(
            graphs(m, images[5:8]), taps="primary")))
    finally:
        del jvit.VARIANTS[cfg.name]
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the port's rank-0 serving results on four gloo ranks, JAX's): one
    spawn of the dry run's "serve" half, JAX's side computed while it
    runs."""
    from interactive_vit_tpu_torch.tools.dryrun_multichip import make_inputs

    tmp = tmp_path_factory.mktemp("mesh_serving")
    inputs = make_inputs(0)
    cfg = jvit.ViTConfig("vit_dryrun", **dry.CFG)
    inputs = {"vit": jax.tree.map(np.asarray, jax.jit(
        jvit.init_params, static_argnums=1)(jax.random.key(0), cfg)),
        "serve_images": inputs["serve_images"]}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    procs = _spawn(WORKER, 4, [str(tmp / "rdzv"), str(tmp / "inputs.pkl"),
                               str(tmp / "out.npz"), "serve"])
    try:
        want = _jax_serving(inputs)
    finally:
        _wait(procs)
    return dict(np.load(tmp / "out.npz")), want


@pytest.mark.parametrize("case", ["serve_a", "serve_grad", "serve_eager",
                                  "serve_pp_one", "serve_pp_group",
                                  "serve_dp"])
def test_serving_case_matches_jax_mesh_executor(served, case):
    """Each serving case's outputs, whole on rank 0, within 1e-4 of JAX's
    mesh executor: (a) a group of 4 on data=2,model=2, every tap (the
    head-sharded maps, a head subset, the rollout, the CLS); (b) saliency
    and ``:attrib`` through the TP-sharded captures, and the same graph
    through ``run_eager`` on that mesh; (c) the folded chain
    with blocks.0's output tapped inside it, one request and a group of 4
    on data=2,stage=2; (d) a group of 3 on data=4 (bucket 4)."""
    got, want = served
    keys = sorted(k for k in want if k.startswith(case + "/"))
    assert keys and keys == sorted(k for k in got
                                   if k.startswith(case + "/"))
    for key in keys:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=ATOL,
                                   err_msg=key)


def test_serving_mesh_placements(served):
    """The chain folded as JAX folds it (blocks 0-1, in the request and in
    the group), and each model rank holds half of a block's qkv columns
    (head-major, [64, 96] of [64, 192])."""
    got, want = served
    assert got["pp_segments"].tolist() == want["pp_segments"].tolist() \
        == dry.PP_SEGMENTS
    assert tuple(got["serve_qkv_local"]) == (64, 96)


# -- the two-rank server ----------------------------------------------------------------


def _body(seed, node_params=None):
    with open(os.path.join(GRAPHS, "vit_t16.json")) as f:
        g = schema.graph_from_json(json.load(f))
    for i, p in (node_params or {}).items():
        g.nodes[i].params.update(p)
    g.add_input(np.random.default_rng(seed).random((3, 224, 224),
                                                   dtype=np.float32),
                g.nodes[0], "o")
    return Request.encode(g)


def _decode(raw):
    obj, tensors = decode_message(raw, expect_magic=RESPONSE_MAGIC)
    return obj, tensors


@pytest.fixture(scope="module")
def mesh_server(tmp_path_factory):
    """The two-rank server's answers (rank 0's pickle, rank 1's call
    count) and the request bodies; the workers' exits checked (a clean
    stop)."""
    tmp = tmp_path_factory.mktemp("mesh_server")
    bodies = {"single": _body(1), "pair": [_body(2), _body(3)],
              "bad": _body(4, {5: {"attn_heads": "[99]"}}),
              "after": _body(5)}
    with open(tmp / "req.pkl", "wb") as f:
        pickle.dump(bodies, f)
    _wait(_spawn(SERVER, 2, [str(tmp / "rdzv"), str(tmp / "req.pkl"),
                             str(tmp / "out.pkl")]))
    with open(tmp / "out.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp / "out.pkl.rank1") as f:
        calls = int(f.read())
    return got, calls, bodies


@pytest.fixture(scope="module")
def one_device_app():
    from interactive_vit_tpu_torch.serving.server import build_app

    app = build_app(models=("vit_t16",), device="cpu")
    yield app
    app.close()


def test_mesh_server_answers_as_one_device(mesh_server, one_device_app):
    """``--mesh data=2`` on two gloo ranks: a request alone and two at once
    (one group of 2, a row on each data rank) answer within 1e-4 of the
    one-device server, with the same routes; rank 1 made each of rank 0's
    five executor calls (three runs, the pair's group and
    /debug_eval's)."""
    got, calls, bodies = mesh_server
    cases = [("single", got["single"], bodies["single"])] + [
        (f"pair{j}", got["pair"][j], bodies["pair"][j]) for j in range(2)]
    for tag, (status, raw, headers), body in cases:
        assert status == 200, (tag, raw[:300])
        obj, tensors = _decode(raw)
        wobj, wtensors = _decode(one_device_app.compute(body))
        assert obj == wobj, tag
        for a, b in zip(tensors, wtensors):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=tag)
    for status, _, headers in got["pair"]:
        assert "batch=2" in headers["X-IVT-Timing"]
    assert calls == 5


def test_mesh_server_debug_eval_is_followed(mesh_server, one_device_app):
    """``/debug_eval`` on the mesh (rank 1 made the same
    ``run_timed_eager``): the one-device server's nodes, shapes and no
    error."""
    got, _, bodies = mesh_server
    status, raw, _ = got["debug_eval"]
    assert status == 200
    res = json.loads(raw)
    want = one_device_app.debug_eval(bodies["single"])
    assert res["errors"] == want["errors"] == {}
    assert res["output_shapes"] == want["output_shapes"]
    assert sorted(res["timings_ms"]) == sorted(want["timings_ms"])


def test_mesh_server_node_error_then_serves_on(mesh_server, one_device_app):
    """A graph whose node 5 fails answers 400 with the one-device server's
    attributed text (every rank raised it), and the next request is served
    (rank 1 took the next call)."""
    got, _, bodies = mesh_server
    status, raw, _ = got["bad"]
    assert status == 400
    with pytest.raises(texec.NodeError) as err:
        one_device_app.compute(bodies["bad"])
    assert raw.decode() == str(err.value)
    assert raw.decode().startswith("node 5 (vit_t16:blocks.3): ")
    status, raw, _ = got["after"]
    assert status == 200
    obj, tensors = _decode(raw)
    wobj, wtensors = _decode(one_device_app.compute(bodies["after"]))
    assert obj == wobj
    for a, b in zip(tensors, wtensors):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_mesh_server_health_and_metrics_name_the_mesh(mesh_server,
                                                      one_device_app):
    """``/health`` and ``/metrics`` keep the one-device fields and add the
    mesh's shape (None off a mesh)."""
    got, _, _ = mesh_server
    status, health = got["health"]
    assert status == 200 and health["ok"] is True
    assert health["mesh"] == {"data": 2, "model": 1}
    assert set(one_device_app.health()) <= set(health)
    status, metrics = got["metrics"]
    assert status == 200 and metrics["mesh"] == {"data": 2, "model": 1}
    assert one_device_app.health()["mesh"] is None


def test_mesh_server_fails_fast_without_its_follower(tmp_path):
    """Rank 1 gone (exited after the build, no stop): rank 0 answers each
    request with an error naming the lost follower instead of waiting on
    it, ``/health`` says 503, and rank 0 stops cleanly."""
    bodies = {"single": _body(1), "after": _body(2)}
    with open(tmp_path / "req.pkl", "wb") as f:
        pickle.dump(bodies, f)
    _wait(_spawn(SERVER, 2, [str(tmp_path / "rdzv"),
                             str(tmp_path / "req.pkl"),
                             str(tmp_path / "out.pkl"), "lost"]))
    with open(tmp_path / "out.pkl", "rb") as f:
        got = pickle.load(f)
    for key in ("single", "after"):
        status, raw, _ = got[key]
        assert status == 400 and b"mesh follower lost" in raw, raw[:300]
    status, health = got["health"]
    assert status == 503 and health["ok"] is False
    assert "mesh follower lost" in health["error"]


# -- the --mesh refusals ------------------------------------------------------------------


def test_mesh_spec_refusals(tmp_path, monkeypatch):
    """``--mesh`` refuses, each with its message: no torchrun launch (no
    process group), a spec whose product is not the ranks launched, a
    spec outside the grammar, and a ``cuda`` device without a card; none
    falls back to one device."""
    import torch.distributed as dist

    from interactive_vit_tpu_torch.serving.server import (
        build_app, make_serving_mesh,
    )

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="launch the server under "
                                           "torchrun"):
        make_serving_mesh("data=1", "cpu")
    with pytest.raises(ValueError, match="expected 'data=all' or"):
        make_serving_mesh("data=two", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_app(models=("vit_t16",), mesh_spec="data=1")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks, but 1 were "
                                             "launched"):
            make_serving_mesh("data=2", "cpu")
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_serving_mesh("data=2,model=2", "cpu")
        mesh, dev = make_serving_mesh("data=all", "cpu")
        assert dev.type == "cpu"
        assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == {
            "data": 1, "model": 1}
    finally:
        dist.destroy_process_group()
