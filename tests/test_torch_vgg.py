"""The port's VGG16 (``models/vgg.py``, ``vgg_plugin.py``) against the JAX
package on the CPU.

VGG16's 138 M parameters are drawn once for the module by JAX's
``vgg.init_params(jax.random.key(11))``, the draw that
``tests/fixtures/vgg16_golden.npz`` pins, and carried across
(``weights.from_jax``). The golden logits on its 64 x 64 input (which
takes ``adaptive_avgpool7``'s non-identity branch) within 1e-4; the
layers and chains against JAX's within 1e-4 in f32; in bf16 within 2^-4
of each output's largest value (both round at the same points, but a sum
that lands next to a bf16 boundary in one order rounds the other way in
the other, and the flip carries through the later layers). The node
surface is the repository's saved ``static/graphs/vgg16.json``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.executor import Executor as JExecutor
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import vgg as jvgg
from interactive_vit_tpu.models.vgg_plugin import (
    make_vgg16_model as jmake_vgg16,
)
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph.executor import Executor
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import vgg
from interactive_vit_tpu_torch.models.vgg_plugin import make_vgg16_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.wire import schema
from interactive_vit_tpu_torch.wire.schema import generate_model_graph_json

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
ATOL = 1e-4
BF16_REL = 2.0 ** -4


@pytest.fixture(scope="module")
def params():
    """(JAX's params as numpy, the port's tensors), drawn once."""
    jp = jax.tree.map(np.asarray, jvgg.init_params(jax.random.key(11)))
    return jp, from_jax(jp)


@pytest.fixture(scope="module")
def regs(params):
    jp, tp = params
    reg, jreg = Registry(), JRegistry()
    register_builtin(reg)
    jbuiltin(jreg)
    make_vgg16_model(params=tp, device="cpu").register(reg)
    jmake_vgg16(params=jax.tree.map(jnp.asarray, jp)).register(jreg)
    return reg, jreg


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               atol=atol, rtol=0)


def test_golden_logits(params):
    _, tp = params
    golden = np.load(os.path.join(ROOT, "fixtures", "vgg16_golden.npz"))
    with torch.inference_mode():
        got = vgg.forward(tp, torch.from_numpy(golden["input"]))
        one = vgg.forward(tp, torch.from_numpy(golden["input"][1]))
    assert got.shape == (2, 1000) and one.shape == (1000,)
    _close(got.numpy(), golden["logits"])
    _close(one.numpy(), golden["logits"][1])  # unbatched, as the reference


@pytest.mark.parametrize("shape", [(2, 8, 5, 9), (8, 14, 14), (1, 3, 7, 7),
                                   (1, 4, 3, 2)])
def test_pools_match_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    _close(vgg.adaptive_avgpool7(torch.from_numpy(x)).numpy(),
           jvgg.adaptive_avgpool7(jnp.asarray(x)), 1e-6)
    if shape[-1] >= 2 and shape[-2] >= 2:
        np.testing.assert_array_equal(
            vgg.maxpool2(torch.from_numpy(x)).numpy(),
            np.asarray(jvgg.maxpool2(jnp.asarray(x))))
    np.testing.assert_array_equal(vgg.flatten(torch.from_numpy(x)).numpy(),
                                  np.asarray(jvgg.flatten(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
def test_conv2d_matches_jax(dtype, batched):
    """The bias is added after the cast, in x's dtype: in bf16 every
    element equal to JAX's but where a one-ulp flip of the f32 sum's
    rounding moves it (a share of the elements, one ulp each)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 9, 11) if batched else (16, 9, 11))
    w = rng.standard_normal((24, 16, 3, 3)) * 0.1
    b = rng.standard_normal(24)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jvgg.conv2d(jnp.asarray(x, jnp.float32),
                                  jnp.asarray(w, jd), jnp.asarray(b, jd)
                                  ).astype(jnp.float32))
    got = vgg.conv2d(torch.tensor(x, dtype=torch.float32),
                     torch.tensor(w, dtype=td), torch.tensor(b, dtype=td))
    assert got.dtype == td and got.shape == want.shape
    got = got.float().numpy()
    if dtype == "float32":
        _close(got, want, 1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
        assert (np.abs(got - want) <= ulp * 1.01).all()
        assert np.mean(got != want) < 0.05


def test_node_surface_is_the_saved_graph(regs):
    """The repository's saved vgg16.json (41 layer nodes and a category
    sink): every endpoint registered, in the model's layer order, and the
    model's generated graph is JAX's."""
    reg, jreg = regs
    with open(os.path.join(os.path.dirname(ROOT), "static", "graphs",
                           "vgg16.json")) as f:
        obj = json.load(f)
    endpoints = [n["instance"]["endpoint"] for n in obj["nodes"]
                 if n["instance"]["kind"] == "net_node"]
    assert len(endpoints) == 41 and len(obj["nodes"]) == 42
    model = reg.get_node("vgg16:transform").model
    jmodel = jreg.get_node("vgg16:transform").model
    assert endpoints == model.list_node_names() == jmodel.list_node_names()
    assert model.generate_graph_json() == jmodel.generate_graph_json()
    assert model.category_names == jmodel.category_names
    assert len(model.category_names) == 1000
    for name in endpoints:
        assert reg.get_node(name).io({}) == jreg.get_node(name).io({})
        assert reg.get_node(name).contents({}) == \
            jreg.get_node(name).contents({})


def test_saved_graph_runs_like_jax(regs):
    """The saved graph, an unbatched 3 x 64 x 64 image as the reference
    sent it: the transform (to 224), features.0, features.30, flatten and
    the logits within 1e-4 of the JAX executor's."""
    reg, jreg = regs
    with open(os.path.join(os.path.dirname(ROOT), "static", "graphs",
                           "vgg16.json")) as f:
        obj = json.load(f)
    image = np.random.default_rng(0).random((3, 64, 64), dtype=np.float32)
    taps = {(0, "o"), (1, "o"), (31, "o"), (33, "o"), (40, "o")}
    out = {}
    for name, mod, ex in (("port", schema, Executor(reg, device="cpu")),
                          ("jax", jschema, JExecutor(jreg))):
        g = mod.graph_from_json(obj)
        g.add_input(image, g.nodes[0], "o")
        out[name] = ex.run(g, taps=taps)
    assert out["port"][40]["o"].shape == (1000,)
    assert out["port"][33]["o"].shape == (25088,)
    for i, ch in taps:
        _close(out["port"][i][ch], out["jax"][i][ch])


def _features_graph(mod, image):
    """The chain from features.0 (no transform): a small image stays
    cheap, and its 1 x 1 map takes the adaptive pool's other branch."""
    names = [n for n, _, _ in vgg.layer_fns()][1:]
    g = mod.graph_from_json(generate_model_graph_json(
        [f"vgg16:{n}" for n in names]))
    g.add_input(image, g.nodes[0], "o")
    return g


@pytest.mark.parametrize("batched", [False, True])
def test_stacked_group_matches_single_runs(regs, batched):
    """Two requests as one stacked pass, each row its own run's: an
    unbatched request stays unbatched through the chain (each layer's
    ``image_entry`` rank), a batched one keeps its batch."""
    reg, _ = regs
    ex = Executor(reg, device="cpu")
    shape = (2, 3, 32, 32) if batched else (3, 32, 32)
    images = np.random.default_rng(3).random((2, *shape), dtype=np.float32)
    taps = {(0, "o"), (30, "o"), (32, "o"), (39, "o")}
    group = ex.run_stacked([_features_graph(schema, im) for im in images],
                           taps)
    for im, res in zip(images, group):
        single = ex.run(_features_graph(schema, im), taps)
        for i, ch in taps:
            np.testing.assert_array_equal(res[i][ch].shape,
                                          single[i][ch].shape)
            np.testing.assert_allclose(res[i][ch], single[i][ch],
                                       atol=1e-5, rtol=0)
    assert group[0][39]["o"].shape == ((2, 1000) if batched else (1000,))


def test_bf16_features_match_jax_within_bound(params):
    """bf16 weights and activations through the convolutions and pools
    (the classifier's bf16 GEMMs are ``layers.linear``'s, held elsewhere)
    against JAX's, each layer's output within 2^-4 of its largest
    value."""
    jp, _ = params
    feats = {"features": jp["features"], "classifier": {}}
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), feats)
    tb = from_jax(feats, dtype=torch.bfloat16)
    x = np.random.default_rng(4).random((1, 3, 32, 32), dtype=np.float32)
    env_j, env_t = {"o": jnp.asarray(x)}, {"o": torch.from_numpy(x)}
    for (name, _, jfn), (_, _, tfn) in zip(jvgg.layer_fns()[1:33],
                                           vgg.layer_fns()[1:33]):
        env_j = jfn(jvgg.layer_params(bf, name), env_j)
        env_t = tfn(vgg.layer_params(tb, name), env_t)
        want = np.asarray(env_j["o"].astype(jnp.float32))
        got = env_t["o"].float().numpy()
        assert env_t["o"].dtype == torch.bfloat16, name
        scale = max(float(np.abs(want).max()), 1e-6)
        assert np.abs(got - want).max() <= BF16_REL * scale, name


def test_from_torchvision_matches_jax_converter(params):
    """A torchvision-named state dict built here from the drawn weights
    converts to the JAX converter's tree."""
    jp, _ = params
    sd = {}
    for idx, p in jp["features"].items():
        sd[f"features.{idx}.weight"] = p["w"]
        sd[f"features.{idx}.bias"] = p["b"]
    for idx, p in jp["classifier"].items():
        sd[f"classifier.{idx}.weight"] = p["w"].T
        sd[f"classifier.{idx}.bias"] = p["b"]
    want = jvgg.from_torchvision(sd)
    got = vgg.from_torchvision(sd)
    for part in ("features", "classifier"):
        assert sorted(got[part]) == sorted(want[part])
        for idx, p in want[part].items():
            for k in ("w", "b"):
                np.testing.assert_array_equal(got[part][idx][k].numpy(),
                                              np.asarray(p[k]))


def test_init_params_layout_and_scales():
    """The port's own draw: JAX's layout and He scales."""
    tp = vgg.init_params(torch.Generator().manual_seed(0))
    assert sorted(tp["features"], key=int) == [
        "0", "2", "5", "7", "10", "12", "14", "17", "19", "21", "24", "26",
        "28"]
    assert tp["features"]["0"]["w"].shape == (64, 3, 3, 3)
    assert tp["classifier"]["0"]["w"].shape == (25088, 4096)
    std = float(tp["features"]["28"]["w"].std())
    assert abs(std - (2.0 / (512 * 9)) ** 0.5) < 1e-3
    assert float(tp["classifier"]["6"]["b"].abs().max()) == 0.0


def test_saved_graph_runs_through_run_graph(tmp_path):
    """``vgg16.json`` unchanged through the headless runner on the CPU,
    its own seeded weights: the 1000 logits of the unbatched image."""
    from interactive_vit_tpu_torch.tools.run_graph import main

    np.save(tmp_path / "x.npy", np.random.default_rng(0).random(
        (3, 64, 64), dtype=np.float32))
    assert main(["vgg16", "--device", "cpu", "--image",
                 str(tmp_path / "x.npy"), "--out", str(tmp_path)]) == 0
    with open(tmp_path / "manifest.json") as f:
        manifest = json.load(f)
    stem = next(k for k, m in manifest.items()
                if m["name"] == "vgg16:classifier.6")
    logits = np.load(tmp_path / (stem + ".npy"))
    assert logits.shape == (1000,) and np.isfinite(logits).all()
