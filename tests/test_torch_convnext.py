"""The port's ConvNeXt (``models/convnext.py``) against the JAX package.

A narrow config (dims 8-32, one to two blocks a stage, 32 px) in both
packages; torchvision is absent, so a torch module with torchvision's
structure and state-dict names (as ``tests/test_convnext.py`` builds it,
every parameter randomized) is the oracle of both ``from_torchvision``
converters. Tolerances: per-layer modules within 1e-5 of the JAX
functions, the logits within 1e-4 (f32); bf16 within its stated bound;
stage taps NHWC as JAX's.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import convnext as jconvnext
from interactive_vit_tpu.models.convnext_plugin import (
    make_convnext_model as jmake,
)
from interactive_vit_tpu.models.weights import to_native_flat as jto_native
from interactive_vit_tpu_torch.models import convnext
from interactive_vit_tpu_torch.models.convnext_plugin import (
    make_convnext_model,
)
from interactive_vit_tpu_torch.models.weights import (
    from_jax, from_native_flat, to_native_flat,
)

torch.set_num_threads(2)

NARROW = dict(depths=(1, 2, 1, 1), dims=(8, 16, 24, 32), num_classes=10,
              img_size=32, resize_to=34)
CFG = convnext.ConvNeXtConfig("convnext_micro", **NARROW)
JCFG = jconvnext.ConvNeXtConfig("convnext_micro", **NARROW)


class LayerNorm2d(nn.LayerNorm):
    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Permute(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.dims = dims

    def forward(self, x):
        return x.permute(self.dims)


class CNBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, 7, padding=3, groups=dim, bias=True),
            Permute([0, 2, 3, 1]), nn.LayerNorm(dim, eps=1e-6),
            nn.Linear(dim, 4 * dim), nn.GELU(), nn.Linear(4 * dim, dim),
            Permute([0, 3, 1, 2]))
        self.layer_scale = nn.Parameter(torch.ones(dim, 1, 1) * 1e-6)

    def forward(self, x):
        return x + self.layer_scale * self.block(x)


class TorchConvNeXt(nn.Module):
    """torchvision's structure and state-dict names."""

    def __init__(self, cfg):
        super().__init__()
        dims = cfg.dims
        layers = [nn.Sequential(nn.Conv2d(3, dims[0], 4, stride=4),
                                LayerNorm2d(dims[0], eps=1e-6))]
        for s, depth in enumerate(cfg.depths):
            layers.append(nn.Sequential(*[CNBlock(dims[s])
                                          for _ in range(depth)]))
            if s + 1 < len(cfg.depths):
                layers.append(nn.Sequential(
                    LayerNorm2d(dims[s], eps=1e-6),
                    nn.Conv2d(dims[s], dims[s + 1], 2, stride=2)))
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.classifier = nn.Sequential(
            LayerNorm2d(dims[-1], eps=1e-6), nn.Flatten(1),
            nn.Linear(dims[-1], cfg.num_classes))

    def forward(self, x):
        return self.classifier(self.avgpool(self.features(x)))


def oracle_state_dict(cfg, seed=0):
    """The oracle (every parameter randomized, so a transposed or missed
    leaf cannot hide behind a default) and its numpy state dict."""
    torch.manual_seed(seed)
    model = TorchConvNeXt(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p) * 0.2)
    return {k: v.numpy() for k, v in model.state_dict().items()}, model


@pytest.fixture(scope="module")
def oracle():
    sd, model = oracle_state_dict(CFG)
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 32), np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    return sd, x, ref


@pytest.fixture(scope="module")
def params(oracle):
    return (convnext.from_torchvision(oracle[0], CFG),
            jconvnext.from_torchvision(oracle[0], JCFG))


def _np(t):
    return t.detach().float().numpy()


def test_logits_match_jax_and_the_oracle(oracle, params):
    sd, x, ref = oracle
    tp, jp = params
    got = _np(convnext.forward(tp, torch.from_numpy(x), CFG))
    want = np.asarray(jconvnext.forward(jp, jnp.asarray(x), JCFG))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_from_torchvision_is_jax_converter(params):
    """HWIO kernels (the depthwise [7, 7, 1, C]), f32 LNs and gammas: the
    JAX converter's tree leaf for leaf, each C-contiguous."""
    tp, jp = params
    want = from_jax(jax.tree.map(np.asarray, jp))
    assert jax.tree.structure(tp) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.is_contiguous()
        np.testing.assert_array_equal(_np(a), _np(b))
    assert tp["stages"][1][1]["dw_w"].shape == (7, 7, 1, 16)
    assert tp["downs"][2]["w"].shape == (2, 2, 24, 32)


def test_missing_key_raises(oracle):
    sd = dict(oracle[0])
    del sd["features.3.1.layer_scale"]
    with pytest.raises(KeyError, match="features.3.1.layer_scale"):
        convnext.from_torchvision(sd, CFG)


LAYERS = {"stem": (3, 32, 32), "stages.1.1": (4, 4, 16),
          "downsample.2": (4, 4, 16), "stages.3.0": (1, 1, 32),
          "avgpool": (2, 2, 32), "head": (32,)}


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layers_match_jax(params, name, batched):
    """Each kind of layer on a batched or unbatched input (NHWC feature
    maps, the pooled features), through both packages' layer fns, within
    1e-5."""
    tp, jp = params
    shape = ((2,) if batched else ()) + LAYERS[name]
    x = np.random.default_rng(3).standard_normal(shape, np.float32)
    tfn = dict((n, f) for n, _, f in convnext.layer_fns(CFG))[name]
    jfn = dict((n, f) for n, _, f in jconvnext.layer_fns(JCFG))[name]
    got = _np(tfn(convnext.layer_params(tp, name) or {},
                  {"o": torch.from_numpy(x)})["o"])
    want = np.asarray(jfn(jconvnext.layer_params(jp, name),
                          {"o": jnp.asarray(x)})["o"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_stage_taps_are_nhwc():
    model = make_convnext_model(cfg=CFG, device="cpu")
    env = {"o": torch.rand(1, 3, 40, 44)}
    shapes = {}
    for name, _, fn in model.layers:
        env = fn(model.layer_params(name) or {}, env)
        shapes[name] = tuple(env["o"].shape)
    assert shapes["transform"] == (1, 3, 32, 32)
    assert shapes["stem"] == (1, 8, 8, 8)
    assert shapes["stages.2.0"] == (1, 2, 2, 24)
    assert shapes["avgpool"] == (1, 32) and shapes["head"] == (1, 10)


def test_bf16_logits_within_bound(oracle, params):
    """bf16 against JAX in bf16 and against f32: within 4 % of the f32
    logits' range."""
    x = oracle[1]
    tp, jp = params
    tb = jax.tree.map(lambda t: t.to(torch.bfloat16), tp)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    got = _np(convnext.forward(tb, torch.from_numpy(x), CFG))
    want = np.asarray(jconvnext.forward(jb, jnp.asarray(x), JCFG),
                      np.float32)
    ref = np.asarray(jconvnext.forward(jp, jnp.asarray(x), JCFG))
    bound = 0.04 * float(np.ptp(ref))
    assert np.abs(got - want).max() <= bound
    assert np.abs(got - ref).max() <= bound


def test_native_names_round_trip(params):
    _, jp = params
    flat = jto_native(jp)
    back = to_native_flat(from_native_flat(flat))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))


@pytest.mark.parametrize("variant", ["convnext_t", "convnext_s",
                                     "convnext_b"])
def test_variants_and_node_surface_are_jax_s(variant):
    """The variant table is JAX's; the node names, descriptions and the
    generated graph equal the JAX plugin's (25 nodes for convnext_t)."""
    tcfg, jcfg = convnext.VARIANTS[variant], jconvnext.VARIANTS[variant]
    assert (tcfg.depths, tcfg.dims, tcfg.resize_to, tcfg.img_size) == (
        jcfg.depths, jcfg.dims, jcfg.resize_to, jcfg.img_size)
    tlayers = [n for n, _, _ in convnext.layer_fns(tcfg)]
    assert tlayers == [n for n, _, _ in jconvnext.layer_fns(jcfg)]
    if variant == "convnext_t":
        assert len(tlayers) == 25


def test_plugin_descriptions_and_graph_are_jax_s(params):
    tm = make_convnext_model(cfg=CFG, device="cpu")
    jm = jmake(cfg=JCFG, params=params[1])
    assert tm.list_node_names() == jm.list_node_names()
    for name, _, _ in tm.layers:
        assert tm.describe(name) == jm.describe(name)
    assert tm.generate_graph_json() == jm.generate_graph_json()
    w = tm.params["stages"][0][0]["fc1"]["w"]
    assert float(w.abs().max()) <= 0.04 and abs(float(w.std()) - 0.0176) \
        < 3e-3
    assert torch.equal(tm.params["stages"][0][0]["gamma"],
                       torch.full((8,), 1e-6))
