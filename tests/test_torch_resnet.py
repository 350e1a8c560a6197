"""The port's ResNet-50 (``models/resnet.py``) against the JAX package.

torchvision is absent, so a torch module with torchvision's structure and
state-dict names (as ``tests/test_resnet.py`` builds it) is the oracle:
its state dict, with randomized batch-norm statistics, goes through the
port's and JAX's ``from_torchvision``. ResNet-50's widths are fixed, so
it runs at a 64 px image. Tolerances: per-layer modules within 1e-5 of
the JAX function, the logits within 1e-4 (f32); bf16 within its stated
bound.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import resnet as jresnet
from interactive_vit_tpu.models.resnet_plugin import (
    make_resnet50_model as jmake,
)
from interactive_vit_tpu.models.weights import to_native_flat as jto_native
from interactive_vit_tpu_torch.models import resnet
from interactive_vit_tpu_torch.models.resnet_plugin import (
    make_resnet50_model,
)
from interactive_vit_tpu_torch.models.weights import (
    from_jax, from_native_flat, to_native_flat,
)

torch.set_num_threads(2)

IMG = 64


class TorchBottleneck(nn.Module):
    def __init__(self, cin, width, stride):
        super().__init__()
        cout = width * 4
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU()
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + idn)


class TorchResNet50(nn.Module):
    """torchvision's structure and state-dict names."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for si, (blocks, width) in enumerate(resnet.STAGES):
            seq = []
            for bi in range(blocks):
                seq.append(TorchBottleneck(cin, width,
                                           2 if (si > 0 and bi == 0) else 1))
                cin = width * 4
            setattr(self, f"layer{si + 1}", nn.Sequential(*seq))
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(cin, 1000)

    @torch.no_grad()
    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return self.fc(self.avgpool(x).flatten(1))


def oracle_state_dict(seed=0):
    """The oracle's state dict (numpy), batch-norm statistics randomized
    so that folding them is exercised, and the oracle."""
    torch.manual_seed(seed)
    tm = TorchResNet50()
    for m in tm.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.uniform_(-0.5, 0.5)
            m.running_var.uniform_(0.5, 2.0)
            m.weight.data.uniform_(0.5, 1.5)
            m.bias.data.uniform_(-0.3, 0.3)
    tm.eval()
    return {k: v.numpy() for k, v in tm.state_dict().items()}, tm


@pytest.fixture(scope="module")
def oracle():
    sd, tm = oracle_state_dict()
    x = np.random.default_rng(0).random((2, 3, IMG, IMG), np.float32)
    return sd, x, tm(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def params(oracle):
    """(port tree, JAX tree) from the oracle's state dict."""
    return resnet.from_torchvision(oracle[0]), jresnet.from_torchvision(
        oracle[0])


def _np(t):
    return t.detach().float().numpy()


def test_logits_match_jax_and_the_oracle(oracle, params):
    sd, x, ref = oracle
    tp, jp = params
    got = _np(resnet.forward(tp, torch.from_numpy(x)))
    want = np.asarray(jresnet.forward(jp, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_from_torchvision_is_jax_converter(params):
    tp, jp = params
    want = from_jax(jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.is_contiguous()
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-7, rtol=0)
    assert jax.tree.structure(tp) == jax.tree.structure(want)


def test_missing_key_raises(oracle):
    sd = dict(oracle[0])
    del sd["layer3.2.bn2.running_var"]
    with pytest.raises(KeyError, match="layer3.2.bn2.running_var"):
        resnet.from_torchvision(sd)


# the block kinds of each stage: (stage, block) -> (input shape, stride)
BLOCKS = {"layer1.0": (64, 16), "layer1.1": (256, 16),
          "layer2.0": (256, 16), "layer3.1": (1024, 4),
          "layer4.0": (1024, 4)}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_bottleneck_matches_jax(params, name):
    """Each kind of block (downsample at stride 1 and 2, identity) within
    1e-5 of the JAX function, through the layer fns of both packages."""
    tp, jp = params
    cin, hw = BLOCKS[name]
    x = np.random.default_rng(1).standard_normal((2, cin, hw, hw),
                                                 np.float32)
    tfn = dict((n, f) for n, _, f in resnet.layer_fns())[name]
    jfn = dict((n, f) for n, _, f in jresnet.layer_fns())[name]
    got = _np(tfn(resnet.layer_params(tp, name),
                  {"o": torch.from_numpy(x)})["o"])
    want = np.asarray(jfn(jresnet.layer_params(jp, name),
                          {"o": jnp.asarray(x)})["o"])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [8, 9])
@pytest.mark.parametrize("stride", [1, 2])
def test_one_by_one_same_padding_pads_nothing(hw, stride):
    """The JAX 1 x 1 convolutions' "SAME" is the port's unpadded conv, at
    stride 2 on even and odd grids too."""
    rng = np.random.default_rng(hw * stride)
    x = rng.standard_normal((1, 8, hw, hw), np.float32)
    w = rng.standard_normal((16, 8, 1, 1), np.float32)
    got = _np(resnet.conv(torch.from_numpy(x), torch.from_numpy(w), stride))
    want = np.asarray(jresnet.conv(jnp.asarray(x), jnp.asarray(w), stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["conv1", "maxpool", "avgpool", "fc"])
def test_edge_layers_match_jax_unbatched(params, name):
    """The stem, pools and classifier on an unbatched input (an image or
    feature map of rank 3, the features of rank 1), as the JAX fns."""
    tp, jp = params
    shape = {"conv1": (3, 33, 30), "maxpool": (64, 17, 16),
             "avgpool": (2048, 3, 2), "fc": (2048,)}[name]
    x = np.random.default_rng(2).standard_normal(shape, np.float32)
    tfn = dict((n, f) for n, _, f in resnet.layer_fns())[name]
    jfn = dict((n, f) for n, _, f in jresnet.layer_fns())[name]
    got = _np(tfn(resnet.layer_params(tp, name) or {},
                  {"o": torch.from_numpy(x)})["o"])
    want = np.asarray(jfn(jresnet.layer_params(jp, name),
                          {"o": jnp.asarray(x)})["o"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_bf16_logits_within_bound(oracle, params):
    """bf16 weights and activations against JAX in bf16: within 4 % of the
    logits' range (bf16 keeps 8 bits, rounded at every cast point of 50
    layers)."""
    x = oracle[1]
    tp, jp = params
    tb = jax.tree.map(lambda t: t.to(torch.bfloat16), tp)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    got = _np(resnet.forward(tb, torch.from_numpy(x)))
    want = np.asarray(jresnet.forward(jb, jnp.asarray(x)), np.float32)
    ref = np.asarray(jresnet.forward(jp, jnp.asarray(x)))
    bound = 0.04 * float(np.ptp(ref))
    assert np.abs(got - want).max() <= bound
    assert np.abs(got - ref).max() <= bound


def test_native_names_round_trip(params):
    """The JAX package's native "/" names of the tree load in the port and
    flatten back to the same names and values."""
    _, jp = params
    flat = jto_native(jp)
    tp = from_native_flat(flat)
    back = to_native_flat(tp)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))


def test_node_surface_is_jax_s():
    """21 layers with the JAX plugin's names and descriptions, seeded on
    the CPU with He-scaled convs and identity batch norms."""
    tm = make_resnet50_model(device="cpu", seed=1)
    jm = jmake(params=jresnet.from_torchvision(oracle_state_dict()[0]))
    assert tm.list_node_names() == jm.list_node_names()
    assert len(tm.layers) == 21
    for name, _, _ in tm.layers:
        assert tm.describe(name) == jm.describe(name)
    assert tm.generate_graph_json() == jm.generate_graph_json()
    w = tm.params["layers"][2][0]["conv2_w"]
    assert w.shape == (256, 256, 3, 3)
    assert abs(float(w.std()) - (2.0 / (256 * 9)) ** 0.5) < 2e-3
    assert torch.equal(tm.params["layers"][0][0]["bn3"]["s"],
                       torch.ones(256))
