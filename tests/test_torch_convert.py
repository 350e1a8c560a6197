"""The port's checkpoint converter (``tools/convert.py``) against the JAX
package's on the CPU.

``convert(model, layout, sd)`` gives the JAX converter's tree (f32, bit
for bit) for every model of ``VALID_LAYOUTS`` that the port serves, in each
of its layouts and under "auto"; the sniffing picks the same layouts; a
wrong layout raises JAX's message; the families the port lacks raise.
Swin and the CLIP towers convert at small configs put in place of their
published ones in both packages; VGG16 at its own size. ``load_state_dict``
reads ``.safetensors``, ``.pth`` (a bare state dict, a wrapped one) and
TorchScript archives as JAX's does, and ``main`` writes a
checkpoint directory that loads back to ``convert``'s tree.
"""

import os

import numpy as np
import pytest
import torch

import jax

from interactive_vit_tpu.models import clip as jclip
from interactive_vit_tpu.models import clip_text as jtext
from interactive_vit_tpu.models import swin as jswin
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models import weights as jweights
from interactive_vit_tpu.tools import convert as jconvert
from interactive_vit_tpu_torch.models import clip as tclip
from interactive_vit_tpu_torch.models import clip_text as ttext
from interactive_vit_tpu_torch.models import swin as tswin
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models import weights as tweights
from interactive_vit_tpu_torch.tools import convert as tconvert
from interactive_vit_tpu_torch.utils.checkpoint import load_params

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
VIT = dict(img_size=32, patch=16, width=64, depth=2, heads=4,
           num_classes=10)
SWIN = dict(img_size=32, patch=4, embed_dim=16, depths=(2, 2),
            heads=(2, 4), window=4, num_classes=10)
CLIP = dict(name="clip_small", img_size=64, patch=32, width=128, depth=2,
            heads=2, embed_dim=32)
TEXT = dict(name="clip_text_small", vocab_size=600, width=64, depth=2,
            heads=2, embed_dim=32)
CLIP_CFG = tclip.CLIPVisionConfig(**CLIP)
TEXT_CFG = ttext.CLIPTextConfig(**TEXT)


def _flat(tree):
    """{keystr: numpy} of a JAX tree or the port's (tensors)."""
    tree = jax.tree.map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
        tree)
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same(got, want):
    # the kernels take contiguous weights only
    assert all(t.is_contiguous() for t in jax.tree.leaves(got)
               if isinstance(t, torch.Tensor))
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k, v in w.items():
        assert g[k].dtype == np.float32 and g[k].shape == v.shape, k
        assert g[k].tobytes() == v.astype(np.float32).tobytes(), k
    # empty containers too (a headless tree's {} head)
    assert (jax.tree.structure(jax.tree.map(lambda _: 0, got))
            == jax.tree.structure(jax.tree.map(lambda _: 0, want)))


@pytest.fixture
def small_models(monkeypatch):
    """Small configs in place of the published ones, in both packages."""
    monkeypatch.setitem(jvit.VARIANTS, "vit_small_cv", jvit.ViTConfig(
        "vit_small_cv", **VIT))
    monkeypatch.setitem(tvit.VARIANTS, "vit_small_cv", tvit.ViTConfig(
        "vit_small_cv", **VIT))
    for name in ("swin_t", "swin_s", "swin_b"):
        monkeypatch.setitem(jswin.VARIANTS, name,
                            jswin.SwinConfig(name, **SWIN))
        monkeypatch.setitem(tswin.VARIANTS, name,
                            tswin.SwinConfig(name, **SWIN))
    monkeypatch.setattr(jclip, "CLIPVisionConfig",
                        lambda c=jclip.CLIPVisionConfig: c(**CLIP))
    monkeypatch.setattr(tclip, "CLIPVisionConfig",
                        lambda c=tclip.CLIPVisionConfig: c(**CLIP))
    monkeypatch.setattr(jtext, "CLIPTextConfig",
                        lambda c=jtext.CLIPTextConfig: c(**TEXT))
    monkeypatch.setattr(ttext, "CLIPTextConfig",
                        lambda c=ttext.CLIPTextConfig: c(**TEXT))


def _resblocks(rng, sd, prefix, depth, d):
    for i in range(depth):
        pre = f"{prefix}transformer.resblocks.{i}."
        for name, shape in (("ln_1.weight", (d,)), ("ln_1.bias", (d,)),
                            ("attn.in_proj_weight", (3 * d, d)),
                            ("attn.in_proj_bias", (3 * d,)),
                            ("attn.out_proj.weight", (d, d)),
                            ("attn.out_proj.bias", (d,)),
                            ("ln_2.weight", (d,)), ("ln_2.bias", (d,)),
                            ("mlp.c_fc.weight", (4 * d, d)),
                            ("mlp.c_fc.bias", (4 * d,)),
                            ("mlp.c_proj.weight", (d, 4 * d)),
                            ("mlp.c_proj.bias", (d,))):
            sd[pre + name] = rng.standard_normal(shape)


def _state_dict(model):
    """A state dict in ``model``'s torch naming (numpy f32), at the small
    configs of ``small_models``."""
    rng = np.random.default_rng(7)
    if model == "vit_small_cv":
        return tconvert.load_state_dict(
            os.path.join(FIXTURES, "vit_golden_tv.safetensors"))
    if model.startswith("swin_"):
        cfg = tswin.SwinConfig(model, **SWIN)
        tp = tswin.init_params(cfg, torch.Generator().manual_seed(1))
        sd = {"features.0.0.weight": tp["patch_embed"]["w"].numpy().T.reshape(
                  cfg.embed_dim, 3, cfg.patch, cfg.patch),
              "features.0.0.bias": tp["patch_embed"]["b"].numpy(),
              "features.0.2.weight": tp["patch_embed"]["ln_s"].numpy(),
              "features.0.2.bias": tp["patch_embed"]["ln_b"].numpy(),
              "norm.weight": tp["norm"]["s"].numpy(),
              "norm.bias": tp["norm"]["b"].numpy(),
              "head.weight": tp["head"]["w"].numpy().T,
              "head.bias": tp["head"]["b"].numpy()}
        names = {"ln1_s": "norm1.weight", "ln1_b": "norm1.bias",
                 "qkv_w": "attn.qkv.weight", "qkv_b": "attn.qkv.bias",
                 "bias_table": "attn.relative_position_bias_table",
                 "proj_w": "attn.proj.weight", "proj_b": "attn.proj.bias",
                 "ln2_s": "norm2.weight", "ln2_b": "norm2.bias",
                 "fc1_w": "mlp.0.weight", "fc1_b": "mlp.0.bias",
                 "fc2_w": "mlp.3.weight", "fc2_b": "mlp.3.bias"}
        for s, blocks in enumerate(tp["stages"]):
            for b, blk in enumerate(blocks):
                for ours, tv in names.items():
                    v = blk[ours].numpy()
                    sd[f"features.{2 * s + 1}.{b}.{tv}"] = (
                        v.T if ours.endswith("_w") else v)
        for s, m in enumerate(tp["merges"]):
            sd[f"features.{2 * s + 2}.norm.weight"] = m["ln_s"].numpy()
            sd[f"features.{2 * s + 2}.norm.bias"] = m["ln_b"].numpy()
            sd[f"features.{2 * s + 2}.reduction.weight"] = m["w"].numpy().T
        return sd
    sd = {}
    if model == "clip_b32":
        cfg = CLIP_CFG
        d, p = cfg.width, cfg.patch
        sd = {"visual.conv1.weight": rng.standard_normal((d, 3, p, p)),
              "visual.class_embedding": rng.standard_normal(d),
              "visual.positional_embedding": rng.standard_normal(
                  (cfg.tokens, d)),
              "visual.proj": rng.standard_normal((d, cfg.embed_dim))}
        for ln in ("ln_pre", "ln_post"):
            sd[f"visual.{ln}.weight"] = rng.standard_normal(d)
            sd[f"visual.{ln}.bias"] = rng.standard_normal(d)
        _resblocks(rng, sd, "visual.", cfg.depth, d)
    elif model == "clip_text_b32":
        cfg = TEXT_CFG
        d = cfg.width
        sd = {"token_embedding.weight": rng.standard_normal(
                  (cfg.vocab_size, d)),
              "positional_embedding": rng.standard_normal((cfg.context, d)),
              "ln_final.weight": rng.standard_normal(d),
              "ln_final.bias": rng.standard_normal(d),
              "text_projection": rng.standard_normal((d, cfg.embed_dim))}
        _resblocks(rng, sd, "", cfg.depth, d)
    elif model == "vgg16":
        from interactive_vit_tpu_torch.models import vgg

        cin = 3
        for idx, (kind, cout) in enumerate(vgg._FEATURES):
            if kind == "conv":
                sd[f"features.{idx}.weight"] = rng.standard_normal(
                    (cout, cin, 3, 3), dtype=np.float32)
                sd[f"features.{idx}.bias"] = rng.standard_normal(cout)
                cin = cout
        for idx, dims in enumerate(vgg._CLASSIFIER_DIMS):
            if dims is not None:
                sd[f"classifier.{idx}.weight"] = np.zeros(dims[::-1],
                                                          np.float32)
                sd[f"classifier.{idx}.bias"] = rng.standard_normal(dims[1])
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


CASES = [("vit_small_cv", "torchvision"), ("vit_small_cv", "auto"),
         ("vit_small_cv", "native"),
         ("swin_t", "torchvision"), ("swin_t", "native"),
         ("swin_s", "auto"), ("swin_b", "auto"),
         ("clip_b32", "openai"), ("clip_b32", "native"),
         ("clip_text_b32", "auto"), ("clip_text_b32", "native")]


@pytest.mark.parametrize("model,layout", CASES)
def test_convert_matches_jax(small_models, model, layout):
    sd = _state_dict(model)
    if layout == "native":
        # the models' own export naming: the JAX converter's tree,
        # flattened
        sd = jweights.to_native_flat(jax.tree.map(
            np.asarray, jconvert.convert(model, "auto", sd)))
    _assert_same(tconvert.convert(model, layout, sd),
                 jconvert.convert(model, layout, sd))


def test_convert_vgg16_matches_jax():
    """VGG16 at its own size (138 M parameters, a sparse draw)."""
    sd = _state_dict("vgg16")
    got, want = tconvert.convert("vgg16", "auto", sd), \
        jconvert.convert("vgg16", "auto", sd)
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert np.array_equal(g[k], w[k]), k


def test_convert_timm_and_geometry_match_jax(small_models, monkeypatch):
    """The timm fixture under "auto" (sniffed), and an @-geometry target
    (adapted after the conversion), as JAX converts them."""
    sd = tconvert.load_state_dict(
        os.path.join(FIXTURES, "vit_golden_timm.safetensors"))
    _assert_same(tconvert.convert("vit_small_cv", "auto", sd),
                 jconvert.convert("vit_small_cv", "auto", sd))
    tv = _state_dict("vit_small_cv")
    got = _flat(tconvert.convert("vit_small_cv@48", "torchvision", tv))
    want = _flat(jconvert.convert("vit_small_cv@48", "torchvision", tv))
    assert sorted(got) == sorted(want)
    assert got["['pos_emb']"].shape == (1, 10, 64)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)


def test_convert_puts_tensors_on_the_device_in_the_dtype(small_models):
    got = tconvert.convert("vit_small_cv", "auto",
                           _state_dict("vit_small_cv"),
                           dtype=torch.bfloat16, device="cpu")
    assert got["blocks"][0]["qkv_w"].dtype == torch.bfloat16
    headless = tconvert.convert("vit_small_cv", "native",
                                {"cls_token": np.zeros((1, 1, 4)),
                                 "pos_emb": np.zeros((1, 2, 4))})
    assert headless["head"] == {} and headless["blocks"] == []


@pytest.mark.parametrize("sd,layout", [
    ({"blocks/0/qkv_w": 0}, "native"),
    ({"blocks.0.attn.qkv.weight": 0, "patch_embed.proj.weight": 0}, "timm"),
    ({"encoder.layers.encoder_layer_0.ln_1.weight": 0}, "torchvision"),
    ({"whatever": 0}, "torchvision")])
def test_sniffing_as_jax(sd, layout):
    assert tconvert._sniff_vit_layout(sd) == layout
    assert jconvert._sniff_vit_layout(sd) == layout


def test_valid_layouts_are_jax_s():
    assert tconvert.VALID_LAYOUTS == jconvert.VALID_LAYOUTS


@pytest.mark.parametrize("model,layout", [
    ("vit_b16", "openai"), ("swin_t", "timm"), ("clip_b32", "torchvision"),
    ("vgg16", "timm"), ("clip_text_b32", "timm")])
def test_wrong_layout_raises_jax_message(model, layout):
    with pytest.raises(ValueError) as want:
        jconvert.convert(model, layout, {})
    with pytest.raises(ValueError) as got:
        tconvert.convert(model, layout, {})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("model,family", [
    ("resnet50", "ResNet-50"), ("convnext_t", "ConvNeXt"),
    ("convnext_b", "ConvNeXt"), ("mae_b16", "MAE")])
def test_unported_families_raise(model, family):
    """The families the port once refused convert now: a native-named
    state dict gives the JAX converter's tree (no ViT head or trunk put
    back for them)."""
    sd = {"x/y": np.arange(3, dtype=np.float32)}
    got = tconvert.convert(model, "auto", sd)
    want = jconvert.convert(model, "auto", sd)
    assert sorted(got) == sorted(want) == ["x"], family
    np.testing.assert_array_equal(got["x"]["y"].numpy(),
                                  np.asarray(want["x"]["y"]))


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 2)

    def forward(self, x):
        return self.lin(x)


@pytest.mark.parametrize("form", ["safetensors", "pth", "wrapped",
                                  "torchscript"])
def test_load_state_dict_as_jax(tmp_path, form):
    torch.manual_seed(0)
    m = _Tiny()
    want_sd = {k: v.detach().numpy().copy() for k, v in
               m.state_dict().items()}
    path = str(tmp_path / ("w.safetensors" if form == "safetensors"
                           else "w.pth"))
    if form == "safetensors":
        from interactive_vit_tpu_torch.utils.safetensors_io import save_file

        save_file(want_sd, path)
    elif form == "pth":
        torch.save(m.state_dict(), path)
    elif form == "wrapped":
        torch.save({"state_dict": m.state_dict()}, path)
    else:
        torch.jit.save(torch.jit.script(m), path)
    got = tconvert.load_state_dict(path)
    want = jconvert.load_state_dict(path)
    assert sorted(got) == sorted(want) == sorted(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_array_equal(got[k], v)
        np.testing.assert_array_equal(got[k], want[k])


def test_main_writes_a_checkpoint_directory(tmp_path, small_models):
    src = os.path.join(FIXTURES, "vit_golden_tv.safetensors")
    out = str(tmp_path / "ckpt")
    tconvert.main(["--model", "vit_small_cv", "--input", src,
                   "--output", out])
    assert sorted(os.listdir(out)) == ["leaves.safetensors", "tree.json"]
    got = load_params(out, device="cpu")
    want = tconvert.convert("vit_small_cv", "auto",
                            tconvert.load_state_dict(src))
    _assert_same(got, jax.tree.map(lambda t: t.numpy(), want))
