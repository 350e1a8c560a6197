"""The port's state-dict converters (``models/weights.py``,
``models/swin.from_torch``) against the JAX package's on the CPU.

On the committed torchvision and timm fixtures the port's trees equal the
JAX converters' leaf for leaf (f32, exact), and the port alone (fixture ->
port converter -> port forward) reproduces the torch-made golden logits
and maps within 1e-4. ``to_torchvision`` inverts ``from_torchvision``;
``to_native_flat`` gives JAX's keys and arrays; the timm options (DeiT's
distillation token, DINOv2's registers and LayerScale) and Swin's
converter are held to JAX's on state dicts built here with the names and
shapes JAX's converters read.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import swin as jswin
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models import weights as jweights
from interactive_vit_tpu_torch.models import swin as tswin
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models import weights as tweights
from interactive_vit_tpu_torch.utils.safetensors_io import load_file

torch.set_num_threads(2)

ATOL = 1e-4
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
SMALL = dict(img_size=32, patch=16, width=64, depth=2, heads=4,
             num_classes=10)


def _leaves(tree, prefix=""):
    """{path: leaf} of a dict / list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out or {prefix: "empty dict"}
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out or {prefix: "empty list"}
    return {prefix: tree}


def _assert_trees_equal(got, want):
    """The port's tree (tensors) equals JAX's (arrays) leaf for leaf,
    bit for bit in f32."""
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k, v in w.items():
        if isinstance(v, str):
            assert g[k] == v, k
            continue
        a = g[k]
        assert isinstance(a, torch.Tensor) and a.dtype == torch.float32, k
        # the kernels take contiguous weights only
        assert a.is_contiguous(), k
        b = np.asarray(v)
        assert a.shape == b.shape, k
        assert a.numpy().tobytes() == b.astype(np.float32).tobytes(), k


def _fixture(name):
    return load_file(os.path.join(FIXTURES, name))


@pytest.mark.parametrize("layout", ["torchvision", "timm"])
def test_fixture_converts_as_jax_converts_it(layout):
    sd = _fixture(f"vit_golden_{'tv' if layout == 'torchvision' else 'timm'}"
                  f".safetensors")
    jcfg = jvit.ViTConfig("vit_golden", **SMALL)
    tcfg = tvit.ViTConfig("vit_golden", **SMALL)
    jconv = {"torchvision": jweights.from_torchvision,
             "timm": jweights.from_timm}[layout]
    tconv = {"torchvision": tweights.from_torchvision,
             "timm": tweights.from_timm}[layout]
    _assert_trees_equal(tconv(sd, tcfg), jconv(sd, jcfg))


@pytest.mark.parametrize("layout", ["torchvision", "timm"])
def test_golden_checkpoint_through_the_port_alone(layout):
    """The independent torch-made oracle with no JAX on the path: the
    committed file, the port's reader and converter, the port's forward;
    the logits (and, for the torchvision fixture, every block's maps)
    within 1e-4."""
    tag = "" if layout == "torchvision" else "_timm"
    golden = np.load(os.path.join(FIXTURES, f"vit_golden{tag}.npz"))
    sd = _fixture(f"vit_golden_{'tv' if layout == 'torchvision' else 'timm'}"
                  f".safetensors")
    cfg = tvit.ViTConfig("vit_golden", **SMALL)
    conv = {"torchvision": tweights.from_torchvision,
            "timm": tweights.from_timm}[layout]
    out = tvit.forward(conv(sd, cfg), torch.from_numpy(golden["input"]),
                       cfg, want_attn="attn" in golden)
    np.testing.assert_allclose(out["logits"].numpy(), golden["logits"],
                               atol=ATOL)
    if "attn" in golden:
        attn = np.stack([a.numpy() for a in out["attn"]])
        np.testing.assert_allclose(attn, golden["attn"], atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_converters_cast_after_f32_on_the_named_device(dtype):
    sd = _fixture("vit_golden_tv.safetensors")
    cfg = tvit.ViTConfig("vit_golden", **SMALL)
    got = tweights.from_torchvision(sd, cfg, dtype=dtype, device="cpu")
    ref = tweights.from_torchvision(sd, cfg)
    for k, v in _leaves(ref).items():
        a = _leaves(got)[k]
        assert a.dtype == dtype and a.device.type == "cpu"
        assert torch.equal(a, v.to(dtype))


def test_to_torchvision_inverts_from_torchvision():
    sd = _fixture("vit_golden_tv.safetensors")
    cfg = tvit.ViTConfig("vit_golden", **SMALL)
    back = tweights.to_torchvision(tweights.from_torchvision(sd, cfg), cfg)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == np.float32 and back[k].shape == v.shape, k
        assert back[k].tobytes() == np.ascontiguousarray(v).tobytes(), k
    # and the JAX package's inverse gives the same state dict
    jback = jweights.to_torchvision(
        jweights.from_torchvision(sd, jvit.ViTConfig("vit_golden", **SMALL)),
        jvit.ViTConfig("vit_golden", **SMALL))
    for k, v in jback.items():
        assert back[k].tobytes() == np.ascontiguousarray(v).tobytes(), k


def test_to_torchvision_of_a_headless_tree():
    cfg = tvit.ViTConfig("vit_hl", **dict(SMALL, num_classes=0))
    params = tvit.init_params(cfg, torch.Generator().manual_seed(1))
    sd = tweights.to_torchvision(params, cfg)
    assert not any(k.startswith("heads.") for k in sd)
    _assert_trees_equal(tweights.from_torchvision(sd, cfg),
                        jweights.from_torchvision(
                            sd, jvit.ViTConfig("vit_hl",
                                               **dict(SMALL, num_classes=0))))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_to_native_flat_gives_jax_keys_and_arrays(dtype):
    """The JAX tree and its ``from_jax`` copy flatten to the same keys and
    values (a bf16 leaf as its exact f32, numpy having no bfloat16)."""
    jcfg = jvit.ViTConfig("vit_tt", **SMALL)
    jp = jvit.init_params(jax.random.key(3), jcfg, dtype=dtype)
    want = jweights.to_native_flat(jax.tree.map(np.asarray, jp))
    tp = tweights.from_jax(jax.tree.map(np.asarray, jp),
                           dtype=torch.float32 if dtype == jnp.float32
                           else torch.bfloat16)
    got = tweights.to_native_flat(tp)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        assert got[k].tobytes() == np.asarray(v, np.float32).tobytes(), k


def test_from_native_flat_rebuilds_the_tree():
    jcfg = jvit.ViTConfig("vit_tt", **SMALL)
    jp = jax.tree.map(np.asarray, jvit.init_params(jax.random.key(4), jcfg))
    flat = jweights.to_native_flat(jp)
    got = tweights.from_native_flat(flat)
    _assert_trees_equal(got, jweights.from_native_flat(flat))
    bf = tweights.from_native_flat(flat, dtype=torch.bfloat16)
    assert bf["blocks"][1]["qkv_w"].dtype == torch.bfloat16
    # integer leaves keep their dtype
    ints = tweights.from_native_flat({"a/0": np.arange(3, dtype=np.int8)})
    assert ints["a"][0].dtype == torch.int8


@pytest.mark.parametrize("sd", [{"a": np.zeros(1), "a/b": np.zeros(1)},
                                {"l/0": np.zeros(1), "l/2": np.zeros(1)}])
def test_from_native_flat_refuses_bad_keys(sd):
    for fn in (tweights.from_native_flat, jweights.from_native_flat):
        with pytest.raises(ValueError):
            fn(sd)


def _timm_sd(tp, cfg, grid_only_pos=False):
    """A timm-named state dict (numpy) from a port tree."""
    def a(t):
        return t.numpy()

    sd = {"patch_embed.proj.weight": a(tp["patch_embed"]["w"]).T.reshape(
              cfg.width, cfg.in_chans, cfg.patch, cfg.patch),
          "patch_embed.proj.bias": a(tp["patch_embed"]["b"]),
          "cls_token": a(tp["cls_token"]),
          "pos_embed": a(tp["pos_emb"]),
          "norm.weight": a(tp["norm"]["s"]), "norm.bias": a(tp["norm"]["b"])}
    if grid_only_pos:
        sd["pos_embed"] = sd["pos_embed"][:, 1:]
    if cfg.num_classes:
        sd["head.weight"] = a(tp["head"]["w"]).T
        sd["head.bias"] = a(tp["head"]["b"])
    if cfg.distilled:
        sd["dist_token"] = a(tp["dist_token"])
        if cfg.num_classes:
            sd["head_dist.weight"] = a(tp["head_dist"]["w"]).T
            sd["head_dist.bias"] = a(tp["head_dist"]["b"])
    if cfg.registers:
        sd["reg_token"] = a(tp["reg_tokens"])
    names = (("norm1.weight", "ln1_s"), ("norm1.bias", "ln1_b"),
             ("attn.qkv.weight", "qkv_w"), ("attn.qkv.bias", "qkv_b"),
             ("attn.proj.weight", "proj_w"), ("attn.proj.bias", "proj_b"),
             ("norm2.weight", "ln2_s"), ("norm2.bias", "ln2_b"),
             ("mlp.fc1.weight", "fc1_w"), ("mlp.fc1.bias", "fc1_b"),
             ("mlp.fc2.weight", "fc2_w"), ("mlp.fc2.bias", "fc2_b"))
    for i, blk in enumerate(tp["blocks"]):
        for tname, ours in names:
            v = a(blk[ours])
            sd[f"blocks.{i}.{tname}"] = v.T if v.ndim == 2 else v
        if cfg.layer_scale:
            sd[f"blocks.{i}.ls1.gamma"] = a(blk["ls1"])
            sd[f"blocks.{i}.ls2.gamma"] = a(blk["ls2"])
    return sd


@pytest.mark.parametrize("extra,grid_only", [
    (dict(distilled=True), False),
    (dict(distilled=True, num_classes=0), False),
    (dict(registers=2, layer_scale=1e-5, num_classes=0), False),
    (dict(registers=2, layer_scale=1e-5, num_classes=0), True)])
def test_from_timm_options_as_jax(extra, grid_only):
    kw = dict(SMALL, **extra)
    tcfg, jcfg = tvit.ViTConfig("vit_x", **kw), jvit.ViTConfig("vit_x", **kw)
    tp = tvit.init_params(tcfg, torch.Generator().manual_seed(2))
    sd = _timm_sd(tp, tcfg, grid_only)
    got = tweights.from_timm(sd, tcfg)
    _assert_trees_equal(got, jweights.from_timm(sd, jcfg))
    assert got["pos_emb"].shape[1] == tcfg.pos_tokens


def test_missing_key_names_it():
    cfg = tvit.ViTConfig("vit_golden", **SMALL)
    sd = dict(_fixture("vit_golden_tv.safetensors"))
    del sd["encoder.ln.bias"]
    with pytest.raises(KeyError, match="encoder.ln.bias"):
        tweights.from_torchvision(sd, cfg)


SWIN = dict(img_size=32, patch=4, embed_dim=16, depths=(2, 2), heads=(2, 4),
            window=4)


def _swin_sd(tp, cfg):
    """A torchvision Swin v1 state dict (numpy) from a port tree."""
    def a(t):
        return t.numpy()

    d0 = cfg.embed_dim
    sd = {"features.0.0.weight": a(tp["patch_embed"]["w"]).T.reshape(
              d0, cfg.in_chans, cfg.patch, cfg.patch),
          "features.0.0.bias": a(tp["patch_embed"]["b"]),
          "features.0.2.weight": a(tp["patch_embed"]["ln_s"]),
          "features.0.2.bias": a(tp["patch_embed"]["ln_b"]),
          "norm.weight": a(tp["norm"]["s"]), "norm.bias": a(tp["norm"]["b"])}
    if cfg.num_classes:
        sd["head.weight"] = a(tp["head"]["w"]).T
        sd["head.bias"] = a(tp["head"]["b"])
    names = (("norm1.weight", "ln1_s"), ("norm1.bias", "ln1_b"),
             ("attn.qkv.weight", "qkv_w"), ("attn.qkv.bias", "qkv_b"),
             ("attn.relative_position_bias_table", "bias_table"),
             ("attn.proj.weight", "proj_w"), ("attn.proj.bias", "proj_b"),
             ("norm2.weight", "ln2_s"), ("norm2.bias", "ln2_b"),
             ("mlp.0.weight", "fc1_w"), ("mlp.0.bias", "fc1_b"),
             ("mlp.3.weight", "fc2_w"), ("mlp.3.bias", "fc2_b"))
    for s, blocks in enumerate(tp["stages"]):
        for b, blk in enumerate(blocks):
            for tname, ours in names:
                v = a(blk[ours])
                sd[f"features.{2 * s + 1}.{b}.{tname}"] = (
                    v.T if v.ndim == 2 and ours != "bias_table" else v)
    for s, m in enumerate(tp["merges"]):
        pre = f"features.{2 * s + 2}."
        sd[pre + "norm.weight"] = a(m["ln_s"])
        sd[pre + "norm.bias"] = a(m["ln_b"])
        sd[pre + "reduction.weight"] = a(m["w"]).T
    return sd


@pytest.mark.parametrize("classes", [10, 0])
def test_swin_from_torch_as_jax(classes):
    tcfg = tswin.SwinConfig("swin_x", num_classes=classes, **SWIN)
    jcfg = jswin.SwinConfig("swin_x", num_classes=classes, **SWIN)
    tp = tswin.init_params(tcfg, torch.Generator().manual_seed(6))
    sd = _swin_sd(tp, tcfg)
    got = tswin.from_torch(sd, tcfg)
    _assert_trees_equal(got, jswin.from_torch(sd, jcfg))
    # and it is the tree the state dict was written from
    g, w = _leaves(got), _leaves(tp)
    assert sorted(g) == sorted(w)
    assert all(torch.equal(g[k], w[k]) for k in w if not isinstance(w[k], str))
    bf = tswin.from_torch(sd, tcfg, dtype=torch.bfloat16)
    assert bf["stages"][1][1]["bias_table"].dtype == torch.bfloat16
