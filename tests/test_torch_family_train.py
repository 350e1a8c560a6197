"""Training the MoE, Swin and ConvNeXt families in the port
(``parallel/train``'s family dispatch, the forwards' ``block_wrapper``,
``tools/train.py`` for every family and ``--no-remat``) against the JAX
package, on the CPU, on shared inputs: the JAX package's toy Swin
(``tests/test_train.py``'s ``swin_train``) and ConvNeXt (``cnx_train``)
and a tiny MoE, their JAX inits through ``weights.from_jax``, images and
labels from numpy.

Tolerances, each with its reason:

* the loss and every gradient against ``jax.value_and_grad`` of JAX's
  ``loss_fn``: 2e-4 absolute / 1e-3 relative, the bound of
  ``tests/test_torch_train.py``'s loss-and-grads test (f32 products summed
  in other orders through the blocks forward and back). The MoE's top-1
  routing is discrete: its seeds are ones whose gates have no near tie (the
  top two gates of every routed token at least 1e-3 apart, checked in the
  test, far above the ~1e-6 by which the two frameworks' gates differ), so
  both packages route alike;
* remat on and "dots" against remat off: the loss within 1e-6 and the
  gradients within 1e-5 (the same operations, run again in the backward);
* a head-major MoE step against the canonical one, and a wrapped forward
  against the unwrapped one: 1e-5;
* an exported file read back: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import convnext as jconvnext
from interactive_vit_tpu.models import moe as jmoe
from interactive_vit_tpu.models import swin as jswin
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.parallel import train as jtrain
from interactive_vit_tpu_torch.models import clip, convnext, moe, swin, vit
from interactive_vit_tpu_torch.models.weights import (
    from_jax, from_native_flat,
)
from interactive_vit_tpu_torch.ops import attention_vjp as av
from interactive_vit_tpu_torch.ops import layers as L
from interactive_vit_tpu_torch.parallel import mesh
from interactive_vit_tpu_torch.parallel import train
from interactive_vit_tpu_torch.tools import train as train_tool
from interactive_vit_tpu_torch.utils.safetensors_io import load_file

torch.set_num_threads(2)

SWIN = dict(img_size=32, patch=4, embed_dim=16, depths=(2, 2), heads=(2, 4),
            window=4, mlp_ratio=2, num_classes=8)
CNX = dict(depths=(1, 1), dims=(8, 16), num_classes=8, img_size=32,
           resize_to=34)
MOE = dict(img_size=32, patch=8, width=32, depth=4, heads=2, num_classes=8,
           n_experts=4)
# heads 64 wide in pairs: the packed (head-major) path
MOE_HM = dict(MOE, width=128)

FAMILIES = {
    "swin": (jswin.SwinConfig("swin_train", **SWIN), jswin,
             swin.SwinConfig("swin_train", **SWIN), swin),
    "convnext": (jconvnext.ConvNeXtConfig("cnx_train", **CNX), jconvnext,
                 convnext.ConvNeXtConfig("cnx_train", **CNX), convnext),
    "moe": (jmoe.MoEViTConfig("moe_train", **MOE), jmoe,
            moe.MoEViTConfig("moe_train", **MOE), moe),
}
# seeds of the MoE's params and batch whose routing has no near tie
MOE_SEEDS = (1, 5)


def _params(family, seed):
    jcfg, jfam, tcfg, _ = FAMILIES[family]
    jp = jax.tree.map(np.asarray, jfam.init_params(jax.random.key(seed),
                                                   jcfg))
    return jp, from_jax(jp)


def _batch(n, seed, classes=8):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, size=(n,))
    images = (rng.normal(size=(n, 3, 32, 32)).astype(np.float32) * 0.3
              + (labels[:, None, None, None] / classes).astype(np.float32))
    return images, labels


def _grads(tp, cfg, images, labels, **kw):
    leaves = [x.detach().clone().requires_grad_(True)
              for x in train.tree_leaves(tp)]
    loss = train.loss_fn(train.tree_unflatten(tp, leaves),
                         torch.from_numpy(images), torch.from_numpy(labels),
                         cfg, **kw)
    return loss.detach(), [g.numpy() for g in
                           torch.autograd.grad(loss, leaves)]


def _routing_margin(params, images, cfg) -> float:
    """The least gap between a routed token's top two gates over the MoE
    blocks of the plain forward."""
    x = vit.embed(params, torch.from_numpy(images), cfg)
    margin = float("inf")
    with torch.no_grad():
        for i, p in enumerate(params["blocks"]):
            if cfg.is_moe(i):
                h, _ = moe.attn_ops.mhsa(
                    L.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.ln_eps), p,
                    cfg.heads)
                h = L.layer_norm(x + h, p["ln2_s"], p["ln2_b"], cfg.ln_eps)
                _, _, gates = moe.route(h, p["router_w"], cfg)
                top2 = gates.topk(2, dim=-1).values
                margin = min(margin, float((top2[..., 0]
                                            - top2[..., 1]).min()))
            x = moe.block(p, x, cfg, i)[0]
    return margin


@pytest.mark.parametrize("family", ["swin", "convnext", "moe"])
def test_family_loss_and_grads_match_jax(family):
    jcfg, _, tcfg, _ = FAMILIES[family]
    seed, bseed = MOE_SEEDS if family == "moe" else (1, 0)
    jp, tp = _params(family, seed)
    images, labels = _batch(4, bseed)
    if family == "moe":
        assert _routing_margin(tp, images, tcfg) > 1e-3
    jloss, jgrads = jax.value_and_grad(jtrain.loss_fn)(
        jp, jnp.asarray(images), jnp.asarray(labels), jcfg)
    loss, grads = _grads(tp, tcfg, images, labels)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=2e-4,
                               rtol=1e-3)
    jg = [np.asarray(x) for x in jax.tree_util.tree_leaves(jgrads)]
    assert len(jg) == len(grads)
    for (path, _), a, b in zip(train.tree_leaves_with_path(tp), grads, jg):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-3,
                                   err_msg=path)


@pytest.mark.parametrize("remat", [True, "dots"])
@pytest.mark.parametrize("family", ["swin", "convnext", "moe"])
def test_remat_gives_the_values_of_no_remat(family, remat):
    _, _, tcfg, _ = FAMILIES[family]
    seed, bseed = MOE_SEEDS if family == "moe" else (1, 0)
    _, tp = _params(family, seed)
    images, labels = _batch(3, bseed)
    want = _grads(tp, tcfg, images, labels)
    got = _grads(tp, tcfg, images, labels,
                 block_wrapper=train.remat_wrapper(remat))
    np.testing.assert_allclose(got[0].item(), want[0].item(), atol=1e-6)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_moe_head_major_step_equals_the_canonical_one():
    """Heads 64 wide in pairs: the packed path on head-major params gives
    the loss (aux included) and the unpermuted gradients of the canonical
    layout."""
    cfg = moe.MoEViTConfig("moe_hm", **MOE_HM)
    jcfg = jmoe.MoEViTConfig("moe_hm", **MOE_HM)
    tp = from_jax(jax.tree.map(np.asarray, jmoe.init_params(
        jax.random.key(2), jcfg)))
    images, labels = _batch(2, 3)
    assert train.wants_head_major(cfg, av.trainable_flash_mhsa)
    hm = mesh.permute_qkv_head_major(tp, cfg.heads)
    loss, grads = _grads(hm, cfg, images, labels,
                         attn_impl=av.trainable_flash_mhsa,
                         qkv_head_major=True,
                         block_wrapper=train.remat_wrapper(True))
    ref_loss, ref_grads = _grads(tp, cfg, images, labels)
    grads = train.tree_leaves(mesh.unpermute_qkv_head_major(
        train.tree_unflatten(tp, [torch.from_numpy(g) for g in grads]),
        cfg.heads))
    np.testing.assert_allclose(loss.item(), ref_loss.item(), atol=1e-5)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)


def test_moe_forward_takes_the_head_major_layout():
    cfg = moe.MoEViTConfig("moe_hm", **MOE_HM)
    tp = moe.init_params(cfg, torch.Generator().manual_seed(4))
    images = torch.from_numpy(_batch(2, 4)[0])
    want = moe.forward(tp, images, cfg, want_aux=True)
    got = moe.forward(mesh.permute_qkv_head_major(tp, cfg.heads), images,
                      cfg, want_aux=True, qkv_head_major=True)
    torch.testing.assert_close(got["logits"], want["logits"], atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(got["aux"], want["aux"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("family", ["swin", "moe"])
def test_block_wrapper_refuses_taps(family):
    _, _, tcfg, fam = FAMILIES[family]
    _, tp = _params(family, 1)
    with pytest.raises(ValueError, match="block_wrapper requires taps off"):
        fam.forward(tp, torch.zeros(1, 3, 32, 32), tcfg, want_attn=True,
                    block_wrapper=lambda f: f)


@pytest.mark.parametrize("family", ["swin", "convnext", "moe"])
def test_wrapped_forward_is_the_unwrapped_one(family):
    _, _, tcfg, fam = FAMILIES[family]
    _, tp = _params(family, 1)
    images = torch.from_numpy(_batch(2, 1)[0])
    want = train._logits(fam.forward(tp, images, tcfg))
    got = train._logits(fam.forward(tp, images, tcfg,
                                    block_wrapper=lambda f: f))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_model_family_dispatch():
    assert train.model_family(swin.VARIANTS["swin_t"]) is swin
    assert train.model_family(convnext.VARIANTS["convnext_t"]) is convnext
    assert train.model_family(moe.VARIANTS["vit_moe_s16"]) is moe
    assert train.model_family(vit.VARIANTS["deit_b16"]) is vit
    with pytest.raises(NotImplementedError, match="not a trainable family"):
        train.model_family(clip.CLIPVisionConfig())
    for name in ("swin_t", "convnext_t", "vit_moe_s16"):
        assert train_tool.resolve_cfg(name).name == name
    assert not train.wants_head_major(swin.VARIANTS["swin_t"],
                                      av.trainable_flash_mhsa)
    assert train.wants_head_major(moe.VARIANTS["vit_moe_s16"],
                                  av.trainable_flash_mhsa)


@pytest.mark.parametrize("gib", [2, 4, 8, 16, 24, 40, 80])
@pytest.mark.parametrize("flash", [False, True])
def test_auto_remat_decides_as_jax(gib, flash):
    """ViT, MoE and Swin configs at the same memory: the port's decision is
    JAX's (the MoE's MLP parameters counted n_experts times)."""
    for name, tcfg, jcfg in (
            ("vit_b16", vit.VARIANTS["vit_b16"], jvit.VARIANTS["vit_b16"]),
            ("vit_moe_s16", moe.VARIANTS["vit_moe_s16"],
             jmoe.VARIANTS["vit_moe_s16"]),
            ("swin_t", swin.VARIANTS["swin_t"], jswin.VARIANTS["swin_t"])):
        for batch in (8, 64, 256):
            for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                            (torch.float32, jnp.float32)):
                got = train.auto_remat(tcfg, batch, dt, flash,
                                       hbm_bytes=gib << 30)
                want = jtrain.auto_remat(jcfg, batch, jdt, flash,
                                         hbm_bytes=gib << 30)
                assert got == want, (name, batch, dt)


def test_auto_remat_counts_every_expert():
    """The regression: at 1 GiB vit_moe_s16 at B=8 in bf16 (with the
    kernels) fits with one expert's MLP but not with eight, and the port
    decides as JAX does."""
    import dataclasses

    cfg = moe.VARIANTS["vit_moe_s16"]
    one = dataclasses.replace(cfg, n_experts=1)
    kw = dict(dtype=torch.bfloat16, flash_attn=True, hbm_bytes=1 << 30)
    assert not train.auto_remat(one, 8, **kw)
    assert train.auto_remat(cfg, 8, **kw)
    assert jtrain.auto_remat(jmoe.VARIANTS["vit_moe_s16"], 8, jnp.bfloat16,
                             True, hbm_bytes=1 << 30)


@pytest.fixture
def toy_variants(monkeypatch):
    for family in FAMILIES.values():
        monkeypatch.setitem(family[3].VARIANTS, family[2].name, family[2])
    hm = moe.MoEViTConfig("moe_hm", **MOE_HM)
    monkeypatch.setitem(moe.VARIANTS, "moe_hm", hm)


def _cli(name, *extra):
    return train_tool.main(["--device", "cpu", "--variant", name, "--batch",
                            "4", "--steps", "2", "--log-every", "1",
                            *extra])


def test_no_remat_is_remat_off(toy_variants):
    """Swin's auto remat is on (no working-set estimate); --no-remat turns
    it off, the run equal to --remat off's bit for bit."""
    assert train_tool.resolve_remat(
        train_tool.parse_args(["--no-remat", "--remat", "on"]), None, None,
        None, "cpu") is False
    auto = _cli("swin_train")
    off = _cli("swin_train", "--remat", "off")
    no = _cli("swin_train", "--no-remat")
    assert auto["remat"] is True and off["remat"] is False
    assert no["remat"] is False
    assert [h[1] for h in no["history"]] == [h[1] for h in off["history"]]
    for a, b in zip(train.tree_leaves(no["params"]),
                    train.tree_leaves(off["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name, extra", [
    ("swin_train", ["--remat", "dots"]),
    ("cnx_train", ["--dtype", "mixed", "--accum-steps", "2"]),
    ("moe_train", ["--ema-decay", "0.9"]),
    ("moe_hm", ["--attn", "flash_vjp", "--dtype", "mixed"])])
def test_cli_two_steps_export_a_file_that_reads_back(toy_variants, tmp_path,
                                                     name, extra):
    path = str(tmp_path / "out.safetensors")
    res = _cli(name, "--export-safetensors", path, *extra)
    assert all(np.isfinite(loss) for _, loss, _ in res["history"])
    assert res["head_major"] == (name == "moe_hm")
    back = from_native_flat(load_file(path))
    want = res["params"]
    assert [p for p, _ in train.tree_leaves_with_path(back)] == [
        p for p, _ in train.tree_leaves_with_path(want)]
    for a, b in zip(train.tree_leaves(back), train.tree_leaves(want)):
        assert torch.equal(a, b)
    if res["head_major"]:
        # the export is canonical, the train state head-major
        state = mesh.unpermute_qkv_head_major(res["state"]["params"], 2)
        for a, b in zip(train.tree_leaves(state), train.tree_leaves(want)):
            assert torch.equal(a, b)


def test_swin_refuses_the_flash_vjp_kernels(toy_variants):
    with pytest.raises(ValueError, match="flash_vjp"):
        _cli("swin_train", "--attn", "flash_vjp")


def test_init_stays_plain_vit_only():
    with pytest.raises(SystemExit):
        train_tool.parse_args(["--variant", "swin_t", "--init", "x.pth"])


@pytest.mark.parametrize("family", ["swin", "convnext"])
def test_setup_trains_and_infers_a_plain_family(family):
    _, _, tcfg, fam = FAMILIES[family]
    params, state, step, infer = train.setup(tcfg, device="cpu", seed=2,
                                             remat=True)
    images, labels = _batch(4, 2)
    want = train._logits(fam.forward(params, torch.from_numpy(images),
                                     tcfg))
    torch.testing.assert_close(infer(params, images), want, atol=0, rtol=0)
    params, state, loss = step(params, state, torch.from_numpy(images),
                               torch.from_numpy(labels))
    assert state["count"] == 1 and torch.isfinite(loss)
