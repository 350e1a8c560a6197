"""The port's training path (``parallel/train.py``, ``parallel/mesh.py``,
``tools/train.py``, ``tools/evaluate.py``) against the JAX package's, on
the CPU, on shared inputs: the same parameter tree (``weights.from_jax``),
images and labels from numpy, the same gradients for the optimizer.

Tolerances, each with its reason:

* the loss, decay mask, LLRD factors and layout permutations: exact or
  f32 round-off (1e-6);
* the optimizer over 5 updates from shared gradients: 1e-6 absolute (the
  same f32 operations in the same order; the global norm and the schedule's
  cosine may differ by an ulp);
* a tiny ViT's loss and gradients: 2e-4 absolute / 1e-3 relative with the
  attention kernels, as the JAX package's own test
  (``tests/test_attention_vjp.py``), and the same with the plain attention
  (the two frameworks' f32 matmuls sum in other orders);
* 3 train steps: 1e-5 on the params (AdamW's update m / sqrt(v) is about
  lr per element whatever the gradient's size, so an f32 difference in a
  small gradient reaches the update only through that ratio; lr 1e-3).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl
import optax

from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.ops import attention_vjp as jav
from interactive_vit_tpu.ops import flash_attention as jfa
from interactive_vit_tpu.parallel import mesh as jmesh
from interactive_vit_tpu.parallel import train as jtrain
from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import attention_vjp as av
from interactive_vit_tpu_torch.parallel import mesh
from interactive_vit_tpu_torch.parallel import train
from interactive_vit_tpu_torch.tools import train as train_tool

torch.set_num_threads(2)

CFG = dict(img_size=32, patch=16, width=32, depth=2, heads=2, num_classes=4)


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    interp = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(jfa.pl, "pallas_call", interp)
    monkeypatch.setattr(jav.pl, "pallas_call", interp)


def _cfgs(**over):
    kw = {**CFG, **over}
    return jvit.ViTConfig("tiny", **kw), vit.ViTConfig("tiny", **kw)


def _params(jcfg, seed=0):
    """The JAX init, as numpy (JAX side) and tensors (port side)."""
    jp = jax.tree.map(np.asarray, jvit.init_params(jax.random.key(seed),
                                                   jcfg))
    return jp, from_jax(jp)


def _batch(n, cfg, seed=5):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 3, cfg.img_size, cfg.img_size)) \
        .astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, size=(n,))
    return images, labels


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _tleaves_np(tree):
    return [x.detach().float().numpy() for x in train.tree_leaves(tree)]


# -- loss, masks, factors ---------------------------------------------------------


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(soft, smoothing):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 10)).astype(np.float32) * 3
    if soft:
        labels = rng.dirichlet(np.ones(10), size=6).astype(np.float32)
    else:
        labels = rng.integers(0, 10, size=(6,))
    want = jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                smoothing)
    got = train.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels), smoothing)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)


def test_tree_order_and_paths_are_jax():
    jcfg, _ = _cfgs()
    jp, tp = _params(jcfg)
    jpaths = [jax.tree_util.keystr(p)
              for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [p for p, _ in train.tree_leaves_with_path(tp)] == jpaths


def test_decay_mask_matches_jax():
    jcfg, _ = _cfgs(distilled=True)
    jp, tp = _params(jcfg)
    want = jax.tree_util.tree_leaves(jtrain._decay_mask(jp))
    got = train.tree_leaves(train._decay_mask(tp))
    assert got == [bool(w) for w in want] and any(got) and not all(got)


@pytest.mark.parametrize("decay", [0.65, 1.0])
def test_llrd_factors_match_jax(decay):
    jcfg, _ = _cfgs(depth=3)
    jp, tp = _params(jcfg)
    want = _leaves_np(jtrain.llrd_factors(jp, decay))
    got = train.tree_leaves(train.llrd_factors(tp, decay))
    np.testing.assert_allclose(np.float32(got), np.float32(want), rtol=0,
                               atol=0)


def test_permute_qkv_head_major_matches_jax():
    jcfg, _ = _cfgs(width=48, heads=3)
    jp, tp = _params(jcfg)
    want = jmesh.permute_qkv_head_major(jp, 3)
    got = mesh.permute_qkv_head_major(tp, 3)
    for a, b in zip(_tleaves_np(got), _leaves_np(want)):
        np.testing.assert_array_equal(a, b)
    back = mesh.unpermute_qkv_head_major(got, 3)
    want_back = jmesh.unpermute_qkv_head_major(want, 3)
    for a, b, c in zip(_tleaves_np(back), _leaves_np(want_back),
                       _tleaves_np(tp)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# -- the optimizer ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(lr=1e-3, warmup_steps=2, total_steps=5, clip_norm=1.0, llrd=0.7),
    dict(lr=1e-3, clip_norm=100.0),
    dict(lr=3e-4, wd=0.0),
])
def test_optimizer_matches_optax_over_5_updates(kw):
    jcfg, _ = _cfgs()
    jp, tp = _params(jcfg)
    tx = jtrain.make_optimizer(**kw)
    opt = train.make_optimizer(**kw)
    jstate, tstate = tx.init(jp), opt.init(tp)
    jparams, tparams = jp, tp
    rng = np.random.default_rng(2)
    for i in range(5):
        grads = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * 0.5).astype(np.float32),
            jp)
        upd, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tupd, tstate = opt.update(from_jax(grads), tstate, tparams)
        tparams = train.apply_updates(tparams, tupd)
        for a, b in zip(_tleaves_np(tparams), _leaves_np(jparams)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        if i == 0 and kw.get("warmup_steps"):
            # optax reads the schedule before the update: lr 0 at step 0
            for a, b in zip(_tleaves_np(tparams), _tleaves_np(tp)):
                np.testing.assert_array_equal(a, b)
    assert tstate["count"] == 5
    for a, b in zip(_tleaves_np(tstate["nu"]),
                    _leaves_np(_adam_state(jstate).nu)):
        np.testing.assert_allclose(a, b, atol=1e-9, rtol=1e-5)


def _adam_state(state):
    """The ScaleByAdamState inside an optax chain's nested state."""
    for leaf in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: hasattr(x, "nu")):
        if hasattr(leaf, "nu"):
            return leaf
    raise AssertionError("no adam state")


def test_clipping_is_optax_not_clip_grad_norm():
    """Above the threshold the gradient is g / norm * max (optax), not
    g * max / (norm + 1e-6) (``clip_grad_norm_``): at a norm of 6e-6 and a
    threshold of 1e-6 the two differ by 14%."""
    g = {"w": torch.full((2, 2), 3e-6)}
    opt = train.make_optimizer(lr=1.0, wd=0.0, clip_norm=1e-6)
    _, st = opt.update(g, opt.init(g), g)
    # mu after one step is (1 - b1) times the clipped gradient, 5e-7
    np.testing.assert_allclose(st["mu"]["w"].numpy(), 0.1 * 5e-7, rtol=1e-6)


# -- the tiny ViT: loss and gradients ----------------------------------------------


@pytest.mark.parametrize("attn", ["reference", "kernel"])
def test_tiny_vit_loss_and_grads_match_jax(attn):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    images, labels = _batch(2, tcfg)
    jimpl = None if attn == "reference" else jav.trainable_flash_mhsa
    timpl = None if attn == "reference" else av.trainable_flash_mhsa
    jloss, jgrads = jax.value_and_grad(jtrain.loss_fn)(
        jp, jnp.asarray(images), jnp.asarray(labels), jcfg, attn_impl=jimpl)
    leaves = [x.requires_grad_(True) for x in train.tree_leaves(tp)]
    loss = train.loss_fn(train.tree_unflatten(tp, leaves),
                         torch.from_numpy(images), torch.from_numpy(labels),
                         tcfg, attn_impl=timpl)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=2e-4,
                               rtol=1e-3)
    jg = _leaves_np(jgrads)
    assert len(jg) == len(grads)
    for a, b in zip(grads, jg):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-4, rtol=1e-3)


def _grads(tp, tcfg, images, labels, **kw):
    leaves = [x.detach().clone().requires_grad_(True)
              for x in train.tree_leaves(tp)]
    p = train.tree_unflatten(tp, leaves)
    loss = train.loss_fn(p, torch.from_numpy(images),
                         torch.from_numpy(labels), tcfg, **kw)
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def test_head_major_packed_path_matches_the_torch_layout():
    """dh=64 and an even head count: the packed kernel path on head-major
    weights gives the loss and (unpermuted) gradients of the canonical
    layout with the plain attention, and JAX's packed path's loss."""
    jcfg, tcfg = _cfgs(width=128, heads=2)
    jp, tp = _params(jcfg)
    images, labels = _batch(2, tcfg)
    assert train.wants_head_major(tcfg, av.trainable_flash_mhsa)
    assert not train.wants_head_major(tcfg, None)
    hm = mesh.permute_qkv_head_major(tp, tcfg.heads)
    loss, grads = _grads(hm, tcfg, images, labels,
                         attn_impl=av.trainable_flash_mhsa,
                         qkv_head_major=True)
    ref_loss, ref_grads = _grads(tp, tcfg, images, labels)
    grads = train.tree_leaves(mesh.unpermute_qkv_head_major(
        train.tree_unflatten(tp, grads), tcfg.heads))
    np.testing.assert_allclose(loss.item(), ref_loss.item(), atol=1e-5)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)
    jloss = jtrain.loss_fn(jmesh.permute_qkv_head_major(jp, jcfg.heads),
                           jnp.asarray(images), jnp.asarray(labels), jcfg,
                           attn_impl=jav.trainable_flash_mhsa,
                           qkv_head_major=True)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=2e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_matches_no_remat(remat):
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    images, labels = _batch(3, tcfg)
    want = _grads(tp, tcfg, images, labels)
    got = _grads(tp, tcfg, images, labels,
                 block_wrapper=train.remat_wrapper(remat),
                 attn_impl=av.trainable_flash_mhsa)
    ref = _grads(tp, tcfg, images, labels,
                 attn_impl=av.trainable_flash_mhsa)
    assert train.remat_wrapper(False) is None
    np.testing.assert_allclose(got[0].item(), want[0].item(), atol=1e-6)
    for a, b, c in zip(got[1], ref[1], want[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5)


# -- the train step -----------------------------------------------------------------


class _SGD:
    """Plain SGD in the optimizer protocol: the step's update is -lr * g,
    so params compare the gradients themselves (AdamW's first update,
    lr * g / |g|, would turn an f32 difference in a near-zero gradient
    into a difference of up to 2 lr)."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        return train.tree_map_with_path(lambda _, g: -self.lr * g,
                                        grads), state


@pytest.mark.parametrize("remat", [False, "dots"])
def test_accum_steps_match_the_full_batch(remat):
    """accum_steps=2 equals the full-batch step (the JAX package's test,
    ``tests/test_train.py``, with its SGD and 1e-5)."""
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    images, labels = _batch(4, tcfg)
    out = []
    for accum in (1, 2):
        step = train.make_train_step(tcfg, _SGD(1e-2), remat=remat,
                                     accum_steps=accum)
        params, _, loss = step(tp, {}, torch.from_numpy(images),
                               torch.from_numpy(labels))
        out.append((loss.item(), _tleaves_np(params)))
    np.testing.assert_allclose(out[0][0], out[1][0], atol=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a, b, atol=1e-5)


def _three_steps(attn, jopt, topt):
    """Three steps of the JAX and the port's ``make_train_step`` on shared
    params and batches: the losses (1e-5) and both final param trees."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    jimpl = None if attn == "reference" else jav.trainable_flash_mhsa
    timpl = None if attn == "reference" else av.trainable_flash_mhsa
    jstep = jtrain.make_train_step(jcfg, jopt, attn_impl=jimpl, remat=False)
    tstep = train.make_train_step(tcfg, topt, attn_impl=timpl, remat=False)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jparams, tparams = jp, tp
    for i in range(3):
        images, labels = _batch(4, tcfg, seed=10 + i)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(images),
                                       jnp.asarray(labels))
        tparams, tstate, loss = tstep(tparams, tstate,
                                      torch.from_numpy(images),
                                      torch.from_numpy(labels))
        np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    return train.tree_leaves_with_path(tparams), _leaves_np(jparams)


@pytest.mark.parametrize("attn", ["reference", "kernel"])
def test_three_sgd_train_steps_match_jax(attn):
    """The step itself (loss, gradients, update, apply) with optax.sgd on
    the JAX side: every param within 1e-5."""
    tleaves, jleaves = _three_steps(attn, optax.sgd(1e-2), _SGD(1e-2))
    for (path, a), b in zip(tleaves, jleaves):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0,
                                   err_msg=path)


@pytest.mark.parametrize("attn", ["reference", "kernel"])
def test_three_adamw_train_steps_match_jax(attn):
    """The CLI's optimizer (warmup + cosine, clipping) on both sides: every
    param within 1e-5, but the k columns of qkv_b. Their exact gradient is
    0 (a constant added to every key shifts a score row by a constant,
    which the softmax ignores), so both sides hold f32 noise there, and
    AdamW turns noise into updates of about lr each: those entries are
    held to 2 lr for each of the two updates with lr > 0 (step 0 of the
    warmup takes lr 0)."""
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3, clip_norm=1.0)
    tleaves, jleaves = _three_steps(attn, jtrain.make_optimizer(**kw),
                                    train.make_optimizer(**kw))
    d = CFG["width"]
    for (path, a), b in zip(tleaves, jleaves):
        a = a.numpy()
        if path.endswith("['qkv_b']"):
            np.testing.assert_allclose(a[d:2 * d], b[d:2 * d], rtol=0,
                                       atol=2 * 2 * kw["lr"])
            a, b = np.delete(a, np.s_[d:2 * d]), np.delete(b, np.s_[d:2 * d])
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=path)


def test_k_bias_gradient_is_zero_up_to_round_off():
    """The reason for the k-bias bound above, in both packages."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    images, labels = _batch(4, tcfg)
    jg = jax.grad(jtrain.loss_fn)(jp, jnp.asarray(images),
                                  jnp.asarray(labels), jcfg)
    _, tg = _grads(tp, tcfg, images, labels)
    d = CFG["width"]
    for blk in range(CFG["depth"]):
        qkv_b = np.asarray(jg["blocks"][blk]["qkv_b"])
        assert np.abs(qkv_b[d:2 * d]).max() < 1e-6
        assert np.abs(qkv_b[:d]).max() > 1e-4
    for path, g in zip([p for p, _ in train.tree_leaves_with_path(tp)], tg):
        if path.endswith("['qkv_b']"):
            assert g[d:2 * d].abs().max().item() < 1e-6


def test_mixed_precision_keeps_f32_masters():
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    images, labels = _batch(2, tcfg)
    opt = train.make_optimizer(1e-3)
    step = train.make_train_step(tcfg, opt, remat=False,
                                 attn_impl=av.trainable_flash_mhsa,
                                 compute_dtype=torch.bfloat16)
    params, state, loss = step(tp, opt.init(tp), torch.from_numpy(images),
                               torch.from_numpy(labels))
    assert all(x.dtype == torch.float32 for x in train.tree_leaves(params))
    assert all(x.dtype == torch.float32
               for x in train.tree_leaves(state["mu"]))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)


@pytest.mark.parametrize("gib", [4, 16, 80])
@pytest.mark.parametrize("flash", [False, True])
def test_auto_remat_matches_jax(gib, flash):
    for name in ("vit_b16", "vit_l16"):
        for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                        (torch.float32, jnp.float32)):
            got = train.auto_remat(vit.VARIANTS[name], 64, dt, flash,
                                   hbm_bytes=gib << 30)
            want = jtrain.auto_remat(jvit.VARIANTS[name], 64, jdt, flash,
                                     hbm_bytes=gib << 30)
            assert got == want, (name, dt)


def test_auto_remat_defaults_to_the_device_memory(monkeypatch):
    """vit_b16 at B=64 in bf16 with the kernels: off on an 80 GB card, on
    where the device holds 4 GiB."""
    cfg = vit.VARIANTS["vit_b16"]
    monkeypatch.setattr(train, "device_memory_bytes", lambda dev: 80 << 30)
    assert not train.auto_remat(cfg, 64, torch.bfloat16, True)
    monkeypatch.setattr(train, "device_memory_bytes", lambda dev: 4 << 30)
    assert train.auto_remat(cfg, 64, torch.bfloat16, True)
    monkeypatch.undo()
    assert train.device_memory_bytes("cpu") > 0


def test_model_family_refuses_other_families():
    """The served-only families (CLIP here) are not trainable; the ViT,
    MoE, Swin and ConvNeXt ones are (``tests/test_torch_family_train.py``)."""
    from interactive_vit_tpu_torch.models import clip

    assert train.model_family(vit.VARIANTS["vit_t16"]) is vit
    with pytest.raises(NotImplementedError, match="CLIPVisionConfig"):
        train.model_family(clip.CLIPVisionConfig())


def test_forward_refuses_taps_with_a_block_wrapper():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    images, _ = _batch(1, tcfg)
    with pytest.raises(ValueError, match="taps off"):
        vit.forward(tp, torch.from_numpy(images), tcfg, want_attn=True,
                    block_wrapper=lambda f: f)


def test_setup_returns_head_major_params_for_the_packed_kernel():
    _, tcfg = _cfgs(width=128, heads=2)
    params, state, step, infer = train.setup(
        tcfg, device="cpu", seed=3, attn_impl="flash_vjp", remat=False)
    canonical = vit.init_params(tcfg, torch.Generator().manual_seed(3))
    got = mesh.unpermute_qkv_head_major(params, tcfg.heads)
    for a, b in zip(train.tree_leaves(got), train.tree_leaves(canonical)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    images, labels = _batch(2, tcfg)
    want = vit.forward(canonical, torch.from_numpy(images), tcfg)["logits"]
    torch.testing.assert_close(infer(params, images), want, atol=1e-5,
                               rtol=1e-5)
    params, state, loss = step(params, state, torch.from_numpy(images),
                               torch.from_numpy(labels))
    assert state["count"] == 1 and torch.isfinite(loss)


# -- the trainer ---------------------------------------------------------------------


def test_memorize_oracle_through_main(monkeypatch):
    """The JAX package's accuracy oracle (``tests/test_accuracy_oracle.py``):
    a width-64, depth-2, 4-head ViT memorises 32 patterned images of 10
    classes in 150 steps."""
    monkeypatch.setitem(vit.VARIANTS, "vit_oracle", vit.ViTConfig(
        "vit_oracle", img_size=32, patch=16, width=64, depth=2, heads=4,
        num_classes=10))
    res = train_tool.main([
        "--device", "cpu", "--variant", "vit_oracle", "--steps", "150",
        "--batch", "16", "--lr", "1e-3", "--memorize", "32",
        "--distinct-classes", "10", "--log-every", "100",
        "--eval-every", "150"])
    assert res["evals"][-1][1] > 0.9
    assert res["history"][-1][1] < res["history"][0][1]


def test_pattern_set_is_jax_s():
    from interactive_vit_tpu.tools.train import pattern_set as jpattern

    for a, b in zip(train_tool.pattern_set(3, 12, 32, 10, 5),
                    jpattern(3, 12, 32, 10, 5)):
        np.testing.assert_array_equal(a, b)


def test_main_runs_every_option_on_the_cpu(monkeypatch):
    monkeypatch.setitem(vit.VARIANTS, "vit_tiny_hm", vit.ViTConfig(
        "vit_tiny_hm", img_size=32, patch=16, width=128, depth=1, heads=2,
        num_classes=4))
    res = train_tool.main([
        "--device", "cpu", "--variant", "vit_tiny_hm", "--steps", "3",
        "--batch", "4", "--attn", "flash_vjp", "--remat", "dots",
        "--dtype", "mixed", "--accum-steps", "2", "--warmup", "1",
        "--clip-norm", "1", "--llrd", "0.7", "--ema-decay", "0.9",
        "--label-smoothing", "0.1", "--eval-every", "3", "--log-every", "1"])
    assert res["head_major"] and res["attn"] == "trainable_flash_mhsa"
    assert res["remat"] == "dots" and len(res["history"]) == 3
    assert all(np.isfinite(loss) for _, loss, _ in res["history"])
    assert res["params"]["blocks"][0]["qkv_w"].dtype == torch.float32


def test_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tool.main(["--steps", "1"])


@pytest.mark.parametrize("flag", [
    ["--mesh", "data=one"], ["--mesh", "data=4,pipe=2"],
    ["--teacher-variant", "vit_t16"],
    ["--distill-alpha", "0.2", "--teacher-variant", "vit_t16"],
    ["--distill-teacher", "t.pth"], ["--platform", "cpu"]])
def test_unported_flags_are_refused(flag):
    """A malformed --mesh (a size that is not a number, an axis other
    than data / model / stage) and --platform are refused; the
    distillation pair (``--distill-teacher`` / ``--teacher-variant``) is
    refused alone."""
    with pytest.raises(SystemExit):
        train_tool.parse_args(["--device", "cpu", *flag])


def test_main_refuses_other_families():
    """A served-only family (ResNet-50) has no train step."""
    with pytest.raises(ValueError, match="not a trainable model"):
        train_tool.main(["--device", "cpu", "--variant", "resnet50",
                         "--steps", "1"])


def test_run_eval_pads_the_last_chunk():
    from interactive_vit_tpu.tools.evaluate import run_eval as jrun_eval
    from interactive_vit_tpu_torch.tools.evaluate import run_eval

    rng = np.random.default_rng(0)
    images = rng.standard_normal((7, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=(7,))
    seen = []

    def infer(params, x):
        seen.append(len(x))
        return torch.from_numpy(np.asarray(x) * params)

    def chunks():
        for lo in range(0, 7, 3):
            yield images[lo:lo + 3], labels[lo:lo + 3]

    got = run_eval(infer, 2.0, chunks(), 3, top_k=2)
    want = jrun_eval(lambda p, x: np.asarray(x) * p, 2.0, chunks(), 3,
                     top_k=2)
    assert got == want and seen == [3, 3, 3]
