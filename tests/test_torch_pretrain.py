"""MAE pretraining in the port (``models/mae``'s folded-key masks and
training hook, ``parallel/train``'s MAE step, ``tools/pretrain.py``)
against the JAX package, on the CPU, on shared inputs: a tiny MAE in both
packages (``tests/test_torch_mae.py``'s: a 32 px encoder at patch 8, width
32, 2 blocks; a decoder 16 wide, 1 block), its JAX init through
``weights.from_jax``, images from numpy, the same keys.

Tolerances, each with its reason:

* the masks from folded keys: bit for bit (``jax.random.uniform``'s bits,
  stable argsorts);
* the loss and every gradient of one pass, and of an ``accum_steps=2`` SGD
  step: 2e-4 absolute / 1e-3 relative, the bound of
  ``tests/test_torch_train.py``'s loss-and-grads test (f32 products summed
  in other orders through both trunks forward and back);
* the remat hook against none: 1e-6 on the loss, 1e-5 on the gradients;
* ``linear_probe`` on the same features: exact (the same float64 numpy);
* the exported encoder served by the port's ViT against JAX's ViT on the
  same file: 1e-5 (f32 products in other orders through 12 blocks).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from interactive_vit_tpu.models import mae as jmae
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.parallel import train as jtrain
from interactive_vit_tpu.tools.convert import convert as jconvert
from interactive_vit_tpu.tools.pretrain import linear_probe as jprobe
from interactive_vit_tpu_torch.data.loader import save_dataset
from interactive_vit_tpu_torch.models import mae
from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.models.mae_plugin import make_mae_model
from interactive_vit_tpu_torch.models.weights import (
    from_jax, from_native_flat,
)
from interactive_vit_tpu_torch.ops.node_ops import fold_in, prng_key
from interactive_vit_tpu_torch.parallel import train
from interactive_vit_tpu_torch.tools import pretrain
from interactive_vit_tpu_torch.tools.convert import convert
from interactive_vit_tpu_torch.tools.train import pattern_set
from interactive_vit_tpu_torch.utils.safetensors_io import load_file

torch.set_num_threads(2)

ENC = dict(img_size=32, patch=8, width=32, depth=2, heads=2)
DEC = dict(dec_width=16, dec_depth=1, dec_heads=2)
CFG = mae.MAEConfig("mae_micro", "vit_t16",
                    enc_override=vit.ViTConfig("e", **ENC), **DEC)
JCFG = jmae.MAEConfig("mae_micro", "vit_t16",
                      enc_override=jvit.ViTConfig("e", **ENC), **DEC)


class _SGD:
    """Plain SGD in the optimizer protocol: at lr 1 a step's params are
    p - g."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        return train.tree_map_with_path(lambda _, g: -self.lr * g,
                                        grads), state


@pytest.fixture(scope="module")
def params():
    jp = jmae.init_params(jax.random.key(4), JCFG)
    # a non-zero mask token and decoder biases, so that a misplaced one
    # shows in the gradients
    jp = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(
        jax.random.key(a.size), a.shape), jp)
    jp = jax.tree.map(np.asarray, jp)
    return from_jax(jp), jp


def _img(seed, n=4):
    return np.random.default_rng(seed).random((n, 3, 32, 32), np.float32)


def _jkey(seed, step, i=None):
    key = jax.random.fold_in(jax.random.key(seed + 0xAE), step)
    return key if i is None else jax.random.fold_in(key, i)


def _tkey(seed, step, i=None):
    key = fold_in(prng_key(seed + 0xAE), step)
    return key if i is None else fold_in(key, i)


@pytest.mark.parametrize("i", [None, 0, 1])
@pytest.mark.parametrize("step", [0, 7, 123456])
@pytest.mark.parametrize("seed", [0, 3])
def test_folded_key_masks_are_jax_bit_for_bit(seed, step, i):
    """``fold_in(key(seed + 0xAE), step)`` (and ``fold_in(., i)`` for a
    microbatch): the kept ids, the mask and the restore order exactly."""
    b, length, keep = 3, 16, 4
    jk, jm, jr = jmae.random_masking(_jkey(seed, step, i), b, length, keep)
    tk, tm, tr = mae.random_masking(_tkey(seed, step, i), b, length, keep,
                                    torch.device("cpu"))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def _grads(tp, images, key, **kw):
    leaves = [x.detach().clone().requires_grad_(True)
              for x in train.tree_leaves(tp)]
    loss = mae.forward_pretrain(train.tree_unflatten(tp, leaves),
                                torch.from_numpy(images), CFG, key,
                                **kw)["loss"]
    return loss.detach(), [g.numpy() for g in
                           torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("mask_ratio", [None, 0.5])
def test_mae_loss_and_grads_match_jax(params, mask_ratio):
    tp, jp = params
    images = _img(1)
    jloss, jg = jax.value_and_grad(lambda p: jmae.forward_pretrain(
        p, jnp.asarray(images), JCFG, _jkey(2, 5),
        mask_ratio=mask_ratio)["loss"])(jp)
    loss, grads = _grads(tp, images, _tkey(2, 5), mask_ratio=mask_ratio)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=2e-4,
                               rtol=1e-3)
    for (path, _), a, b in zip(train.tree_leaves_with_path(tp), grads,
                               jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=1e-3,
                                   err_msg=path)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_mae_remat_gives_the_values_of_no_remat(params, remat):
    tp, _ = params
    images = _img(2)
    want = _grads(tp, images, _tkey(0, 1))
    got = _grads(tp, images, _tkey(0, 1),
                 block_wrapper=train.remat_wrapper(remat))
    np.testing.assert_allclose(got[0].item(), want[0].item(), atol=1e-6)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("accum", [1, 2])
def test_mae_step_matches_jax(params, accum):
    """One SGD step at lr 1 of JAX's ``make_mae_train_step`` and the
    port's: the loss and p0 - p1 of every parameter (under accumulation
    each microbatch draws from fold_in(key, i) in both)."""
    tp, jp = params
    images = _img(3)
    jstep = jtrain.make_mae_train_step(JCFG, optax.sgd(1.0),
                                       accum_steps=accum)
    tstep = train.make_mae_train_step(CFG, _SGD(1.0), accum_steps=accum)
    jp1, _, jloss = jstep(jp, optax.sgd(1.0).init(jp), jnp.asarray(images),
                          _jkey(1, 9))
    tp1, _, loss = tstep(tp, {}, torch.from_numpy(images), _tkey(1, 9))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=2e-4,
                               rtol=1e-3)
    for (path, a0), a1, b0, b1 in zip(
            train.tree_leaves_with_path(tp), train.tree_leaves(tp1),
            jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(jp1)):
        np.testing.assert_allclose(a0.numpy() - a1.numpy(),
                                   np.asarray(b0) - np.asarray(b1),
                                   atol=2e-4, rtol=1e-3, err_msg=path)


def test_accum_microbatches_draw_their_own_masks(params):
    """accum_steps=2 is not the full-batch step: its microbatches' masks
    come from fold_in(key, 0) and fold_in(key, 1)."""
    tp, _ = params
    images = _img(4)
    key = _tkey(0, 2)
    step = train.make_mae_train_step(CFG, _SGD(1.0), accum_steps=2)
    _, _, loss = step(tp, {}, torch.from_numpy(images), key)
    with torch.no_grad():
        want = [mae.forward_pretrain(tp, torch.from_numpy(images[2 * i:
                                                                 2 * i + 2]),
                                     CFG, fold_in(key, i))["loss"]
                for i in range(2)]
    np.testing.assert_allclose(loss.item(), float(sum(want) / 2), atol=1e-6)


def test_linear_probe_equals_jax():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, size=60)
    feats = (np.eye(5)[labels] * 2.0
             + rng.standard_normal((60, 5)) * 0.5).astype(np.float32)
    assert pretrain.linear_probe(feats, labels, 5) == jprobe(feats, labels,
                                                             5)
    assert pretrain.linear_probe(feats[:4], labels[:4], 5) == jprobe(
        feats[:4], labels[:4], 5)


def test_setup_mae_steps_on_the_cpu():
    params, state, step = train.setup_mae(CFG, device="cpu", seed=3)
    images = torch.from_numpy(_img(5))
    losses = []
    for s in range(3):
        params, state, loss = step(params, state, images, _tkey(3, s))
        losses.append(loss.item())
    assert state["count"] == 3 and all(np.isfinite(losses))


def _run(tmp_path, *extra):
    return pretrain.main([
        "--device", "cpu", "--variant", "mae_t16@64", "--batch", "8",
        "--memorize", "16", "--distinct-classes", "4", "--log-every", "1",
        *extra])


def _dataset(tmp_path) -> str:
    """The --memorize set of ``_run`` saved for ``--data``."""
    images, labels = pattern_set(0, 16, 64, 4, 4)
    prefix = str(tmp_path / "ds")
    save_dataset(prefix, images, labels.astype(np.int64))
    return prefix


def test_pretrain_cli_exports_resumes_and_serves(tmp_path):
    """A tiny run of mae_t16@64 through ``--data``: both exports, a run
    resumed from its state ends on the uninterrupted run's params bit for
    bit (the loader skips the consumed batches, as in the JAX package),
    the exported encoder loads into the port's vit_t16@64 (its logits, the
    CLS features, within 1e-5 of JAX's forward on the same file), and the
    full tree serves through the port's MAE plugin."""
    out, enc, full = (str(tmp_path / n) for n in
                      ("ckpt", "enc.safetensors", "full.safetensors"))
    data = ["--data", _dataset(tmp_path)]
    whole = _run(tmp_path, "--steps", "4", "--export-encoder", enc,
                 "--export-safetensors", full, "--probe", *data)
    assert os.path.exists(enc) and os.path.exists(full)
    assert all(np.isfinite(x) for _, x, _ in whole["history"])
    assert len(whole["probe"]) == 2
    assert all(0.0 <= acc <= 1.0 for acc in whole["probe"])
    first = _run(tmp_path, "--steps", "2", "--output", out, *data)
    resumed = _run(tmp_path, "--steps", "4", "--output", out, "--resume",
                   *data)
    assert first["start_step"] == 0 and resumed["start_step"] == 2
    for a, b in zip(train.tree_leaves(resumed["params"]),
                    train.tree_leaves(whole["params"])):
        assert torch.equal(a, b)
    assert os.path.isdir(os.path.join(out, "params"))

    sd = load_file(enc)
    tvit = convert("vit_t16@64", "auto", sd)
    jtree = jconvert("vit_t16@64", "auto", sd)
    x = np.random.default_rng(6).random((2, 3, 64, 64), np.float32)
    got = vit.forward(tvit, torch.from_numpy(x),
                      vit.resolve_variant("vit_t16@64"))["logits"]
    want = jvit.forward(jtree, jnp.asarray(x),
                        jvit.resolve_variant("vit_t16@64"))["logits"]
    assert got.shape == (2, 192)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    tree = from_native_flat(load_file(full))
    m = make_mae_model("mae_t16@64", params=tree, device="cpu")
    assert m.list_node_names() == ["mae_t16@64:transform",
                                   "mae_t16@64:reconstruct"]


def test_memorize_resume_reseeds_as_jax(tmp_path, monkeypatch):
    """A ``--memorize`` run resumed at step 2 draws its batch indices from
    ``default_rng(seed + 2)``, as the JAX pretrainer does (and the port's
    trainer): each step's images are the set's rows at those indices."""
    out = str(tmp_path / "ckpt")
    _run(tmp_path, "--steps", "2", "--output", out, "--seed", "5")
    seen = []
    setup_mae = train.setup_mae

    def recording(*a, **kw):
        params, state, step = setup_mae(*a, **kw)

        def step_and_record(p, s, images, key):
            seen.append(images.clone())
            return step(p, s, images, key)

        return params, state, step_and_record

    monkeypatch.setattr(train, "setup_mae", recording)
    resumed = _run(tmp_path, "--steps", "4", "--output", out, "--resume",
                   "--seed", "5")
    assert resumed["start_step"] == 2 and len(seen) == 2
    images = torch.from_numpy(pattern_set(5, 16, 64, 4, 4)[0])
    rng = np.random.default_rng(5 + 2)
    for got in seen:
        assert torch.equal(got, images[rng.integers(0, 16, size=(8,))])


def test_pretrain_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain.main(["--steps", "1"])


@pytest.mark.parametrize("flags", [["--mesh", "pipe=2"],
                                   ["--platform", "cpu"],
                                   ["--batch", "6", "--accum-steps", "4"]])
def test_pretrain_refuses_unported_and_bad_flags(flags):
    with pytest.raises(SystemExit):
        pretrain.parse_args(["--device", "cpu", *flags])
