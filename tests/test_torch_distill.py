"""DeiT distillation in the port (``models/vit.head_split``,
``parallel/train``'s distillation step and ``setup_distill``, the trainer's
``--distill-teacher``) against the JAX package, on the CPU, on shared
inputs: JAX's toy student and teacher (``tests/test_distill.py``), their
JAX inits through ``weights.from_jax``, images and labels from numpy.

Tolerances, each with its reason:

* ``head_split`` and ``_student_logits``: 1e-5 (the same f32 products,
  summed in other orders);
* the hard and soft losses and every gradient: 2e-4 absolute / 1e-3
  relative, the bound of ``tests/test_torch_train.py``'s loss-and-grads
  test (the two frameworks' f32 matmuls sum in other orders through two
  blocks forward and back);
* three SGD steps: 1e-5 on every parameter (lr 1e-2 times gradients within
  the bound above);
* an ``accum_steps=2`` step against the full batch: 1e-5 (the JAX
  package's own bound for the same identity);
* a head-major student against the canonical one: 1e-5 (the same products
  on permuted columns).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.parallel import train as jtrain
from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import attention_vjp as av
from interactive_vit_tpu_torch.parallel import mesh
from interactive_vit_tpu_torch.parallel import train
from interactive_vit_tpu_torch.tools import train as train_tool

torch.set_num_threads(2)

STUDENT_KW = dict(img_size=32, patch=16, width=64, depth=2, heads=4,
                  num_classes=8, distilled=True)
TEACHER_KW = dict(img_size=32, patch=16, width=96, depth=2, heads=4,
                  num_classes=8)
JSTUDENT = jvit.ViTConfig("deit_tiny_test", **STUDENT_KW)
JTEACHER = jvit.ViTConfig("teacher_test", **TEACHER_KW)
STUDENT = vit.ViTConfig("deit_tiny_test", **STUDENT_KW)
TEACHER = vit.ViTConfig("teacher_test", **TEACHER_KW)


class _SGD:
    """Plain SGD in the optimizer protocol (``tests/test_torch_train.py``'s):
    with lr 1 a step's params are p - g, so both packages' gradients are
    read off one step."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        return train.tree_map_with_path(lambda _, g: -self.lr * g,
                                        grads), state


def _params(jcfg, seed):
    jp = jax.tree.map(np.asarray, jvit.init_params(jax.random.key(seed),
                                                   jcfg))
    return jp, from_jax(jp)


def _batch(seed=0, n=8):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 8, size=(n,))
    images = (rng.normal(size=(n, 3, 32, 32)).astype(np.float32) * 0.3
              + (labels[:, None, None, None] / 8).astype(np.float32))
    return images, labels


def _np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _tnp(tree):
    return [x.detach().float().numpy() for x in train.tree_leaves(tree)]


@pytest.fixture(scope="module")
def shared():
    """(JAX student, port student, JAX teacher, port teacher)."""
    js, ts = _params(JSTUDENT, 0)
    jt, tt = _params(JTEACHER, 7)
    return js, ts, jt, tt


@pytest.mark.parametrize("distilled", [True, False])
def test_head_split_matches_jax(shared, distilled):
    js, ts, jt, tt = shared
    jp, tp = (js, ts) if distilled else (jt, tt)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 64 if distilled else 96)).astype(
        np.float32)
    jcls, jdist = jvit.head_split(jp, jnp.asarray(x))
    cls, dist = vit.head_split(tp, torch.from_numpy(x))
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=1e-5)
    if distilled:
        np.testing.assert_allclose(dist.numpy(), np.asarray(jdist),
                                   atol=1e-5)
    else:
        assert dist is None and jdist is None


def test_head_split_refuses_a_headless_tree(shared):
    _, ts, _, _ = shared
    headless = {**ts, "head": {}}
    with pytest.raises(ValueError, match="head_split needs a classifier "
                                         "head"):
        vit.head_split(headless, torch.zeros(1, 2, 64))


def test_student_logits_match_jax(shared):
    js, ts, _, _ = shared
    images, _ = _batch(3)
    jcls, jdist = jtrain._student_logits(js, jnp.asarray(images), JSTUDENT)
    cls, dist = train._student_logits(ts, torch.from_numpy(images), STUDENT)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=1e-5)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), atol=1e-5)


@pytest.mark.parametrize("tau", [0.0, 2.0])
def test_distill_loss_and_grads_match_jax(shared, tau):
    """One SGD step at lr 1: the loss and p0 - p1 (the gradient) of every
    student parameter, the JAX step's against the port's."""
    js, ts, jt, tt = shared
    images, labels = _batch(2)
    jstep = jtrain.make_distill_train_step(JSTUDENT, JTEACHER, jt,
                                           optax.sgd(1.0), tau=tau,
                                           alpha=0.4)
    tstep = train.make_distill_train_step(STUDENT, TEACHER, tt, _SGD(1.0),
                                          tau=tau, alpha=0.4)
    jp1, _, jloss = jstep(js, optax.sgd(1.0).init(js), jnp.asarray(images),
                          jnp.asarray(labels))
    tp1, _, loss = tstep(ts, {}, torch.from_numpy(images),
                         torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=2e-4,
                               rtol=1e-3)
    for (path, a0), a1, b0, b1 in zip(train.tree_leaves_with_path(ts),
                                      _tnp(tp1), _np(js), _np(jp1)):
        np.testing.assert_allclose(a0.numpy() - a1, b0 - b1, atol=2e-4,
                                   rtol=1e-3, err_msg=path)


@pytest.mark.parametrize("tau", [0.0, 1.0])
def test_three_sgd_distill_steps_match_jax(shared, tau):
    js, ts, jt, tt = shared
    jopt = optax.sgd(1e-2)
    jstep = jtrain.make_distill_train_step(JSTUDENT, JTEACHER, jt, jopt,
                                           tau=tau)
    tstep = train.make_distill_train_step(STUDENT, TEACHER, tt, _SGD(1e-2),
                                          tau=tau)
    jstate, jparams, tparams, tstate = jopt.init(js), js, ts, {}
    for i in range(3):
        images, labels = _batch(10 + i)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(images),
                                       jnp.asarray(labels))
        tparams, tstate, loss = tstep(tparams, tstate,
                                      torch.from_numpy(images),
                                      torch.from_numpy(labels))
        np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    for (path, a), b in zip(train.tree_leaves_with_path(tparams),
                            _np(jparams)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0,
                                   err_msg=path)


@pytest.mark.parametrize("tau", [0.0, 1.0])
def test_distill_accum_matches_full_batch(shared, tau):
    _, ts, _, tt = shared
    images, labels = _batch(4)
    out = []
    for accum in (1, 2):
        step = train.make_distill_train_step(STUDENT, TEACHER, tt,
                                             _SGD(1e-2), tau=tau,
                                             accum_steps=accum)
        params, _, loss = step(ts, {}, torch.from_numpy(images),
                               torch.from_numpy(labels))
        out.append((loss.item(), _tnp(params)))
    np.testing.assert_allclose(out[0][0], out[1][0], atol=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("change, text", [
    ("plain", "has no distillation token/head"),
    ("resolution", "teacher resolution 64 != student 32"),
    ("classes", "teacher classes 16 != student 8")])
def test_distill_validation_errors(shared, change, text):
    """JAX's three ValueErrors, with their texts."""
    _, _, _, tt = shared
    student, teacher = STUDENT, TEACHER
    if change == "plain":
        student = dataclasses.replace(STUDENT, distilled=False)
    elif change == "resolution":
        teacher = dataclasses.replace(TEACHER, img_size=64)
    else:
        teacher = dataclasses.replace(TEACHER, num_classes=16)
    with pytest.raises(ValueError, match=text):
        train.make_distill_train_step(student, teacher, tt)


def test_head_major_student_matches_the_canonical_one():
    """A student whose heads pack (2 of 64) trains head-major through the
    packed path, the teacher canonical through the [B, H, N, dh] one: the
    loss and the unpermuted gradients equal the canonical student's."""
    jcfg = jvit.ViTConfig("deit_hm", img_size=32, patch=16, width=128,
                          depth=2, heads=2, num_classes=8, distilled=True)
    cfg = vit.ViTConfig("deit_hm", img_size=32, patch=16, width=128,
                        depth=2, heads=2, num_classes=8, distilled=True)
    _, tp = _params(jcfg, 3)
    _, tt = _params(JTEACHER, 7)
    assert train.wants_head_major(cfg, av.trainable_flash_mhsa)
    images, labels = _batch(5)
    out = []
    for hm in (False, True):
        step = train.make_distill_train_step(
            cfg, TEACHER, tt, _SGD(1.0), attn_impl=av.trainable_flash_mhsa,
            qkv_head_major=hm, tau=1.0)
        p0 = mesh.permute_qkv_head_major(tp, cfg.heads) if hm else tp
        p1, _, loss = step(p0, {}, torch.from_numpy(images),
                           torch.from_numpy(labels))
        grads = train.tree_unflatten(p0, [a - b for a, b in zip(
            train.tree_leaves(p0), train.tree_leaves(p1))])
        if hm:
            grads = mesh.unpermute_qkv_head_major(grads, cfg.heads)
        out.append((loss.item(), _tnp(grads)))
    np.testing.assert_allclose(out[1][0], out[0][0], atol=1e-5)
    for a, b in zip(out[1][1], out[0][1]):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_teacher_stays_out_of_autograd_and_the_state(shared):
    """setup_distill: the optimizer state holds the student's leaves only,
    the teacher's logits carry no graph, and a step leaves the teacher's
    params unchanged."""
    _, _, _, tt = shared
    before = [x.clone() for x in train.tree_leaves(tt)]
    params, state, step, infer = train.setup_distill(
        STUDENT, TEACHER, tt, device="cpu", seed=1)
    n_student = len(train.tree_leaves(params))
    assert len(train.tree_leaves(state["mu"])) == n_student
    assert [tuple(x.shape) for x in train.tree_leaves(state["mu"])] == [
        tuple(x.shape) for x in train.tree_leaves(params)]
    teacher = train.make_teacher_fn(TEACHER, tt)
    images, labels = _batch(6)
    x = torch.from_numpy(images).requires_grad_(True)
    assert not teacher(x).requires_grad
    params, state, loss = step(params, state, torch.from_numpy(images),
                               torch.from_numpy(labels))
    assert torch.isfinite(loss) and state["count"] == 1
    for a, b in zip(train.tree_leaves(tt), before):
        assert torch.equal(a, b) and not a.requires_grad
    assert infer(params, images).shape == (8, 8)


def test_distill_cli_exports_a_teacher_then_distils(tmp_path, monkeypatch):
    """The trainer trains a teacher and exports it, then distils a student
    from the export (JAX's ``test_distill_cli_end_to_end`` with
    ``--device cpu``); the student's saved state holds no teacher leaf."""
    from interactive_vit_tpu_torch.utils.checkpoint import (
        load_params, state_keys,
    )

    monkeypatch.setitem(vit.VARIANTS, "teacher_test", TEACHER)
    monkeypatch.setitem(vit.VARIANTS, "deit_tiny_test", STUDENT)
    t_ckpt = str(tmp_path / "teacher.safetensors")
    common = ["--device", "cpu", "--steps", "3", "--batch", "8",
              "--memorize", "8", "--distinct-classes", "4",
              "--log-every", "1"]
    train_tool.main(["--variant", "teacher_test", *common,
                     "--export-safetensors", t_ckpt])
    out = str(tmp_path / "student")
    res = train_tool.main(["--variant", "deit_tiny_test", *common,
                           "--distill-teacher", t_ckpt,
                           "--teacher-variant", "teacher_test",
                           "--distill-tau", "1", "--output", out])
    assert all(np.isfinite(loss) for _, loss, _ in res["history"])
    state = os.path.join(out, "state")
    assert sorted(state_keys(state)) == ["opt_state", "params",
                                         "qkv_head_major", "step"]
    saved = load_params(state, device="cpu")
    n_student = len(train.tree_leaves(res["params"]))
    assert len(train.tree_leaves(saved["params"])) == n_student
    assert len(train.tree_leaves(saved["opt_state"]["mu"])) == n_student
    assert "head_dist" in saved["params"]


@pytest.mark.parametrize("flags", [
    ["--distill-teacher", "t.safetensors"],
    ["--teacher-variant", "vit_t16"]])
def test_teacher_flags_go_together(flags):
    with pytest.raises(SystemExit):
        train_tool.parse_args(["--device", "cpu", *flags])

