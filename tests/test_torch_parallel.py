"""The port's parallelism (``parallel/{mesh,sequence,sp_attention,
pipeline,train}.py``, ``models/moe.py``'s expert parallelism) on four gloo
ranks, held against the JAX functions on a mesh of the same shape built
from ``jax.devices()[:4]``.

One module-scoped spawn runs ``tools/dryrun_multichip.run_cases`` on four
processes (``tests/torch_parallel_worker.py``: ``OMP_NUM_THREADS=1``, no
JAX, joined through a ``file://`` under ``tmp_path``) on JAX's inits
(``models/weights.from_jax``) and numpy inputs; rank 0's results come back
in an .npz.

Tolerances, each with its reason (f32 on both sides):

* ring and Ulysses (outputs and Ulysses' maps), the pipelined forward and
  its tap: 1e-5 (the same f32 products; the online softmax and the
  matmuls sum in other orders);
* three ``setup_sharded`` steps at ``data=2,model=2`` with accumulation 2,
  one ``setup_sharded_distill`` and one ``setup_sharded_mae`` step (plain
  SGD on both sides, so the params compare the gradients): losses and
  params 1e-5, the three-step test's bound (``test_torch_train.py``);
* the MoE step's loss with the load-balance term: 1e-5;
* the expert-parallel MoE forward, Swin's DP x TP logits and its shifted
  block's maps, the ToMe and ConvNeXt DP logits: 1e-4 (the JAX dry run's
  forward bound: GSPMD's partial sums and the port's row-parallel
  all-reduce add the halves of each product in other orders).
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from interactive_vit_tpu.data import augment as jaug
from interactive_vit_tpu.models import convnext as jcnx
from interactive_vit_tpu.models import mae as jmae
from interactive_vit_tpu.models import moe as jmoe
from interactive_vit_tpu.models import swin as jswin
from interactive_vit_tpu.models import tome as jtome
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.parallel import mesh as jmesh
from interactive_vit_tpu.parallel import pipeline as jpp
from interactive_vit_tpu.parallel import sequence as jseq
from interactive_vit_tpu.parallel import sp_attention as jsp
from interactive_vit_tpu.parallel import train as jtrain
from interactive_vit_tpu_torch.parallel import mesh as tmesh
from interactive_vit_tpu_torch.tools import dryrun_multichip as dry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
N_REAL = dry.N_REAL


def _jcfgs():
    """The dry run's configs in the JAX package's classes."""
    cfg = jvit.ViTConfig("vit_dryrun", **dry.CFG)
    return {
        "vit": cfg,
        "deit": dataclasses.replace(cfg, name="deit_dryrun", distilled=True),
        "mae": jmae.MAEConfig("mae_dryrun", "vit_t16", dec_width=32,
                              dec_depth=1, dec_heads=2, enc_override=cfg),
        "moe": jmoe.MoEViTConfig(
            "moe_dryrun", img_size=32, patch=16, width=64, depth=2, heads=4,
            num_classes=16, n_experts=4, capacity_factor=2.0),
        "tome": jtome.ToMeViTConfig(
            "tome_dryrun", img_size=32, patch=8, width=64, depth=2, heads=4,
            num_classes=16, r=3),
        "swin": jswin.SwinConfig(
            "swin_dryrun", img_size=32, patch=4, embed_dim=16, depths=(2, 2),
            heads=(2, 4), window=4, mlp_ratio=2, num_classes=16),
        "convnext": jcnx.ConvNeXtConfig(
            "cnx_dryrun", depths=(1, 1), dims=(8, 16), num_classes=16,
            img_size=32, resize_to=34),
    }


# the JAX init seed of each tree (the JAX setups init from these too)
SEEDS = {"vit": 0, "deit": 1, "teacher": 6, "mae": 7, "moe": 2, "tome": 3,
         "swin": 4, "convnext": 5}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs():
    """JAX's inits (numpy) and the dry run's numpy inputs."""
    c = _jcfgs()
    fam = {"vit": (jvit, c["vit"]), "deit": (jvit, c["deit"]),
           "teacher": (jvit, c["vit"]), "mae": (jmae, c["mae"]),
           "moe": (jmoe, c["moe"]), "tome": (jtome, c["tome"]),
           "swin": (jswin, c["swin"]), "convnext": (jcnx, c["convnext"])}
    # jitted: JAX's eager init dispatches every op alone (seconds a tree)
    out = {k: _np_tree(jax.jit(mod.init_params, static_argnums=1)(
        jax.random.key(SEEDS[k]), cfg)) for k, (mod, cfg) in fam.items()}
    rng = np.random.default_rng(0)
    out["batches"] = [(rng.random((dry.BATCH, 3, 32, 32), dtype=np.float32),
                       rng.integers(0, 16, size=(dry.BATCH,)))
                      for _ in range(3)]
    out["qkv"] = [rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
                  for _ in range(3)]
    out["serve_images"] = rng.random((8, 3, 32, 32), dtype=np.float32)
    return out


def _mesh(sizes):
    return jmesh.make_mesh(sizes, jax.devices()[:4])


def _flat(prefix, tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


def _jax_results(inputs):
    """Every case through the JAX functions on meshes of jax.devices()[:4]
    (each jitted)."""
    c = _jcfgs()
    want = {}
    images, labels = (jnp.asarray(a) for a in inputs["batches"][0])
    m22, m4 = _mesh({"data": 2, "model": 2}), _mesh({"data": 4})

    q, k, v = (jnp.asarray(x) for x in inputs["qkv"])
    for name, m in (("data", m4), ("model", m22)):
        def sp(q, k, v, m=m, name=name):
            uo, up = jseq.ulysses_attention(q, k, v, m, axis=name,
                                            n_real=N_REAL, want_attn=True)
            return jseq.ring_attention(q, k, v, m, axis=name,
                                       n_real=N_REAL), uo, up
        (want[f"ring_{name}"], want[f"ulysses_{name}"],
         want[f"ulysses_{name}_probs"]) = jax.jit(sp)(q, k, v)

    cfg = c["vit"]
    vp = jax.tree.map(jnp.asarray, inputs["vit"])
    mp = _mesh({"data": 2, "stage": 2})

    def pipe(p, x):
        emb = jvit.embed(p, x, cfg)
        y, taps = jpp.pipeline_apply_stacked(
            jpp._stack_blocks(p["blocks"]), emb,
            lambda bp, h: jvit.block(bp, h, cfg)[0], mp, tap_layers=(0,))
        return jpp.pipelined_vit_forward(p, x, cfg, mp), y, taps[0]
    (want["pipeline_logits"], want["pipeline_trunk"],
     want["pipeline_tap0"]) = jax.jit(pipe)(vp, images)

    sgd = optax.sgd(1e-2)
    with m22:
        p, o, step, _ = jtrain.setup_sharded(
            cfg, m22, seed=SEEDS["vit"], optimizer=sgd, remat=True,
            accum_steps=2)
        losses = []
        for im, lb in inputs["batches"]:
            p, o, loss = step(p, o, jnp.asarray(im), jnp.asarray(lb))
            losses.append(float(loss))
        want["train3_loss"] = np.asarray(losses)
        want.update(_flat("train3_params",
                          jmesh.unpermute_qkv_head_major(p, cfg.heads)))

        aug = jaug.make_augment_fn(
            jaug.AugmentConfig(hflip=True, crop_pad=2, cutout=4,
                               mixup_alpha=0.5, cutmix_alpha=1.0), 16,
            base_key=jax.random.key(3 + 0x5EED),
            batch_sharding=jmesh.batch_sharding(m22))
        a_im, want["train_aug_labels"] = aug(0, images, labels)
        p, o, step, infer = jtrain.setup_sharded(cfg, m22, seed=SEEDS["vit"],
                                                 remat=False)
        want["train_aug_logits"] = infer(p, images)
        want["train_aug_loss"] = step(p, o, a_im,
                                      want["train_aug_labels"])[2]

        p, o, step, _ = jtrain.setup_sharded_distill(
            c["deit"], cfg, inputs["teacher"], m22, seed=SEEDS["deit"],
            optimizer=sgd)
        p, o, want["distill_loss"] = step(p, o, images, labels)
        want.update(_flat("distill_params",
                          jmesh.unpermute_qkv_head_major(p, cfg.heads)))

        p, o, step = jtrain.setup_sharded_mae(c["mae"], m22,
                                              seed=SEEDS["mae"],
                                              optimizer=sgd)
        p, o, want["mae_loss"] = step(p, o, images, jax.random.key(0))
        want.update(_flat("mae_params", p))

        bsh = jmesh.batch_sharding(m22)
        xs = jax.device_put(images, bsh)
        want["moe_logits"] = jax.jit(
            lambda p, i: jmoe.forward(p, i, c["moe"])["logits"])(
                jmesh.shard_params(inputs["moe"], m22), xs)
        p, o, step, _ = jtrain.setup_sharded(
            c["moe"], m22, seed=SEEDS["moe"], optimizer=sgd, remat=False)
        want["moe_loss"] = step(p, o, images, labels)[2]

        so = jax.jit(lambda p, i: jswin.forward(p, i, c["swin"],
                                                want_attn=True))(
            jmesh.shard_params(inputs["swin"], m22), xs)
        want["swin_logits"], want["swin_maps"] = so["logits"], so["attn"][1]
    with m4:
        xs4 = jax.device_put(images, jmesh.batch_sharding(m4))
        for name, mod in (("tome", jtome), ("convnext", jcnx)):
            out = jax.jit(lambda p, i, mod=mod, name=name: mod.forward(
                p, i, c[name]))(
                jax.device_put(inputs[name], jmesh.replicated(m4)), xs4)
            want[f"{name}_logits"] = (out["logits"] if isinstance(out, dict)
                                      else out)
    return {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's rank-0 results, JAX's, the inputs): one spawn of four
    ranks, with the JAX side computed while they run."""
    tmp = tmp_path_factory.mktemp("parallel")
    inputs = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "4", str(tmp / "rdzv"),
         str(tmp / "inputs.pkl"), str(tmp / "out.npz"), "train"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        want = _jax_results(inputs)
    finally:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    got = dict(np.load(tmp / "out.npz"))
    return got, want, inputs


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol, err_msg=what)


def _close_prefix(got, want, prefix, tol=1e-5):
    keys = [k for k in want if k.startswith(prefix)]
    assert keys, prefix
    for key in keys:
        _close(got[key], want[key], tol, key)


# -- sequence parallelism -------------------------------------------------------


@pytest.mark.parametrize("name", ["data", "model"])
def test_ring_and_ulysses_match_jax(runs, name):
    """Ring (out) and Ulysses (out and the maps) with 3 padded keys, on the
    data axis of data=4 and the model axis of data=2,model=2: 1e-5."""
    got, want, _ = runs
    for key in (f"ring_{name}", f"ulysses_{name}", f"ulysses_{name}_probs"):
        _close(got[key], want[key], 1e-5, key)


def test_sequence_refusals_are_jax_s(runs):
    """Heads or tokens that do not divide the axis, and a ring asked for
    maps, raise JAX's texts."""
    got, _, inputs = runs
    q, k, v = (jnp.asarray(x) for x in inputs["qkv"])
    m = _mesh({"data": 4})

    def text(fn):
        with pytest.raises(ValueError) as err:
            fn()
        return str(err.value)

    assert str(got["err_ulysses_heads"]) == text(
        lambda: jseq.ulysses_attention(q[:, :3], k[:, :3], v[:, :3], m))
    assert str(got["err_ring_tokens"]) == text(
        lambda: jseq.ring_attention(q[:, :, :15], k[:, :, :15],
                                    v[:, :, :15], m))
    assert str(got["err_ulysses_tokens"]) == text(
        lambda: jseq.ulysses_attention(q[:, :, :15], k[:, :, :15],
                                       v[:, :, :15], m))
    assert str(got["err_ring_maps"]) == text(
        lambda: jsp.make_sp_attn_impl(m, "data", "ring")(q, k, v, True))


# -- the pipeline -----------------------------------------------------------------


def test_pipelined_forward_and_tap_match_jax(runs):
    """``pipelined_vit_forward`` and a tapped ``pipeline_apply_stacked`` on
    data=2,stage=2: logits, trunk and layer 0's tap within 1e-5; a layer
    count that does not divide the stages raises JAX's text."""
    got, want, inputs = runs
    _close_prefix(got, want, "pipeline_")
    p = inputs["vit"]
    with pytest.raises(ValueError) as err:
        jpp.pipeline_apply(p["blocks"] * 3 + p["blocks"][:1], None, None,
                           _mesh({"data": 2, "stage": 2}))
    assert str(got["err_pipeline_layers"]) == str(err.value)


# -- training on the mesh -----------------------------------------------------------


def test_three_setup_sharded_steps_match_jax(runs):
    """Three SGD steps of ``setup_sharded`` at data=2,model=2, accumulation
    2 and remat, against JAX's ``setup_sharded`` on its mesh: every loss
    and param within 1e-5; each rank's qkv_w shard is [D, 3D/2] and its
    proj_w shard [D/2, D]."""
    got, want, _ = runs
    d = dry.CFG["width"]
    assert tuple(got["train3_qkv_local"]) == (d, 3 * d // 2)
    assert tuple(got["train3_proj_local"]) == (d // 2, d)
    _close_prefix(got, want, "train3_")


def test_augmented_step_matches_jax(runs):
    """The augmentation stage drawn for the global batch (mixup / cutmix
    soft labels) and one AdamW step on data=2,model=2: the labels within
    1e-6, the inference logits 1e-4 and the loss 1e-5."""
    got, want, _ = runs
    _close(got["train_aug_labels"], want["train_aug_labels"], 1e-6)
    _close(got["train_aug_logits"], want["train_aug_logits"], 1e-4)
    _close(got["train_aug_loss"], want["train_aug_loss"], 1e-5)


def test_checkpoints_cross_between_the_mesh_and_one_rank(runs):
    """A state saved at data=2,model=2 (DTensor params and AdamW moments,
    written whole by rank 0) reads back on one rank, and a state written
    by one rank reads back onto that mesh as the same shards
    (``tools/train.save_state`` / ``load_state``): bit for bit."""
    got, _, _ = runs
    assert float(got["ckpt_mesh_to_one"]) == 0.0
    assert float(got["ckpt_one_to_mesh"]) == 0.0
    d = dry.CFG["width"]
    assert tuple(got["ckpt_qkv_local"]) == (d, 3 * d // 2)


def test_setup_sharded_distill_step_matches_jax(runs):
    """One SGD step of ``setup_sharded_distill`` (a DeiT student, head-major
    and TP-sharded, against the canonical-layout teacher): loss and params
    within 1e-5."""
    got, want, _ = runs
    _close_prefix(got, want, "distill_")


def test_setup_sharded_mae_step_matches_jax(runs):
    """One SGD step of ``setup_sharded_mae`` on data=2,model=2: the masks
    of the global batch (each rank keeps its rows), loss and params within
    1e-5."""
    got, want, _ = runs
    _close_prefix(got, want, "mae_")


def test_expert_parallel_moe_matches_jax(runs):
    """Experts over "model" (each rank holds 2 of the 4): the forward
    within 1e-4 of JAX's on the mesh, and the step's loss with the
    load-balance term (f_e and P_e averaged over "data" before their
    product) within 1e-5."""
    got, want, _ = runs
    cfg = _jcfgs()["moe"]
    assert tuple(got["moe_exp_local"]) == (2, cfg.width, cfg.mlp_dim)
    _close(got["moe_logits"], want["moe_logits"], 1e-4)
    _close(got["moe_loss"], want["moe_loss"], 1e-5)


def test_swin_dp_tp_forward_matches_jax(runs):
    """Swin on data=2,model=2 (flat qkv columns, gathered at the heads'
    split as GSPMD reshards there): logits and the shifted block's window
    maps within 1e-4."""
    got, want, _ = runs
    _close_prefix(got, want, "swin_", 1e-4)


@pytest.mark.parametrize("name", ["tome", "convnext"])
def test_data_parallel_forwards_match_jax(runs, name):
    """ToMe's merging ladder and ConvNeXt under pure DP (data=4): logits
    within 1e-4."""
    got, want, _ = runs
    _close(got[f"{name}_logits"], want[f"{name}_logits"], 1e-4)


# -- the sharding rules ---------------------------------------------------------------


@pytest.mark.parametrize("family", ["vit", "swin", "moe", "mae"])
def test_param_spec_is_jax_s_on_every_leaf(family):
    """``param_spec`` on every leaf path of the family's tree (JAX's "/"
    paths), and ``param_shardings``' tree, equal JAX's PartitionSpecs."""
    c = _jcfgs()
    mod = {"vit": jvit, "swin": jswin, "moe": jmoe, "mae": jmae}[family]
    tree = jax.eval_shape(lambda: mod.init_params(jax.random.key(0),
                                                  c[family]))
    paths = []

    def walk(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + "/" + k)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, prefix + f"/{i}")
        else:
            paths.append(prefix)

    walk(tree)
    assert paths
    specs = tmesh.param_shardings(jax.tree.map(lambda _: 0, tree))
    sharded = 0
    for path in paths:
        want = tuple(jmesh.param_spec(path))
        assert tmesh.param_spec(path) == want, path
        node = specs
        for part in path.strip("/").split("/"):
            node = node[int(part) if isinstance(node, list) else part]
        assert node == want, path
        sharded += bool(want)
    assert sharded  # the rules shard something in every family


def test_param_spec_quantized_and_pipeline_leaves():
    """The int8 children shard like their parent (the scale by its out
    dim), and a ``__pp`` subtree's leaves are stacked over "stage"."""
    for path in ("/blocks/0/qkv_w/int8_q", "/blocks/0/qkv_w/int8_s",
                 "/blocks/0/proj_w/int8_s", "/blocks/0/fc2_w/int8a8_q",
                 "/blocks/0/fc1_w/int8a8_s"):
        assert tmesh.param_spec(path) == tuple(jmesh.param_spec(path)), path
    specs = tmesh.param_shardings({"__pp0": {"qkv_w": 0}, "head": {"w": 0}})
    assert specs == {"__pp0": {"qkv_w": ("stage",)}, "head": {"w": ()}}
