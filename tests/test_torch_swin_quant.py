"""Quantized Swin (``make_swin_model(quantize=...)``, ``--dtype int8`` /
``int8w8a8``) and row 7 at chunks of 96 columns, against the JAX package on
the CPU.

Weights come from the JAX initializer and reach the port through
``models/weights.from_jax``; images are numpy arrays from a seed.

* The quantized trees ("w8", True, "w8a8") equal JAX's bit for bit (int8
  values and f32 scales): both quantize on the host in numpy.
* Logits through the executor, f32, both modes on the unfused path on both
  sides (the CPU's "auto" gives no kernel in either package), within 1e-4:
  the two frameworks differ only in the order of f32 sums, and both round
  the activations of ``linear_w8a8`` half to even.
* Row 7's plain version at d = 96 and 192 (hidden 384 / 768, the chunks of
  96 of swin_t's stages 0 and 1) within 1e-5 of the Pallas kernel in
  interpret mode, and the integer stages of the kernel's split over its
  cluster (4 and 8 slices of 96, the requantization's row max over the
  cluster) exactly the plain version's. Both round half up.
* A Swin forward (96 and 192 wide) with ``mlp_impls`` set to the port's
  W8A8 block (its plain version on the CPU) within 1e-4 of JAX's
  ``swin.forward`` with the Pallas kernel in interpret mode.
* A quantized model's saliency within 1e-4 of JAX's (both differentiate
  the dequantized plain twins).
* ``build_app(dtype_name="int8w8a8" | "int8", device="cpu")``: the blocks
  quantize the leaves the JAX server's do, and the app answers /compute.
* The routes: "mma" at every stage of swin_t / s / b in bf16, and in f32
  at all but swin_b's 1024-wide stage; "dp4a" off the 16-byte grid.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.executor import Executor as JExecutor
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import swin as jswin
from interactive_vit_tpu.models.swin_plugin import make_swin_model as jmake
from interactive_vit_tpu.ops import fused_mlp as jfm
from interactive_vit_tpu.ops import quant as jq
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph.executor import Executor
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import swin as tswin
from interactive_vit_tpu_torch.models.swin_plugin import make_swin_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import fused_mlp as fm
from interactive_vit_tpu_torch.ops import quant as tq
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.wire import schema

torch.set_num_threads(2)

ATOL = 1e-4
KERNEL_ATOL = 1e-5
NAME = "swin_q_port"
GEOM = dict(img_size=32, patch=4, embed_dim=16, depths=(2, 2), heads=(2, 4),
            window=4, num_classes=10)
# the narrow chunk's widths: stage 0 96 wide (8 x 8, hidden 384), stage 1
# 192 wide (4 x 4, hidden 768), heads 32 wide
GEOM96 = dict(img_size=32, patch=4, embed_dim=96, depths=(2, 2),
              heads=(3, 6), window=4, num_classes=10)
MODES = {"w8": "w8", "true": True, "w8a8": "w8a8"}


@pytest.fixture
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(jfm.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def jparams():
    return jswin.init_params(jax.random.key(7), jswin.SwinConfig(NAME,
                                                                **GEOM))


def _models(jparams, quantize):
    jm = jmake(NAME, params=jparams, cfg=jswin.SwinConfig(NAME, **GEOM),
               quantize=quantize)
    tm = make_swin_model(NAME, params=from_jax(jax.tree.map(np.asarray,
                                                            jparams)),
                         cfg=tswin.SwinConfig(NAME, **GEOM), device="cpu",
                         quantize=quantize)
    return jm, tm


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("mode", sorted(MODES))
def test_quantized_trees_equal_jax(jparams, mode):
    jm, tm = _models(jparams, MODES[mode])
    want = dict(_leaves(from_jax(jax.tree.map(np.asarray, jm.params))))
    got = dict(_leaves(tm.params))
    assert sorted(got) == sorted(want)
    qkeys = {tq.QKEY, tq.AQKEY}
    quantized = {p.rsplit("/", 2)[-2] for p in got
                 if p.rsplit("/", 1)[-1] in qkeys}
    assert quantized == ({"fc1_w", "fc2_w"} if mode == "w8a8" else
                         {"qkv_w", "proj_w", "fc1_w", "fc2_w"})
    for p, v in want.items():
        assert got[p].dtype == v.dtype, p
        assert torch.equal(got[p], v), p


def _chain(mod_schema, model, seed=2):
    g = mod_schema.graph_from_json(model.generate_graph_json())
    img = np.random.default_rng(seed).random((3, 36, 40), dtype=np.float32)
    g.add_input(img, g.nodes[0], "o")
    return g


def _registries(jm, tm):
    reg, jreg = Registry(), JRegistry()
    register_builtin(reg)
    jbuiltin(jreg)
    tm.register(reg)
    jm.register(jreg)
    return reg, jreg


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_logits_through_the_executor_match_jax(jparams, mode):
    jm, tm = _models(jparams, mode)
    assert tm.grad_layers is not None
    reg, jreg = _registries(jm, tm)
    g, jg = _chain(schema, tm), _chain(jschema, jm)
    head = next(n.index for n in g.nodes if n.name == f"{NAME}:head")
    got = Executor(reg, device="cpu").run(g, [(head, "o"), (2, "attn")])
    want = JExecutor(jreg).run(jg, [(head, "o"), (2, "attn")])
    for i, ch in ((head, "o"), (2, "attn")):
        np.testing.assert_allclose(got[i][ch], np.asarray(want[i][ch]),
                                   atol=ATOL, rtol=0, err_msg=f"{i} {ch}")
    # and they are quantized: the dense model's logits differ
    dense = make_swin_model(NAME, params=from_jax(jax.tree.map(
        np.asarray, jparams)), cfg=tswin.SwinConfig(NAME, **GEOM),
        device="cpu")
    reg2 = Registry()
    register_builtin(reg2)
    dense.register(reg2)
    plain = Executor(reg2, device="cpu").run(_chain(schema, dense),
                                             [(head, "o")])
    assert np.abs(plain[head]["o"] - got[head]["o"]).max() > 1e-4


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_saliency_matches_jax(jparams, mode):
    """Saliency off the head: both differentiate the plain twins with the
    int8 leaves dequantized."""
    jm, tm = _models(jparams, mode)
    reg, jreg = _registries(jm, tm)

    def build(mod_schema, model):
        g = _chain(mod_schema, model, seed=5)
        head = next(n for n in g.nodes if n.name == f"{NAME}:head")
        s = g.add_node("saliency", {"target": "max"})
        g.connect(head, "o", s, "o")
        return g, s.index

    g, si = build(schema, tm)
    jg, _ = build(jschema, jm)
    got = Executor(reg, device="cpu").run(g, [(si, "g")])[si]["g"]
    want = np.asarray(JExecutor(jreg).run(jg, [(si, "g")])[si]["g"])
    assert np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# -- row 7 at chunks of 96 ----------------------------------------------------------


def _w8a8_params(d, md, seed):
    rng = np.random.default_rng(seed)
    jp = {"ln2_s": 1.0 + 0.2 * rng.standard_normal(d),
          "ln2_b": 0.2 * rng.standard_normal(d),
          "fc1_w": rng.standard_normal((d, md)) * d ** -0.5,
          "fc1_b": 0.2 * rng.standard_normal(md),
          "fc2_w": rng.standard_normal((md, d)) * md ** -0.5,
          "fc2_b": 0.2 * rng.standard_normal(d)}
    jp = {k: jnp.asarray(v.astype(np.float32)) for k, v in jp.items()}
    for name in ("fc1_w", "fc2_w"):
        jp[name] = jq.quantize_weight(jp[name], "w8a8")
    return jp, from_jax(jax.tree.map(np.asarray, jp))


def w8a8_split(x, p, eps=1e-6):
    """Row 7's tensor-core arithmetic at chunks of 96, in its order: q1 of
    the whole row in every block; on each of the cluster's slices acc1, h,
    the GELU and the slice's row max |h|; sx2 from the max over the
    cluster; q2 and the s32 fc2 partial of each slice, summed. Returns the
    integer stages."""
    d = x.shape[-1]
    md = p["fc1_w"][tq.AQKEY].shape[-1]
    s = fm.cluster_of(d, md)
    sl = md // s
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    ln = ((xf - mu) * torch.rsqrt(var + eps) * p["ln2_s"] + p["ln2_b"])
    q1, sx1 = tq.quant_rows_mosaic(ln.to(x.dtype).float())
    acc1, hs = [], []
    for r in range(s):
        cols = slice(r * sl, (r + 1) * sl)
        a1 = tq.int_matmul(q1, p["fc1_w"][tq.AQKEY][:, cols])
        h = (a1.float() * (sx1 * p["fc1_w"][tq.ASKEY][cols])
             + p["fc1_b"][cols].float())
        hs.append(torch.nn.functional.gelu(h.to(x.dtype),
                                           approximate="tanh").float())
        acc1.append(a1)
    m = torch.stack([h.abs().amax(dim=-1, keepdim=True) for h in hs]).amax(0)
    sx2 = torch.where(m == 0, torch.ones_like(m), m / 127.0)
    q2, acc2 = [], 0
    for r in range(s):
        q = torch.clamp(torch.floor(hs[r] / sx2 + 0.5), -127, 127).to(
            torch.int8)
        acc2 = acc2 + tq.int_matmul(q, p["fc2_w"][tq.AQKEY][r * sl:
                                                             (r + 1) * sl])
        q2.append(q)
    return {"q1": q1, "acc1": torch.cat(acc1, -1), "q2": torch.cat(q2, -1),
            "acc2": acc2}


@pytest.mark.parametrize("d,cluster", [(96, 4), (192, 8)])
@pytest.mark.parametrize("batch,n", [(1, 9), (2, 7)])
def test_row7_plain_version_at_96_chunks_matches_pallas(
        pallas_interpret, d, cluster, batch, n):
    md = 4 * d
    assert fm.chunk_of(d) == fm.MMA_NARROW_CHUNK
    assert fm.cluster_of(d, md) == cluster and md // cluster == 96
    jp, tp = _w8a8_params(d, md, d + batch)
    x = np.random.default_rng(n).standard_normal((batch, n, d)).astype(
        np.float32)
    want = np.asarray(jfm.fused_mlp_w8a8_block(jnp.asarray(x), jp, 1e-6,
                                               block_q=8))
    y, parts = fm.fused_mlp_w8a8_block(torch.from_numpy(x), tp,
                                       want_parts=True)
    np.testing.assert_allclose(y.numpy(), want, atol=KERNEL_ATOL, rtol=0)
    split = w8a8_split(torch.from_numpy(x), tp)
    for k in ("q1", "acc1", "q2", "acc2"):
        assert torch.equal(split[k], parts[k]), k


def test_swin_forward_with_the_w8a8_block_matches_pallas(pallas_interpret):
    """The 96 / 192-wide geometry's forward with fc1 / fc2 W8A8 and each
    stage's MLP through the W8A8 block: the port's plain version against
    the interpreted Pallas kernel."""
    jcfg = jswin.SwinConfig("swin_q96", **GEOM96)
    tcfg = tswin.SwinConfig("swin_q96", **GEOM96)
    jp = jq.quantize_tree(jswin.init_params(jax.random.key(9), jcfg),
                          names=frozenset({"fc1_w", "fc2_w"}), mode="w8a8")
    tp = from_jax(jax.tree.map(np.asarray, jp))
    imgs = np.random.default_rng(9).random((2, 3, 32, 32), np.float32)
    want = jswin.forward(jp, jnp.asarray(imgs), jcfg,
                         mlp_impls=[functools.partial(
                             jfm.fused_mlp_w8a8_block, block_q=8)] * 2)
    got = tswin.forward(tp, torch.from_numpy(imgs), tcfg,
                        mlp_impls=[fm.fused_mlp_w8a8_block] * 2)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL, rtol=0)


# -- the server -------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["int8w8a8", "int8"])
def test_build_app_quantizes_the_leaves_the_jax_server_does(
        tmp_path, monkeypatch, jparams, dtype_name):
    from interactive_vit_tpu.serving.server import build_app as jbuild
    from interactive_vit_tpu_torch.serving.server import build_app
    from interactive_vit_tpu_torch.wire.codec import Request, Response

    monkeypatch.setitem(jswin.VARIANTS, NAME, jswin.SwinConfig(NAME, **GEOM))
    monkeypatch.setitem(tswin.VARIANTS, NAME, tswin.SwinConfig(NAME, **GEOM))
    japp = jbuild(models=[NAME], graphs_dir=str(tmp_path / "j"),
                  dtype_name=dtype_name, speculate=False)
    try:
        jstages = japp.reg.get_node(NAME + ":stages.0.0").model.params[
            "stages"]
    finally:
        japp.batcher.stop()
    app = build_app(models=[NAME], graphs_dir=str(tmp_path / "t"),
                    dtype_name=dtype_name, device="cpu")
    try:
        stages = app.reg.get_node(NAME + ":stages.0.0").model.params[
            "stages"]
        for s, blocks in enumerate(stages):
            for b, blk in enumerate(blocks):
                quantized = {k for k, v in blk.items() if isinstance(v, dict)}
                jblk = jstages[s][b]
                assert quantized == {k for k, v in jblk.items()
                                     if isinstance(v, dict)}, (s, b)
                assert quantized == ({"fc1_w", "fc2_w"}
                                     if dtype_name == "int8w8a8" else
                                     {"qkv_w", "proj_w", "fc1_w", "fc2_w"})
                assert blk["ln1_s"].dtype == torch.bfloat16
        g = schema.graph_from_json(app.graphs.load(NAME + ".json"))
        img = np.random.default_rng(1).random((3, 40, 48), dtype=np.float32)
        g.add_input(img, g.nodes[0], "o")
        head = next(n.index for n in g.nodes if n.name == f"{NAME}:head")
        outs = Response.decode(app.compute(Request.encode(g)))
        logits = np.asarray(outs[head]["o"])
        assert logits.shape == (1, 10) and np.isfinite(logits).all()
    finally:
        app.close()


# -- the routes -------------------------------------------------------------------

STAGES = [(v, s) for v in ("swin_t", "swin_s", "swin_b") for s in range(4)]


@pytest.mark.parametrize("variant,stage", STAGES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a8_route_takes_every_swin_stage(variant, stage, dtype):
    """bf16 (the served dtype) takes the tensor cores at every stage; f32
    at all but swin_b's 1024-wide last stage, whose block (265,984 bytes)
    is over the card's 232,448; off the 16-byte grid the __dp4a kernel."""
    cfg = tswin.VARIANTS[variant]
    d = cfg.stage_dim(stage)
    md = d * cfg.mlp_ratio
    tc = not (dtype == torch.float32 and d == 1024)
    assert fm.fits_w8a8_mma(d, md, dtype) == tc
    assert fm.w8a8_route(dtype, d, md, (0, 256, 512)) == (
        "mma" if tc else "dp4a")
    assert fm.w8a8_route(dtype, d, md, (0, 256, 516)) == "dp4a"
    if d == 1024 and dtype == torch.float32:
        assert fm.w8a8_mma_smem_bytes(d, md, 4) == 265984


def test_w8a8_without_kernels_raises_jax_text(jparams):
    with pytest.raises(ValueError) as jerr:
        jmake(NAME, params=jparams, cfg=jswin.SwinConfig(NAME, **GEOM),
              quantize="w8a8", kernels=False)
    with pytest.raises(ValueError) as err:
        make_swin_model(NAME, cfg=tswin.SwinConfig(NAME, **GEOM),
                        device="cpu", quantize="w8a8", kernels=False)
    assert str(err.value) == str(jerr.value)
