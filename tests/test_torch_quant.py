"""The port's int8 serving modes against the JAX package's, on the CPU.

Shared inputs are made with numpy (or the JAX initializer) from a seed and
handed to both packages; quantized trees cross with
``models/weights.from_jax``. What is held, and how closely:

* ``quantize_weight`` / ``quantize_tree``: bit for bit (both quantize on the
  host in numpy, half to even);
* ``quantize_acts`` (half to even) and ``quant_rows_mosaic`` /
  ``quant_cols_mosaic`` (half up): equal int8 values and scales, exact .5
  lattice points included, where the two roundings part;
* ``linear_w8a8``, weight-only ``layers.linear``, the W8A8 MLP's plain
  version against the Pallas kernel in interpret mode, and the logits of
  ``make_vit_model(quantize="w8"/"w8a8")``: f32 atol 1e-5 for one op and
  1e-4 for a model (the order of f32 sums differs; the int32 products are
  exact on both sides, and an int8 that lands on the other side of a
  rounding boundary would show as a miss far above these bounds);
* the server's ``--dtype`` / ``--attn`` refusals: those of the JAX server.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.vit_plugin import make_vit_model as jmake
from interactive_vit_tpu.ops import fused_mlp as jfm
from interactive_vit_tpu.ops import layers as jL
from interactive_vit_tpu.ops import quant as jq
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import dispatch
from interactive_vit_tpu_torch.ops import fused_mlp as fm
from interactive_vit_tpu_torch.ops import layers as L
from interactive_vit_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

ATOL = 1e-5
MODEL_ATOL = 1e-4
NAME = "vit_qnt"
SMALL = dict(img_size=32, patch=16, width=64, depth=2, heads=4,
             num_classes=10)


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        jfm.pl, "pallas_call", functools.partial(pl.pallas_call,
                                                 interpret=True))


def _np(t):
    return t.detach().cpu().numpy()


def _weight(seed, shape=(64, 48)):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column takes scale 1
    return w


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_weight_is_bit_equal(mode, seed):
    w = _weight(seed)
    want = jq.quantize_weight(jnp.asarray(w), mode=mode)
    got = tq.quantize_weight(torch.from_numpy(w), mode=mode)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
        assert got[k].dtype == (torch.int8 if k in (tq.QKEY, tq.AQKEY)
                                else torch.float32)
    assert tq.is_quantized(got) == (mode == "w8")
    assert tq.is_w8a8(got) == (mode == "w8a8")


def test_quantize_weight_from_bf16_is_bit_equal():
    w = _weight(2)
    want = jq.quantize_weight(jnp.asarray(w, jnp.bfloat16))
    got = tq.quantize_weight(torch.from_numpy(w).to(torch.bfloat16))
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("mode,names", [
    ("w8", jq.BLOCK_WEIGHTS), ("w8a8", frozenset({"fc1_w", "fc2_w"}))])
def test_quantize_tree_is_bit_equal_and_from_jax_maps_it(mode, names):
    cfg = jvit.ViTConfig(NAME, **SMALL)
    jparams = jvit.init_params(jax.random.key(5), cfg)
    want = jax.tree.map(np.asarray,
                        jq.quantize_tree(jparams, names=names, mode=mode))
    got = tq.quantize_tree(from_jax(jax.tree.map(np.asarray, jparams)),
                           names=names, mode=mode)
    crossed = from_jax(want)  # the JAX tree carried over as it is
    assert tq.BLOCK_WEIGHTS == jq.BLOCK_WEIGHTS
    for blk_w, blk_g, blk_c in zip(want["blocks"], got["blocks"],
                                   crossed["blocks"]):
        for name in names:
            for k in blk_w[name]:
                np.testing.assert_array_equal(_np(blk_g[name][k]),
                                              blk_w[name][k])
                assert blk_c[name][k].dtype == blk_g[name][k].dtype
                np.testing.assert_array_equal(_np(blk_c[name][k]),
                                              blk_w[name][k])
        assert isinstance(blk_g["ln1_s"], torch.Tensor)
    assert isinstance(got["patch_embed"]["w"], torch.Tensor)
    assert isinstance(got["head"]["w"], torch.Tensor)


def _lattice_rows():
    """Rows whose x / s lands on exact .5 points: max 127 gives s = 1."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 32)).astype(np.float32) * 3
    x[0, :5] = [127.0, 0.5, -0.5, 1.5, -2.5]
    x[0, 5:] = rng.integers(-126, 126, 27) + 0.5
    x[1] = 0.0  # scale 1, all zeros
    return x


def test_quantize_acts_rounds_half_to_even_like_jax():
    x = _lattice_rows()
    jqx, jsx = jq.quantize_acts(jnp.asarray(x))
    tqx, tsx = tq.quantize_acts(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tqx), np.asarray(jqx))
    np.testing.assert_array_equal(_np(tsx), np.asarray(jsx))
    assert _np(tqx)[0, :5].tolist() == [127, 0, 0, 2, -2]


@pytest.mark.parametrize("fn", ["quant_rows_mosaic", "quant_cols_mosaic"])
def test_mosaic_quantizers_round_half_up_like_jax(fn):
    x = _lattice_rows()
    if fn == "quant_cols_mosaic":
        x = np.ascontiguousarray(x.T)
    jqx, jsx = getattr(jq, fn)(jnp.asarray(x))
    tqx, tsx = getattr(tq, fn)(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tqx), np.asarray(jqx))
    np.testing.assert_array_equal(_np(tsx), np.asarray(jsx))
    if fn == "quant_rows_mosaic":
        assert _np(tqx)[0, :5].tolist() == [127, 1, 0, 2, -2]


def test_int_matmul_is_exact():
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, (3, 4096), dtype=np.int8)
    b = rng.integers(-127, 128, (4096, 5), dtype=np.int8)
    got = tq.int_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(got), a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
@pytest.mark.parametrize("bias", [False, True])
def test_linear_matches_jax(mode, bias):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = _weight(4)
    b = rng.standard_normal(48).astype(np.float32) if bias else None
    jw = jq.quantize_weight(jnp.asarray(w), mode=mode)
    want = jL.linear(jnp.asarray(x), jw, None if b is None else jnp.asarray(b))
    got = L.linear(torch.from_numpy(x), from_jax(jax.tree.map(np.asarray, jw)),
                   None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=0)


def _w8a8_block(seed, d=64, md=256):
    """A W8A8 MLP block's parameters with non-trivial LN and biases: the
    JAX tree and its torch counterpart."""
    rng = np.random.default_rng(seed)
    jp = {"ln2_s": 1.0 + 0.2 * rng.standard_normal(d),
          "ln2_b": 0.2 * rng.standard_normal(d),
          "fc1_b": 0.2 * rng.standard_normal(md),
          "fc2_b": 0.2 * rng.standard_normal(d)}
    jp = {k: jnp.asarray(v.astype(np.float32)) for k, v in jp.items()}
    jp["fc1_w"] = jq.quantize_weight(jnp.asarray(
        rng.standard_normal((d, md)).astype(np.float32) * d ** -0.5), "w8a8")
    jp["fc2_w"] = jq.quantize_weight(jnp.asarray(
        rng.standard_normal((md, d)).astype(np.float32) * md ** -0.5), "w8a8")
    return jp, from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("batch,n,eps", [(1, 5, 1e-6), (3, 7, 1e-5)])
def test_w8a8_mlp_plain_version_matches_pallas_kernel(batch, n, eps):
    jp, tp = _w8a8_block(batch)
    x = np.random.default_rng(batch).standard_normal(
        (batch, n, 64)).astype(np.float32)
    want = jfm.fused_mlp_w8a8_block(jnp.asarray(x), jp, eps, block_q=8)
    before = fm.fused_mlp_w8a8_block.launches
    got, parts = fm.fused_mlp_w8a8_block(torch.from_numpy(x), tp, eps,
                                         want_parts=True)
    assert fm.fused_mlp_w8a8_block.launches == before  # no kernel on CPU
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=0)
    assert torch.equal(got, fm.fused_mlp_w8a8_reference(
        torch.from_numpy(x), tp, eps))
    # the integer stages: int8 activations, and accumulators that are the
    # exact products of those activations with the int8 weights
    assert parts["q1"].dtype == torch.int8 and parts["q2"].dtype == torch.int8
    np.testing.assert_array_equal(
        _np(parts["acc1"]),
        _np(parts["q1"]).astype(np.int64) @ _np(tp["fc1_w"][tq.AQKEY])
        .astype(np.int64))
    np.testing.assert_array_equal(
        _np(parts["acc2"]),
        _np(parts["q2"]).astype(np.int64) @ _np(tp["fc2_w"][tq.AQKEY])
        .astype(np.int64))


def test_w8a8_mlp_bf16_plain_version_near_pallas_kernel():
    """bf16: both sides round at the same points, but XLA rounds the GELU's
    intermediates to bf16 where torch keeps them in f32; a flipped bf16
    hidden value can move one int8 of q2. Bound: 2^-6 of y's scale."""
    jp, tp = _w8a8_block(9)
    x = np.random.default_rng(9).standard_normal((2, 9, 64)).astype(
        np.float32)
    jpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                       if a.dtype == jnp.float32 and a.ndim == 1 else a, jp)
    jpb["fc1_w"], jpb["fc2_w"] = jp["fc1_w"], jp["fc2_w"]
    want = np.asarray(jfm.fused_mlp_w8a8_block(
        jnp.asarray(x, jnp.bfloat16), jpb, 1e-6, block_q=8)
        .astype(jnp.float32))
    tpb = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v)
           for k, v in tp.items()}
    got = fm.fused_mlp_w8a8_reference(
        torch.from_numpy(x).to(torch.bfloat16), tpb).float().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()


@pytest.mark.parametrize("args,ok", [
    ((768, 3072, torch.bfloat16), True), ((768, 3072, torch.float32), True),
    ((1280, 5120, torch.float32), True), ((96, 384, torch.bfloat16), True),
    ((1284, 5136, torch.bfloat16), False),  # wider than the register slots
    ((768, 16384, torch.float32), False),   # hidden block over 227 KB
    ((766, 3064, torch.bfloat16), False),   # not whole __dp4a words
    ((0, 0, torch.bfloat16), False),
])
def test_fits_w8a8(args, ok):
    assert fm.fits_w8a8(*args) is ok


def test_w8a8_wrapper_refuses_other_devices_and_dense_weights():
    _, tp = _w8a8_block(0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fm.fused_mlp_w8a8_block(torch.zeros((1, 5, 64), device="meta"), tp)
    with pytest.raises(ValueError, match="W8A8 leaf-dict"):
        fm._check_w8a8_operands(
            torch.zeros((1, 5, 64)),
            {**tp, "fc1_w": tq.dequantize_weight(tp["fc1_w"])})


@pytest.mark.parametrize("name,dtype,device,quant_mode,want", [
    ("w8a8", torch.bfloat16, "cpu", "", "w8a8"),
    ("auto", torch.bfloat16, "cuda", "w8a8", "w8a8"),
    ("auto", torch.float32, "cuda:0", "w8a8", "w8a8"),  # f32 not excluded
    ("auto", torch.bfloat16, "cpu", "w8a8", None),
    ("auto", torch.bfloat16, None, "w8a8", None),
    ("auto", torch.float16, "cuda", "w8a8", None),
    ("auto", torch.bfloat16, "cuda", "", None),
    ("reference", torch.bfloat16, "cuda", "w8a8", None),
])
def test_default_mlp_impl_w8a8_policy(name, dtype, device, quant_mode, want):
    got = dispatch.default_mlp_impl(name, dtype=dtype, d=768, mlp_dim=3072,
                                    quant=quant_mode, device=device)
    assert got is {"w8a8": fm.fused_mlp_w8a8_block, None: None}[want]


def test_default_mlp_impl_w8a8_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="does not take"):
        dispatch.default_mlp_impl("w8a8", dtype=torch.float32, d=768,
                                  mlp_dim=16384)
    assert dispatch.default_mlp_impl(
        "auto", dtype=torch.float32, d=768, mlp_dim=16384, quant="w8a8",
        device="cuda") is None


@pytest.fixture(scope="module")
def micro():
    cfg = jvit.ViTConfig(NAME, **SMALL)
    jparams = jvit.init_params(jax.random.key(9), cfg)
    imgs = np.random.default_rng(9).random((2, 3, 32, 32), np.float32)
    jvit.VARIANTS[NAME] = cfg
    tvit.VARIANTS[NAME] = tvit.ViTConfig(NAME, **SMALL)
    yield jparams, imgs
    del jvit.VARIANTS[NAME]
    del tvit.VARIANTS[NAME]


def _chain_logits(model, imgs):
    x = imgs
    for name, _, fn in model.layers:
        if name == "transform":
            continue
        x = fn(model.layer_params(name), {"o": x})["o"]
    return x


@pytest.mark.parametrize("quantize", ["w8", "w8a8"])
def test_quantized_model_logits_match_jax(micro, quantize):
    """``make_vit_model(quantize=)`` in both packages from the same dense
    weights, through their layer chains (the CPU path: weight-only int8 or
    ``linear_w8a8`` in every block, as the JAX package runs off the TPU)."""
    jparams, imgs = micro
    jm = jmake(NAME, params=jparams, quantize=quantize,
               with_categories=False)
    tm = make_vit_model(NAME, params=from_jax(jax.tree.map(np.asarray,
                                                           jparams)),
                        quantize=quantize, device="cpu")
    blk = tm.params["blocks"][0]
    want_q = ({"qkv_w", "proj_w", "fc1_w", "fc2_w"} if quantize == "w8"
              else {"fc1_w", "fc2_w"})
    assert {k for k, v in blk.items() if isinstance(v, dict)} == want_q
    want = jnp.asarray(imgs)
    for name, _, fn in jm.layers:
        if name == "transform":
            continue
        want = fn(jm.layer_params(name), {"o": want})["o"]
    got = _chain_logits(tm, torch.from_numpy(imgs))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODEL_ATOL,
                               rtol=0)
    dense = _chain_logits(make_vit_model(
        NAME, params=from_jax(jax.tree.map(np.asarray, jparams)),
        device="cpu"), torch.from_numpy(imgs))
    assert (got - dense).abs().max() > 1e-6  # the quantization shows


def test_w8a8_model_with_the_kernels_plain_versions_matches_jax(micro):
    """W8A8 with the MLP kernel and the s8 block in every block: the port's
    plain versions against the JAX Pallas kernels in interpret mode."""
    from interactive_vit_tpu.ops import fused_block as jfb

    jparams, imgs = micro
    jtree = jq.quantize_tree(jparams, names=frozenset({"fc1_w", "fc2_w"}),
                             mode="w8a8")
    tparams = from_jax(jax.tree.map(np.asarray, jtree))
    jcfg, tcfg = jvit.VARIANTS[NAME], tvit.VARIANTS[NAME]
    with pytest.MonkeyPatch.context() as mp:
        import jax.experimental.pallas as pl

        mp.setattr(jfb.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        want = jvit.forward(
            jtree, jnp.asarray(imgs), jcfg, want_attn=True,
            block_impl=functools.partial(jfb.fused_attn_block,
                                         int8_scores=True),
            mlp_impl=functools.partial(jfm.fused_mlp_w8a8_block, block_q=8))
    got = tvit.forward(
        tparams, torch.from_numpy(imgs), tcfg, want_attn=True,
        block_impl=dispatch.default_block_impl("int8-scores"),
        mlp_impl=dispatch.default_mlp_impl("w8a8"))
    np.testing.assert_allclose(_np(got["logits"]), np.asarray(want["logits"]),
                               atol=MODEL_ATOL, rtol=0)
    np.testing.assert_allclose(_np(got["rollout"]),
                               np.asarray(want["rollout"]), atol=MODEL_ATOL,
                               rtol=0)


def test_make_vit_model_refusals(micro):
    jparams, _ = micro
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    with pytest.raises(ValueError, match="dense attention weights"):
        make_vit_model(NAME, params=tparams, quantize="w8",
                       block_kernel="int8-scores", device="cpu")
    with pytest.raises(ValueError, match="dense attention weights"):
        jmake(NAME, params=jparams, quantize="w8",
              block_kernel="int8-scores")
    with pytest.raises(ValueError, match="LayerScale"):
        make_vit_model("dinov2_s14", quantize="w8a8", device="cpu")
    with pytest.raises(ValueError, match="LayerScale"):
        jmake("dinov2_s14", quantize="w8a8")
    with pytest.raises(ValueError, match="unknown quantize mode"):
        make_vit_model(NAME, params=tparams, quantize="w4", device="cpu")


@pytest.mark.parametrize("dtype_name,attn,ok", [
    ("int8", "int8-scores", False),
    ("int8w8a8", "int8-scores", True),
    ("bfloat16", "int8-scores", True),
    ("int8", "auto", True),
])
def test_server_dtype_and_attn_refusals_match_jax(tmp_path, micro, dtype_name,
                                                  attn, ok):
    """``--dtype int8 --attn int8-scores`` is refused by both servers; the
    other pairs build. (The JAX server also refuses ``int8-scores`` in
    float32, through its dispatch; the port's dispatch does not exclude
    f32.)"""
    from interactive_vit_tpu.serving import server as jserver
    from interactive_vit_tpu.serving.server import build_app as jbuild
    from interactive_vit_tpu_torch.serving.server import build_app

    def port():
        return build_app(models=[NAME], graphs_dir=str(tmp_path / "t"),
                         dtype_name=dtype_name, device="cpu",
                         attn_impl_name=attn)

    if not ok:
        with pytest.raises(ValueError, match="int8-scores"):
            port()
        # the JAX server refuses after building its App: a stand-in App
        # keeps its batcher threads from starting
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jserver, "App", lambda **kw: None)
            with pytest.raises(ValueError, match="int8-scores"):
                jbuild(models=[NAME], graphs_dir=str(tmp_path / "j"),
                       dtype_name=dtype_name, attn_impl_name=attn,
                       speculate=False)
        return
    app = port()
    try:
        blk = app.reg.get_node(NAME + ":blocks.0").model.params["blocks"][0]
        quantized = {k for k, v in blk.items() if isinstance(v, dict)}
        assert quantized == {"int8": {"qkv_w", "proj_w", "fc1_w", "fc2_w"},
                             "int8w8a8": {"fc1_w", "fc2_w"}}.get(
                                 dtype_name, set())
        assert blk["ln1_s"].dtype == torch.bfloat16
    finally:
        app.close()
