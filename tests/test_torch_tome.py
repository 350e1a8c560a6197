"""The port's ToMe family against the JAX package on shared inputs.

Inputs are made with numpy from a seed, parameters with the JAX
initializer (``models/weights.from_jax`` hands them to the port). The JAX
block kernel runs its Pallas call in interpret mode; the port's wrapper
runs its plain version on CPU tensors. Tolerances: the matching's luts
must be identical (they are discrete decisions); merged values 1e-6 in
f32 (the same f32 sums over at most a few rows, in another order); bf16
merged values one bf16 ulp of their scale (2^-7); the colour map 1e-6;
logits, maps and rollout 1e-4 (the parity contract).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import tome as jtome
from interactive_vit_tpu.ops import fused_block as jfb
from interactive_vit_tpu.ops import tome_ops as jops
from interactive_vit_tpu.ops.attention import attention_reference as jattn
from interactive_vit_tpu_torch.models import tome as ttome
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import fused_block as tfb
from interactive_vit_tpu_torch.ops import tome_ops as tops
from interactive_vit_tpu_torch.ops.attention import attention_reference

torch.set_num_threads(2)

ATOL = 1e-4
# the tiny config of the JAX package's kernel-vs-XLA ToMe test
SMALL = dict(img_size=32, patch=8, width=64, depth=3, heads=4,
             num_classes=10, r=6)
JCFG = jtome.ToMeViTConfig("tome_port", **SMALL)
TCFG = ttome.ToMeViTConfig("tome_port", **SMALL)


@pytest.fixture
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        jfb.pl, "pallas_call", functools.partial(pl.pallas_call,
                                                 interpret=True))


@pytest.fixture(scope="module")
def shared():
    """The JAX-initialised tree (numpy leaves) and an image batch."""
    params = jax.tree.map(np.asarray,
                          jtome.init_params(jax.random.key(0), JCFG))
    img = np.random.default_rng(0).random((2, 3, 32, 32), dtype=np.float32)
    return params, img


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# -- tome_ops ----------------------------------------------------------------------


@pytest.mark.parametrize("n,r,protect", [(13, 4, 1), (12, 4, 1), (17, 100, 1),
                                         (197, 8, 1), (21, 16, 1), (9, 3, 0),
                                         (2, 5, 1)])
def test_merge_counts_and_matching_match_jax(n, r, protect):
    assert tops.merge_counts(n, r, protect) == jops.merge_counts(n, r,
                                                                 protect)
    rng = np.random.default_rng(n + r)
    metric = rng.standard_normal((2, n, 6)).astype(np.float32)
    lut, n_new = tops.bipartite_matching(torch.from_numpy(metric), r,
                                         protect)
    jlut, jn_new = jops.bipartite_matching(jnp.asarray(metric), r, protect)
    assert n_new == jn_new and lut.dtype == torch.int32
    np.testing.assert_array_equal(lut.numpy(), np.asarray(jlut))


@pytest.mark.parametrize("n,r", [(13, 4), (12, 5), (197, 8), (21, 16)])
def test_bipartite_merge_matches_jax_and_the_numpy_reference(n, r):
    rng = np.random.default_rng(3 + n)
    x = rng.standard_normal((2, n, 8)).astype(np.float32)
    s = rng.integers(1, 4, size=(2, n)).astype(np.float32)
    metric = rng.standard_normal((2, n, 6)).astype(np.float32)
    xo, so, lut = tops.bipartite_merge(torch.from_numpy(x),
                                       torch.from_numpy(s),
                                       torch.from_numpy(metric), r)
    jx, js, jlut = jops.bipartite_merge(jnp.asarray(x), jnp.asarray(s),
                                        jnp.asarray(metric), r)
    xr, sr, lr = tops.bipartite_merge_reference(x, s, metric, r)
    np.testing.assert_array_equal(lut.numpy(), np.asarray(jlut))
    np.testing.assert_array_equal(lut.numpy(), lr)
    np.testing.assert_allclose(xo.numpy(), np.asarray(jx), atol=1e-6, rtol=0)
    np.testing.assert_allclose(so.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    np.testing.assert_allclose(xo.numpy(), xr, atol=1e-5, rtol=0)
    np.testing.assert_allclose(so.numpy(), sr, atol=1e-6, rtol=0)


def test_numpy_reference_is_a_copy_of_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 15, 5))
    s = rng.integers(1, 5, size=(2, 15)).astype(np.float64)
    metric = rng.standard_normal((2, 15, 4))
    for got, want in zip(tops.bipartite_merge_reference(x, s, metric, 5),
                         jops.bipartite_merge_reference(x, s, metric, 5)):
        np.testing.assert_array_equal(got, want)


def test_apply_merge_bf16_keeps_the_jax_cast_points():
    """bf16 values: weighted rows cast to bf16, f32 accumulation, the sum
    rounded to bf16, then divided by the f32 sizes."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 31, 16)).astype(np.float32)
    s = rng.integers(1, 6, size=(2, 31)).astype(np.float32)
    metric = rng.standard_normal((2, 31, 8)).astype(np.float32)
    lut, n_new = tops.bipartite_matching(torch.from_numpy(metric), 7)
    got, s_new = tops.apply_merge(torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(s), lut, n_new)
    want, js_new = jops.apply_merge(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(s), jnp.asarray(lut.numpy()),
                                    n_new)
    assert got.dtype == torch.bfloat16 and s_new.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=2.0 ** -7 * np.abs(x).max(), rtol=0)
    np.testing.assert_array_equal(s_new.numpy(), np.asarray(js_new))


def test_merges_conserve_sizes_and_keep_cls_first():
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, 17, 16)).astype(np.float32))
    s = torch.ones((3, 17))
    for n_expect in (12, 7, 4):
        x, s, lut = tops.bipartite_merge(x, s, x, r=5)
        assert x.shape[1] == n_expect
        np.testing.assert_allclose(s.sum(-1).numpy(), 17.0, atol=1e-4)
        assert torch.all(lut[:, 0] == 0)


@pytest.mark.parametrize("n", [5, 17, 197])
def test_merge_map_render_matches_jax(n):
    a = np.random.default_rng(n).integers(0, n, size=(2, n)).astype(np.int32)
    got = tops.merge_map_render(torch.from_numpy(a))
    want = jops.merge_map_render(jnp.asarray(a))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError, match="square"):
        tops.merge_map_render(torch.zeros((1, 6), dtype=torch.int32))


def test_proportional_attention_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 3, 7, 8)).astype(np.float32)
               for _ in range(3))
    kb = np.log(rng.integers(1, 5, size=(2, 7)).astype(np.float32))
    out, probs = attention_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), want_attn=True,
        key_bias=torch.from_numpy(kb))
    jout, jprobs = jattn(*(jnp.asarray(t) for t in (q, k, v)), want_attn=True,
                         key_bias=jnp.asarray(kb))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)


# -- the model -------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jtome.VARIANTS))
def test_variants_and_token_ladders_match_jax(name):
    jcfg, tcfg = jtome.VARIANTS[name], ttome.VARIANTS[name]
    for field in ("img_size", "patch", "width", "depth", "heads", "r",
                  "num_classes", "tokens"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    ladder = [tcfg.n_tokens(i) for i in range(tcfg.depth + 1)]
    assert ladder == [jcfg.n_tokens(i) for i in range(jcfg.depth + 1)]
    if name == "vit_b16_tome":
        assert ladder[0] == 197 and ladder[-2:] == [109, 101]
    if name == "vit_b16_tome16":
        assert ladder[-2:] == [21, 11]


@pytest.mark.parametrize("kernel", [True, False])
def test_forward_matches_jax(shared, pallas_interpret, kernel):
    """``tome.forward`` with maps and rollout: the port's plain block (or
    its unfused path) against the JAX forward with the interpreted Pallas
    kernel (or its XLA path)."""
    params, img = shared
    want = jtome.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(img),
                         JCFG, want_attn=True,
                         block_impl=jfb.fused_attn_block if kernel else None)
    before = tfb.fused_attn_block.launches
    got = ttome.forward(from_jax(params), torch.from_numpy(img), TCFG,
                        want_attn=True,
                        block_impl=tfb.fused_attn_block if kernel else None)
    assert tfb.fused_attn_block.launches == before  # CPU: no kernel
    np.testing.assert_allclose(_np(got["logits"]), np.asarray(want["logits"]),
                               atol=ATOL, rtol=0)
    assert [a.shape[-1] for a in got["attn"]] == [17, 11, 6]
    for g, w in zip(got["attn"], want["attn"]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL, rtol=0)
    assert tuple(got["rollout"].shape) == (2, 4, 17)
    np.testing.assert_allclose(_np(got["rollout"]),
                               np.asarray(want["rollout"]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kernel", [True, False])
def test_layer_chain_matches_jax(shared, pallas_interpret, kernel):
    """The layer functions chained as the generated graph wires them (o,
    s and a along the blocks, r unwired), every block tapping s, a, attn
    (heads 0 and 2 on block 1), r, merge and cls: identical assignments,
    everything else within 1e-4."""
    params, img = shared
    jlayers = jtome.layer_fns(JCFG, block_impl=(jfb.fused_attn_block
                                                 if kernel else None))
    tlayers = ttome.layer_fns(TCFG, block_impl=(tfb.fused_attn_block
                                                 if kernel else None))
    assert [n for n, _, _ in tlayers] == [n for n, _, _ in jlayers]
    tparams = from_jax(params)
    jx, tx = jnp.asarray(img), torch.from_numpy(img)
    jcarry, tcarry = {}, {}
    for (name, extra, jfn), (_, textra, tfn) in zip(jlayers, tlayers):
        assert textra == extra
        jp = jax.tree.map(jnp.asarray, jtome.layer_params(params, name))
        tp = ttome.layer_params(tparams, name)
        if not extra:
            jx, tx = jfn(jp, {"o": jx})["o"], tfn(tp, {"o": tx})["o"]
            continue
        want = frozenset(extra)
        node_params = {"attn_heads": "[2,0]"} if name == "blocks.1" else None
        jout = jfn(jp, {"o": jx, **jcarry}, want=want, node_params=node_params)
        tout = tfn(tp, {"o": tx, **tcarry}, want=want, node_params=node_params)
        assert set(tout) == set(jout)
        np.testing.assert_array_equal(tout["a"].numpy(), np.asarray(jout["a"]))
        assert tout["a"].dtype == torch.int32
        for ch in jout:
            assert tuple(tout[ch].shape) == jout[ch].shape, (name, ch)
            np.testing.assert_allclose(_np(tout[ch]), np.asarray(jout[ch]),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{name} {ch}")
        jx, tx = jout["o"], tout["o"]
        jcarry = {ch: jout[ch] for ch in ("s", "a")}
        tcarry = {ch: tout[ch] for ch in ("s", "a")}
    np.testing.assert_allclose(_np(tx), np.asarray(jx), atol=ATOL, rtol=0)


def test_block_luts_match_jax_through_the_ladder(shared, pallas_interpret):
    """Block by block on the same inputs: the port's plain kernel version
    and the interpreted Pallas kernel pick identical luts at every rung."""
    params, img = shared
    tparams = from_jax(params)
    jx = jtome.vit.embed(jax.tree.map(jnp.asarray, params), jnp.asarray(img),
                         JCFG)
    js = None
    for i in range(JCFG.depth):
        jp = jax.tree.map(jnp.asarray, params["blocks"][i])
        x_in, s_in = np.array(jx), None if js is None else np.array(js)
        jx, js, jlut, _, _ = jtome.block(jp, jx, js, JCFG,
                                         block_impl=jfb.fused_attn_block)
        tx, ts, tlut, _, _ = ttome.block(
            tparams["blocks"][i], torch.from_numpy(x_in),
            None if s_in is None else torch.from_numpy(s_in), TCFG,
            block_impl=tfb.fused_attn_block)
        np.testing.assert_array_equal(tlut.numpy(), np.asarray(jlut))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL)


def test_from_jax_converts_a_tome_tree(shared):
    """A ToMe tree is the plain-ViT tree: ``from_jax`` maps every leaf."""
    params, img = shared
    tparams = from_jax(params)
    jleaves, jdef = jax.tree.flatten(params)
    tleaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tparams))
    assert jax.tree.structure(jax.tree.map(lambda t: t.numpy(),
                                           tparams)) == jdef
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_array_equal(t, j)
    logits = ttome.forward(tparams, torch.from_numpy(img), TCFG)["logits"]
    assert tuple(logits.shape) == (2, 10)


def test_init_params_is_the_vit_tree():
    from interactive_vit_tpu_torch.models import vit as tvit

    gen = torch.Generator().manual_seed(1)
    p = ttome.init_params(TCFG, gen)
    q = tvit.init_params(TCFG, torch.Generator().manual_seed(1))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, p)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, q))
    assert all(torch.equal(a, b) for a, b in
               zip(jax.tree.leaves(p), jax.tree.leaves(q)))


def test_unwired_assignment_is_refused_past_the_first_block(shared):
    params, _ = shared
    fn = ttome.layer_fns(TCFG)[3][2]  # blocks.1
    x = torch.zeros((1, 11, 64))
    with pytest.raises(ValueError, match="'a' channel"):
        fn(from_jax(params["blocks"][1]), {"o": x}, want=frozenset({"a"}))
