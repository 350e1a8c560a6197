"""The port's Chefer attention attribution (``models/attrib.py``, the
``<model>:attrib`` node) on the CPU, against the JAX package.

A ViT of depth 2, width 64, 2 heads, 32 px, patch 8 (and a distilled
DeiT of the same size), the JAX initializer's weights in both packages:

* ``trunk_with_attn_grads``: the trunk's logits equal the chain's; the one
  backward's per-block gradients equal JAX's within 1e-4 of max(1, |ref|),
  the probs are attention rows; ``chefer_relevance`` is nonnegative with a
  diagonal of at least 1.
* The node through both executors, target max and class, dense and
  weight-only int8 (the trunk dequantized inline): "o", "rel" and
  "logits" within 1e-4 of max(1, |ref|).
* A class scrub is a cache hit with a new map; a stacked group of distinct
  classes equals the separate runs bit for bit; a bad target is JAX's
  ``NodeError``; a ToMe config is refused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.executor import Executor as JExecutor
from interactive_vit_tpu.graph.executor import NodeError as JNodeError
from interactive_vit_tpu.graph.ir import Graph as JGraph
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import attrib as jattrib
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.vit_plugin import make_vit_model as jmake
from interactive_vit_tpu.ops import node_ops as J
from interactive_vit_tpu_torch.graph.executor import Executor, NodeError
from interactive_vit_tpu_torch.graph.ir import Graph
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import attrib
from interactive_vit_tpu_torch.models import tome as ttome
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import node_ops as T

torch.set_num_threads(2)

GEOM = dict(img_size=32, patch=8, width=64, depth=2, heads=2, num_classes=10)
NAME, DEIT = "vita_t", "deita_t"


def _close(got, want, what=""):
    """f32 within 1e-4 of max(1, |ref|)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol, what


@pytest.fixture(scope="module")
def models():
    """{name: (our model, JAX model)} for the ViT, its int8 twin and the
    DeiT, registered in (ours, JAX's) registries."""
    with pytest.MonkeyPatch.context() as mp:
        reg, jreg = Registry(), JRegistry()
        T.register_builtin(reg)
        J.register_builtin(jreg)
        out = {}
        for name, kw, quant in ((NAME, {}, False), (NAME + "q", {}, "w8"),
                                (DEIT, {"distilled": True}, False)):
            mp.setitem(jvit.VARIANTS, name, jvit.ViTConfig(name, **GEOM,
                                                           **kw))
            mp.setitem(tvit.VARIANTS, name, tvit.ViTConfig(name, **GEOM,
                                                           **kw))
            jp = jvit.init_params(jax.random.key(11), jvit.VARIANTS[name])
            jm = jmake(name, params=jp, quantize=quant)
            tm = make_vit_model(name, params=from_jax(
                jax.tree.map(np.asarray, jp)), device="cpu", quantize=quant)
            jm.register(jreg)
            tm.register(reg)
            out[name] = (tm, jm)
        yield reg, jreg, out


def _tokens(seed=0, batch=2):
    img = np.random.default_rng(seed).random((batch, 3, 32, 32),
                                             dtype=np.float32)
    return img


def _attrib_graph(graph_cls, name, params, img):
    """embed -> attrib beside embed -> blocks -> norm -> head."""
    g = graph_cls()
    chain = [g.add_node(f"{name}:{n}") for n in
             ("embed", "blocks.0", "blocks.1", "norm", "head")]
    for a, b in zip(chain, chain[1:]):
        g.connect(a, "o", b, "o")
    att = g.add_node(f"{name}:attrib", params)
    g.connect(chain[0], "o", att, "o")
    g.add_input(img, chain[0], "o")
    return g, att.index, chain[-1].index


def _trunk(model):
    p = model.params
    return {"blocks": p["blocks"], "norm": p["norm"], "head": p["head"]}


def test_trunk_grads_and_logits_match_jax(models):
    """One forward and one backward: per-block probs and gradients, and the
    logits, against JAX's ``trunk_with_attn_grads`` (f32)."""
    _, _, ms = models
    tm, jm = ms[NAME]
    img = _tokens()
    cfg, jcfg = tvit.VARIANTS[NAME], jvit.VARIANTS[NAME]
    x = tvit.embed(tm.params, torch.from_numpy(img), cfg)
    jx = jvit.embed(jm.params, jnp.asarray(img), jcfg)

    def scalar(logits):
        return logits.float().amax(dim=-1).sum()

    def jscalar(logits):
        return jnp.sum(jnp.max(logits.astype(jnp.float32), axis=-1))

    probs, grads, logits = attrib.trunk_with_attn_grads(_trunk(tm), x, cfg,
                                                        scalar)
    jprobs, jgrads, jlogits = jax.jit(
        lambda caps, toks: jattrib.trunk_with_attn_grads(
            caps, toks, jcfg, jscalar))(_trunk(jm), jx)
    assert len(grads) == len(jgrads) == 2
    for a, b in zip(probs + grads, jprobs + jgrads):
        _close(a.numpy(), b)
    _close(logits.numpy(), jlogits)
    np.testing.assert_allclose(probs[0].sum(-1).numpy(), 1.0, atol=1e-5)
    rel = attrib.chefer_relevance(probs, grads).numpy()
    assert rel.min() >= 0.0
    assert np.all(np.diagonal(rel, axis1=1, axis2=2) >= 1.0 - 1e-6)
    _close(rel, jattrib.chefer_relevance(jprobs, jgrads, jx.dtype))


CASES = [(NAME, {"target": "max"}), (NAME, {"target": "class",
                                             "class": "7"}),
         (NAME + "q", {"target": "max"}), (DEIT, {"target": "class",
                                                  "class": "2"})]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_attrib_node_matches_jax(models, case):
    """The node's "o", "rel" and "logits" through both executors; its
    logits equal the chain's head (the live parity probe)."""
    reg, jreg, _ = models
    name, params = CASES[case]
    img = _tokens(case)
    g, att, head = _attrib_graph(Graph, name, params, img)
    jg, _, _ = _attrib_graph(JGraph, name, params, img)
    taps = {(att, "o"), (att, "rel"), (att, "logits"), (head, "o")}
    got = Executor(reg, device="cpu").run(g, taps)
    want = JExecutor(jreg).run(jg, taps)
    for ch in ("o", "rel", "logits"):
        _close(got[att][ch], want[att][ch], ch)
    assert got[att]["o"].shape == (2, 3, 4, 4)
    _close(got[att]["logits"], got[head]["o"])


def test_class_scrub_is_a_cache_hit_with_a_new_map(models):
    reg, _, _ = models
    ex = Executor(reg, device="cpu")
    outs = []
    for n, c in enumerate(("0", "7")):
        g, att, _ = _attrib_graph(Graph, NAME, {"target": "class",
                                                "class": c}, _tokens())
        outs.append(ex.run(g, {(att, "o")})[att]["o"])
        assert ex.last_stats.cache_hit == (n == 1)
    assert np.abs(outs[0] - outs[1]).max() > 1e-6


def test_stacked_distinct_classes_equal_runs(models):
    """A group of two sessions on different classes (the trunk's weights
    passed once, the class per row): each row its own run's."""
    reg, _, _ = models
    ex = Executor(reg, device="cpu")
    graphs = [_attrib_graph(Graph, NAME, {"target": "class", "class": c},
                            _tokens(3, batch=1))[0] for c in ("0", "7")]
    att = graphs[0].nodes[-1].index
    taps = {(att, "rel"), (att, "o")}
    res = ex.run_stacked(graphs, taps)
    for g, r in zip(graphs, res):
        single = ex.run(g, taps)
        for ch in ("rel", "o"):
            np.testing.assert_array_equal(r[att][ch], single[att][ch])
    assert not np.array_equal(res[0][att]["rel"], res[1][att]["rel"])


def test_bad_target_is_jax_node_error(models):
    reg, jreg, _ = models
    img = _tokens()
    g, att, _ = _attrib_graph(Graph, NAME, {"target": "nope"}, img)
    jg, _, _ = _attrib_graph(JGraph, NAME, {"target": "nope"}, img)
    with pytest.raises(JNodeError) as jerr:
        JExecutor(jreg).run(jg, {(att, "o")})
    with pytest.raises(NodeError) as err:
        Executor(reg, device="cpu").run(g, {(att, "o")})
    assert (err.value.node_index, str(err.value)) == (
        jerr.value.node_index, str(jerr.value))


def test_contents_and_io_equal_jax(models):
    _, _, ms = models
    tm, jm = ms[NAME]
    tk = next(k for k in tm.extra_kinds if k.name.endswith(":attrib"))
    jk = next(k for k in jm.extra_kinds if k.name.endswith(":attrib"))
    for params in ({}, {"target": "class", "class": "4"}):
        assert tk.contents(params) == jk.contents(params)
        assert tk.io(params) == jk.io(params)
    assert tk.dynamic_params() == jk.dynamic_params()


def test_tome_config_refused(models):
    _, _, ms = models
    with pytest.raises(TypeError, match="plain ViT trunks only"):
        attrib.AttribNodeKind(ms[NAME][0], ttome.ToMeViTConfig(
            "t", **GEOM, r=2))
