"""The long-sequence slice on the CPU, at a small size: the port against the
JAX package on shared weights.

Two configurations, each depth 2 and width 64, 65+ tokens:

* a plain ViT forced onto the headwise block kernel (``block_kernel=
  "headwise"``), against JAX with ``block_impl=headwise_attn_block``;
* a DINOv2-style ViT (LayerScale, 4 registers, no classifier) whose blocks
  run the unfused path with the flash attention, against JAX with
  ``attn_impl=flash_mhsa``.

The port runs the kernels' plain versions here; JAX runs its Pallas
kernels in interpret mode. Each goes through ``vit.forward``, the
``layer_fns`` chain, the port's executor and one HTTP ``/compute``:
logits, maps and rollout within f32 atol 1e-4, the BASELINE parity
contract.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph import executor as jexec
from interactive_vit_tpu.graph.registry import Registry as JRegistry
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.vit_plugin import make_vit_model as jmake
from interactive_vit_tpu.ops import flash_attention as jfa
from interactive_vit_tpu.ops import fused_block as jfb
from interactive_vit_tpu.ops.node_ops import register_builtin as jbuiltin
from interactive_vit_tpu.wire import schema as jschema
from interactive_vit_tpu_torch.graph.registry import Registry
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.ops import flash_attention as tfa
from interactive_vit_tpu_torch.ops import fused_block as tfb
from interactive_vit_tpu_torch.ops.node_ops import register_builtin
from interactive_vit_tpu_torch.serving.app import App
from interactive_vit_tpu_torch.wire import schema
from interactive_vit_tpu_torch.wire.codec import (
    REQUEST_MAGIC, Request, Response, decode_message, encode_message,
)

torch.set_num_threads(2)

ATOL = 1e-4
SMALL = dict(img_size=64, patch=8, width=64, depth=2, heads=4)
CASES = {
    # name: (config extras, port kernels, JAX kernels)
    "vit_headwise_small": (
        dict(num_classes=10),
        dict(block_kernel="headwise"),
        dict(block_kernel="headwise")),
    "dinov2_reg_flash_small": (
        dict(num_classes=0, layer_scale=1e-5, registers=4),
        dict(attn_impl=tfa.flash_mhsa),
        dict(attn_impl=jfa.flash_mhsa)),
}


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    interp = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(jfb.pl, "pallas_call", interp)
    monkeypatch.setattr(jfa.pl, "pallas_call", interp)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, JAX config, port config, numpy params), registered in both
    packages' variant tables for the module."""
    name = request.param
    extra = CASES[name][0]
    jcfg = jvit.ViTConfig(name, **SMALL, **extra)
    tcfg = tvit.ViTConfig(name, **SMALL, **extra)
    params = jax.tree.map(np.asarray, jvit.init_params(jax.random.key(21),
                                                       jcfg))
    rng = np.random.default_rng(21)
    for blk in params["blocks"]:
        for k in ("ln1_b", "qkv_b", "proj_b"):  # non-trivial biases
            blk[k] = (rng.standard_normal(blk[k].shape) * 0.1).astype(
                np.float32)
        if "ls1" in blk:  # non-trivial LayerScale gammas
            blk["ls1"] = rng.standard_normal(blk["ls1"].shape, np.float32)
            blk["ls2"] = rng.standard_normal(blk["ls2"].shape, np.float32)
    jvit.VARIANTS[name], tvit.VARIANTS[name] = jcfg, tcfg
    try:
        yield name, jcfg, tcfg, params
    finally:
        del jvit.VARIANTS[name], tvit.VARIANTS[name]


def _impls(name):
    if name == "vit_headwise_small":
        return (dict(block_impl=tfb.headwise_attn_block),
                dict(block_impl=jfb.headwise_attn_block))
    return dict(attn_impl=tfa.flash_mhsa), dict(attn_impl=jfa.flash_mhsa)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("attn_heads", [None, (3, 1)])
def test_forward_matches_jax(case, attn_heads):
    name, jcfg, tcfg, params = case
    timpl, jimpl = _impls(name)
    images = np.random.default_rng(22).random((2, 3, 64, 64),
                                               dtype=np.float32)
    want = jvit.forward(jax.tree.map(jnp.asarray, params),
                        jnp.asarray(images), jcfg, want_attn=True,
                        attn_heads=attn_heads, **jimpl)
    got = tvit.forward(from_jax(params), torch.from_numpy(images), tcfg,
                       want_attn=True, attn_heads=attn_heads, **timpl)
    assert set(got) == set(want)
    np.testing.assert_allclose(_np(got["logits"]), want["logits"], atol=ATOL)
    np.testing.assert_allclose(_np(got["rollout"]), want["rollout"],
                               atol=ATOL)
    assert len(got["attn"]) == len(want["attn"]) == jcfg.depth
    for g, w in zip(got["attn"], want["attn"]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), w, atol=ATOL)


def test_layer_fns_match_jax_node_by_node(case):
    name, jcfg, tcfg, params = case
    timpl, jimpl = _impls(name)
    img = np.random.default_rng(23).random((3, 70, 80), dtype=np.float32)
    jlayers = jvit.layer_fns(jcfg, **jimpl)
    tlayers = tvit.layer_fns(tcfg, **timpl)
    assert [n for n, _, _ in jlayers] == [n for n, _, _ in tlayers]
    jp, tp = jax.tree.map(jnp.asarray, params), from_jax(params)
    jx, tx = jnp.asarray(img), torch.from_numpy(img)
    want = frozenset({"attn", "r", "cls"})
    for (lname, extra, jf), (_, _, tf) in zip(jlayers, tlayers):
        kw = ({"want": want, "node_params": {"attn_heads": "[0, 2]"}}
              if extra else {})
        jout = jf(jvit.layer_params(jp, lname), {"o": jx}, **kw)
        tout = tf(tvit.layer_params(tp, lname), {"o": tx}, **kw)
        assert set(tout) == set(jout), lname
        for ch in jout:
            np.testing.assert_allclose(_np(tout[ch]), np.asarray(jout[ch]),
                                       atol=ATOL, err_msg=f"{lname}:{ch}")
        jx, tx = jout["o"], tout["o"]


def test_executor_and_http_compute_match_jax(case, tmp_path):
    """The generated chain graph with ``attn`` + ``r`` taps on both blocks
    (a head subset on block 1) and the head: the port's executor and its
    HTTP ``/compute`` against the JAX executor on the same graph."""
    import urllib.request

    name, jcfg, tcfg, params = case
    jreg = JRegistry()
    jbuiltin(jreg)
    jmake(name, params=jax.tree.map(jnp.asarray, params),
          **CASES[name][2]).register(jreg, None)
    reg = Registry()
    register_builtin(reg)
    app = App(reg=reg, graphs_dir=str(tmp_path), device="cpu",
              max_wait_ms=5.0)
    make_vit_model(name, params=from_jax(params), device="cpu",
                   **CASES[name][1]).register(reg, app.graphs)
    httpd = app.serve("127.0.0.1", 0, background=True)
    try:
        obj = app.graphs.load(name + ".json")
        img = np.random.default_rng(24).random((3, 70, 80), dtype=np.float32)
        g, jg = schema.graph_from_json(obj), jschema.graph_from_json(obj)
        for graph in (g, jg):
            graph.nodes[3].params["attn_heads"] = "[2, 0]"
            graph.add_input(img, graph.nodes[0], "o")
        taps = [(2 + i, ch) for i in range(jcfg.depth)
                for ch in ("attn", "r")] + [(2 + jcfg.depth + 1, "o")]
        want = jexec.Executor(jreg).run(jg, taps)
        got_exec = app.executor.run(g, taps)
        req, tensors = decode_message(Request.encode(g),
                                      expect_magic=REQUEST_MAGIC)
        req["taps"] = [{"node": i, "channel": ch} for i, ch in taps]
        body = encode_message(REQUEST_MAGIC, req, tensors)
        url = f"http://127.0.0.1:{httpd.server_address[1]}/compute"
        with urllib.request.urlopen(urllib.request.Request(
                url, data=body, method="POST"), timeout=60) as r:
            got_http = Response.decode(r.read())
    finally:
        httpd.shutdown()
        app.close()
    assert got_exec[3]["attn"].shape == (1, 2, tcfg.tokens, tcfg.tokens)
    for got in (got_exec, got_http):
        assert sorted(got) == sorted(want)
        for i in want:
            assert sorted(got[i]) == sorted(want[i])
            for ch in want[i]:
                np.testing.assert_allclose(got[i][ch], np.asarray(want[i][ch]),
                                           atol=ATOL,
                                           err_msg=f"node {i} channel {ch}")
