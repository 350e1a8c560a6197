"""Real weights into the port's server and headless runner on the CPU:
``build_app(ckpts=..., ckpt_layout=...)``, ``--ckpt`` / ``--ckpt-layout``,
``run_graph --ckpt``.

A ``.safetensors`` the JAX package writes (``to_native_flat`` + its
``save_file``) serves from the port within 1e-4 of the JAX app serving the
same file (logits and maps over ``/compute``). A server loading a
checkpoint gives, bit for bit, the taps of a server that draws the same
seeded params itself (the loading server is seeded otherwise, so its
weights can only come from the file): a torchvision file, a checkpoint
directory of ``tools/convert``, Swin from a native file, each serving
dtype (the int8 modes quantize after the load). A ``--ckpt`` key whose
model is not served raises JAX's error.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import jax

from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models import weights as jweights
from interactive_vit_tpu.serving.server import build_app as jbuild_app
from interactive_vit_tpu.utils.safetensors_io import (
    load_file as jload, save_file as jsave,
)
from interactive_vit_tpu_torch.graph.ir import Graph
from interactive_vit_tpu_torch.models import swin as tswin
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.weights import (
    to_native_flat, to_torchvision,
)
from interactive_vit_tpu_torch.serving import server
from interactive_vit_tpu_torch.tools import convert as tconvert
from interactive_vit_tpu_torch.utils.safetensors_io import save_file
from interactive_vit_tpu_torch.wire.codec import (
    REQUEST_MAGIC, Request, Response, decode_message, encode_message,
)

torch.set_num_threads(2)

NAME = "vit_ck_srv"
SMALL = dict(img_size=32, patch=16, width=64, depth=2, heads=4,
             num_classes=10)
SWIN = dict(img_size=32, patch=4, embed_dim=32, depths=(2, 2),
            heads=(2, 4), window=4, num_classes=10)
ATOL = 1e-4


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setitem(jvit.VARIANTS, NAME, jvit.ViTConfig(NAME, **SMALL))
    cfg = tvit.ViTConfig(NAME, **SMALL)
    monkeypatch.setitem(tvit.VARIANTS, NAME, cfg)
    monkeypatch.setitem(tswin.VARIANTS, "swin_t",
                        tswin.SwinConfig("swin_t", **SWIN))
    return cfg


def _post(url, body):
    req = urllib.request.Request(url + "/compute", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return Response.decode(r.read())


def _request(chain, image, taps):
    g = Graph()
    nodes = [g.add_node(name) for name in chain]
    for a, b in zip(nodes, nodes[1:]):
        g.connect(a, "o", b, "o")
    g.add_input(image, nodes[0], "o")
    obj, tensors = decode_message(Request.encode(g),
                                  expect_magic=REQUEST_MAGIC)
    obj["taps"] = [{"node": i, "channel": ch} for i, ch in taps]
    return encode_message(REQUEST_MAGIC, obj, tensors)


def _vit_request(depth=SMALL["depth"], seed=0):
    chain = ([f"{NAME}:transform", f"{NAME}:embed"]
             + [f"{NAME}:blocks.{i}" for i in range(depth)]
             + [f"{NAME}:norm", f"{NAME}:head"])
    taps = ([(2 + i, ch) for i in range(depth) for ch in ("attn", "r")]
            + [(len(chain) - 1, "o")])
    img = np.random.default_rng(seed).random((3, 40, 48), dtype=np.float32)
    return _request(chain, img, taps)


def _serve(tmp_path, tag, **kw):
    app = server.build_app(graphs_dir=str(tmp_path / f"g_{tag}"),
                           device="cpu", **kw)
    httpd = app.serve("127.0.0.1", 0, background=True)
    return app, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(app, httpd):
    httpd.shutdown()
    httpd.server_close()
    app.close()


def _responses(tmp_path, models, body, **kw):
    """One request to a port server built with ``kw``."""
    app, httpd, url = _serve(tmp_path, str(len(os.listdir(tmp_path))),
                             models=models, **kw)
    try:
        return _post(url, body)
    finally:
        _stop(app, httpd)


def _bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        assert sorted(got[i]) == sorted(want[i])
        for ch in want[i]:
            assert np.isfinite(want[i][ch]).all(), (i, ch)
            assert got[i][ch].tobytes() == want[i][ch].tobytes(), (i, ch)


def test_jax_written_file_serves_as_the_jax_app_serves_it(tmp_path, small):
    jp = jax.tree.map(np.asarray,
                      jvit.init_params(jax.random.key(3), jvit.VARIANTS[NAME]))
    path = str(tmp_path / "jax.safetensors")
    jsave(jweights.to_native_flat(jp), path)
    body = _vit_request()
    got = _responses(tmp_path, (NAME,), body, ckpts={NAME: path})
    japp = jbuild_app(models=(NAME,), graphs_dir=str(tmp_path / "jg"),
                      ckpts={NAME: path}, speculate=False)
    jhttpd = japp.serve("127.0.0.1", 0, background=True)
    try:
        want = _post(f"http://127.0.0.1:{jhttpd.server_address[1]}", body)
    finally:
        jhttpd.shutdown()
        japp.batcher.stop()
    assert sorted(got) == sorted(want)
    for i in want:
        for ch in want[i]:
            assert got[i][ch].shape == want[i][ch].shape, (i, ch)
            np.testing.assert_allclose(got[i][ch], want[i][ch], atol=ATOL,
                                       err_msg=f"node {i} {ch}")


def test_port_written_file_reads_in_jax(tmp_path, small):
    tp = tvit.init_params(small, torch.Generator().manual_seed(4))
    path = str(tmp_path / "port.safetensors")
    save_file(to_native_flat(tp), path)
    tree = jweights.from_native_flat(jload(path))
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0])
    assert sorted(map(str, flat)) == sorted(map(str, want))
    for k, v in want.items():
        assert flat[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8",
                                        "int8w8a8"])
def test_checkpoint_serves_bit_for_bit_the_seeded_weights(tmp_path, small,
                                                          dtype_name):
    """A torchvision file and a ``tools.convert`` directory of seed 5's
    params, served by servers of seed 6, equal the seed-5 server."""
    path = str(tmp_path / "tv.safetensors")
    save_file(to_torchvision(tvit.init_params(
        small, torch.Generator().manual_seed(5)), small), path)
    out = str(tmp_path / "dir")
    tconvert.main(["--model", NAME, "--input", path, "--output", out])
    body = _vit_request()
    want = _responses(tmp_path, (NAME,), body, seed=5, dtype_name=dtype_name)
    for ckpt, layout in ((path, "torchvision"), (path, "auto"), (out, "auto")):
        got = _responses(tmp_path, (NAME,), body, seed=6,
                         dtype_name=dtype_name, ckpts={NAME: ckpt},
                         ckpt_layout=layout)
        _bit_equal(got, want)
    other = _responses(tmp_path, (NAME,), body, seed=6,
                       dtype_name=dtype_name)
    # the seed-6 server's own weights give other logits
    assert other[max(other)]["o"].tobytes() != want[max(want)]["o"].tobytes()


def test_swin_from_a_native_file(tmp_path, small):
    cfg = tswin.VARIANTS["swin_t"]
    path = str(tmp_path / "swin.safetensors")
    save_file(to_native_flat(tswin.init_params(
        cfg, torch.Generator().manual_seed(5))), path)
    names = [n for n, _, _ in tswin.layer_fns(cfg)]
    img = np.random.default_rng(1).random((3, 36, 40), dtype=np.float32)
    body = _request([f"swin_t:{n}" for n in names], img,
                    [(2, "attn"), (len(names) - 1, "o")])
    want = _responses(tmp_path, ("swin_t",), body, seed=5)
    got = _responses(tmp_path, ("swin_t",), body, seed=6,
                     ckpts={"swin_t": path})
    _bit_equal(got, want)


def test_unserved_ckpt_key_raises_jax_s_error(tmp_path, small):
    ckpts = {"vit_b16": "w.safetensors", "swin_t": "s.safetensors"}
    with pytest.raises(ValueError) as want:
        jbuild_app(models=(NAME,), graphs_dir=str(tmp_path / "jg"),
                   ckpts=ckpts, speculate=False)
    with pytest.raises(ValueError) as got:
        server.build_app(models=(NAME,), graphs_dir=str(tmp_path / "g"),
                         device="cpu", ckpts=ckpts)
    assert str(got.value) == str(want.value)


def test_wrong_layout_raises_the_converter_s_error(tmp_path, small):
    path = str(tmp_path / "tv.safetensors")
    save_file(to_torchvision(tvit.init_params(
        small, torch.Generator().manual_seed(5)), small), path)
    with pytest.raises(ValueError, match="layout 'openai' is not valid"):
        server.build_app(models=(NAME,), graphs_dir=str(tmp_path / "g"),
                         device="cpu", ckpts={NAME: path},
                         ckpt_layout="openai")
    with pytest.raises(KeyError, match="state dict missing"):
        server.build_app(models=(NAME,), graphs_dir=str(tmp_path / "g"),
                         device="cpu", ckpts={NAME: path},
                         ckpt_layout="timm")


def test_load_model_params_puts_f32_on_the_named_device(tmp_path, small):
    path = str(tmp_path / "tv.safetensors")
    save_file(to_torchvision(tvit.init_params(
        small, torch.Generator().manual_seed(5)), small), path)
    params = server.load_model_params(NAME, path, device="cpu")
    w = params["blocks"][0]["qkv_w"]
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    assert w.is_contiguous()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            server.build_app(models=(NAME,), ckpts={NAME: path})


def test_server_flags():
    args = server.make_parser().parse_args(
        ["--ckpt", "vit_b16=a.safetensors", "--ckpt", "swin_t=b",
         "--ckpt-layout", "timm"])
    assert args.ckpt == ["vit_b16=a.safetensors", "swin_t=b"]
    assert args.ckpt_layout == "timm"
    assert server.make_parser().parse_args([]).ckpt_layout == "auto"
    with pytest.raises(SystemExit):
        server.make_parser().parse_args(["--ckpt-layout", "native"])


NARROW = dict(img_size=64, patch=16, width=32, depth=12, heads=2,
              num_classes=0)


def test_run_graph_ckpt_as_the_jax_runner(tmp_path, monkeypatch):
    """dino_s16's saved graph (narrowed) with ``--ckpt`` from a
    torchvision file: the model's taps within 1e-4 of the JAX runner's
    with the same file, and not those of the seeded weights."""
    from interactive_vit_tpu.tools.run_graph import main as jmain
    from interactive_vit_tpu_torch.tools import run_graph

    monkeypatch.setitem(tvit.VARIANTS, "dino_s16",
                        tvit.ViTConfig("dino_s16", **NARROW))
    monkeypatch.setitem(jvit.VARIANTS, "dino_s16",
                        jvit.ViTConfig("dino_s16", **NARROW))
    cfg = tvit.VARIANTS["dino_s16"]
    path = str(tmp_path / "dino.safetensors")
    save_file(to_torchvision(tvit.init_params(
        cfg, torch.Generator().manual_seed(8)), cfg), path)
    from PIL import Image

    img = str(tmp_path / "in.png")  # both runners decode it through PIL
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, size=(48, 64, 3), dtype=np.uint8)).save(img)
    outs = {}
    for tag, argv in (("port", ["--device", "cpu", "--ckpt",
                                f"dino_s16={path}"]),
                      ("seeded", ["--device", "cpu"])):
        outs[tag] = str(tmp_path / tag)
        assert run_graph.main(["dino_s16", "--image", img, "--taps", "all",
                               "--out", outs[tag], *argv]) == 0
    outs["jax"] = str(tmp_path / "jax")
    assert jmain(["dino_s16", "--image", img, "--taps", "all", "--out",
                  outs["jax"], "--platform", "cpu", "--ckpt",
                  f"dino_s16={path}"]) == 0
    with open(os.path.join(outs["port"], "manifest.json")) as f:
        man = json.load(f)
    model_taps = [s for s, m in man.items()
                  if m["name"].startswith("dino_s16:")]
    assert model_taps
    for stem in model_taps:
        got = np.load(os.path.join(outs["port"], stem + ".npy"))
        want = np.load(os.path.join(outs["jax"], stem + ".npy"))
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=stem)
    norm = next(s for s in model_taps if man[s]["name"] == "dino_s16:norm")
    assert not np.array_equal(
        np.load(os.path.join(outs["port"], norm + ".npy")),
        np.load(os.path.join(outs["seeded"], norm + ".npy")))
