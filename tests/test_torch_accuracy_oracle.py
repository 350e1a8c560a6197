"""The end-to-end accuracy oracle through the port: train -> export ->
serve -> classify, on the CPU.

The JAX package's ``tests/test_accuracy_oracle.py`` with the port on every
step: the port's trainer (``tools.train.main --device cpu``) memorises 32
patterned images of 10 classes on JAX's ``vit_oracle`` config (32 px,
width 64, depth 2, 4 heads), exports them with ``--export-safetensors``,
and the port's server loads the file with ``--ckpt`` semantics and
classifies the set over HTTP through the batcher (8 clients at a time)
above 90% top-1. The JAX app, serving the same file, agrees with the
port's logits within 1e-4.
"""

import threading
import urllib.request

import numpy as np
import pytest
import torch

from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu_torch.graph.ir import Graph
from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.serving.server import build_app
from interactive_vit_tpu_torch.tools import train as train_tool
from interactive_vit_tpu_torch.wire.codec import Request, Response

torch.set_num_threads(2)

ORACLE = dict(img_size=32, patch=16, width=64, depth=2, heads=4,
              num_classes=10)
N_SET, N_CLASSES = 32, 10
CHAIN = ["vit_oracle:embed", "vit_oracle:blocks.0", "vit_oracle:blocks.1",
         "vit_oracle:norm", "vit_oracle:head"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(the exported file, the trainer's result)."""
    vit.VARIANTS["vit_oracle"] = vit.ViTConfig("vit_oracle", **ORACLE)
    jvit.VARIANTS["vit_oracle"] = jvit.ViTConfig("vit_oracle", **ORACLE)
    path = str(tmp_path_factory.mktemp("oracle") / "vit_oracle.safetensors")
    try:
        res = train_tool.main([
            "--device", "cpu", "--variant", "vit_oracle", "--steps", "150",
            "--batch", "16", "--lr", "1e-3", "--memorize", str(N_SET),
            "--distinct-classes", str(N_CLASSES), "--log-every", "100",
            "--export-safetensors", path])
        yield path, res
    finally:
        del vit.VARIANTS["vit_oracle"]
        del jvit.VARIANTS["vit_oracle"]


def _body(image):
    # the model chain from embed on: the trainer fed raw tensors
    g = Graph()
    nodes = [g.add_node(name) for name in CHAIN]
    for a, b in zip(nodes, nodes[1:]):
        g.connect(a, "o", b, "o")
    g.add_input(image, nodes[0], "o")
    return Request.encode(g)


def _logits(url, image):
    req = urllib.request.Request(url + "/compute", data=_body(image),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        outs = Response.decode(r.read())
    return np.asarray(outs[len(CHAIN) - 1]["o"])


def _classify(url, images):
    """The logits of every image, 8 concurrent clients at a time."""
    out = [None] * len(images)

    def worker(i):
        out[i] = _logits(url, images[i])

    for lo in range(0, len(images), 8):
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(lo, min(lo + 8, len(images)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert all(x is not None for x in out)
    return out


def test_trained_model_classifies_over_the_wire(trained, tmp_path):
    path, res = trained
    assert res["history"][-1][1] < res["history"][0][1]
    app = build_app(models=("vit_oracle",), graphs_dir=str(tmp_path / "g"),
                    ckpts={"vit_oracle": path}, max_wait_ms=5.0,
                    device="cpu")
    httpd = app.serve("127.0.0.1", 0, background=True)
    try:
        images, labels = train_tool.pattern_set(0, N_SET, ORACLE["img_size"],
                                                N_CLASSES, N_CLASSES)
        logits = _classify(f"http://127.0.0.1:{httpd.server_address[1]}",
                           images)
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()
    preds = [int(x.argmax()) for x in logits]
    acc = float(np.mean([p == int(y) for p, y in zip(preds, labels)]))
    assert acc > 0.9, f"served top-1 {acc:.2f} <= 0.9"


def test_the_jax_app_serves_the_port_s_export_alike(trained, tmp_path):
    """The port's export in the JAX server: the same logits within 1e-4
    on a few of the images."""
    from interactive_vit_tpu.serving.server import build_app as jbuild_app

    path, _ = trained
    images, _ = train_tool.pattern_set(0, 4, ORACLE["img_size"], N_CLASSES,
                                       N_CLASSES)
    app = build_app(models=("vit_oracle",), graphs_dir=str(tmp_path / "g"),
                    ckpts={"vit_oracle": path}, device="cpu")
    japp = jbuild_app(models=("vit_oracle",), graphs_dir=str(tmp_path / "j"),
                      ckpts={"vit_oracle": path}, speculate=False)
    httpd = app.serve("127.0.0.1", 0, background=True)
    jhttpd = japp.serve("127.0.0.1", 0, background=True)
    try:
        for img in images:
            np.testing.assert_allclose(
                _logits(f"http://127.0.0.1:{httpd.server_address[1]}", img),
                _logits(f"http://127.0.0.1:{jhttpd.server_address[1]}", img),
                atol=1e-4)
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()
        jhttpd.shutdown()
        japp.batcher.stop()
