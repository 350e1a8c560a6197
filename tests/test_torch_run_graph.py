"""The port's headless graph runner (``interactive_vit_tpu_torch.tools.
run_graph``) on the CPU: the counterparts of ``tests/test_run_graph.py``'s
four tests, the manifest against the JAX runner's on ``demo_noise``, the
PNG writer against PIL's decoder, and the refused flags. ``dino_s16`` is
narrowed to width 32 and 64 pixels (its 12 blocks kept) for the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.tools import run_graph

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(img_size=64, patch=16, width=32, depth=12, heads=2,
              num_classes=0)


@pytest.fixture()
def narrow_dino(monkeypatch):
    monkeypatch.setitem(tvit.VARIANTS, "dino_s16",
                        tvit.ViTConfig("dino_s16", **NARROW))


@pytest.fixture()
def img(tmp_path):
    p = str(tmp_path / "in.npy")
    np.save(p, np.random.default_rng(0).random((3, 64, 48),
                                               dtype=np.float32))
    return p


def _manifest(out):
    with open(os.path.join(out, "manifest.json")) as f:
        return json.load(f)


def test_demo_graph_to_taps(tmp_path):
    out = str(tmp_path / "taps")
    assert run_graph.main(["demo_noise", "--taps", "all", "--out", out,
                           "--device", "cpu"]) == 0
    man = _manifest(out)
    assert man
    for stem, meta in man.items():
        a = np.load(os.path.join(out, stem + ".npy"))
        assert list(a.shape) == meta["shape"]
        assert os.path.exists(os.path.join(out, stem + ".png")) == meta["png"]


def test_manifest_and_taps_equal_the_jax_runner(tmp_path):
    """demo_noise (noise, const, binop: exact kinds): the same manifest,
    the same arrays bit for bit, and PNGs of the same pixels."""
    from PIL import Image

    from interactive_vit_tpu.tools.run_graph import main as jmain

    out, jout = str(tmp_path / "torch"), str(tmp_path / "jax")
    assert run_graph.main(["demo_noise", "--taps", "all", "--out", out,
                           "--device", "cpu"]) == 0
    assert jmain(["demo_noise", "--taps", "all", "--out", jout,
                  "--platform", "cpu"]) == 0
    man = _manifest(out)
    assert man == _manifest(jout)
    for stem, meta in man.items():
        np.testing.assert_array_equal(
            np.load(os.path.join(out, stem + ".npy")),
            np.load(os.path.join(jout, stem + ".npy")))
        if meta["png"]:
            ours = np.asarray(Image.open(os.path.join(out, stem + ".png")))
            theirs = np.asarray(Image.open(os.path.join(jout, stem + ".png")))
            np.testing.assert_array_equal(ours, theirs)


def test_dino_graph_renders_feature_views(tmp_path, img, narrow_dino):
    out = str(tmp_path / "taps")
    assert run_graph.main(["dino_s16", "--image", img, "--out", out,
                           "--dtype", "float32", "--device", "cpu"]) == 0
    man = _manifest(out)
    pca = [m for m in man.values() if m["name"] == "pca_view"]
    sim = [m for m in man.values() if m["name"] == "patch_sim"]
    assert pca and pca[0]["png"] and pca[0]["shape"] == [1, 3, 4, 4]
    assert sim and sim[0]["png"] and sim[0]["shape"] == [1, 3, 4, 4]
    # the rollout map rendered as a square heatmap png
    rmaps = [s for s, m in man.items() if m["channel"] == "r"]
    assert rmaps and os.path.exists(os.path.join(out, rmaps[0] + ".png"))
    views = np.load(os.path.join(out, next(
        s for s, m in man.items() if m["name"] == "pca_view") + ".npy"))
    assert views.min() == 0.0 and views.max() == 1.0


def test_png_and_bfloat16_images(tmp_path, narrow_dino):
    """A PNG image through PIL; a bf16 run of the same graph."""
    from PIL import Image

    p = str(tmp_path / "in.png")
    Image.fromarray((np.random.default_rng(1).random((40, 56, 3)) * 255)
                    .astype("uint8")).save(p)
    out = str(tmp_path / "taps")
    assert run_graph.main(["dino_s16", "--image", p, "--out", out,
                           "--dtype", "bfloat16", "--device", "cpu"]) == 0
    assert any(m["name"] == "pca_view" and m["png"]
               for m in _manifest(out).values())


def test_missing_image_is_a_clear_error(tmp_path, narrow_dino, capsys):
    assert run_graph.main(["dino_s16", "--out", str(tmp_path),
                           "--device", "cpu"]) == 2
    assert "pass --image" in capsys.readouterr().err
    assert run_graph.main(["no_such_graph", "--out", str(tmp_path),
                           "--device", "cpu"]) == 2


def test_dangling_sink_does_not_demand_image(tmp_path, img):
    """A disconnected viewer neither fails the run nor gets the image."""
    with open(os.path.join(ROOT, "static", "graphs", "demo_slice.json")) as f:
        obj = json.load(f)
    obj["nodes"].append({"instance": {"kind": "img_view"},
                         "pos": {"x": 0, "y": 0}})
    gp = str(tmp_path / "g.json")
    with open(gp, "w") as f:
        json.dump(obj, f)
    sink_idx = len(obj["nodes"]) - 1
    out = str(tmp_path / "taps")
    assert run_graph.main([gp, "--image", img, "--out", out,
                           "--device", "cpu"]) == 0
    man = _manifest(out)
    assert man and not [m for m in man.values() if m["node"] == sink_idx]


@pytest.mark.parametrize("shape", [(3, 5, 7), (1, 3, 4, 4), (6, 6),
                                   (1, 1, 9, 9)])
def test_png_writer_decodes_with_pil(tmp_path, shape):
    from PIL import Image

    a = np.random.default_rng(2).random(shape).astype(np.float32)
    p = str(tmp_path / "x.png")
    assert run_graph._save_png(p, a)
    got = np.asarray(Image.open(p))
    x = a.reshape(a.shape[-3:] if a.shape[-3:-2] == (3,) else a.shape[-2:])
    if x.ndim == 3:
        want = (np.clip(x, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    else:
        want = ((x - x.min()) / (x.max() - x.min()) * 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert not run_graph._save_png(p, np.zeros((2, 5, 7), np.float32))
    assert not run_graph._save_png(p, np.zeros((4, 6), np.float32))


def test_refused_flags_and_no_card(tmp_path):
    with pytest.raises(SystemExit) as exc:
        run_graph.main(["demo_noise", "--out", str(tmp_path), "--platform",
                        "cpu"])
    assert exc.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_graph.main(["demo_noise", "--out", str(tmp_path)])
