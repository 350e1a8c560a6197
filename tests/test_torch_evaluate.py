"""The port's ``ivt-eval`` (``tools/evaluate.py``'s ``main``) against the
JAX package's on the CPU: the same checkpoint (a JAX-initialised tiny ViT
written by JAX's safetensors writer) and the same set give the same JSON
line, but for the wall time and the rate.
"""

import json

import numpy as np
import pytest
import torch

import jax

from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models.weights import to_native_flat
from interactive_vit_tpu.tools import evaluate as jevaluate
from interactive_vit_tpu.utils.safetensors_io import save_file
from interactive_vit_tpu_torch.data.loader import save_dataset
from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.tools import evaluate

TINY = dict(img_size=32, patch=16, width=64, depth=2, heads=2,
            num_classes=10)
TIMES = ("wall_s", "imgs_per_s")


@pytest.fixture
def ckpt(monkeypatch, tmp_path):
    monkeypatch.setitem(vit.VARIANTS, "vit_tiny_ev",
                        vit.ViTConfig("vit_tiny_ev", **TINY))
    monkeypatch.setitem(jvit.VARIANTS, "vit_tiny_ev",
                        jvit.ViTConfig("vit_tiny_ev", **TINY))
    params = jvit.init_params(jax.random.key(7),
                              jvit.VARIANTS["vit_tiny_ev"])
    path = str(tmp_path / "tiny.safetensors")
    save_file(to_native_flat(jax.device_get(params)), path)
    return path


def _jax_line(argv, capsys):
    capsys.readouterr()
    jevaluate.main(argv + ["--platform", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _strip(line):
    return {k: v for k, v in line.items() if k not in TIMES}


def test_memorize_json_equals_jax(ckpt, capsys):
    argv = ["--variant", "vit_tiny_ev", "--ckpt", ckpt, "--memorize", "36",
            "--distinct-classes", "10", "--batch", "8", "--top-k", "3"]
    got = evaluate.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == got
    want = _jax_line(argv, capsys)
    assert sorted(got) == sorted(want) == sorted(
        ["variant", "n", "top1", "top3", *TIMES])
    assert _strip(got) == _strip(want)
    assert got["n"] == 36


def test_data_in_file_order_with_its_tail(ckpt, tmp_path, capsys):
    """``--data`` reads every sample once in file order: ``--limit 21
    --batch 8`` is two full chunks and a tail of 5."""
    rng = np.random.default_rng(2)
    prefix = str(tmp_path / "val")
    save_dataset(prefix, rng.random((30, 3, 32, 32)).astype(np.float32),
                 rng.integers(0, 10, 30))
    argv = ["--variant", "vit_tiny_ev", "--ckpt", ckpt, "--data", prefix,
            "--batch", "8", "--limit", "21"]
    got = evaluate.main(argv + ["--device", "cpu"])
    assert got["n"] == 21
    assert _strip(got) == _strip(_jax_line(argv, capsys))


def test_random_init_and_bfloat16_run(monkeypatch):
    monkeypatch.setitem(vit.VARIANTS, "vit_tiny_ev",
                        vit.ViTConfig("vit_tiny_ev", **TINY))
    got = evaluate.main(["--variant", "vit_tiny_ev", "--memorize", "10",
                         "--batch", "4", "--dtype", "bfloat16", "--device",
                         "cpu"])
    assert got["n"] == 10 and 0.0 <= got["top1"] <= got["top5"] <= 1.0


@pytest.mark.parametrize("argv", [[], ["--data", "x", "--memorize", "4"],
                                  ["--memorize", "4", "--mesh",
                                   "data=2,model=2"],
                                  ["--memorize", "4", "--platform", "cpu"]])
def test_parser_refusals(argv):
    """Exactly one of --data / --memorize; --mesh is data parallelism
    only (a model axis is refused); --platform is not ported."""
    with pytest.raises(SystemExit) as exc:
        evaluate.parse_args(argv)
    assert exc.value.code == 2


def test_feature_extractors_and_unknown_families_raise():
    with pytest.raises(ValueError, match="feature extractor"):
        evaluate.make_logits_fn("dino_s16")
    with pytest.raises(ValueError, match="no evaluation path"):
        evaluate.make_logits_fn("clip_b32")
    with pytest.raises(ValueError, match="suffix"):
        evaluate.make_logits_fn("swin_t@384")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--memorize", "4"])
