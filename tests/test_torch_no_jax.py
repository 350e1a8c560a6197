"""The port and ``chip_smoke.py`` never load JAX or the JAX package.

Each check runs in a fresh interpreter, so what the test process itself
imported (this suite imports both frameworks) cannot hide a leak.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "interactive_vit_tpu_torch",
    "interactive_vit_tpu_torch.graph.executor",
    "interactive_vit_tpu_torch.wire.codec",
    "interactive_vit_tpu_torch.wire.schema",
    "interactive_vit_tpu_torch.wire.partition",
    "interactive_vit_tpu_torch.wire.render",
    "interactive_vit_tpu_torch.config",
    "interactive_vit_tpu_torch.runtime.build",
    "interactive_vit_tpu_torch.runtime.native",
    "interactive_vit_tpu_torch.data.loader",
    "interactive_vit_tpu_torch.data.augment",
    "interactive_vit_tpu_torch.ops.fused_block",
    "interactive_vit_tpu_torch.ops.fused_window",
    "interactive_vit_tpu_torch.ops.fused_mlp",
    "interactive_vit_tpu_torch.ops.quant",
    "interactive_vit_tpu_torch.ops.layers",
    "interactive_vit_tpu_torch.ops.flash_attention",
    "interactive_vit_tpu_torch.ops.tiled_attention",
    "interactive_vit_tpu_torch.ops.attention",
    "interactive_vit_tpu_torch.ops.attention_vjp",
    "interactive_vit_tpu_torch.ops.dispatch",
    "interactive_vit_tpu_torch.ops.preprocess_mm",
    "interactive_vit_tpu_torch.ops.node_ops",
    "interactive_vit_tpu_torch.models.vit_plugin",
    "interactive_vit_tpu_torch.models.swin",
    "interactive_vit_tpu_torch.models.swin_plugin",
    "interactive_vit_tpu_torch.models.tome",
    "interactive_vit_tpu_torch.models.tome_plugin",
    "interactive_vit_tpu_torch.ops.tome_ops",
    "interactive_vit_tpu_torch.models.autoregister",
    "interactive_vit_tpu_torch.models.clip",
    "interactive_vit_tpu_torch.models.clip_bpe",
    "interactive_vit_tpu_torch.models.clip_plugin",
    "interactive_vit_tpu_torch.models.clip_text",
    "interactive_vit_tpu_torch.models.clip_text_plugin",
    "interactive_vit_tpu_torch.models.vgg",
    "interactive_vit_tpu_torch.models.vgg_plugin",
    "interactive_vit_tpu_torch.models.attrib",
    "interactive_vit_tpu_torch.models.resnet",
    "interactive_vit_tpu_torch.models.resnet_plugin",
    "interactive_vit_tpu_torch.models.convnext",
    "interactive_vit_tpu_torch.models.convnext_plugin",
    "interactive_vit_tpu_torch.models.moe",
    "interactive_vit_tpu_torch.models.moe_plugin",
    "interactive_vit_tpu_torch.models.mae",
    "interactive_vit_tpu_torch.models.mae_plugin",
    "interactive_vit_tpu_torch.models.model_plugin",
    "interactive_vit_tpu_torch.models.weights",
    "interactive_vit_tpu_torch.runtime.constants",
    "interactive_vit_tpu_torch.runtime.cuda_build",
    "interactive_vit_tpu_torch.runtime.device",
    "interactive_vit_tpu_torch.models.vit",
    "interactive_vit_tpu_torch.serving.app",
    "interactive_vit_tpu_torch.serving.batcher",
    "interactive_vit_tpu_torch.serving.server",
    "interactive_vit_tpu_torch.parallel.mesh",
    "interactive_vit_tpu_torch.parallel.train",
    "interactive_vit_tpu_torch.parallel.sequence",
    "interactive_vit_tpu_torch.parallel.sp_attention",
    "interactive_vit_tpu_torch.parallel.pipeline",
    "interactive_vit_tpu_torch.tools.dryrun_multichip",
    "interactive_vit_tpu_torch.tools.evaluate",
    "interactive_vit_tpu_torch.tools.kernel_variants",
    "interactive_vit_tpu_torch.tools.run_graph",
    "interactive_vit_tpu_torch.tools.train",
    "interactive_vit_tpu_torch.tools.pretrain",
    "interactive_vit_tpu_torch.tools.convert",
    "interactive_vit_tpu_torch.utils.safetensors_io",
    "interactive_vit_tpu_torch.utils.checkpoint",
    "interactive_vit_tpu_torch.utils.tracing",
    "interactive_vit_tpu_torch.tools.quant_agreement",
    "interactive_vit_tpu_torch.ops.custom_ops",
    "interactive_vit_tpu_torch.graph.export",
    "interactive_vit_tpu_torch.serving.export_app",
    "interactive_vit_tpu_torch.tools.export_graph",
    "interactive_vit_tpu_torch.tools.run_exported",
    "chip_smoke",
]

CHECK = """
import importlib, sys
for m in sys.argv[1:]:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "interactive_vit_tpu"
                or m.startswith("interactive_vit_tpu."))
assert not leaked, leaked
print("clean")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_every_port_module_is_checked():
    """PORT_MODULES names every module of the package, so a new module
    cannot slip past the import check."""
    pkg = os.path.join(ROOT, "interactive_vit_tpu_torch")
    found = set()
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py") and f != "__init__.py":
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                found.add(rel[:-3].replace(os.sep, "."))
    # importing a module imports its parents and whatever it uses
    imported_by_others = {
        "interactive_vit_tpu_torch.graph.ir",
        "interactive_vit_tpu_torch.graph.registry",
        "interactive_vit_tpu_torch.models.labels",
        "interactive_vit_tpu_torch.serving.metrics",
    }
    assert found - set(PORT_MODULES) - imported_by_others == set()


def test_port_and_chip_smoke_import_no_jax():
    res = subprocess.run([sys.executable, "-c", CHECK, *PORT_MODULES],
                         capture_output=True, text=True, cwd=ROOT,
                         env=_env(), timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def _run_smoke(cwd):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even where there is one
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_server_entry_point_parses():
    res = subprocess.run(
        [sys.executable, "-m", "interactive_vit_tpu_torch.serving.server",
         "--help"], capture_output=True, text=True, cwd=ROOT, env=_env(),
        timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ("--models", "--dtype", "--device", "--port", "--graphs-dir",
                 "--seed", "--max-batch", "--max-wait-ms", "--attn"):
        assert flag in res.stdout


def test_train_entry_point_parses():
    res = subprocess.run(
        [sys.executable, "-m", "interactive_vit_tpu_torch.tools.train",
         "--help"], capture_output=True, text=True, cwd=ROOT, env=_env(),
        timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ("--variant", "--steps", "--batch", "--lr", "--warmup",
                 "--clip-norm", "--llrd", "--seed", "--remat", "--dtype",
                 "--accum-steps", "--attn", "--eval-every", "--memorize",
                 "--distinct-classes", "--label-smoothing", "--ema-decay",
                 "--log-every", "--device", "--data", "--hflip",
                 "--crop-pad", "--color-jitter", "--cutout", "--mixup",
                 "--cutmix", "--no-remat", "--distill-teacher",
                 "--teacher-variant", "--distill-alpha", "--distill-tau",
                 "--mesh"):
        assert flag in res.stdout


def test_pretrain_entry_point_parses():
    res = subprocess.run(
        [sys.executable, "-m", "interactive_vit_tpu_torch.tools.pretrain",
         "--help"], capture_output=True, text=True, cwd=ROOT, env=_env(),
        timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ("--variant", "--steps", "--batch", "--lr", "--warmup",
                 "--weight-decay", "--mask-ratio", "--no-norm-pix", "--seed",
                 "--dtype", "--remat", "--accum-steps", "--memorize",
                 "--distinct-classes", "--data", "--probe", "--output",
                 "--save-every", "--resume", "--export-encoder",
                 "--export-safetensors", "--log-every", "--device",
                 "--mesh"):
        assert flag in res.stdout


def test_evaluate_entry_point_parses():
    res = subprocess.run(
        [sys.executable, "-m", "interactive_vit_tpu_torch.tools.evaluate",
         "--help"], capture_output=True, text=True, cwd=ROOT, env=_env(),
        timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ("--variant", "--ckpt", "--ckpt-layout", "--data",
                 "--memorize", "--distinct-classes", "--batch", "--limit",
                 "--top-k", "--seed", "--dtype", "--device", "--mesh"):
        assert flag in res.stdout


def _default_device_entry_points():
    from interactive_vit_tpu_torch.graph.executor import Executor
    from interactive_vit_tpu_torch.models.autoregister import make_model
    from interactive_vit_tpu_torch.models.clip_plugin import make_clip_model
    from interactive_vit_tpu_torch.models.clip_text_plugin import (
        make_clip_text_model,
    )
    from interactive_vit_tpu_torch.models.vgg_plugin import make_vgg16_model
    from interactive_vit_tpu_torch.models.swin_plugin import make_swin_model
    from interactive_vit_tpu_torch.models.tome_plugin import make_tome_model
    from interactive_vit_tpu_torch.models.vit import VARIANTS
    from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model
    from interactive_vit_tpu_torch.parallel.train import setup
    from interactive_vit_tpu_torch.serving.app import App
    from interactive_vit_tpu_torch.serving.server import build_app
    from interactive_vit_tpu_torch.tools.run_graph import main as run_graph
    from interactive_vit_tpu_torch.tools.evaluate import main as eval_main
    from interactive_vit_tpu_torch.tools.pretrain import main as pretrain_main
    from interactive_vit_tpu_torch.tools.train import main as train_main
    from interactive_vit_tpu_torch.tools.dryrun_multichip import (
        main as dryrun_main,
    )

    return {
        "build_app": lambda tmp: build_app(models=["vit_t16"],
                                           graphs_dir=str(tmp)),
        "App": lambda tmp: App(graphs_dir=str(tmp)),
        "Executor": lambda tmp: Executor(),
        "make_vit_model": lambda tmp: make_vit_model("vit_t16"),
        "build_app_swin": lambda tmp: build_app(models=("swin_t",),
                                                graphs_dir=str(tmp)),
        "make_swin_model": lambda tmp: make_swin_model("swin_t"),
        "make_model": lambda tmp: make_model("swin_t"),
        "make_tome_model": lambda tmp: make_tome_model("vit_s16_tome"),
        "make_model_tome": lambda tmp: make_model("vit_s16_tome"),
        "train_setup": lambda tmp: setup(VARIANTS["vit_t16"]),
        "train_main": lambda tmp: train_main(["--steps", "1"]),
        "make_clip_model": lambda tmp: make_clip_model(),
        "make_clip_text_model": lambda tmp: make_clip_text_model(),
        "make_vgg16_model": lambda tmp: make_vgg16_model(),
        "make_model_clip": lambda tmp: make_model("clip_b32"),
        "make_model_vgg16": lambda tmp: make_model("vgg16"),
        "build_app_clip_vgg": lambda tmp: build_app(
            models=("clip_b32", "clip_text_b32", "vgg16"),
            graphs_dir=str(tmp)),
        "run_graph_zeroshot": lambda tmp: run_graph(["clip_zeroshot"]),
        "train_main_data": lambda tmp: train_main(
            ["--steps", "1", "--data", str(tmp / "none"), "--hflip"]),
        "eval_main": lambda tmp: eval_main(["--memorize", "4"]),
        "pretrain_main": lambda tmp: pretrain_main(["--steps", "1"]),
        "train_main_swin": lambda tmp: train_main(
            ["--steps", "1", "--variant", "swin_t", "--no-remat"]),
        "train_main_distill": lambda tmp: train_main(
            ["--steps", "1", "--variant", "deit_b16", "--distill-teacher",
             str(tmp / "t.safetensors"), "--teacher-variant", "vit_b16"]),
        "train_main_mesh": lambda tmp: train_main(
            ["--steps", "1", "--mesh", "data=1"]),
        "pretrain_main_mesh": lambda tmp: pretrain_main(
            ["--steps", "1", "--mesh", "data=1"]),
        "eval_main_mesh": lambda tmp: eval_main(
            ["--memorize", "4", "--mesh", "data=1"]),
        "dryrun_main": lambda tmp: dryrun_main([]),
    }


@pytest.mark.parametrize("entry", ["build_app", "App", "Executor",
                                   "make_vit_model", "build_app_swin",
                                   "make_swin_model", "make_model",
                                   "make_tome_model", "make_model_tome",
                                   "train_setup", "train_main",
                                   "make_clip_model", "make_clip_text_model",
                                   "make_vgg16_model", "make_model_clip",
                                   "make_model_vgg16", "build_app_clip_vgg",
                                   "run_graph_zeroshot", "train_main_data",
                                   "eval_main", "pretrain_main",
                                   "train_main_swin", "train_main_distill",
                                   "train_main_mesh", "pretrain_main_mesh",
                                   "eval_main_mesh", "dryrun_main"])
def test_default_device_entry_points_raise_without_a_card(
        entry, tmp_path, monkeypatch):
    """The entry points run on the card unless asked for the CPU: with no
    card they raise a clear error instead of carrying on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _default_device_entry_points()[entry](tmp_path)


def test_server_entry_point_serves_on_cpu(tmp_path):
    """``python -m ...serving.server`` boots vit_t16 on the CPU over a
    graphs dir in tmp_path and answers the registry and graph endpoints."""
    graphs = tmp_path / "graphs"
    graphs.mkdir()
    shutil.copy(os.path.join(ROOT, "static", "graphs", "vit_t16.json"),
                graphs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "interactive_vit_tpu_torch.serving.server",
         "--models", "vit_t16", "--device", "cpu", "--dtype", "bfloat16",
         "--port", str(port), "--graphs-dir", str(graphs)],
        cwd=ROOT, env=_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(base + "/health", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None, "server exited"
                assert time.monotonic() < deadline, "server did not start"
                time.sleep(0.5)
        assert health["ok"] is True
        with urllib.request.urlopen(base + "/list_graphs", timeout=5) as r:
            assert json.loads(r.read()) == ["vit_t16.json",
                                            "vit_t16_saliency.json"]
        with urllib.request.urlopen(
                base + "/description/vit_t16:blocks.11", timeout=5) as r:
            assert json.loads(r.read()) == {"ins": ["o", "r"],
                                            "outs": ["o", "attn", "r", "cls"]}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
