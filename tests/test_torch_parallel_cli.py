"""The mesh entry points under ``torchrun`` (two gloo ranks, ``--device
cpu``) against their one-process runs.

* ``tools/train.py --mesh data=2``: every rank draws the global batch of
  the one-process run's stream and trains its rows; the logged losses
  (1e-5, the three-step test's bound: the two halves' means are averaged
  in another order than the whole batch's) and the final checkpoint match
  the one-process run's (1e-5, but the k columns of qkv_b: their exact
  gradient is 0, so both runs hold f32 noise there, which AdamW turns into
  updates of about lr each; held to 2 lr an update, as in
  ``test_torch_train.py``), and the mesh's checkpoint resumes without a
  mesh.
* ``tools/evaluate.py --mesh data=2`` on that checkpoint: the JSON line's
  counts and accuracies equal the one-process run's exactly (the chunk of
  20 images pads to 24, and each rank counts only its real rows).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from interactive_vit_tpu_torch.parallel import train as train_lib
from interactive_vit_tpu_torch.tools import evaluate
from interactive_vit_tpu_torch.tools import train as train_tool
from interactive_vit_tpu_torch.utils.checkpoint import load_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, STEPS = 1e-4, 3
TRAIN = ["--variant", "vit_t16@32", "--batch", "8", "--steps", str(STEPS),
         "--memorize", "16", "--lr", str(LR), "--log-every", "1",
         "--device", "cpu"]
EVAL = ["--variant", "vit_t16@32", "--memorize", "20", "--batch", "8",
        "--device", "cpu"]


def _torchrun(module, argv):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", module, *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return res


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(the mesh run's output dir and logged losses, the one-process
    run's output dir and history)."""
    tmp = tmp_path_factory.mktemp("cli")
    res = _torchrun("interactive_vit_tpu_torch.tools.train",
                    [*TRAIN, "--mesh", "data=2", "--output", str(tmp / "m")])
    logged = [(int(s), float(v)) for s, v in re.findall(
        r"step\s+(\d+)\s+loss\s+([-\d.]+)", res.stderr)]
    one = train_tool.main([*TRAIN, "--output", str(tmp / "o")])
    return tmp / "m", logged, tmp / "o", one["history"]


def test_train_mesh_losses_match_one_process(trained):
    _, logged, _, history = trained
    assert [s for s, _ in logged] == list(range(STEPS))  # rank 0 logs
    np.testing.assert_allclose([v for _, v in logged],
                               [v for _, v, _ in history], rtol=0,
                               atol=1e-5)


def test_train_mesh_checkpoint_matches_one_process(trained):
    mesh_dir, _, one_dir, _ = trained
    for part in ("params", "state"):
        got = load_params(str(mesh_dir / part), device="cpu")
        want = load_params(str(one_dir / part), device="cpu")
        if part == "state":
            got, want = got["params"], want["params"]
        d = 192
        for (path, a), b in zip(train_lib.tree_leaves_with_path(got),
                                train_lib.tree_leaves(want)):
            a, b = a.numpy(), b.numpy()
            if path.endswith("['qkv_b']"):
                np.testing.assert_allclose(a[d:2 * d], b[d:2 * d], rtol=0,
                                           atol=2 * LR * STEPS)
                a = np.delete(a, np.s_[d:2 * d])
                b = np.delete(b, np.s_[d:2 * d])
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                       err_msg=path)


def test_mesh_checkpoint_resumes_without_a_mesh(trained):
    mesh_dir, _, _, _ = trained
    argv = [a for a in TRAIN if a != str(STEPS)]
    out = train_tool.main([*argv[:argv.index("--steps") + 1],
                           str(STEPS + 1),
                           *argv[argv.index("--steps") + 1:],
                           "--output", str(mesh_dir), "--resume"])
    assert out["start_step"] == STEPS
    assert [s for s, _, _ in out["history"]] == [STEPS]
    assert np.isfinite(out["history"][0][1])


def test_eval_mesh_matches_one_process(trained, capsys):
    mesh_dir, _, _, _ = trained
    ckpt = ["--ckpt", str(mesh_dir / "params")]
    res = _torchrun("interactive_vit_tpu_torch.tools.evaluate",
                    [*EVAL, *ckpt, "--mesh", "data=2"])
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 1  # rank 0 prints
    one = evaluate.main([*EVAL, *ckpt])
    for key in ("variant", "n", "top1", "top5"):
        assert lines[0][key] == one[key], key


def test_pretrain_mesh_losses_match_one_process(tmp_path):
    """``tools/pretrain.py --mesh data=2``: each rank draws the global
    batch's masks and keeps its rows, so the reconstruction losses are the
    one-process run's (1e-5)."""
    argv = ["--variant", "mae_t16@64", "--batch", "8", "--steps", "2",
            "--memorize", "16", "--log-every", "1", "--device", "cpu"]
    res = _torchrun("interactive_vit_tpu_torch.tools.pretrain",
                    [*argv, "--mesh", "data=2"])
    logged = [float(v) for v in re.findall(
        r"step\s+\d+\s+recon loss\s+([-\d.]+)", res.stderr)]
    from interactive_vit_tpu_torch.tools import pretrain

    one = pretrain.main(argv)
    assert len(logged) == 2
    np.testing.assert_allclose(logged, [v for _, v, _ in one["history"]],
                               rtol=0, atol=1e-5)
