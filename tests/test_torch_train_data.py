"""The trainer's data path (``tools/train.py --data`` and the augmentation
flags) on the CPU, against the JAX package's loader and augmentations.

A ``--data`` run reads ``{PREFIX}_images.npy`` / ``_labels.npy`` through
the native loader (``borrow=True``): the first batch is the train-stream
eval sample, step k trains on batch k + 1 of the JAX ``Loader``'s stream,
augmented as JAX's ``make_augment_fn`` augments it at step k (the batches
within 1e-6, ``tests/test_torch_augment.py``'s bound); a run resumed
halfway skips the consumed batches and ends on the uninterrupted run's
params bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.data import augment as JA
from interactive_vit_tpu.data import loader as jloader
from interactive_vit_tpu_torch.data.loader import save_dataset
from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.parallel import train as train_lib
from interactive_vit_tpu_torch.tools import train as train_tool

torch.set_num_threads(2)

AUG = ["--hflip", "--crop-pad", "4", "--color-jitter", "0.4", "--cutout",
       "8", "--mixup", "0.8", "--cutmix", "1.0"]


@pytest.fixture
def tiny(monkeypatch):
    cfg = vit.ViTConfig("vit_tiny_data", img_size=32, patch=16, width=128,
                        depth=1, heads=2, num_classes=10)
    monkeypatch.setitem(vit.VARIANTS, "vit_tiny_data", cfg)
    return cfg


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    """40 images of 3 x 32 x 32 over 10 classes: 5 batches of 8 an
    epoch, so a 6-step run crosses an epoch boundary."""
    rng = np.random.default_rng(0)
    p = str(tmp_path_factory.mktemp("data") / "ds")
    save_dataset(p, rng.random((40, 3, 32, 32)).astype(np.float32),
                 rng.integers(0, 10, 40))
    return p


def _args(prefix, *extra):
    return ["--device", "cpu", "--variant", "vit_tiny_data", "--batch", "8",
            "--data", prefix, "--seed", "3", "--log-every", "1", *AUG,
            *extra]


def _same(a, b):
    la, lb = train_lib.tree_leaves(a), train_lib.tree_leaves(b)
    return len(la) == len(lb) and all(
        (x.dtype == y.dtype and torch.equal(x, y))
        if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


@pytest.mark.parametrize("dtype,attn", [("float32", "reference"),
                                        ("mixed", "flash_vjp")])
def test_resume_through_the_loader_is_bit_for_bit(tmp_path, tiny, prefix,
                                                  dtype, attn):
    """4 steps straight, against 2 steps saved and resumed to 4: the same
    params, optimizer state and step."""
    extra = ["--dtype", dtype, "--attn", attn]
    full = train_tool.main(_args(prefix, "--steps", "4", *extra))
    assert full["backend"] == "native"
    out = str(tmp_path / "run")
    train_tool.main(_args(prefix, "--steps", "2", "--output", out,
                          "--save-every", "2", *extra))
    resumed = train_tool.main(_args(prefix, "--steps", "4", "--output", out,
                                    "--resume", *extra))
    assert resumed["start_step"] == 2
    assert _same(resumed["params"], full["params"])
    assert _same(resumed["state"]["opt_state"], full["state"]["opt_state"])
    assert [h[0] for h in resumed["history"]] == [2, 3]
    assert [h[1] for h in resumed["history"]] == [h[1] for h in
                                                  full["history"][2:]]


def test_batches_are_the_jax_stream_augmented(tiny, prefix, monkeypatch):
    """What each step trains on: the JAX loader's batch k + 1 (batch 0 is
    the eval sample) through JAX's augmentations at step k."""
    seen = []
    real_setup = train_lib.setup

    def recording_setup(*a, **k):
        params, opt, step_fn, infer = real_setup(*a, **k)

        def step(p, o, images, labels):
            seen.append((images.clone(), labels.clone()))
            return step_fn(p, o, images, labels)

        return params, opt, step, infer

    monkeypatch.setattr(train_lib, "setup", recording_setup)
    res = train_tool.main(_args(prefix, "--steps", "6"))
    ld = jloader.Loader(prefix + "_images.npy", prefix + "_labels.npy", 8,
                        seed=3, flip=True, backend="python")
    ev_images, ev_labels, _ = next(ld)
    assert res["eval_sample"][0].tobytes() == ev_images.tobytes()
    assert res["eval_sample"][1].tobytes() == ev_labels.tobytes()
    aug = JA.make_augment_fn(
        JA.AugmentConfig(hflip=True, crop_pad=4, color_jitter=0.4, cutout=8,
                         mixup_alpha=0.8, cutmix_alpha=1.0), 10,
        base_key=jax.random.key(3 + 0x5EED))
    assert len(seen) == 6
    for step, (images, labels) in enumerate(seen):
        bi, bl, _ = next(ld)
        ji, jl = aug(step, jnp.asarray(bi), jnp.asarray(bl))
        assert images.shape == (8, 3, 32, 32) and labels.shape == (8, 10)
        assert float(np.abs(np.asarray(ji) - images.numpy()).max()) <= 1e-6
        assert float(np.abs(np.asarray(jl) - labels.numpy()).max()) <= 1e-6


def test_python_backend_trains_the_same(tiny, prefix, monkeypatch):
    """``IVT_NATIVE=0``: the Python loader, the same params bit for bit."""
    native_run = train_tool.main(_args(prefix, "--steps", "2"))
    monkeypatch.setenv("IVT_NATIVE", "0")
    python_run = train_tool.main(_args(prefix, "--steps", "2"))
    assert (native_run["backend"], python_run["backend"]) == ("native",
                                                              "python")
    assert _same(native_run["params"], python_run["params"])


def test_unaugmented_data_run_feeds_int_labels(tiny, prefix):
    res = train_tool.main(["--device", "cpu", "--variant", "vit_tiny_data",
                           "--batch", "8", "--data", prefix, "--steps", "2",
                           "--eval-every", "2"])
    assert res["evals"] and 0.0 <= res["evals"][0][1] <= 1.0
    assert res["eval_sample"][1].dtype == np.int64


@pytest.mark.parametrize("argv", [
    ["--data", "x", "--memorize", "8"],
    ["--mesh", "data"],
    ["--init", "x.safetensors", "--variant", "swin_t"],
    ["--distill-teacher", "t.safetensors"],
])
def test_parser_refusals(argv):
    """--data and --memorize stay exclusive; a --mesh without sizes is
    refused; --init takes the plain-ViT family only; --distill-teacher
    needs --teacher-variant."""
    with pytest.raises(SystemExit) as exc:
        train_tool.parse_args(["--device", "cpu", *argv])
    assert exc.value.code == 2
