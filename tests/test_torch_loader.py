"""The port's batch loader (``data/loader.py``) against the JAX package's.

The contract: the port's native backend (``runtime/dataloader.cpp``) and
its Python backend give the stream of the JAX ``Loader``'s Python backend
for the same files, seed and flip, bit for bit, whatever the thread count
and with ``borrow`` on or off: a per-epoch mt19937_64 shuffle, a
splitmix64 flip per sample, batches in order, the tail dropped.
"""

import shutil

import numpy as np
import pytest

from interactive_vit_tpu.data import loader as jloader
from interactive_vit_tpu_torch.data import loader
from interactive_vit_tpu_torch.data.loader import Loader, save_dataset
from interactive_vit_tpu_torch.runtime import native

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build the host library")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds")
    rng = np.random.default_rng(0)
    images = rng.random((37, 3, 8, 8)).astype(np.float32)
    labels = rng.integers(0, 10, 37).astype(np.int64)
    prefix = str(d / "ds")
    save_dataset(prefix, images, labels)
    return prefix, images, labels


def _files(prefix):
    return prefix + "_images.npy", prefix + "_labels.npy"


def _jax_stream(prefix, batch, seed, flip, n):
    ld = jloader.Loader(*_files(prefix), batch=batch, seed=seed, flip=flip,
                        backend="python")
    return [next(ld) for _ in range(n)]


@pytest.mark.parametrize("backend,threads,borrow,flip", [
    pytest.param("native", 1, False, True, marks=needs_gxx),
    pytest.param("native", 3, False, True, marks=needs_gxx),
    pytest.param("native", 2, True, True, marks=needs_gxx),
    pytest.param("native", 3, True, False, marks=needs_gxx),
    pytest.param("auto", 2, True, True, marks=needs_gxx),
    ("python", 1, False, True),
    ("python", 1, True, False),
])
def test_stream_equals_jax_python_backend(dataset, backend, threads, borrow,
                                          flip):
    """12 batches of 8 (4 an epoch: two epoch boundaries) equal the JAX
    loader's Python stream bit for bit; borrowed batches are compared
    before the next next() reuses their slot."""
    prefix, _, _ = dataset
    want = _jax_stream(prefix, 8, 5, flip, 12)
    ld = Loader(*_files(prefix), batch=8, seed=5, flip=flip,
                threads=threads, depth=6, backend=backend, borrow=borrow)
    assert ld.native == (backend != "python")
    try:
        for wi, wl, we in want:
            gi, gl, ge = next(ld)
            assert ge == we
            assert gl.tobytes() == wl.tobytes()
            assert gi.dtype == np.float32 and gi.tobytes() == wi.tobytes()
    finally:
        ld.close()


def test_ivt_native_0_gives_the_python_backend(dataset, monkeypatch):
    monkeypatch.setenv("IVT_NATIVE", "0")
    ld = Loader(*_files(dataset[0]), batch=8)
    assert not ld.native


@needs_gxx
def test_native_asked_for_raises_when_it_cannot_be_built(
        dataset, monkeypatch, tmp_path):
    """``backend="native"`` (and ``auto``) never fall back to Python."""
    from interactive_vit_tpu_torch.runtime import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "FLAGS", build.FLAGS + ("-fno-such-flag",))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.delenv("IVT_NATIVE", raising=False)
    for backend in ("native", "auto"):
        with pytest.raises(RuntimeError, match="IVT_NATIVE=0"):
            Loader(*_files(dataset[0]), batch=8, backend=backend)


@needs_gxx
def test_native_refuses_a_truncated_file(dataset, tmp_path):
    ip, lp = _files(dataset[0])
    bad = tmp_path / "cut_images.npy"
    bad.write_bytes(open(ip, "rb").read()[:-100])
    with pytest.raises(RuntimeError, match="could not open"):
        Loader(str(bad), lp, batch=8, backend="native")


def test_shuffle_and_flip_helpers_equal_jax():
    for seed in (0, 7, 2 ** 40 + 3):
        a, b = loader._MT19937_64(seed), jloader._MT19937_64(seed)
        assert [a.next() for _ in range(700)] == [b.next() for _ in range(700)]
        for epoch in (0, 1, 5):
            np.testing.assert_array_equal(loader._epoch_perm(37, seed, epoch),
                                          jloader._epoch_perm(37, seed, epoch))
        assert loader._splitmix64(seed) == jloader._splitmix64(seed)


def test_save_dataset_and_meta_equal_jax(dataset, tmp_path):
    _, images, labels = dataset
    save_dataset(str(tmp_path / "a"), images, labels.astype(np.int32))
    jloader.save_dataset(str(tmp_path / "b"), images, labels)
    for part in ("_images.npy", "_labels.npy"):
        a = (tmp_path / ("a" + part)).read_bytes()
        assert a == (tmp_path / ("b" + part)).read_bytes()
        path = str(tmp_path / ("a" + part))
        assert loader._npy_meta(path) == jloader._npy_meta(path)


def test_epoch_covers_every_sample_once(dataset):
    prefix, _, labels = dataset
    ld = Loader(*_files(prefix), batch=8, seed=1, backend="python")
    seen = []
    for _ in range(ld.batches_per_epoch):
        _, lab, ep = next(ld)
        assert ep == 0
        seen.extend(lab.tolist())
    from collections import Counter

    assert len(seen) == 32 and not Counter(seen) - Counter(labels.tolist())


@pytest.mark.parametrize("backend", [pytest.param("native", marks=needs_gxx),
                                     "python"])
def test_malformed_inputs_raise(dataset, tmp_path, backend):
    ip, lp = _files(dataset[0])
    bad = tmp_path / "bad_images.npy"
    np.save(bad, np.zeros((4, 3, 8, 8), np.float64))
    with pytest.raises(ValueError, match="float32"):
        Loader(str(bad), lp, batch=2, backend=backend)
    bad = tmp_path / "bad_labels.npy"
    np.save(bad, np.zeros((37,), np.int32))
    with pytest.raises(ValueError, match="int64"):
        Loader(ip, str(bad), batch=2, backend=backend)
    with pytest.raises(ValueError, match="batch"):
        Loader(ip, lp, batch=1000, backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        Loader(ip, lp, batch=2, backend="numpy")
