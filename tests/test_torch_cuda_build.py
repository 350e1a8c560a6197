"""The kernel build's cache key and its refusal to go on without a compiler.

A library's file name must change with its source, with every shared
header under ``csrc/`` and with the flags, or an edited header would load
a stale library. Without ``nvcc`` a build raises; nothing falls back.

The ``cuda``-marked cases build the window-attention, MLP, W8A8 MLP and
online flash kernels from ``csrc/`` and skip without a card.
"""

import os

import pytest

from interactive_vit_tpu_torch.runtime import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "common.cuh"\n')
    (src / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(src))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    return src


def test_library_path_keys_on_source_headers_and_flags(csrc, monkeypatch):
    first = cuda_build.library_path("k")
    assert first == cuda_build.library_path("k")
    assert os.path.dirname(first) == cuda_build.BUILD_DIR
    assert os.path.basename(first).startswith("k-")
    (csrc / "common.cuh").write_text("// v2\n")
    header_edit = cuda_build.library_path("k")
    (csrc / "other.cuh").write_text("// new header\n")
    new_header = cuda_build.library_path("k")
    (csrc / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    source_edit = cuda_build.library_path("k")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ("-lineinfo",))
    flags_edit = cuda_build.library_path("k")
    paths = [first, header_edit, new_header, source_edit, flags_edit]
    assert len(set(paths)) == len(paths)


def test_build_without_nvcc_raises(csrc, monkeypatch):
    exists = os.path.exists
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists",
                        lambda p: False if p.endswith("bin/nvcc")
                        else exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("k")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_all(["k"])
    assert not any(f.endswith(".so") for f in
                   os.listdir(cuda_build.BUILD_DIR))


@pytest.mark.cuda
@pytest.mark.parametrize("name,module,entry", [
    ("fused_window_attn", "fused_window", "ivt_fused_window_attn"),
    ("fused_mlp_block", "fused_mlp", "ivt_fused_mlp_block"),
    ("fused_mlp_w8a8_block", "fused_mlp", "ivt_fused_mlp_w8a8_block"),
    ("flash_attention_online", "flash_attention",
     "ivt_flash_attention_online"),
])
def test_kernel_builds_and_loads_on_the_card(name, module, entry):
    """The source builds with nvcc into its keyed library, exports its
    entry, and agrees with its Python module on the shape envelope."""
    import importlib

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    so = cuda_build.build(name)
    assert so == cuda_build.library_path(name) and os.path.exists(so)
    mod = importlib.import_module("interactive_vit_tpu_torch.ops." + module)
    loader = {"fused_mlp_w8a8_block": "load_w8a8_kernel",
              "flash_attention_online": "load_online_kernel"}.get(
                  name, "load_kernel")
    lib = getattr(mod, loader)()  # raises if the envelopes disagree
    assert hasattr(lib, entry)
