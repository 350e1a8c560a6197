"""The kernel build's cache key and its refusal to go on without a compiler.

A library's file name must change with its source, with every shared
header under ``csrc/`` and with the flags, or an edited header would load
a stale library. Without ``nvcc`` a build raises; nothing falls back.

The ``cuda``-marked cases build the fused-block, window-attention, MLP,
W8A8 MLP, online flash and attention-backward kernels and the six
tensor-core sources from ``csrc/`` and skip without a card. The fused block's C entry is also read from its
source here, so that its ctypes signature cannot drift from it.
"""

import ctypes
import os
import re

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


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "unsigned long long": ctypes.c_ulonglong}


def test_fused_block_entry_matches_its_ctypes_signature():
    """``ivt_fused_attn_block``'s parameters in ``csrc/fused_attn_block.cu``
    (ToMe's key bias and metric pointers included) against the argtypes
    that ``ops/fused_block.py`` binds: the same count and kinds, in
    order."""
    from interactive_vit_tpu_torch.ops import fused_block

    with open(os.path.join(cuda_build.CSRC_DIR, "fused_attn_block.cu")) as f:
        src = f.read()
    params = re.search(r"int ivt_fused_attn_block\(([^)]*)\)", src).group(1)
    kinds = []
    for decl in (" ".join(p.split()) for p in params.split(",")):
        ctype = decl.rsplit(" ", 1)[0]
        kinds.append(ctypes.c_void_p if "*" in decl
                     else _C_TYPES[ctype.replace("const ", "")])
    names = [decl.split()[-1].lstrip("*") for decl in params.split(",")]
    assert names[14:16] == ["kb", "metric"]
    assert kinds == fused_block.ENTRY_ARGTYPES


@pytest.mark.cuda
@pytest.mark.parametrize("name,module,entry", [
    ("fused_attn_block", "fused_block", "ivt_fused_attn_block"),
    ("fused_window_attn", "fused_window", "ivt_fused_window_attn"),
    ("fused_mlp_block", "fused_mlp", "ivt_fused_mlp_block"),
    ("fused_mlp_w8a8_block", "fused_mlp", "ivt_fused_mlp_w8a8_block"),
    ("flash_attention_online", "flash_attention",
     "ivt_flash_attention_online"),
    ("attention_bwd", "attention_vjp", "ivt_attention_bwd"),
    ("flash_attention_online_mma", "flash_attention",
     "ivt_flash_attention_online_mma"),
    ("attention_train_mma", "attention_vjp", "ivt_attention_train_bwd_mma"),
    ("flash_attention_mma", "flash_attention", "ivt_flash_attention_mma"),
    ("flash_attention_online_tf32", "flash_attention",
     "ivt_flash_attention_online_tf32x3"),
    ("flash_attention_tf32", "flash_attention", "ivt_flash_attention_tf32x3"),
    ("attention_train_tf32", "attention_vjp", "ivt_attention_train_bwd_tf32"),
    ("headwise_attn_block_mma", "fused_block", "ivt_headwise_attn_block_mma"),
    ("headwise_attn_block_tf32", "fused_block",
     "ivt_headwise_attn_block_tf32x3"),
    ("fused_mlp_block_mma", "fused_mlp", "ivt_fused_mlp_block_mma"),
    ("fused_mlp_w8a8_mma", "fused_mlp", "ivt_fused_mlp_w8a8_mma"),
    ("fused_window_attn_mma", "fused_window", "ivt_fused_window_attn_mma"),
    ("fused_window_attn_tf32", "fused_window",
     "ivt_fused_window_attn_tf32x3"),
    ("fused_mlp_block_tf32", "fused_mlp", "ivt_fused_mlp_block_tf32x3"),
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
              "flash_attention_online": "load_online_kernel",
              "flash_attention_online_mma": "load_online_mma_kernel",
              "attention_train_mma": "load_mma_kernel",
              "flash_attention_mma": "load_mma_kernel",
              "flash_attention_online_tf32": "load_online_tf32_kernel",
              "flash_attention_tf32": "load_tf32_kernel",
              "attention_train_tf32": "load_tf32_kernel",
              "headwise_attn_block_mma": "load_headwise_mma_kernel",
              "headwise_attn_block_tf32": "load_headwise_tf32_kernel",
              "fused_mlp_block_mma": "load_mma_kernel",
              "fused_mlp_w8a8_mma": "load_w8a8_mma_kernel",
              "fused_window_attn_mma": "load_mma_kernel",
              "fused_window_attn_tf32": "load_tf32_kernel",
              "fused_mlp_block_tf32": "load_tf32_kernel"}.get(
                  name, "load_kernel")
    lib = getattr(mod, loader)()  # raises if the envelopes disagree
    assert hasattr(lib, entry)
