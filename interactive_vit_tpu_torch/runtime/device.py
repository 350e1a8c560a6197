"""The device an entry point runs on.

The port's entry points (``serving.server.build_app``, ``serving.app.App``,
``graph.executor.Executor``, ``models.vit_plugin.make_vit_model``) run on
the card unless the caller asks for the CPU. Asked for CUDA where there is
no card, they raise here; they never carry on on the CPU.
``exact_f32_matmuls`` turns TF32 off for the process, as the entry points
that serve f32 results do first.
"""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it
    names CUDA and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            f"pass device='cpu' to run on the CPU")
    return dev


def exact_f32_matmuls() -> None:
    """Turn TF32 off for cuBLAS matmuls and cuDNN: the f32 paths
    (``ops/layers.linear``, ``pca_view``, the gradient kinds' twins) keep
    the 1e-4 parity contract only with exact f32 products, which an
    environment that turned TF32 on would silently lose."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
