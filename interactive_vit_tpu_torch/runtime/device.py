"""The device an entry point runs on.

The port's entry points (``serving.server.build_app``, ``serving.app.App``,
``graph.executor.Executor``, ``models.vit_plugin.make_vit_model``) run on
the card unless the caller asks for the CPU. Asked for CUDA where there is
no card, they raise here; they never carry on on the CPU.
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
