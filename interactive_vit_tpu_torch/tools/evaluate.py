"""Top-1 / top-k evaluation over a stream of labelled batches.

Counterpart of ``run_eval`` in ``interactive_vit_tpu/tools/evaluate.py``
(the ``ivt-eval`` command line around it is not ported).
"""

from __future__ import annotations

import numpy as np
import torch


def run_eval(infer, params, batches, batch: int, top_k: int = 5):
    """Stream (images, labels) chunks through ``infer(params, images) ->
    logits``. A short final chunk is padded to ``batch`` rows by repeating
    its first image, so every call sees the training batch size. Returns
    (n, top1_hits, topk_hits)."""
    n = hits1 = hitsk = 0
    for images, labels in batches:
        k = len(labels)
        images = np.asarray(images)
        if k < batch:
            pad = np.repeat(images[:1], batch - k, axis=0)
            images = np.concatenate([images, pad])
        logits = infer(params, images)
        if isinstance(logits, torch.Tensor):
            logits = logits.float().cpu().numpy()
        logits = np.asarray(logits)[:k]
        labels = np.asarray(labels)[:k]
        order = np.argsort(-logits, axis=-1)
        hits1 += int((order[:, 0] == labels).sum())
        hitsk += int((order[:, :top_k] == labels[:, None]).any(-1).sum())
        n += k
    return n, hits1, hitsk
