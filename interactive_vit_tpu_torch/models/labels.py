"""Class-label catalogs for classifier category nodes.

A copy of ``interactive_vit_tpu/models/labels.py``: the standard 1000
ImageNet-1k category names are vendored as ``static/labels/imagenet1k.txt``,
so any model with 1000 classes gets real labels instead of ``class_000...``
placeholders."""

from __future__ import annotations

import functools
import os
from typing import List, Optional

_LABELS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "static", "labels",
)


@functools.lru_cache(maxsize=None)
def imagenet_labels() -> Optional[List[str]]:
    """The 1000 ImageNet-1k category names, or None if the data file is
    missing (installs that strip static data)."""
    path = os.path.join(_LABELS_DIR, "imagenet1k.txt")
    try:
        with open(path, encoding="utf-8") as f:
            labels = [line.rstrip("\n") for line in f]
    except OSError:
        return None
    return labels if len(labels) == 1000 else None


def class_names(num_classes: int) -> List[str]:
    """Labels for a classifier head: the real ImageNet names when the head
    is 1000-way, positional placeholders otherwise. Returns a fresh list
    — the underlying label table is cached process-wide, and handing out
    the cached object would let one caller's mutation corrupt every
    model's category sink."""
    if num_classes == 1000:
        labels = imagenet_labels()
        if labels is not None:
            return list(labels)
    return [f"class_{i:03d}" for i in range(num_classes)]
