"""Device constants cached across passes, owned by the captures that read them.

A pass reads a few small tensors that it does not make itself: resize
matrices, normalisation constants, head-subset indices, Swin's bias index
and seam masks. Each is built once for its key (``device_constant``), so
that a pass uploads nothing from the host, which a CUDA graph capture
refuses. The caches are bounded LRUs, since some keys come from requests
(an image's size, a head subset). A captured graph keeps only the
constants' device addresses, so an entry evicted from its LRU while a
cached program still replays would give its memory back to the allocator
and the replay would read whatever is written there next. The executor
therefore collects, in ``retained()``, every constant that its warm pass
and capture read, and the program holds them for as long as it lives.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Iterator, List

_local = threading.local()
_CACHES: List[Callable] = []


def device_constant(maxsize: int):
    """``functools.lru_cache(maxsize)`` whose every result, a hit or a
    miss, is also handed to the ``retained()`` collection open in the
    calling thread."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args, **kw):
            out = cached(*args, **kw)
            keep = getattr(_local, "keep", None)
            if keep is not None:
                keep.append(out)
            return out

        get.cache_clear = cached.cache_clear
        get.cache_info = cached.cache_info
        _CACHES.append(get)
        return get
    return wrap


@contextlib.contextmanager
def retained() -> Iterator[list]:
    """A list that collects every ``device_constant`` result returned in
    this thread inside the block (nested blocks each collect their own)."""
    prev = getattr(_local, "keep", None)
    keep = _local.keep = []
    try:
        yield keep
    finally:
        _local.keep = prev


def clear_all() -> None:
    """Empty every ``device_constant`` cache (their entries stay alive
    where a program retained them)."""
    for get in _CACHES:
        get.cache_clear()
