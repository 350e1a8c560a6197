"""Tracing, profiling and the NaN sanitizer.

Counterpart of ``interactive_vit_tpu/utils/tracing.py``, on
``torch.profiler``:

* ``trace(log_dir)`` -- a profile of the enclosed block (CPU activities,
  and CUDA ones where a card is present) written as a Chrome trace into
  ``log_dir``. The executor runs every node inside
  ``torch.profiler.record_function("n<i>_<kind>")`` (the JAX executor's
  ``jax.named_scope`` names, ':' written '.'), so in a profiled eager pass
  each kernel's launch lies inside the range of the node that issued it. A
  CUDA-graph replay issues no host step, so it records no node range: its
  kernels appear in the trace with none;
* ``profiler_server(port)`` -- ``jax.profiler.start_server`` has no torch
  counterpart: it raises, and ``trace`` is the way to capture;
* ``debug_nans(on)`` -- the process-wide NaN sanitizer, as JAX's
  ``jax_debug_nans``. While it is on, an eager pass checks each node's
  outputs after the node runs and raises ``FloatingPointError`` naming the
  node; a replay (no per-node host step) checks its tapped outputs and, on
  a NaN, reruns the program's eager pass with the per-node checks to find
  the node, as JAX reruns a jitted call op by op. ``Executor.run_eager`` /
  ``run_timed_eager`` record the node's NaN as its error and mark its
  descendants "eval error upstream". It also turns on autograd's anomaly
  mode with NaN checks, so a gradient node's backward is checked too.
  While it is off nothing is checked: the served path pays nothing;
* ``node_timings(executor, graph)`` -- per-node wall times from the eager
  debug path (``Executor.run_timed_eager``), for "which layer is slow".
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Dict

import torch

_debug_nans = False
_traces = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block and write its Chrome trace into
    ``log_dir`` (created if missing) as ``trace.<pid>.<n>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace.{os.getpid()}.{next(_traces)}.json"))


def profiler_server(port: int = 9999):
    """JAX's live profiler server (attach with TensorBoard / XProf) has no
    torch counterpart."""
    raise NotImplementedError(
        f"torch has no live-attach profiler server (jax.profiler."
        f"start_server, port {port}); capture a window with "
        f"tracing.trace(log_dir)")


def debug_nans(on: bool = True) -> None:
    """Turn the NaN sanitizer on or off for the whole process (see the
    module docstring)."""
    global _debug_nans
    _debug_nans = bool(on)
    torch.autograd.set_detect_anomaly(_debug_nans, check_nan=True)


def nans_enabled() -> bool:
    return _debug_nans


def check_nans(index: int, name: str, outs) -> None:
    """Raises ``FloatingPointError`` naming node ``index`` (kind ``name``)
    where one of its output tensors ``outs`` ({channel: tensor}) holds a NaN
    (a host sync on a card: only while ``debug_nans`` is on)."""
    for ch, v in outs.items():
        if (isinstance(v, torch.Tensor) and v.is_floating_point()
                and bool(torch.isnan(v).any())):
            raise FloatingPointError(
                f"invalid value (nan): output {ch!r} of node {index} "
                f"({name}) holds a NaN")


def node_range(scope: str):
    """The profiler range of one node (``record_function(scope)``) while a
    profiler runs; otherwise a no-op, so an unprofiled pass pays nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(scope)
    return contextlib.nullcontext()


def node_timings(executor, graph) -> Dict[int, float]:
    """Per-node wall times in seconds: ``Executor.run_timed_eager`` (each
    node run once, then once more timed between device syncs), with its
    fault isolation: a failing node loses only its own and its
    descendants' timings."""
    timings_ms, _, _ = executor.run_timed_eager(graph)
    return {i: ms / 1e3 for i, ms in timings_ms.items()}
