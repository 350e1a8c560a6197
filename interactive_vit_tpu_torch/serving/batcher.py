"""Micro-batcher: group concurrent graph evals by signature.

Counterpart of ``interactive_vit_tpu/serving/batcher.py``. One worker
thread queues incoming (graph, taps) requests, groups consecutive requests
whose executor group signature matches (topology, params, input shapes,
taps) up to ``max_batch`` within ``max_wait_ms``, runs a group through
``Executor.run_stacked`` (one request: ``Executor.run``), and resolves each
request's future with its slice of the results. All device work happens on
that one thread.

Other-signature requests seen while a group collects wait in a backlog that
is served first on the next cycle, so a minority signature is not starved.
The JAX batcher's dispatch pipelining (overlapping one group's transfer
with the next group's compute) is not ported: groups run synchronously.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

from interactive_vit_tpu_torch.graph.executor import Executor, TapSpec
from interactive_vit_tpu_torch.graph.ir import Graph
from interactive_vit_tpu_torch.serving.metrics import Metrics

logger = logging.getLogger(__name__)


class _Item:
    __slots__ = ("graph", "taps", "future", "enqueued", "sig", "queue_s")

    def __init__(self, graph: Graph, taps: TapSpec, sig: str):
        self.graph = graph
        self.taps = taps
        self.sig = sig
        self.future: Future = Future()
        self.enqueued = time.perf_counter()
        self.queue_s = 0.0


class MicroBatcher:
    """Background worker turning a request stream into micro-batches."""

    def __init__(self, executor: Executor, max_batch: int = 8,
                 max_wait_ms: float = 3.0, metrics: Optional[Metrics] = None):
        self.executor = executor
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.metrics = metrics or Metrics()
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue()
        self._backlog: List[_Item] = []  # worker-thread only
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            self._start_locked()

    def _start_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="ivt-batcher")
            self._thread.start()
            self._started = True

    def stop(self) -> None:
        """Stop the worker; requests still queued fail with RuntimeError.
        Atomic with respect to ``submit`` (same lock)."""
        with self._lock:
            if self._started and self._thread is not None:
                self._q.put(None)
                self._thread.join(timeout=30)
                self._started = False
                if not self._thread.is_alive():
                    self._thread = None

    def submit(self, graph: Graph, taps: TapSpec = "all") -> Future:
        """Enqueue one eval; returns a Future of {node: {ch: array}}."""
        if not isinstance(taps, str):
            taps = frozenset(taps)  # a generator would be exhausted below
        tap_key = taps if isinstance(taps, str) else str(sorted(taps))
        item = _Item(graph, taps, self.executor.group_sig(graph,
                                                          extra=[tap_key]))
        with self._lock:
            if (not self._started and self._thread is not None
                    and self._thread.is_alive()):
                raise RuntimeError(
                    "batcher is stopping (worker still exiting); retry")
            self._start_locked()
            self._q.put(item)
        return item.future

    # -- worker ----------------------------------------------------------------
    def _collect_group(self, first: _Item) -> List[_Item]:
        """Gather same-signature items up to max_batch within the window."""
        group = [first]
        keep: List[_Item] = []
        for it in self._backlog:
            if it.sig == first.sig and len(group) < self.max_batch:
                group.append(it)
            else:
                keep.append(it)
        self._backlog = keep
        deadline = time.perf_counter() + self.max_wait_s
        while len(group) < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:  # shutdown marker: push back and bail
                self._q.put(None)
                break
            if item.sig == first.sig:
                group.append(item)
            else:
                self._backlog.append(item)
        return group

    def _loop(self) -> None:
        while True:
            item = self._backlog.pop(0) if self._backlog else self._q.get()
            if item is None:
                self._drain_stopped()
                return
            self._run_group(self._collect_group(item))

    def _drain_stopped(self) -> None:
        """Fail anything still queued at shutdown: a future never resolved
        would hang its HTTP handler thread."""
        err = RuntimeError("batcher stopped")
        leftovers = list(self._backlog)
        self._backlog = []
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            if it is not None:
                leftovers.append(it)
        for it in leftovers:
            if not it.future.done():
                it.future.set_exception(err)

    def _run_group(self, group: List[_Item]) -> None:
        t0 = time.perf_counter()
        for it in group:
            it.queue_s = t0 - it.enqueued
            self.metrics.queue_latency.observe(it.queue_s)
        try:
            if len(group) == 1:
                results = [self.executor.run(group[0].graph, group[0].taps)]
            else:
                results = self.executor.run_stacked(
                    [it.graph for it in group], group[0].taps)
        except Exception as err:  # noqa: BLE001 -- fail the whole group
            logger.exception("batch failed")
            self.metrics.inc("batch_errors")
            for it in group:
                if not it.future.done():
                    it.future.set_exception(err)
            return
        compute_s = time.perf_counter() - t0
        self.metrics.compute_latency.observe(compute_s)
        self.metrics.batch_sizes.observe(len(group))
        self.metrics.inc("batches")
        self.metrics.inc("batched_requests", len(group))
        for it, res in zip(group, results):
            # per-request phase attribution, read by App.compute
            it.future.ivt_timing = {
                "queue_ms": round(it.queue_s * 1e3, 2),
                "compute_ms": round(compute_s * 1e3, 2),
                "batch": len(group),
            }
            it.future.set_result(res)
            self.metrics.request_latency.observe(
                time.perf_counter() - it.enqueued)
